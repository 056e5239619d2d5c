"""ChEES-HMC: fixed-budget adaptive Hamiltonian Monte Carlo for the
many-chain regime.

Counterpart of ``desilike_tpu/samplers/chees.py`` (Hoffman, Radul &
Sountsov 2021, arXiv:2110.11576). A lockstep NUTS makes every chain wait
for the deepest tree in the batch; ChEES removes the tree: all chains take
the same halton-jittered trajectory length an iteration, so the batch stays
dense, and that length is adapted from cross-chain statistics (the Change
in the Estimator of the Expected Square jump distance). Here an iteration
is a loop of batched leapfrog steps whose count is read on the host once
(it sets the loop), and every draw is an argument of the step.
"""

import numpy as np
import torch

from .nuts import NUTSSampler, dual_averaging_update, halton


class ChEESSampler(NUTSSampler):
    """Adaptive jittered HMC with cross-chain trajectory adaptation.

    Parameters
    ----------
    likelihood : BaseLikelihood
    nchains : int, default=128
        Designed for the many-chain regime (>= 32 chains; the cross-chain
        ChEES gradient estimate needs a healthy batch).
    target_accept : float, default=0.651
        Dual-averaging target (the HMC-optimal 0.651 rather than NUTS' 0.8).
    max_leapfrog : int, default=1024
        Safety bound on leapfrog steps per trajectory.
    """

    def __init__(self, likelihood, nchains=128, target_accept=0.651,
                 max_leapfrog=1024, **kwargs):
        kwargs.setdefault('pool_adaptation', True)
        super().__init__(likelihood, nchains=nchains, target_accept=target_accept, **kwargs)
        self.max_leapfrog = int(max_leapfrog)

    def _build_step(self, lg):
        """One ChEES iteration over the whole chain batch: shared jittered
        trajectory, per-chain leapfrog and Metropolis test, cross-chain ChEES
        and acceptance statistics, Adam on log T while ``adapting``.

        step(state, noise, uniform, halton, adapting) -> (state, record,
        stats); state = (u, lp, grad, eps, log_T, inv_mass, (m, v, t)) with
        eps, log_T and the Adam moments 0-dim tensors and inv_mass (ndim,);
        noise (B, ndim) standard normal (the momenta before the mass),
        uniform (B,) the Metropolis draws, halton the jitter (float32)."""
        max_leapfrog = self.max_leapfrog

        def step(state, noise, uniform, halton_value, adapting):
            u, lp, grad, eps, log_T, inv_mass, adam = state
            # shared jittered trajectory length (same for every chain)
            traj = halton_value * torch.exp(log_T)
            nsteps = int(torch.clamp(torch.ceil(traj / eps), 1, max_leapfrog))  # the host read of the iteration
            r0 = noise / torch.sqrt(inv_mass)
            u1, grad1, r1 = u, grad, r0
            for _ in range(nsteps):
                r_half = r1 + 0.5 * eps * grad1
                u1 = u1 + eps * inv_mass * r_half
                lp1, grad1 = lg(u1)
                r1 = r_half + 0.5 * eps * grad1
            energy0 = -lp + 0.5 * (inv_mass * r0 ** 2).sum(1)
            energy1 = -lp1 + 0.5 * (inv_mass * r1 ** 2).sum(1)
            delta = energy0 - energy1
            delta = torch.where(torch.isnan(delta), torch.full_like(delta, -np.inf), delta)
            accept_prob = torch.clamp(torch.exp(delta), max=1.)
            accept = torch.log(uniform) < delta
            u_new = torch.where(accept[:, None], u1, u)
            lp_new = torch.where(accept, lp1, lp)
            grad_new = torch.where(accept[:, None], grad1, grad)

            # ChEES criterion (arXiv:2110.11576 eq. 8): cross-chain gradient
            # of the expected squared jump of the centered squared norm
            center0 = u - u.mean(0)
            center1 = u1 - u1.mean(0)
            jump = (center1 ** 2).sum(1) - (center0 ** 2).sum(1)
            dtraj = (center1 * (inv_mass * r1)).sum(1)
            w = accept_prob / torch.clamp(accept_prob.sum(), min=1e-12)
            # diverged chains have w == 0 but jump/dtraj == nan; 0 * nan = nan
            # would poison the Adam state permanently: mask them out
            finite = torch.isfinite(jump) & torch.isfinite(dtraj)
            contrib = torch.where(finite, w * jump * dtraj, torch.zeros_like(jump))
            chees_grad = contrib.sum() * halton_value  # d/d log T direction

            # Adam on log T (only while adapting)
            m, v, t = adam
            g = -chees_grad  # ascend the criterion
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g ** 2
            t = t + 1.
            mhat = m / (1. - 0.9 ** t)
            vhat = v / (1. - 0.999 ** t)
            if adapting:
                log_T = log_T - 0.025 * mhat / (torch.sqrt(vhat) + 1e-8)
            # keep T sane relative to eps
            log_T = torch.minimum(torch.maximum(log_T, torch.log(eps)), torch.log(eps * max_leapfrog))
            stats = {'accept_prob': accept_prob.mean(), 'nsteps': nsteps, 'delta_energy': delta.abs().mean()}
            record = {'u': u_new, 'logposterior': lp_new}
            return (u_new, lp_new, grad_new, eps, log_T, inv_mass, (m, v, t)), record, stats

        return step

    def _draws(self):
        return self.normal(self.nchains, self.ndim), self.uniform(self.nchains)

    def _warm_phase(self, step, state0, hs, collect_from):
        """Dual averaging of the shared step size on the cross-chain mean
        acceptance over len(hs) iterations, collecting the cross-chain
        variance from iteration ``collect_from`` on. Returns (state, eps_bar, var)."""
        eps_in = state0[3]
        mu = np.log(10.) + torch.log(eps_in)
        log_eps_bar, h_bar = torch.log(eps_in), torch.zeros_like(eps_in)
        var_sum, count = torch.zeros_like(state0[5]), 0
        state = state0
        for i, h in enumerate(hs):
            state, _, stats = step(state, *self._draws(), h, True)
            self._count_iteration(stats)
            log_eps, log_eps_bar, h_bar = dual_averaging_update(log_eps_bar, h_bar, stats['accept_prob'], i + 1.,
                                                                mu, self.target_accept)
            if i >= collect_from:
                var_sum = var_sum + state[0].var(0, unbiased=False)
                count += 1
            state = state[:3] + (torch.exp(log_eps),) + state[4:]
        # eps_bar gates on whether the phase ran any iteration, not on the
        # variance count: phase B collects none, but its point is the re-tune
        eps_bar = torch.exp(log_eps_bar) if len(hs) else eps_in
        var = torch.clamp(var_sum / max(count, 1), 1e-12, 1e12) if count > 2 else state0[5]
        return state, eps_bar, var

    def _count_iteration(self, stats):
        self.diagnostics['iterations'] = self.diagnostics.get('iterations', 0) + 1
        self.diagnostics['leapfrogs'] = self.diagnostics.get('leapfrogs', 0) + stats['nsteps']
        self.diagnostics['host_reads'] = self.diagnostics.get('host_reads', 0) + 1

    def run(self, nsteps=1000, nwarmup=None, thin=1, resume=False):
        if nwarmup is None:
            nwarmup = max(300, nsteps // 2)
        lg = self._logdens_grad()
        step = self._build_step(lg)
        resume = resume and getattr(self, '_state', None) is not None
        # quasi-random trajectory jitter, shared across chains, in float64 then float32
        h_samp = np.array([halton(i + 1) for i in range(nwarmup, nwarmup + nsteps)], dtype='f4')
        if resume:
            # continue with the adapted kernel: no re-warmup
            u0, inv_mass0 = self._state['u'], self._state['inv_mass']
            eps0, log_T0 = self._state['eps'], self._state['log_T']
            nwarmup = 0
        else:
            u0, inv_mass0 = self._start()
            eps0 = 0.1 * torch.sqrt(inv_mass0).min()
            log_T0 = torch.log(eps0 * 16.)
        h_warm = np.array([halton(i + 1) for i in range(nwarmup)], dtype='f4')
        h_warm, h_samp = (torch.as_tensor(h, device=self.device) for h in (h_warm, h_samp))
        nw1 = int(np.ceil(0.7 * nwarmup))
        nw2 = nwarmup - nw1

        lp0, grad0 = lg(u0)
        adam0 = tuple(torch.zeros((), device=self.device) for _ in range(3))
        state = (u0, lp0, grad0, eps0, log_T0, inv_mass0, adam0)
        eps_final = eps0
        if nwarmup:
            # warmup, two phases (Stan-style windows): A) dual-averaging eps and
            # ChEES T under the initial (Hessian) mass, collecting the cross-chain
            # variance over the last third only; B) swap in the measured mass and
            # re-tune eps against it, from eps rescaled by the metric change
            stateA, epsA, varA = self._warm_phase(step, state, h_warm[:nw1], 2 * nw1 // 3)
            scale = torch.sqrt(torch.min(stateA[5] / varA)) if nw2 > 0 else 1.
            state = stateA[:3] + (epsA * scale, stateA[4], varA, stateA[6])
            eps_final = epsA
            if nw2 > 0:
                state, eps_final, _ = self._warm_phase(step, state, h_warm[nw1:], nw2 + 1)

        # sampling: everything frozen
        state = state[:3] + (eps_final,) + state[4:]
        records, accept, nleap = [], [], []
        for h in h_samp:
            state, record, stats = step(state, *self._draws(), h, False)
            self._count_iteration(stats)
            records.append(record)
            accept.append(stats['accept_prob'])
            nleap.append(stats['nsteps'])
        u, _, _, eps, log_T, inv_mass, _ = state
        self._state = {'u': u, 'inv_mass': inv_mass, 'eps': eps, 'log_T': log_T}
        self.diagnostics['step_size'] = float(eps)
        self.diagnostics['trajectory_length'] = float(torch.exp(log_T))
        self.diagnostics['acceptance_rate'] = float(torch.stack(accept).mean()) if accept else float('nan')
        self.diagnostics['mean_leapfrog'] = float(np.mean(nleap)) if nleap else float('nan')

        u_rec = torch.stack([record['u'] for record in records])[::thin]
        x_rec = self._constrain(u_rec)[0]
        lp_rec = torch.stack([record['logposterior'] for record in records])[::thin]
        return self._make_chain(x_rec.cpu().numpy(), {'logposterior': lp_rec.cpu().numpy()},
                                attrs={'sampler': 'chees',
                                       'step_size': self.diagnostics['step_size'],
                                       'trajectory_length': self.diagnostics['trajectory_length'],
                                       'acceptance_rate': self.diagnostics['acceptance_rate']})
