"""No-U-Turn sampler over a batch of chains, stepped in lockstep.

Counterpart of ``desilike_tpu/samplers/nuts.py``: iterative multinomial
NUTS (Hoffman & Gelman 2014, algorithm 3, with multinomial trajectory
sampling a la Betancourt 2017) with the checkpoint scheme for sub-tree
U-turn checks (even leaves stored at slot popcount(j); at leaf i the
subtrees of size 2^k for every k with 2^k | (i + 1) are checked against the
stored left edges), a diagonal mass matrix (Welford) and dual-averaging
step size during warmup.

Where the JAX package vmaps one chain's ``while_loop``, here every chain is
a row of one batched log-density call: the chains build their trees in
lockstep, leaf by leaf, each with a ``done`` mask, and the loop over leaves
ends when no chain is still building. That test is one host read a leaf
(counted in the step's ``host_reads``), as lockstep as the reference's
vmapped loop. The draws (momenta, direction bits, merge and multinomial
uniforms) are arguments of the step.
"""

import numpy as np
import torch

from .base import BasePosteriorSampler


def _kinetic(r, inv_mass):
    return 0.5 * (r * inv_mass * r).sum(-1)


def _is_turning(z_minus, r_minus, z_plus, r_plus, inv_mass):
    """(..., ndim) edges -> (...) bool: the trajectory between them turns back."""
    dz = z_plus - z_minus
    return ((dz * (inv_mass * r_minus)).sum(-1) < 0.) | ((dz * (inv_mass * r_plus)).sum(-1) < 0.)


def _popcount(x):
    """Population count of a non-negative int (or int tensor) below 2^31, by
    the reference's bit tricks."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _column(value, like):
    """A per-chain (B,) value, or a scalar, broadcastable against (B, ndim)."""
    return value[..., None] if isinstance(value, torch.Tensor) and value.ndim == like.ndim - 1 else value


def _where(mask, a, b):
    """torch.where with a (B,) mask against (B, ...) values."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)


class NUTSKernel(object):
    """One NUTS transition of every chain. ``draws(sampler, nchains)`` makes
    its random inputs from the sampler's generator; calling it with them
    returns (z, lp, grad, stats): stats holds per-chain 'accept_stat',
    'depth', 'diverging' and 'n_leaves', and the lockstep 'leaves' (batched
    log-density calls) and 'host_reads' of the step."""

    def __init__(self, logdens_grad_fn, ndim, max_depth=10, max_delta_energy=1000.):
        self.lg = logdens_grad_fn
        self.ndim = int(ndim)
        self.max_depth = int(max_depth)
        self.max_delta_energy = float(max_delta_energy)

    def draws(self, sampler, nchains):
        return dict(noise=sampler.normal(nchains, self.ndim),
                    go_right=sampler.uniform(nchains, self.max_depth) < 0.5,
                    accept_u=sampler.uniform(nchains, self.max_depth),
                    pick_u=sampler.uniform(nchains, 2 ** self.max_depth - 1))

    def __call__(self, z0, lp0, grad0, eps, inv_mass, noise, go_right, accept_u, pick_u):
        nchains, max_depth = z0.shape[0], self.max_depth
        eps_c = _column(eps, z0)
        r0 = noise / torch.sqrt(inv_mass)
        energy0 = -lp0 + _kinetic(r0, inv_mass)
        z_minus = z_plus = z_prop = z0
        r_minus = r_plus = r0
        grad_minus = grad_plus = grad_prop = grad0
        lp_prop = lp0
        logw_total = -energy0
        sum_accept = torch.zeros_like(lp0)
        n_leaves = torch.zeros(nchains, dtype=torch.int32, device=z0.device)
        depth = torch.zeros_like(n_leaves)
        turning = torch.zeros(nchains, dtype=torch.bool, device=z0.device)
        diverging = torch.zeros_like(turning)
        leaves = reads = 0
        for level in range(max_depth):
            active = ~turning & ~diverging
            reads += 1
            if not bool(active.any()):
                break
            right = go_right[:, level]
            z = _where(right, z_plus, z_minus)
            r = _where(right, r_plus, -r_minus)
            grad = _where(right, grad_plus, grad_minus)
            sub_z_prop, sub_lp_prop, sub_grad_prop = z, torch.zeros_like(lp0), grad
            logw = torch.full_like(lp0, -np.inf)
            sub_accept = torch.zeros_like(lp0)
            n = torch.zeros_like(n_leaves)
            sub_turning = torch.zeros_like(turning)
            sub_diverging = torch.zeros_like(turning)
            ckpt_z = torch.zeros((nchains, max_depth, self.ndim), dtype=z0.dtype, device=z0.device)
            ckpt_r = torch.zeros_like(ckpt_z)
            building = active
            for i in range(2 ** level):
                if i:
                    reads += 1
                    if not bool(building.any()):
                        break
                leaves += 1
                r_half = r + 0.5 * eps_c * grad
                z_new = z + eps_c * inv_mass * r_half
                lp_new, grad_new = self.lg(z_new)
                r_new = r_half + 0.5 * eps_c * grad_new
                z, r, grad = (_where(building, new, old) for new, old in ((z_new, z), (r_new, r), (grad_new, grad)))
                if i % 2 == 0:  # even leaves stored after the leapfrog, at slot popcount(i)
                    slot = _popcount(i)
                    ckpt_z[:, slot] = _where(building, z_new, ckpt_z[:, slot])
                    ckpt_r[:, slot] = _where(building, r_new, ckpt_r[:, slot])
                energy = -lp_new + _kinetic(r_new, inv_mass)
                delta = energy - energy0
                # NaN energies must terminate (and count as) divergences
                leaf_diverging = (delta > self.max_delta_energy) | torch.isnan(delta)
                logw_leaf = torch.where(torch.isnan(delta), torch.full_like(delta, -np.inf), -energy)
                accept_prob = torch.clamp(torch.exp(-delta), 0., 1.)
                accept_prob = torch.where(torch.isnan(accept_prob), torch.zeros_like(accept_prob), accept_prob)
                # progressive multinomial sampling within the subtree
                logw_new = torch.logaddexp(logw, logw_leaf)
                take = building & (pick_u[:, 2 ** level - 1 + i] < torch.exp(logw_leaf - logw_new))
                sub_z_prop = _where(take, z_new, sub_z_prop)
                sub_lp_prop = torch.where(take, lp_new, sub_lp_prop)
                sub_grad_prop = _where(take, grad_new, sub_grad_prop)
                logw = torch.where(building, logw_new, logw)
                sub_accept = sub_accept + torch.where(building, accept_prob, torch.zeros_like(accept_prob))
                n = n + building.to(n.dtype)
                # sub-tree U-turn checks against the left edges stored at popcount(i + 1 - 2^k)
                turn = torch.zeros_like(turning)
                for k in range(1, max_depth + 1):
                    if (i + 1) % 2 ** k == 0:
                        slot_j = _popcount(i + 1 - 2 ** k)
                        turn = turn | _is_turning(ckpt_z[:, slot_j], ckpt_r[:, slot_j], z_new, r_new, inv_mass)
                sub_turning = sub_turning | (building & turn)
                sub_diverging = sub_diverging | (building & leaf_diverging)
                building = building & ~sub_turning & ~sub_diverging

            # merge the subtree into the trajectory
            merge = active & ~sub_turning & ~sub_diverging
            z_plus = _where(right & merge, z, z_plus)
            r_plus = _where(right & merge, r, r_plus)
            grad_plus = _where(right & merge, grad, grad_plus)
            z_minus = _where(~right & merge, z, z_minus)
            r_minus = _where(~right & merge, -r, r_minus)
            grad_minus = _where(~right & merge, grad, grad_minus)
            # biased progressive sampling across the doubling
            p_new = torch.exp(torch.clamp(logw - logw_total, max=0.))
            take = merge & (accept_u[:, level] < p_new)
            z_prop = _where(take, sub_z_prop, z_prop)
            lp_prop = torch.where(take, sub_lp_prop, lp_prop)
            grad_prop = _where(take, sub_grad_prop, grad_prop)
            logw_total = torch.where(active, torch.logaddexp(
                logw_total, torch.where(merge, logw, torch.full_like(logw, -np.inf))), logw_total)
            turning_ends = _is_turning(z_minus, r_minus, z_plus, r_plus, inv_mass)
            sum_accept = sum_accept + sub_accept
            n_leaves = n_leaves + n
            depth = depth + active.to(depth.dtype)
            turning = torch.where(active, sub_turning | turning_ends, turning)
            diverging = diverging | sub_diverging

        stats = dict(accept_stat=sum_accept / torch.clamp(n_leaves, min=1), depth=depth, diverging=diverging,
                     n_leaves=n_leaves, leaves=leaves, host_reads=reads)
        return z_prop, lp_prop, grad_prop, stats


def build_nuts_kernel(logdens_grad_fn, ndim, max_depth=10, max_delta_energy=1000.):
    """The NUTS transition over a batch of chains (:class:`NUTSKernel`);
    ``logdens_grad_fn`` maps u (B, ndim) to ((B,) log-density, (B, ndim)
    gradient)."""
    return NUTSKernel(logdens_grad_fn, ndim, max_depth=max_depth, max_delta_energy=max_delta_energy)


def halton(i, base=2):
    """The i-th element of the base-``base`` van der Corput sequence, at least
    1e-3, in float64 (the shared trajectory jitter)."""
    f, r, ii = 1., 0., i
    for _ in range(20):
        f = f / base
        r = r + f * (ii % base)
        ii = ii // base
    return max(r, 1e-3)


def dual_averaging_update(log_eps_bar, h_bar, accept, t, mu, target):
    """One dual-averaging update (Hoffman & Gelman 2014, with the reference's
    constants: t0 = 10, gamma = 0.05, kappa = 0.75) at iteration t (from 1).
    Returns (log_eps, log_eps_bar, h_bar)."""
    h_bar = (1. - 1. / (t + 10.)) * h_bar + (target - accept) / (t + 10.)
    log_eps = mu - np.sqrt(t) / 0.05 * h_bar
    w = t ** -0.75
    log_eps_bar = w * log_eps + (1. - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar


def welford_update(mean, m2, count, u):
    """One Welford update of the running mean and sum of squared deviations
    with the sample u; returns (mean, m2, count)."""
    count = count + 1.
    delta = u - mean
    mean = mean + delta / torch.clamp(_column(count, u), min=1.)
    return mean, m2 + delta * (u - mean), count


class NUTSSampler(BasePosteriorSampler):
    """Batched NUTS with Stan-style warmup (dual-averaging step size and
    diagonal Welford mass matrix, per chain).

    Bounded parameters are handled with a logit transform (gradients stay
    finite at the prior edges); the log-Jacobian is added to the density.
    """

    def __init__(self, likelihood, nchains=8, max_depth=8, target_accept=0.8,
                 pool_adaptation=None, trajectory=None, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.nchains = int(nchains)
        self.max_depth = int(max_depth)
        self.target_accept = float(target_accept)
        # pool warmup adaptation across chains by default in the many-chain regime
        self.pool_adaptation = (self.nchains >= 32) if pool_adaptation is None else bool(pool_adaptation)
        # The lockstep tree makes every chain wait for the deepest tree in
        # the batch. trajectory='jitter' keeps the NUTS warmup but samples with
        # dense fixed-budget HMC at the warmup-measured mean path length,
        # halton-jittered and shared across the batch: the default at >= 1024 chains.
        if trajectory is None:
            trajectory = 'jitter' if self.nchains >= 1024 else 'nuts'
        if trajectory not in ('nuts', 'jitter'):
            raise ValueError("trajectory must be 'nuts' or 'jitter'")
        self.trajectory = trajectory
        self._set_transform()

    # --- bounded-parameter transform ---

    def _set_transform(self):
        limits = [p.prior.limits if p.prior is not None else (-np.inf, np.inf) for p in self.varied_params]
        self._lo = np.array([lim[0] for lim in limits])
        self._hi = np.array([lim[1] for lim in limits])
        self._bounded = np.isfinite(self._lo) & np.isfinite(self._hi)
        as_tensor = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)  # noqa: E731
        lo, hi = as_tensor(np.where(self._bounded, self._lo, 0.)), as_tensor(np.where(self._bounded, self._hi, 1.))
        self._transform = (torch.as_tensor(self._bounded, device=self.device), lo, hi - lo)

    def _constrain(self, u):
        """Unconstrained u (..., ndim) -> (constrained x, (...) log|Jacobian|)."""
        bounded, lo, width = self._transform
        sig = torch.sigmoid(u)
        x = torch.where(bounded, lo + width * sig, u)
        logjac = torch.where(bounded, torch.log(width) + torch.log(sig) + torch.log1p(-sig),
                             torch.zeros_like(u)).sum(-1)
        return x, logjac

    def _unconstrain(self, x):
        """Constrained x (..., ndim), numpy -> unconstrained u (float64 numpy)."""
        lo, hi = self._lo, self._hi
        t = np.clip((np.asarray(x) - lo) / np.where(self._bounded, hi - lo, 1.), 1e-6, 1 - 1e-6)
        return np.where(self._bounded, np.log(t) - np.log1p(-t), np.asarray(x))

    def _logdens_grad(self):
        """u (B, ndim) -> ((B,) log-density in u, (B, ndim) its gradient): one
        batched call and one backward of the sum, since the chains are
        independent. On the card the whole of it (the constraint, the
        forward pass and ``torch.autograd.grad``) is captured as one CUDA
        graph a (B, ndim) and replayed (:meth:`Pipeline.capture`), the unit
        that the JAX package's jitted loops repeat: one leapfrog, or one NUTS
        leaf, is one replay. ``self.lg_graph`` is that captured function.
        Counts its calls in ``self.gradient_evaluations``."""
        self.gradient_evaluations = 0

        def value_and_grad(u):
            with torch.enable_grad():
                u = u.detach().requires_grad_(True)
                x, logjac = self._constrain(u)
                lp = self._logpost_flat(x)[0] + logjac
                (grad,) = torch.autograd.grad(lp.sum(), u)
            return lp.detach(), grad

        self.lg_graph = self.pipeline.capture(value_and_grad, name='{}.logdens_grad'.format(type(self).__name__))

        def lg(u):
            self.gradient_evaluations += 1
            self.evaluated_points += u.shape[0]
            return self.lg_graph(u)
        return lg

    def initial_mass(self, u0):
        """Inverse mass guess from the Hessian of the log-density at the
        median start point: one batch of ``ndim`` copies of it evaluated with
        ``create_graph``, then one second backward of sum_i g[i, i], whose row
        i is the Hessian's row i since the chains are independent. Sets
        ``self.start_hessian`` and returns the clipped -1 / diag (ndim,)."""
        u_med = torch.quantile(u0, 0.5, dim=0)
        with torch.enable_grad():
            u = u_med.expand(self.ndim, self.ndim).clone().requires_grad_(True)
            x, logjac = self._constrain(u)
            lp = self.logpost_flat(x)[0] + logjac
            (grad,) = torch.autograd.grad(lp.sum(), u, create_graph=True)
            (hessian,) = torch.autograd.grad(torch.diagonal(grad).sum(), u)
        self.start_hessian = hessian
        hdiag = torch.diagonal(hessian)
        mass = torch.where(hdiag < -1e-12, -1. / hdiag, torch.ones_like(hdiag))
        return torch.clamp(mass, 1e-12, 1e12)

    def _start(self):
        """Start points (unconstrained, float32 on the device; this rank's
        rows with a mesh) and the initial inverse mass (from all of them)."""
        x0, _ = self.get_start(self.nchains)
        u0 = torch.as_tensor(self._unconstrain(x0.cpu().numpy().astype('f8')), dtype=torch.float32,
                             device=self.device)
        mass = self.initial_mass(u0)
        return self._shard_chains(u0), mass

    def _make_kernel(self, lg):
        return build_nuts_kernel(lg, self.ndim, max_depth=self.max_depth)

    def _count(self, stats):
        self.diagnostics['leaves'] = self.diagnostics.get('leaves', 0) + stats['leaves']
        self.diagnostics['host_reads'] = self.diagnostics.get('host_reads', 0) + stats['host_reads']
        self.diagnostics['iterations'] = self.diagnostics.get('iterations', 0) + 1

    def _warmup_phase(self, kernel, u, lp, grad, inv_mass, eps0, n, collect_from):
        """Dual averaging of each chain's step size over ``n`` transitions,
        accumulating each chain's Welford variance from transition
        ``collect_from`` on. Returns (u, lp, grad, eps, var, count, mean leaves)."""
        mu = torch.log(10. * eps0)
        log_eps, log_eps_bar, h_bar = torch.log(eps0), torch.log(eps0), torch.zeros_like(eps0)
        mean, m2, count = torch.zeros_like(u), torch.zeros_like(u), torch.zeros_like(eps0)
        nl_sum = torch.zeros_like(eps0)
        for i in range(n):
            u, lp, grad, stats = kernel(u, lp, grad, torch.exp(log_eps), inv_mass, **self._kernel_draws(kernel))
            self._count(stats)
            log_eps, log_eps_bar, h_bar = dual_averaging_update(log_eps_bar, h_bar, stats['accept_stat'], i + 1.,
                                                                mu, self.target_accept)
            if i >= collect_from:
                mean, m2, count = welford_update(mean, m2, count, u)
            nl_sum = nl_sum + stats['n_leaves']
        var = m2 / torch.clamp(count - 1., min=1.)[:, None]
        return u, lp, grad, torch.exp(log_eps_bar), var, count, nl_sum / max(n, 1)

    def _warmup(self, kernel, u0, mass0, nwarmup):
        """The two-phase warmup of every chain; returns (u, lp, grad, eps,
        inv_mass, mean leaves of phase 2)."""
        lp, grad = kernel.lg(u0)
        nw1 = nwarmup // 2
        nw2 = nwarmup - nw1
        mass0 = mass0.expand(u0.shape[0], self.ndim)
        eps0 = torch.full_like(lp, 0.1)
        # phase 1: adapt eps under the curvature mass guess, collect the variance
        u, lp, grad, eps1, var, count, _ = self._warmup_phase(kernel, u0, lp, grad, mass0, eps0, nw1, nw1 // 3)
        inv_mass = torch.where(count[:, None] > 10, torch.clamp(var, min=1e-10), mass0)
        # phase 2: re-adapt eps under the learned mass; its mean leaves set the jitter path length
        u, lp, grad, eps, _, _, nleap = self._warmup_phase(kernel, u, lp, grad, inv_mass, eps1, nw2, nw2 + 1)
        if self.pool_adaptation:
            # the median step size and mean mass over chains: robust to outlier
            # chains and fewer lockstep leaves
            eps = torch.full_like(eps, float(torch.quantile(self._all_chains(eps), 0.5)))
            inv_mass = self._all_chains(inv_mass).mean(0).expand(inv_mass.shape)
        return u, lp, grad, eps, inv_mass, nleap

    def _kernel_draws(self, kernel):
        """The kernel's draws for the whole batch, this rank's rows kept."""
        return self._shard_chains(kernel.draws(self, self.nchains))

    def _record(self, u):
        """The constrained point and the log-posterior and aux there, as the records keep them."""
        x, _ = self._constrain(u)
        lp_x, aux = self.logpost_batch(x)
        return x, lp_x, aux

    def _jitter_sample(self, lg, u, lp, grad, eps, inv_mass, L_ref, nsteps):
        """Dense fixed-budget sampling for trajectory='jitter': every chain
        takes the same halton-jittered number of leapfrog steps an iteration
        (mean: the warmup's NUTS path length). Returns the final (u, lp,
        grad) and the time-major records."""
        nchains = self.nchains
        max_steps = int(np.clip(4 * L_ref, 4, 2 ** self.max_depth))
        hs = np.array([halton(i + 1) for i in range(nsteps)], dtype='f4')
        counts = np.clip(np.ceil(np.float32(2. * L_ref) * hs), 1, max_steps).astype(int)
        eps_c = _column(eps, u)
        # When aux holds nothing beyond loglikelihood and logprior, the record
        # needs no pipeline call (reference nuts.py:281-342): lp_x = lp_u -
        # log|Jacobian|, the log prior is the elementwise prior sum, and
        # loglikelihood = lp_x - logprior. One call of one chain reads the keys.
        aux_keys = set(self.logpost_batch(self._constrain(u[:1])[0])[1])
        cheap_aux = aux_keys <= {'loglikelihood', 'logprior'}
        records = []
        for nstep in counts:
            r0 = self._shard_chains(self.normal(nchains, self.ndim)) / torch.sqrt(inv_mass)
            u1, grad1, r1 = u, grad, r0
            for _ in range(nstep):
                r_half = r1 + 0.5 * eps_c * grad1
                u1 = u1 + eps_c * inv_mass * r_half
                lp1, grad1 = lg(u1)
                r1 = r_half + 0.5 * eps_c * grad1
            delta = (-lp + _kinetic(r0, inv_mass)) - (-lp1 + _kinetic(r1, inv_mass))
            delta = torch.where(torch.isnan(delta), torch.full_like(delta, -np.inf), delta)
            accept = torch.log(self._shard_chains(self.uniform(nchains))) < delta
            u, lp, grad = _where(accept, u1, u), torch.where(accept, lp1, lp), _where(accept, grad1, grad)
            if cheap_aux:
                x, logjac = self._constrain(u)
                lp_x, aux = lp - logjac, {}
                if aux_keys:
                    logprior = self.pipeline.logprior(dict(zip(self.names, x.unbind(-1))))
                    aux = {'logprior': logprior, 'loglikelihood': lp_x - logprior}
                    aux = {name: aux[name] for name in aux_keys}
            else:
                x, lp_x, aux = self._record(u)
            records.append(dict(x=x, logposterior=lp_x, divergence=delta < -1000., **aux))
        self.diagnostics['iterations'] = self.diagnostics.get('iterations', 0) + nsteps
        return (u, lp, grad), _stack(records)

    def run(self, nsteps=1000, nwarmup=None, thin=1, resume=False):
        if nwarmup is None:
            nwarmup = max(200, nsteps // 2)
        lg = self._logdens_grad()
        kernel = self._make_kernel(lg)
        resume = resume and getattr(self, '_state', None) is not None
        if resume:
            u, lp, grad, eps, inv_mass, nleap = self._state
        else:
            u0, mass0 = self._start()
            u, lp, grad, eps, inv_mass, nleap = self._warmup(kernel, u0, mass0, nwarmup)
        self.diagnostics['step_size'] = self._all_chains(eps).cpu().numpy()

        if self.trajectory == 'jitter':
            L_ref = float(torch.quantile(self._all_chains(nleap).float(), 0.5))
            self.diagnostics['jitter_path_length'] = L_ref
            (u, lp, grad), records = self._jitter_sample(lg, u, lp, grad, eps, inv_mass, L_ref, nsteps)
            attrs = {'sampler': 'nuts-jitter', 'path_length_leapfrogs': L_ref}
        else:
            steps = []
            for _ in range(nsteps):
                u, lp, grad, stats = kernel(u, lp, grad, eps, inv_mass, **self._kernel_draws(kernel))
                self._count(stats)
                x, lp_x, aux = self._record(u)
                steps.append(dict(x=x, logposterior=lp_x, divergence=stats['diverging'], **aux))
            records = _stack(steps)
            attrs = {'sampler': 'nuts', 'step_size': [float(e) for e in self._all_chains(eps).cpu()]}
        self._state = (u, lp, grad, eps, inv_mass, nleap)
        records = {name: value[::thin] for name, value in records.items()}
        if self.mesh is not None:
            self._mesh_gelman_rubin(records['x'])
        records = self._all_chains(records, dim=1)
        records = {name: value.cpu().numpy() for name, value in records.items()}  # one copy to the host
        self.diagnostics['divergence_rate'] = float(np.mean(records.pop('divergence')))
        if self.trajectory == 'nuts':
            attrs['divergence_rate'] = self.diagnostics['divergence_rate']
        x = records.pop('x')
        return self._make_chain(x, records, attrs=attrs)


def _stack(steps):
    """A list of per-iteration record dicts -> dict of time-major tensors."""
    return {name: torch.stack([step[name] for step in steps]) for name in steps[0]} if steps else {}
