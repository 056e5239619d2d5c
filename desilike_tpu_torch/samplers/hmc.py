"""Static HMC and microcanonical Langevin (MCLMC) samplers over a batch of chains.

Counterpart of ``desilike_tpu/samplers/hmc.py`` (the reference's blackjax
bindings, samplers/hmc.py:17, mclmc.py:9), on the batched machinery of
:mod:`.nuts`. Each step takes its draws as arguments.
"""

import numpy as np
import torch

from .nuts import NUTSSampler, _column, _kinetic, _where


class HMCKernel(object):
    """One static-HMC transition of every chain with a per-chain jittered
    step count in [nleapfrog // 2, nleapfrog]: the chains leapfrog in
    lockstep up to the largest count (one host read), each stopping at its
    own. Returns (z, lp, grad, stats) like :class:`.nuts.NUTSKernel`."""

    def __init__(self, logdens_grad_fn, ndim, nleapfrog):
        self.lg = logdens_grad_fn
        self.ndim = int(ndim)
        self.nleapfrog = int(nleapfrog)

    def draws(self, sampler, nchains):
        return dict(noise=sampler.normal(nchains, self.ndim),
                    nstep=torch.randint(self.nleapfrog // 2, self.nleapfrog + 1, (nchains,),
                                        generator=sampler.generator, device=sampler.device),
                    accept_u=sampler.uniform(nchains))

    def __call__(self, z0, lp0, grad0, eps, inv_mass, noise, nstep, accept_u):
        eps_c = _column(eps, z0)
        r0 = noise / torch.sqrt(inv_mass)
        z, r, lp, grad = z0, r0, lp0, grad0
        shortest, leaves = torch.stack([nstep.min(), nstep.max()]).tolist()  # the one host read
        for i in range(leaves):
            r_half = r + 0.5 * eps_c * grad
            z_new = z + eps_c * inv_mass * r_half
            lp_new, grad_new = self.lg(z_new)
            r_new = r_half + 0.5 * eps_c * grad_new
            if i < shortest:  # every chain still moves
                z, r, lp, grad = z_new, r_new, lp_new, grad_new
            else:
                do = i < nstep
                z, r, lp, grad = _where(do, z_new, z), _where(do, r_new, r), torch.where(do, lp_new, lp), \
                    _where(do, grad_new, grad)
        h0 = -lp0 + _kinetic(r0, inv_mass)
        h1 = -lp + _kinetic(r, inv_mass)
        log_accept = torch.where(torch.isnan(h1), torch.full_like(h1, -np.inf), h0 - h1)
        accept = torch.log(accept_u) < log_accept
        stats = dict(accept_stat=torch.clamp(torch.exp(log_accept), 0., 1.), depth=torch.zeros_like(nstep),
                     diverging=torch.isnan(h1), n_leaves=nstep, leaves=leaves, host_reads=1)
        return _where(accept, z, z0), torch.where(accept, lp, lp0), _where(accept, grad, grad0), stats


class HMCSampler(NUTSSampler):
    """Static-trajectory HMC with jittered step count, dual-averaging step
    size and Welford mass adaptation (shares the NUTS warmup machinery)."""

    def __init__(self, likelihood, nleapfrog=32, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.nleapfrog = int(nleapfrog)

    def _make_kernel(self, lg):
        return HMCKernel(lg, self.ndim, self.nleapfrog)


def mclmc_velocity_update(u, g, eps, d):
    """ESH velocity map: rotate the unit velocity u (B, ndim) towards the
    normalized force g over a step ``eps`` ((B,) or scalar); d = max(ndim, 2)."""
    gnorm = torch.sqrt((g * g).sum(-1) + 1e-30)
    e = g / gnorm[..., None]
    delta = eps * gnorm / (d - 1)
    ue = (u * e).sum(-1)
    ch, sh = torch.cosh(delta), torch.sinh(delta)
    u_new = (u + e * (sh + ue * (ch - 1.))[..., None]) / (ch + ue * sh)[..., None]
    return u_new / torch.sqrt((u_new ** 2).sum(-1))[..., None]


def mclmc_step(lg, carry, noise, d):
    """One MCLMC step of every chain: half velocity, position, half velocity,
    then a partial refresh of the velocity with the standard normal
    ``noise`` (B, ndim). carry = (u, z, lp, grad, eps, L), eps and L (B,)."""
    u, z, lp, grad, eps, L = carry
    u = mclmc_velocity_update(u, grad, eps / 2., d)
    z = z + _column(eps, z) * u
    lp, grad = lg(z)
    u = mclmc_velocity_update(u, grad, eps / 2., d)
    # partial momentum refresh with rate nu = sqrt(2 eps / L (d-1))-ish
    nu = torch.sqrt(torch.expm1(2. * eps / L))
    u = u + _column(nu, u) * noise
    u = u / torch.sqrt((u ** 2).sum(-1))[..., None]
    return u, z, lp, grad, eps, L


class MCLMCSampler(NUTSSampler):
    r"""Unadjusted microcanonical Langevin Monte Carlo (Robnik & Seljak 2022,
    arXiv:2212.08549): energy-conserving dynamics on the sphere of momenta
    with partial refresh; very high ESS/gradient for smooth posteriors.

    Unadjusted: has an O(eps^2) discretization bias; use NUTS when exactness
    matters, MCLMC for speed at scale.
    """

    def __init__(self, likelihood, L=None, step_size=None, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.L = L
        self.step_size = step_size

    def run(self, nsteps=2000, nwarmup=500, thin=1, resume=False):
        ndim, nchains = self.ndim, self.nchains
        lg = self._logdens_grad()
        d = max(ndim, 2)
        resume = resume and getattr(self, '_state', None) is not None
        if resume:
            carry = self._state
        else:
            x0, _ = self.get_start(nchains)
            z = self._shard_chains(torch.as_tensor(self._unconstrain(x0.cpu().numpy().astype('f8')),
                                                   dtype=torch.float32, device=self.device))
            lp, grad = lg(z)
            u = self._shard_chains(self.normal(nchains, ndim))
            u = u / torch.sqrt((u ** 2).sum(-1))[..., None]
            eps0 = np.float32(0.2 * np.sqrt(ndim)) if self.step_size is None else self.step_size
            L0 = np.float32(float(ndim) ** 0.5) if self.L is None else self.L
            # crude warmup: run, estimate the position scale, set L ~ mean std * sqrt(d)
            carry = (u, z, lp, grad, torch.full_like(lp, float(eps0) * 0.1), torch.full_like(lp, float(L0)))
            positions = []
            for _ in range(nwarmup):
                carry = mclmc_step(lg, carry, self._shard_chains(self.normal(nchains, ndim)), d)
                positions.append(carry[1])
            scale = torch.stack(positions[nwarmup // 2:]).std(0, unbiased=False).mean(-1)
            u, z, lp, grad, _, _ = carry
            carry = (u, z, lp, grad, scale * 0.5, np.sqrt(float(ndim)) * scale)
        positions = []
        for _ in range(nsteps):
            carry = mclmc_step(lg, carry, self._shard_chains(self.normal(nchains, ndim)), d)
            positions.append(carry[1])
        self._state = carry
        zs = torch.stack(positions)[::thin]  # (nsteps, nchains, ndim)
        x, _ = self._constrain(zs)
        lps, aux = self.logpost_batch(x.reshape(-1, ndim))
        records = {name: value.reshape(zs.shape[:2] + value.shape[1:])
                   for name, value in dict(logposterior=lps, **aux).items()}
        x, records = self._all_chains((x, records), dim=1)
        return self._make_chain(x.cpu().numpy(), {name: value.cpu().numpy() for name, value in records.items()},
                                attrs={'sampler': 'mclmc'})
