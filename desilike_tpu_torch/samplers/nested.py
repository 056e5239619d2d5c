"""Nested sampler: evidence and posterior with batched live-point replacement.

Counterpart of ``desilike_tpu/samplers/nested.py`` (in place of the
reference's dynesty, polychord, nautilus and pocomc bindings):

- live points live in the unit cube; the prior transform
  (``Prior.ppf_torch``) runs on the device;
- each batch step deletes the ``nbatch`` worst points at once (argsort,
  gather, ``index_copy_``) and regenerates all of them together by
  ``num_slices`` random-direction slice updates (Neal 2003 shrinkage from an
  interval covering the cube), each a lockstep loop over the K points with
  per-point masks, one batched evaluation of the K points an iteration, at
  most 32 iterations;
- the shrinkage bookkeeping, the evidence and the dlogz stopping rule
  follow Skilling (2006) on the host, numpy, one read a batch step;
- with a mesh, every rank holds the whole live set, evaluates its rows of
  the initial points and regenerates its rows of the K replacements, and
  the results are gathered, so the deletion of the worst points is over
  the whole live set on every rank.

Results are a weighted Chain with ``logweight`` and ``aweight`` columns and
``logz``/``logzerr`` in ``chain.attrs``, as the JAX package's.
"""

import numpy as np
import torch

from .base import BasePosteriorSampler
from .deterministic import CHUNK

SLICE_ITERATIONS = 32  # the bound on one slice update's shrink iterations


def slice_update(nsloglike, u0, L0, Lmin, direction, shrink, width, read_done=True):
    """One random-direction slice update of K points in the unit cube,
    constrained to L > Lmin (K,) or a scalar: the initial bracket
    [-width, width] along ``direction`` (K, ndim, unit rows) covers the cube,
    and shrinks toward the start point on rejection; ``shrink`` (n, K)
    holds one uniform an iteration. Each iteration evaluates the K points in
    one batched call; points outside the cube read -inf. With ``read_done``
    the loop ends when every point has moved (one host read an iteration),
    else it runs all n iterations masked. Returns (u, L, ncall (K,), reads)."""
    K = u0.shape[0]
    left = torch.full((K,), -width, dtype=u0.dtype, device=u0.device)
    right = torch.full((K,), width, dtype=u0.dtype, device=u0.device)
    done = torch.zeros(K, dtype=torch.bool, device=u0.device)
    ncall = torch.zeros(K, dtype=torch.int64, device=u0.device)
    u_cur, L_cur, reads = u0, L0, 0
    for i in range(shrink.shape[0]):
        if read_done:
            reads += 1
            if bool(done.all()):
                break
        active = ~done
        t = torch.maximum(left, shrink[i] * (right - left) + left)
        u_new = u0 + t[:, None] * direction
        inside = ((u_new >= 0.) & (u_new <= 1.)).all(-1)
        L_new = torch.where(inside, nsloglike(u_new), torch.full_like(t, -np.inf))
        accept = active & (L_new > Lmin)
        reject = active & ~accept
        left = torch.where(reject & (t < 0.), t, left)
        right = torch.where(reject & (t >= 0.), t, right)
        u_cur = torch.where(accept[:, None], u_new, u_cur)
        L_cur = torch.where(accept, L_new, L_cur)
        done = done | accept
        ncall = ncall + active
    return u_cur, L_cur, ncall, reads


class NestedSampler(BasePosteriorSampler):
    """Static nested sampling with batched live-point replacement.

    Parameters
    ----------
    likelihood : BaseLikelihood
    nlive : int, default=512
        Number of live points.
    nbatch : int, default=nlive//4
        Worst points deleted (and regenerated together) a batch step.
    num_slices : int, default=max(5, 2*ndim)
        Random-direction slice updates a replacement.

    All varied parameters must have proper priors (finite-volume support);
    the evidence is defined with respect to these priors.
    """

    read_done = True  # end a slice loop when every point has moved (PERF.md, PR 15)

    def __init__(self, likelihood, nlive=512, nbatch=None, num_slices=None, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.nlive = int(nlive)
        self.nbatch = int(nbatch) if nbatch is not None else max(1, self.nlive // 4)
        if self.nbatch >= self.nlive:
            raise ValueError('nbatch must be < nlive')
        self.num_slices = int(num_slices) if num_slices is not None else max(5, 2 * self.ndim)
        self.priors = [p.prior for p in self.varied_params]
        for p, prior in zip(self.varied_params, self.priors):
            if not (prior.is_proper and np.isfinite([prior.ppf(1e-6), prior.ppf(1. - 1e-6)]).all()):
                raise ValueError('nested sampling requires proper priors; {} has {}'.format(p.name, prior))
        self.host_reads = self.evaluations = 0

    # --- kernel pieces ---

    def _transform(self, u):
        """Unit cube (n, ndim) -> parameter space, on the device."""
        return torch.stack([prior.ppf_torch(u[:, i]) for i, prior in enumerate(self.priors)], dim=-1)

    def _nsloglike(self, u):
        """Nested-sampling likelihood of (n, ndim) points: the logposterior
        minus the varied parameters' log prior (the prior is the sampling
        measure, through the transform)."""
        theta = self._transform(torch.clamp(u, 0., 1.))
        lp = self.logpost_batch(theta)[0]
        self.evaluations += 1
        logprior = sum(prior.logpdf(theta[:, i]) for i, prior in enumerate(self.priors))
        L = lp - logprior
        return torch.where(torch.isfinite(L), L, torch.full_like(L, -np.inf))

    def batch_step(self, u_live, L_live, pick, directions, shrink):
        """Delete the K worst live points and replace each by S slice updates
        from a surviving point: pick (K,) indices into the survivors,
        directions (S, K, ndim) unit rows, shrink (S, n, K) uniforms (the
        whole batch's; with a mesh each rank updates its rows of the K
        points and the updates are gathered). Returns (u_live, L_live,
        u_dead, L_dead (ascending), ncall)."""
        K = self.nbatch
        order = torch.argsort(L_live)
        dead_idx, surv_idx = order[:K], order[K:]
        Lmin = L_live[order[K - 1]]
        starts = surv_idx[pick]
        u, L = self._shard_chains(u_live[starts], L_live[starts])
        directions, shrink = self._shard_chains(directions, dim=1), self._shard_chains(shrink, dim=2)
        ncall = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
        width = float(np.sqrt(self.ndim))
        for d, s in zip(directions, shrink):
            u, L, nc, reads = slice_update(self._nsloglike, u, L, Lmin, d, s, width, read_done=self.read_done)
            ncall, self.host_reads = ncall + nc, self.host_reads + reads
        u, L, ncall = self._all_chains((u, L, ncall))
        u_dead, L_dead = u_live[dead_idx], L_live[dead_idx]
        u_live = u_live.index_copy(0, dead_idx, u)
        L_live = L_live.index_copy(0, dead_idx, L)
        return u_live, L_live, u_dead, L_dead, ncall.sum()

    def _draws(self):
        K, S = self.nbatch, self.num_slices
        pick = torch.randint(0, self.nlive - K, (K,), generator=self.generator, device=self.device)
        d = self.normal(S, K, self.ndim)
        return pick, d / torch.linalg.norm(d, dim=-1, keepdim=True), self.uniform(S, SLICE_ITERATIONS, K)

    # --- run ---

    def run(self, dlogz=0.1, max_iterations=100000, **kwargs):
        """Run to the dlogz evidence criterion; returns a weighted Chain
        (columns ``logweight``/``aweight``; ``chain.attrs['logz'/'logzerr']``)."""
        nlive, K = self.nlive, self.nbatch
        reads0, evaluations0 = self.host_reads, self.evaluations
        with torch.no_grad():
            u_live = self.uniform(nlive, self.ndim)
            L_live = self._all_chains(self._nsloglike(self._shard_chains(u_live)))
            # host-side bookkeeping (Skilling 2006 expected shrinkage)
            dead_u, dead_L, dead_logw = [], [], []
            logX, logz, H = 0.0, -np.inf, 0.0
            ncall = int(nlive)
            shrink = np.cumsum(1.0 / (nlive - np.arange(K)))  # per-batch log-volume decrements
            it = 0
            while it * K < max_iterations:
                u_live, L_live, u_d, L_d, nc = self.batch_step(u_live, L_live, *self._draws())
                # the one read of the step: the dead points' L, the live maximum, the calls
                host = torch.cat([L_d.double(), L_live.max().double()[None], nc.double()[None]]).cpu().numpy()
                self.host_reads += 1
                L_d, Lmax = host[:K], float(host[K])
                ncall += int(host[K + 1])
                logX_j = logX - shrink                      # log X after each deletion
                logX_prev = np.concatenate([[logX], logX_j[:-1]])
                logdX = logX_prev + np.log1p(-np.exp(logX_j - logX_prev))
                logw = np.where(np.isfinite(L_d), L_d + logdX, -np.inf)
                logz_new = np.logaddexp(logz, np.logaddexp.reduce(logw))
                if np.isfinite(logz_new):
                    # incremental information (Skilling 2006 eq. 22)
                    new_term = float(np.sum(np.exp(logw - logz_new) * np.where(np.isfinite(L_d), L_d, 0.)))
                    old_term = float(np.exp(logz - logz_new) * (H + logz)) if np.isfinite(logz) else 0.
                    H = new_term + old_term - logz_new
                logz = logz_new
                dead_u.append(u_d)
                dead_L.append(L_d)
                dead_logw.append(logw)
                logX = logX - float(shrink[-1])
                it += 1
                if np.logaddexp(logz, Lmax + logX) - logz < dlogz:
                    break
            self._live = (u_live, L_live)
            # the final live set: each live point carries X / nlive of the remaining volume
            order = torch.argsort(L_live)
            u_l, L_l = u_live[order], L_live[order].double().cpu().numpy()
            self.host_reads += 1
            logw_l = np.where(np.isfinite(L_l), L_l + logX - np.log(nlive), -np.inf)
            logz = np.logaddexp(logz, np.logaddexp.reduce(logw_l))
            u_all = torch.cat(dead_u + [u_l])
        L_all = np.concatenate(dead_L + [L_l])
        logw_all = np.concatenate(dead_logw + [logw_l])
        logzerr = float(np.sqrt(max(H, 0.) / nlive)) if np.isfinite(H) else float('nan')
        self.diagnostics.update({'logz': float(logz), 'logzerr': logzerr, 'ncall': ncall, 'niterations': it,
                                 'host_reads': self.host_reads - reads0,
                                 'host_reads_per_batch_step': (self.host_reads - reads0) / max(it, 1),
                                 'evaluations': self.evaluations - evaluations0})
        return self._make_nested_chain(u_all, L_all, logw_all, float(logz), logzerr, ncall, it)

    def _make_nested_chain(self, u_all, L_all, logw_all, logz, logzerr, ncall, it):
        from ..samples.chain import Chain
        from .deterministic import _evaluate
        thetas = self._transform(torch.clamp(u_all, 0., 1.)).cpu().numpy().astype('f8')
        lp, aux = _evaluate(self, thetas, chunk=CHUNK)
        chain = Chain()
        for i, p in enumerate(self.varied_params):
            chain[p] = thetas[:, i]
        chain['logposterior'] = lp
        for name, val in aux.items():
            if name == 'solved_hessian':
                chain.attrs['solved_hessian'] = val
                continue
            param = self.pipeline.params.get(name)
            chain[param if param is not None else name] = val
        chain['logweight'] = logw_all
        with np.errstate(invalid='ignore'):
            aweight = np.exp(logw_all - np.max(logw_all[np.isfinite(logw_all)]))
        chain['aweight'] = np.where(np.isfinite(aweight), aweight, 0.)
        solved_names = self.pipeline.solved_params.names()
        if solved_names:
            chain.attrs['solved_names'] = solved_names
        chain.attrs.update({'sampler': 'nested', 'logz': logz, 'logzerr': logzerr,
                            'ncall': ncall, 'niterations': it, 'nlive': self.nlive})
        if self.save_fn:
            chain.save(self.save_fn)
        return chain

    def sample(self, dlogz=0.1, max_iterations=100000, **kwargs):
        """Nested sampling has its own stopping rule; sample() == run()."""
        return self.run(dlogz=dlogz, max_iterations=max_iterations)
