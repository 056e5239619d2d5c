"""Adaptive random-walk Metropolis over a batch of chains.

Counterpart of ``desilike_tpu/samplers/mcmc.py``. ``MCMCSampler`` steps
every chain in lockstep through one batched posterior call a step, with an
adapted full-covariance Gaussian proposal: a Robbins-Monro global scale
targeting 23.4% acceptance and a covariance pooled over all chains
(Welford), refreshed every adaptation step with no host read.

``BlockedMCMCSampler`` is for pipelines that hold a host-evaluated node
(``_host_eval``): it cycles per-block Metropolis updates (the slow block,
whose footprint touches the host node, once; the fast block oversampled),
and the pipeline's footprint memo skips the host code on fast moves
(reference base.py:737-857, mcmc.py:408-424). Its chains move in lockstep,
one batched evaluation a block move: with more than one chain, each block's
scale adapts on the sum of the chains' acceptances of a move, where the JAX
package updates it chain by chain (ROADMAP "Known deviations").
"""

import numpy as np
import torch

from .base import BasePosteriorSampler
from .nuts import _where

TARGET_ACCEPT = 0.234


def _select_aux(mask, new, old):
    return {name: _where(mask, new[name], old[name]) for name in new}


def _stack_records(records):
    return {name: torch.stack([record[name] for record in records]) for name in records[0]}


def _default_scales(params):
    return np.array([p.proposal if p.proposal else
                     (p.prior.std if p.prior is not None and np.isfinite(p.prior.std) else 1.) for p in params])


class MCMCSampler(BasePosteriorSampler):
    """Random-walk Metropolis with the chains as a batch and a learned
    full-covariance proposal (Haario-style adaptive Metropolis).

    Parameters
    ----------
    nchains : int, default=8
    proposal : (ndim, ndim) covariance or None
        Initial proposal covariance; defaults to diag(param.proposal^2).
    adapt : bool or str, default=True
        True/'cov': learn scale + full covariance; 'scale': global scale
        only; False: fixed proposal.
    """

    def __init__(self, likelihood, nchains=8, proposal=None, adapt=True, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.nchains = int(nchains)
        if proposal is None:
            proposal = np.diag(_default_scales(self.varied_params) ** 2)
        proposal = np.atleast_2d(np.asarray(proposal, dtype='f8'))
        self._chol = np.linalg.cholesky(proposal) * 2.38 / np.sqrt(self.ndim)
        if adapt is True:
            adapt = 'cov'
        self.adapt = adapt if adapt in ('cov', 'scale') else False

    def _metropolis(self, x, lp, aux, logscale, L, z, u):
        """One Metropolis move of every chain: z (B, ndim) standard normal,
        u (B,) uniform. Returns (x, lp, aux, accept)."""
        prop = x + torch.exp(logscale) * z @ L.T
        lp_y, aux_y = self.logpost_batch(prop)
        accept = torch.log(u) < (lp_y - lp)
        return _where(accept, prop, x), torch.where(accept, lp_y, lp), _select_aux(accept, aux_y, aux), accept

    def _build_step(self, nadapt):
        """step(state, z, u, adapting) -> (state, record), state = (x, lp, aux,
        logscale, L, wmean, wm2, count, istep) with logscale, count and istep
        0-dim tensors. While ``adapting``: the Robbins-Monro scale update,
        the pooled Welford update of the batch (from step nadapt // 3 on),
        and, with ``adapt='cov'``, the regularised Cholesky of the pooled
        covariance, kept where it factors (``cholesky_ex``, no host read).
        With a mesh, the acceptance and the moments are those of the whole
        batch, gathered from every rank."""
        ndim, nchains = self.ndim, self.nchains
        learn_cov = self.adapt == 'cov'
        min_count = max(8 * ndim, 2 * nchains)
        collect_from = nadapt // 3  # early states are ref-distribution sticky

        def step(state, z, u, adapting):
            x, lp, aux, logscale, L, wmean, wm2, count, istep = state
            x, lp, aux, accept = self._metropolis(x, lp, aux, logscale, L, z, u)
            record = {'x': x, 'logposterior': lp, 'accept': accept, **aux}
            if not adapting:
                return (x, lp, aux, logscale, L, wmean, wm2, count, istep), record
            gamma = 1. / torch.sqrt(1. + istep)
            logscale = logscale + gamma * (self._all_chains(accept).to(x.dtype).mean() - TARGET_ACCEPT)
            collect = istep >= collect_from
            x_all = self._all_chains(x)
            mean_b = x_all.mean(0)
            d_b = x_all - mean_b
            m2_b = d_b.T @ d_b
            delta = mean_b - wmean
            count_new = count + torch.where(collect, float(nchains), 0.)
            safe = torch.clamp(count_new, min=1.)
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            wmean = wmean + torch.where(collect, delta * (nchains / safe), zero)
            wm2 = wm2 + torch.where(collect, m2_b + torch.outer(delta, delta) * (count * nchains / safe), zero)
            if learn_cov:
                cov = wm2 / torch.clamp(count_new - 1., min=1.)
                cov = cov + 1e-8 * torch.trace(cov) / ndim * torch.eye(ndim, dtype=cov.dtype, device=cov.device)
                Lnew, info = torch.linalg.cholesky_ex(cov)
                Lnew = Lnew * (2.38 / np.sqrt(ndim))
                ok = (count_new > min_count) & (info == 0) & torch.isfinite(Lnew).all()
                L = torch.where(ok, Lnew, L)
            return (x, lp, aux, logscale, L, wmean, wm2, count_new, istep + 1.), record

        return step

    def run(self, nsteps=2000, thin=1, burnin=0, nadapt=None, resume=False):
        resume = resume and getattr(self, '_state', None) is not None
        if nadapt is None:
            nadapt = 0 if resume else (nsteps // 2 if self.adapt else 0)
        nadapt = min(int(nadapt), nsteps)
        if resume:
            start, lp0, aux0, logscale0, L0 = self._state
        else:
            start, lp0 = self._shard_chains(*self.get_start(self.nchains))
            _, aux0 = self.logpost_batch(start)
            logscale0 = torch.zeros((), device=self.device)
            L0 = torch.as_tensor(self._chol, dtype=start.dtype, device=self.device)
        zero = torch.zeros((), dtype=start.dtype, device=self.device)
        state = (start, lp0, aux0, logscale0, L0, torch.zeros(self.ndim, dtype=start.dtype, device=self.device),
                 torch.zeros((self.ndim, self.ndim), dtype=start.dtype, device=self.device), zero, zero)
        step = self._build_step(nadapt)
        records = []
        with torch.no_grad():
            for istep in range(nsteps):
                z, u = self._shard_chains(self.normal(self.nchains, self.ndim), self.uniform(self.nchains))
                state, record = step(state, z, u, istep < nadapt and bool(self.adapt))
                records.append(record)
        x_f, lp_f, aux_f, logscale_f, L_f = state[:5]
        self._state = (x_f, lp_f, aux_f, logscale_f, L_f)
        records = _stack_records(records)
        if self.mesh is not None:
            self._mesh_gelman_rubin(records['x'])
        records = self._all_chains(records, dim=1)
        accept = records.pop('accept')
        self.diagnostics['acceptance_rate'] = float(accept.float().mean())
        self.diagnostics['proposal_scale'] = float(torch.exp(logscale_f))
        self.diagnostics['iterations'] = self.diagnostics.get('iterations', 0) + nsteps
        self.diagnostics['host_reads'] = self.diagnostics.get('host_reads', 0) + 3  # acceptance, scale, records
        x = records.pop('x')
        sl = slice(burnin, None, thin)
        return self._make_chain(x[sl], {k: v[sl] for k, v in records.items()},
                                attrs={'sampler': 'mcmc', 'acceptance_rate': self.diagnostics['acceptance_rate']})


class BlockedMCMCSampler(BasePosteriorSampler):
    """Blocked Metropolis for pipelines that hold host-evaluated nodes.

    Parameters are grouped by ``Pipeline.block_params`` (the slow block
    touches a ``_host_eval`` calculator, the fast block does not) and
    updated block by block, the fast block oversampled; the pipeline's memo
    then skips the host code on fast moves. Per-block Robbins-Monro scales
    target 23.4% acceptance, and a per-block covariance learned from the
    chains' history replaces the diagonal proposal every 25 iterations.

    With ``drag=n > 0`` (and a slow + fast split), slow-block moves use Neal
    (2004) fast-parameter dragging (reference mcmc.py:408-424): the fast
    parameters take ``n`` Metropolis steps against the density interpolated
    between the slow start and end points, and the whole trajectory is
    accepted as one move; the host code still runs once a slow proposal.

    The draws come from a numpy generator seeded from the sampler's
    generator, in the JAX package's order (with one chain, the same draws
    as there for the same numpy seed). The chains' state, proposals and
    scales are float64 on the device, as the JAX package keeps them in
    float64 on the host, and each point is evaluated in float32: with a
    float32 state, the log-posterior of a one-chain run moved by 4e-5 of
    its magnitude from the JAX package's (tests/test_torch_mcmc.py).
    """

    def __init__(self, likelihood, nchains=1, oversample_power=0.4, adapt=True, drag=0, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.nchains = int(nchains)
        self.oversample_power = float(oversample_power)
        self.adapt = bool(adapt)
        self.drag = int(drag)
        self.blocks = self.pipeline.block_params(oversample_power=self.oversample_power)
        names = self.varied_params.names()
        self._block_idx = [(np.array([names.index(n) for n in block]), repeat) for block, repeat in self.blocks]
        if self.drag and len(self._block_idx) != 2:
            raise ValueError('dragging needs exactly one slow + one fast block '
                             '(got {} blocks)'.format(len(self._block_idx)))

    @property
    def _logpost_aux(self):
        # host nodes cannot be captured (desilike_tpu/samplers/mcmc.py:211): evaluate the pipeline eagerly
        if self._logpost_aux_fn is None:
            self._logpost_aux_fn = self.likelihood.logpost_fn(jit=False)
        return self._logpost_aux_fn

    def _rng(self):
        """The numpy generator of a run, seeded from the sampler's generator."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator, device=self.device))
        return np.random.default_rng(seed)

    def _lp(self, x):
        return self.logpost_batch(x.float())[0].double()

    def _jump(self, rng, iblock, logscale, chols):
        """The proposal's step in block ``iblock``: (nchains, block size)."""
        idx, _ = self._block_idx[iblock]
        z = torch.as_tensor(rng.standard_normal((self.nchains, idx.size)), dtype=torch.float64, device=self.device)
        return torch.exp(logscale[iblock]) * (z @ chols[iblock].T) * (2.38 / np.sqrt(idx.size))

    def _uniform(self, rng):
        return torch.as_tensor(rng.uniform(size=self.nchains), dtype=torch.float64, device=self.device)

    @staticmethod
    def _adapt_scale(logscale, iblock, accept, it):
        """Robbins-Monro update of one block's scale on the chains' acceptances."""
        gamma = 1. / np.sqrt(1. + it)
        logscale[iblock] = logscale[iblock] + gamma * (accept.to(logscale.dtype) - TARGET_ACCEPT).sum()

    def _block_step(self, iblock, x, lp, rng, logscale, chols, adapting, it):
        """One Metropolis update of block ``iblock`` of every chain; returns (x, lp, accept)."""
        idx, _ = self._block_idx[iblock]
        idx_t = torch.as_tensor(idx, device=self.device)
        prop = x.clone()
        prop[:, idx_t] = prop[:, idx_t] + self._jump(rng, iblock, logscale, chols)
        lp_y = self._lp(prop)
        accept = torch.log(self._uniform(rng)) < (lp_y - lp)
        if adapting:
            self._adapt_scale(logscale, iblock, accept, it)
        return _where(accept, prop, x), torch.where(accept, lp_y, lp), accept

    def _drag_step(self, x, lp, rng, logscale, chols, adapting, it):
        """Neal (2004) dragged slow-block move of every chain: propose the
        slow block, take ``self.drag`` fast Metropolis steps against the
        interpolated density, accept the whole trajectory with
        log A = (1/n) sum_i [logP(y_slow, f_i) - logP(x_slow, f_i)]."""
        (idx_s, _), (idx_f, _) = self._block_idx
        idx_s, idx_f = (torch.as_tensor(i, device=self.device) for i in (idx_s, idx_f))
        n = self.drag
        xs_end = x.clone()
        xs_end[:, idx_s] = xs_end[:, idx_s] + self._jump(rng, 0, logscale, chols)
        lp0_f = lp                      # logP(x_slow, f_0)
        lp1_f = self._lp(xs_end)        # logP(y_slow, f_0): the one new host call
        f = x[:, idx_f].clone()
        drag_sum = torch.zeros_like(lp)
        for i in range(1, n + 1):
            drag_sum = drag_sum + (lp1_f - lp0_f)   # at f_{i-1}
            lam = i / n
            f_prop = f + self._jump(rng, 1, logscale, chols)
            a, b = x.clone(), xs_end.clone()
            a[:, idx_f] = f_prop                   # (x_slow, f')
            b[:, idx_f] = f_prop                   # (y_slow, f')
            lp0_p, lp1_p = self._lp(a), self._lp(b)  # both host-memoized on their slow footprint
            d_interp = ((1. - lam) * lp0_p + lam * lp1_p) - ((1. - lam) * lp0_f + lam * lp1_f)
            move = torch.log(self._uniform(rng)) < d_interp
            f, lp0_f, lp1_f = _where(move, f_prop, f), torch.where(move, lp0_p, lp0_f), torch.where(move, lp1_p, lp1_f)
        accept = torch.log(self._uniform(rng)) < drag_sum / n
        end = xs_end.clone()
        end[:, idx_f] = f
        if adapting:
            self._adapt_scale(logscale, 0, accept, it)
        return _where(accept, end, x), torch.where(accept, lp1_f, lp), accept

    def _sweep(self, x, lp, rng, logscale, chols, adapting, it):
        """One iteration: every block's moves of every chain. Returns (x, lp,
        accepted moves (nchains,), moves)."""
        naccept, nmoves = torch.zeros_like(lp), 0
        if self.drag:
            x, lp, acc = self._drag_step(x, lp, rng, logscale, chols, adapting, it)
            naccept, nmoves = naccept + acc, nmoves + 1
            for _ in range(self._block_idx[1][1]):  # the fast block's own oversampled updates
                x, lp, acc = self._block_step(1, x, lp, rng, logscale, chols, adapting, it)
                naccept, nmoves = naccept + acc, nmoves + 1
        else:
            for iblock, (_, repeat) in enumerate(self._block_idx):
                for _ in range(repeat):
                    x, lp, acc = self._block_step(iblock, x, lp, rng, logscale, chols, adapting, it)
                    naccept, nmoves = naccept + acc, nmoves + 1
        return x, lp, naccept, nmoves

    def _learn_covariance(self, hist, chols):
        """Per-block covariance of the history's last two thirds (Haario
        regularised), kept where its Cholesky factor exists."""
        h = torch.cat(hist[len(hist) // 3:], dim=0)
        for iblock, (idx, _) in enumerate(self._block_idx):
            if h.shape[0] > max(20, 2 * idx.size):
                sub = h[:, torch.as_tensor(idx, device=self.device)]
                cov = torch.atleast_2d(torch.cov(sub.T))
                cov = cov + 1e-8 * torch.trace(cov) / idx.size * torch.eye(idx.size, dtype=cov.dtype,
                                                                            device=cov.device)
                Lnew, info = torch.linalg.cholesky_ex(cov)
                chols[iblock] = torch.where(info == 0, Lnew, chols[iblock])

    def run(self, nsteps=500, thin=1, burnin=0, resume=False):
        rng = self._rng()
        scales = _default_scales(self.varied_params)
        reads0 = self.pipeline.host_reads
        with torch.no_grad():
            if resume and getattr(self, '_state', None) is not None:
                xs, lps, logscale, chols, hist = self._state
            else:
                xs, lps = (v.double() for v in self.get_start(self.nchains))
                logscale = torch.zeros(len(self._block_idx), dtype=torch.float64, device=self.device)
                chols = [torch.as_tensor(np.diag(scales[idx]), dtype=torch.float64, device=self.device)
                         for idx, _ in self._block_idx]
                hist = []
            records_x, records_lp = [], []
            naccept, nmoves = torch.zeros_like(lps), 0
            for it in range(nsteps):
                adapting = self.adapt and it < nsteps // 2 and not resume
                xs, lps, acc, moves = self._sweep(xs, lps, rng, logscale, chols, adapting, it)
                naccept, nmoves = naccept + acc, nmoves + moves
                records_x.append(xs)
                records_lp.append(lps)
                hist.append(xs)
                if adapting and it % 25 == 24:
                    self._learn_covariance(hist, chols)
        self._state = (xs, lps, logscale, chols, hist)
        self.diagnostics['acceptance_rate'] = float(naccept.sum()) / max(nmoves * self.nchains, 1)
        self.diagnostics['iterations'] = self.diagnostics.get('iterations', 0) + nsteps
        # the pipeline's footprint reads (one a call) and the acceptance and records at the end
        self.diagnostics['host_reads'] = (self.diagnostics.get('host_reads', 0) + 2
                                          + self.pipeline.host_reads - reads0)
        sl = slice(burnin, None, thin)
        return self._make_chain(torch.stack(records_x)[sl], {'logposterior': torch.stack(records_lp)[sl]},
                                attrs={'sampler': 'blocked-mcmc', 'blocks': [list(b) for b, _ in self.blocks],
                                       'acceptance_rate': self.diagnostics['acceptance_rate']})
