"""Sampler base: batched posterior, start-point sampling, chain assembly.

Counterpart of ``desilike_tpu/samplers/base.py``. The likelihood is one
batched function over chains (``logpost_fn``: (B,) tensors in, (B,) out),
so the chains are the batch dimension of every call and the samplers step
all of them in lockstep, eagerly, on the likelihood's device. Randomness
comes from a ``torch.Generator`` seeded with ``seed`` on that device: a run
is reproducible for a fixed seed and device. The step functions take their
draws as arguments, so that a step can be fed any draws (e.g. the JAX
package's). Chains are not sharded across cards until ROADMAP A16.
"""

import numpy as np
import torch

from ..utils import BaseClass
from ..samples.chain import Chain


class Diagnostics(dict):
    """History of convergence quantities across check() calls, with
    ``stable_over`` semantics (reference samplers/base.py:671): each key
    maps to the per-check list of values; '<key>_test' tracks pass/fail
    and a criterion only counts as met once it has held for the last
    ``stable_over`` consecutive checks."""

    def add(self, key, value):
        self.setdefault(key, []).append(value)
        return value

    def is_stable(self, key, stable_over=1):
        vals = self.get(key, [])
        return len(vals) >= stable_over and all(bool(v) for v in vals[-stable_over:])

    def add_test(self, key, value, low=None, high=None, stable_over=1):
        """Record value + threshold test; returns the stable_over verdict.
        With no threshold set the quantity is recorded and passes."""
        self.add(key, value)
        if low is None and high is None:
            return True
        test = np.isfinite(value)
        if low is not None:
            test &= value > low
        if high is not None:
            test &= value < high
        self.add(key + '_test', bool(test))
        return self.is_stable(key + '_test', stable_over=stable_over)


class BasePosteriorSampler(BaseClass):
    """Common machinery: batched flat-vector posterior, reference-distribution
    starts, chain assembly, the convergence loop and its checks."""

    def __init__(self, likelihood, seed=42, max_tries=1000, save_fn=None, chains=None, ref_scale=None):
        self.ref_scale = float(ref_scale) if ref_scale is not None else 1.
        self.likelihood = likelihood
        self.pipeline = likelihood.pipeline
        self.varied_params = self.pipeline.varied_params
        if not len(self.varied_params):
            raise ValueError('no varied parameters to sample')
        self.names = self.varied_params.names()
        self.ndim = len(self.names)
        self.save_fn = save_fn
        self.max_tries = int(max_tries)
        self.device = self.pipeline.device
        self.generator = torch.Generator(self.device).manual_seed(int(seed))
        self._logpost_aux_fn = None
        self.evaluated_points = 0  # the points evaluated through logpost_flat
        self._resume_chain = chains if isinstance(chains, Chain) else (Chain.load(chains) if chains else None)
        self.diagnostics = {}
        self.diagnostics_history = Diagnostics()

    def normal(self, *shape):
        """Standard normal draws of ``shape`` from the sampler's generator."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    def uniform(self, *shape):
        """Uniform [0, 1) draws of ``shape`` from the sampler's generator."""
        return torch.rand(shape, generator=self.generator, device=self.device)

    # --- flat-vector posterior ---

    @property
    def _logpost_aux(self):
        if self._logpost_aux_fn is None:
            self._logpost_aux_fn = self.likelihood.logpost_fn()
        return self._logpost_aux_fn

    def logpost_flat(self, thetas):
        """thetas (B, ndim) -> ((B,) logposterior with NaN read as -inf, aux
        dict of (B,) values and, for solved parameters, their best fits and
        'solved_hessian' (B, n, n))."""
        self.evaluated_points += thetas.shape[0]
        lp, aux = self._logpost_aux(dict(zip(self.names, thetas.unbind(-1))))
        lp = torch.where(torch.isnan(lp), torch.full_like(lp, -np.inf), lp)
        keep = {name: aux[name] for name in ('loglikelihood', 'logprior') if name in aux}
        for name, val in aux.items():
            if name in ('loglikelihood', 'logprior', 'solved', 'solved_hessian', 'solved_info'):
                continue
            if isinstance(val, torch.Tensor) and val.shape == lp.shape:
                keep[name] = val
        for sname, sval in aux.get('solved', {}).items():
            keep[sname] = sval
        if 'solved_hessian' in aux:
            hessian = aux['solved_hessian']
            keep['solved_hessian'] = hessian.expand(lp.shape + hessian.shape[-2:])
        return lp, keep

    def logpost_batch(self, thetas):
        """(n, ndim) -> ((n,), aux), with no autograd."""
        with torch.no_grad():
            return self.logpost_flat(thetas)

    # --- start points ---

    def get_start(self, nchains):
        """Rejection-sample start points from the parameters' reference
        distributions until the posterior is finite (reference
        samplers/base.py:274-323): one batched evaluation a try, of the
        chains still without one. Returns ((nchains, ndim), (nchains,))
        tensors on the sampler's device."""
        start = torch.empty((nchains, self.ndim), device=self.device)
        logpost = torch.full((nchains,), -np.inf, device=self.device)
        todo = np.ones(nchains, dtype=bool)
        for _ in range(self.max_tries):
            if not todo.any():
                break
            n = int(todo.sum())
            draws = []
            for p in self.varied_params:
                d = p.sample_ref(self.generator, (n,), device=self.device)
                if self.ref_scale != 1.:
                    # widen the reference distribution about the param value
                    # (reference base.py:113 ref.affine_transform(scale=...))
                    d = p.value + self.ref_scale * (d - p.value)
                    lims = p.prior.limits if p.prior is not None else (-np.inf, np.inf)
                    if np.isfinite(lims).any():
                        d = d.clamp(lims[0], lims[1])
                draws.append(d)
            draws = torch.stack(draws, dim=-1)
            lps = self.logpost_batch(draws)[0]
            good = torch.isfinite(lps)
            idx = np.flatnonzero(todo)[good.cpu().numpy()]
            start[torch.as_tensor(idx, device=self.device)] = draws[good]
            logpost[torch.as_tensor(idx, device=self.device)] = lps[good]
            todo[idx] = False
        if todo.any():
            raise ValueError('could not find finite posterior start points in {} tries'.format(self.max_tries))
        return start, logpost

    # --- chain assembly ---

    def _make_chain(self, positions, records, attrs=None):
        """positions: (nsteps, nchains, ndim); records: dict name -> (nsteps,
        nchains[, ...]); numpy or tensors, copied to the host here."""
        chain = Chain()
        positions = _numpy(positions)
        for i, p in enumerate(self.varied_params):
            chain[p] = positions[..., i]
        for name, val in records.items():
            val = _numpy(val)
            if name == 'solved_hessian':
                chain.attrs['solved_hessian'] = val.reshape(-1, val.shape[-2], val.shape[-1])
                continue
            param = self.pipeline.params.get(name)
            if param is not None:
                chain[param] = val
            else:
                chain[name] = val
        solved_names = self.pipeline.solved_params.names()
        if solved_names:
            chain.attrs['solved_names'] = solved_names
        chain.attrs.update(attrs or {})
        if self._resume_chain is not None:
            chain = Chain.concatenate([self._resume_chain, chain], axis=0)
        if self.save_fn:
            chain.save(self.save_fn)
        return chain

    def sample(self, max_iterations=10000, check_every=500, min_iterations=1000,
               max_gr=1.05, min_ess=200, thin=1, check=None, **run_kwargs):
        """Batch loop with convergence checking (reference
        BaseBatchPosteriorSampler.run, samplers/base.py:409): run
        ``check_every`` steps at a time, concatenating chains, until
        the check() suite converges or max_iterations is reached. ``check``
        forwards extra criteria (max_geweke, max_cl_gr, max_dact,
        stable_over, ...) to :meth:`check`."""
        chain = None
        done = 0
        check = dict(check or {})
        while done < max_iterations:
            n = min(check_every, max_iterations - done)
            new = self.run(nsteps=n, thin=thin, resume=done > 0, **run_kwargs)
            chain = new if chain is None else type(new).concatenate([chain, new], axis=0)
            done += n
            if done >= min_iterations and self.check(chain, max_gr=max_gr, min_ess=min_ess, **check):
                break
        if self.save_fn:
            chain.save(self.save_fn)
        return chain

    def check(self, chain, params=None, max_gr=1.03, min_ess=100, burnin=0.5,
              nsplits=2, stable_over=1, max_eigen_gr=None, max_cl_gr=None,
              nsigmas_cl=1., max_geweke=None, min_geweke_pvalue=None,
              max_dact=None):
        """Convergence check suite (reference samplers/base.py:504-726), on
        the host, as ``desilike_tpu``'s.

        Always run: split-chain diagonal Gelman-Rubin (< ``max_gr``) and
        min ESS over params (> ``min_ess``). Opt-in (set the threshold):
        ``max_eigen_gr`` (multivariate GR), ``max_cl_gr`` (GR of the
        ``nsigmas_cl``-sigma interval edges), ``max_geweke`` (max |Geweke z|,
        corrected by sqrt(IAT)), ``min_geweke_pvalue`` (normality p-value of
        the z-scores), ``max_dact`` (relative change of the integrated
        autocorrelation time since the previous check). Every quantity and
        its pass/fail is appended to ``self.diagnostics_history``; with
        ``stable_over=n`` each criterion must hold for the last ``n``
        checks. Returns the combined bool."""
        from ..samples import diagnostics as diag
        params = params or self.names
        D = self.diagnostics_history
        burned = chain.remove_burnin(burnin)
        # (nchains * nsplits, nsub, ndim) split-chain stack
        arr = np.stack([np.asarray(burned[p], dtype='f8') for p in params], axis=-1)
        if arr.ndim == 2:
            arr = arr[:, None]
        pc = np.moveaxis(arr, 0, 1)              # (nchains, nsteps, ndim)
        nsub = pc.shape[1] // nsplits
        splits = np.concatenate([pc[:, i * nsub:(i + 1) * nsub] for i in range(nsplits)], axis=0)

        ok = True
        gr = np.asarray(diag.gelman_rubin(splits, method='diag'))
        self.diagnostics['gelman_rubin'] = gr
        ok &= D.add_test('diag_gr', float(gr.max()), high=max_gr, stable_over=stable_over)
        if max_eigen_gr is not None:
            try:
                egr = float(diag.gelman_rubin(splits, method='eigen'))
            except np.linalg.LinAlgError:
                egr = np.nan
            ok &= D.add_test('eigen_gr', egr, high=max_eigen_gr, stable_over=stable_over)
        if max_cl_gr is not None:
            from scipy import stats as sps
            qs = sps.norm.cdf([-nsigmas_cl, nsigmas_cl])
            cl_gr = max(
                float(np.max(diag.gelman_rubin_statistic(
                    splits, lambda c, q=q: np.quantile(c, q, axis=0)))) for q in qs)
            ok &= D.add_test('cl_gr', cl_gr, high=max_cl_gr, stable_over=stable_over)
        iact = np.array([diag.integrated_autocorrelation_time(pc[..., i])
                         for i in range(pc.shape[-1])])
        D.add('iact', iact)
        # Geweke z-scores use an iid standard error; correct by sqrt(IAT) so
        # converged-but-autocorrelated chains read ~N(0, 1)
        zscores = np.concatenate([
            np.atleast_1d(diag.geweke(pc[..., i], first=0.1, last=0.5))
            / np.sqrt(max(float(iact[i]), 1.)) for i in range(pc.shape[-1])])
        self.diagnostics['geweke'] = float(np.max(np.abs(zscores)))
        if max_geweke is not None:
            ok &= D.add_test('geweke', self.diagnostics['geweke'],
                             high=max_geweke, stable_over=stable_over)
        if min_geweke_pvalue is not None:
            ok &= D.add_test('geweke_pvalue', diag.geweke_pvalue(zscores),
                             low=min_geweke_pvalue, stable_over=stable_over)
        ess = float(pc.shape[0] * pc.shape[1] / max(float(iact.max()), 1.))
        self.diagnostics['ess'] = ess
        ok &= D.add_test('ess', ess, low=min_ess, stable_over=stable_over)
        if max_dact is not None:
            hist = D['iact']
            dact = (float(np.max(np.abs(hist[-2] / iact - 1.)))
                    if len(hist) >= 2 else np.inf)
            ok &= D.add_test('dact', dact, high=max_dact, stable_over=stable_over)
        converged = bool(ok)
        self.diagnostics['converged'] = converged
        return converged


def _numpy(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
