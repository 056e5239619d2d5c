"""Deterministic samplers: grid, quasi-Monte-Carlo, importance reweighting.

Counterpart of ``desilike_tpu/samplers/deterministic.py`` (the reference's
samplers/grid.py, qmc.py, importance.py). The points are evaluated on the
likelihood's device in batched calls of at most ``CHUNK`` points.
"""

import numpy as np
import torch

from .base import BasePosteriorSampler, _numpy
from ..parameters import Samples

CHUNK = 4096  # points a batched call: a 3^9 grid on config 3d fits the card in such calls


def _evaluate(sampler, points, chunk=CHUNK):
    """logposterior and aux of (n, ndim) host points, in calls of at most
    ``chunk`` points; returned as numpy."""
    lps, auxs = [], []
    for start in range(0, len(points), chunk):
        thetas = torch.as_tensor(points[start:start + chunk], dtype=torch.float32, device=sampler.device)
        lp, aux = sampler.logpost_batch(thetas)
        lps.append(_numpy(lp))
        auxs.append({name: _numpy(value) for name, value in aux.items()})
    aux = {name: np.concatenate([a[name] for a in auxs]) for name in auxs[0]} if auxs else {}
    return np.concatenate(lps), aux


def _store_aux(sampler, samples, aux):
    """The chain path's bookkeeping of solved parameters (base._make_chain):
    each point's solved best fits become columns, the posterior Hessian and
    the solved names land in attrs."""
    for name, val in aux.items():
        val = np.asarray(val)
        if name == 'solved_hessian':
            samples.attrs['solved_hessian'] = val
            continue
        if val.ndim == 1:
            param = sampler.pipeline.params.get(name)
            samples[param if param is not None else name] = val
    solved_names = sampler.pipeline.solved_params.names()
    if solved_names:
        samples.attrs['solved_names'] = solved_names


class GridSampler(BasePosteriorSampler):
    """Regular grid over the varied parameters (reference samplers/grid.py).

    size : int or dict name -> int (points per dimension)
    sigmas : grid half-width in proposal (or prior) sigmas about the value
    grid_range : dict name -> (lo, hi), overriding the default range
    """

    def __init__(self, likelihood, size=3, sigmas=3., grid_range=None, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.size = size if isinstance(size, dict) else {n: int(size) for n in self.names}
        self.sigmas = float(sigmas)
        self.grid_range = grid_range or {}

    def _axes(self):
        axes = []
        for p in self.varied_params:
            n = self.size.get(p.name, self.size.get(p.basename, 3))
            if p.name in self.grid_range:
                lo, hi = self.grid_range[p.name]
            else:
                center = p.value
                scale = p.proposal or (p.prior.std if p.prior is not None and np.isfinite(p.prior.std) else 1.)
                lo, hi = center - self.sigmas * scale, center + self.sigmas * scale
                if p.prior is not None and p.prior.is_limited:
                    lo = max(lo, p.prior.limits[0])
                    hi = min(hi, p.prior.limits[1])
            axes.append(np.linspace(lo, hi, n) if n > 1 else np.array([p.value]))
        return axes

    def run(self):
        axes = self._axes()
        mesh = np.meshgrid(*axes, indexing='ij')
        pts = np.column_stack([m.reshape(-1) for m in mesh])
        lps, aux = _evaluate(self, pts)
        samples = Samples()
        for i, p in enumerate(self.varied_params):
            samples[p] = pts[:, i]
        samples['logposterior'] = lps
        _store_aux(self, samples, aux)
        samples.attrs['grid_shape'] = tuple(len(a) for a in axes)
        return samples


def _rqrs(d, n, seed=0):
    """Roberts' R_d quasi-random sequence (reference samplers/qmc.py
    ``RQuasiRandomSequence``): x_n = frac(u0 + n * phi_d^{-(i+1)}), phi_d the
    generalized golden ratio solving x^(d+1) = x + 1."""
    phi = 2.
    for _ in range(64):
        phi = (1. + phi) ** (1. / (d + 1.))
    alpha = (1. / phi) ** (1. + np.arange(d))
    u0 = np.random.default_rng(seed).uniform(size=d)
    n = np.arange(1, int(n) + 1)[:, None]
    return (u0 + n * alpha) % 1.


class QMCSampler(BasePosteriorSampler):
    """Quasi-Monte-Carlo sampling of the reference distributions (reference
    samplers/qmc.py; engines sobol, halton, lhs, rqrs). The engine's seed
    comes from the sampler's generator."""

    def __init__(self, likelihood, engine='sobol', **kwargs):
        super().__init__(likelihood, **kwargs)
        self.engine = str(engine)

    def run(self, niterations=256, evaluate=False):
        from scipy.stats import qmc
        d = self.ndim
        seed = int(torch.randint(0, 2 ** 30, (1,), generator=self.generator, device=self.device))
        if self.engine == 'sobol':
            u = qmc.Sobol(d, seed=seed).random(int(niterations))
        elif self.engine == 'halton':
            u = qmc.Halton(d, seed=seed).random(int(niterations))
        elif self.engine == 'lhs':
            u = qmc.LatinHypercube(d, seed=seed).random(int(niterations))
        elif self.engine == 'rqrs':
            u = _rqrs(d, int(niterations), seed=seed)
        else:
            raise ValueError('unknown engine {}'.format(self.engine))
        pts = np.empty_like(u)
        for i, p in enumerate(self.varied_params):
            dist = p.ref if p.ref is not None else p.prior
            pts[:, i] = dist.ppf(u[:, i])
        samples = Samples()
        for i, p in enumerate(self.varied_params):
            samples[p] = pts[:, i]
        if evaluate:
            lps, aux = _evaluate(self, pts)
            samples['logposterior'] = lps
            _store_aux(self, samples, aux)
        return samples


class ImportanceSampler(BasePosteriorSampler):
    """Reweight an existing chain under this likelihood (reference
    samplers/importance.py): ``aweight`` *= exp(new - old logposterior)."""

    def run(self, chain, batch=CHUNK):
        pts, names = chain.points([p.name for p in self.varied_params])
        lps = _evaluate(self, np.asarray(pts), chunk=batch)[0].reshape(chain.shape)
        new = chain.copy()
        old_lp = np.asarray(chain['logposterior']) if 'logposterior' in chain else 0.
        logw = lps - old_lp
        logw = logw - np.max(logw[np.isfinite(logw)])
        aweight = np.exp(np.where(np.isfinite(logw), logw, -np.inf))
        if 'aweight' in new:
            aweight = aweight * np.asarray(new['aweight'])
        new['aweight'] = aweight
        new['logposterior'] = lps
        return new
