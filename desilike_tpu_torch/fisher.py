"""Fisher forecasts: F = J^T J of the whitened residuals, by forward mode.

Counterpart of ``desilike_tpu/fisher.py``: ``Fisher`` (the forecast of a
likelihood at one point), ``LikelihoodFisher`` (the Gaussian it describes,
with its numpy algebra) and ``PriorFisher``. For Gaussian likelihoods the
whitened design matrix comes from one ``torch.func.jacfwd`` over the varied
and solved parameters, through the card's kernels where the pipeline reaches
them; for the others the Hessian and gradient of the log-likelihood
(``torch.func.hessian``, ``torch.func.grad``); ``method='finite'`` takes
central differences instead, every stencil point in one batched pipeline
call. ``read_getdist`` reads a getdist ``.covmat`` with numpy alone;
``to_getdist`` needs getdist.
"""

import copy

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from .differentiation import evaluator, finite_derivatives
from .parameters import Deriv, ParameterCollection
from .utils import BaseClass
from . import config


class LikelihoodFisher(BaseClass):
    """Fisher information container: center, hessian of the log-likelihood
    (negative definite), gradient, and their algebra."""

    def __init__(self, center, params, hessian, gradient=None, offset=0.):
        self.params = ParameterCollection(params)
        self._names = self.params.names()
        self.center = np.asarray(center, dtype='f8')
        self.hessian = np.atleast_2d(np.asarray(hessian, dtype='f8'))
        self.gradient = np.zeros(len(self._names)) if gradient is None else np.asarray(gradient, dtype='f8')
        self.offset = float(offset)

    def names(self):
        return list(self._names)

    def index(self, params):
        return [self._names.index(getattr(p, 'name', p)) for p in params]

    @property
    def precision(self):
        """Fisher matrix F = -H."""
        return -self.hessian

    def covariance(self, params=None):
        cov = np.linalg.inv(self.precision)
        if params is not None:
            idx = self.index(params)
            cov = cov[np.ix_(idx, idx)]
        return cov

    def std(self, param):
        return np.sqrt(self.covariance([param])[0, 0])

    def fom(self, params=None):
        """Figure of merit: 1/sqrt(det C)."""
        return 1. / np.sqrt(np.linalg.det(self.covariance(params)))

    def _keep(self, params):
        drop = [getattr(p, 'name', p) for p in params]
        keep = [n for n in self._names if n not in drop]
        return keep, self.index(keep)

    def marginalize(self, params):
        """Marginalize over ``params``: drop them from the covariance."""
        keep, idx = self._keep(params)
        hessian = -np.linalg.inv(self.covariance()[np.ix_(idx, idx)])
        return LikelihoodFisher(self.center[idx], [self.params[n] for n in keep], hessian)

    def fix(self, params):
        """Condition on ``params`` fixed at the center: drop their rows and
        columns of F."""
        keep, idx = self._keep(params)
        return LikelihoodFisher(self.center[idx], [self.params[n] for n in keep], self.hessian[np.ix_(idx, idx)])

    def _solve(self):
        """Newton step dx with H dx = g."""
        try:
            return np.linalg.solve(self.hessian, self.gradient)
        except np.linalg.LinAlgError as exc:
            raise ValueError('singular hessian for parameters {}'.format(self._names)) from exc

    def mean(self, params=None, return_type='nparray'):
        """Likelihood mean = center - H^-1 g."""
        mean = self.center - self._solve()
        if params is not None:
            single = not isinstance(params, (list, tuple))
            mean = mean[self.index([params] if single else params)]
            if single:
                return float(mean[0])
        if return_type == 'dict':
            names = self._names if params is None else [getattr(p, 'name', p) for p in params]
            return dict(zip(names, mean))
        return mean

    def chi2min(self):
        r"""Minimum chi^2 = -2 loglike at the mean."""
        flatdiff = -self._solve()
        return -2. * (self.offset + self.gradient.dot(flatdiff) + 0.5 * flatdiff.dot(self.hessian).dot(flatdiff))

    def choice(self, index='mean', params=None, return_type='dict'):
        """Mean point as a dict or an array."""
        mean = np.atleast_1d(self.mean(params=params))
        if return_type == 'dict':
            names = self._names if params is None else [getattr(p, 'name', p) for p in params]
            return dict(zip(names, mean))
        return mean

    def var(self, params=None):
        """Marginalized variances."""
        return np.diag(self.covariance(params if isinstance(params, (list, tuple)) or params is None else [params]))

    def corrcoef(self, params=None):
        """Correlation matrix."""
        cov = self.covariance(params)
        std = np.sqrt(np.diag(cov))
        return cov / std[:, None] / std[None, :]

    def clone(self, center=None, params=None, gradient=None, offset=None, hessian=None):
        """Copy with overrides."""
        return LikelihoodFisher(self.center if center is None else center,
                                self.params if params is None else params,
                                self.hessian if hessian is None else hessian,
                                gradient=self.gradient if gradient is None else gradient,
                                offset=self.offset if offset is None else offset)

    def deepcopy(self):
        return copy.deepcopy(self)

    def shift(self, mean):
        """Move the likelihood mean to ``mean`` by adjusting the gradient."""
        return self.clone(gradient=self.hessian.dot(self.center - np.asarray(mean, dtype='f8')))

    def view(self, params=None):
        """Restrict to ``params`` (the conditioned precision's sub-matrix);
        parameters it does not know enter with zero precision and gradient."""
        if params is None:
            return self.deepcopy()
        names = [getattr(p, 'name', p) for p in params]
        n = len(names)
        H, g, center = np.zeros((n, n)), np.zeros(n), np.full(n, np.nan)
        known = [(i, self._names.index(nm)) for i, nm in enumerate(names) if nm in self._names]
        if known:
            inew, iold = [i for i, _ in known], [j for _, j in known]
            H[np.ix_(inew, inew)] = self.hessian[np.ix_(iold, iold)]
            g[inew] = self.gradient[iold]
            center[inew] = self.center[iold]
        plist = [self.params[nm] if nm in self._names else nm for nm in names]
        return LikelihoodFisher(np.nan_to_num(center), plist, H, gradient=g, offset=self.offset)

    def select(self, params=None, **kwargs):
        """Restrict to ``params`` (or a ParameterCollection.select query)."""
        if params is None:
            params = self.params.select(**kwargs)
        return self.view(params=params)

    @classmethod
    def read_getdist(cls, base_fn):
        """Build from a getdist-format .covmat (reference fisher.py
        read_getdist): F = -H = C^-1 around a zero-filled center."""
        from .parameters import ParameterCovariance
        return ParameterCovariance.from_getdist(base_fn).to_fisher()

    def to_getdist(self, params=None, label=None):
        """Gaussian mixture in getdist form (reference fisher.py:567); raises
        ImportError without getdist."""
        from getdist.gaussian_mixtures import GaussianND
        names = self._names if params is None else [getattr(p, 'name', p) for p in params]
        return GaussianND(self.mean(params=list(names)), self.covariance(list(names)),
                          names=names, label=label)

    @classmethod
    def sum(cls, *others):
        """Combine independent Fisher information (union of parameters)."""
        if len(others) == 1 and isinstance(others[0], (list, tuple)):
            others = others[0]
        names = []
        for f in others:
            names += [n for n in f.names() if n not in names]
        n = len(names)
        H, g, center, wsum = np.zeros((n, n)), np.zeros(n), np.zeros(n), np.zeros(n)
        params = ParameterCollection()
        for f in others:
            idx = [names.index(nn) for nn in f.names()]
            H[np.ix_(idx, idx)] += f.hessian
            g[idx] += f.gradient
            center[idx] += f.center
            wsum[idx] += 1.
            for p in f.params:
                if p.name not in params:
                    params.set(p)
        return cls(center / np.maximum(wsum, 1.), [params[nn] for nn in names], H, gradient=g)

    def __add__(self, other):
        return self.sum(self, other)

    def to_likelihood(self, device=None):
        """Export as a Gaussian compressed likelihood on the parameters
        (``device``: where it evaluates, the card by default)."""
        from .likelihoods.base import FisherGaussianLikelihood
        return FisherGaussianLikelihood(fisher=self, device=device)

    def to_stats(self):
        lines = ['{:<24s} {:>14s} {:>14s}'.format('parameter', 'center', 'sigma')]
        for i, n in enumerate(self._names):
            lines.append('{:<24s} {:>14.6g} {:>14.6g}'.format(n, self.center[i], self.std(n)))
        return '\n'.join(lines)


class PriorFisher(BaseClass):
    """Analytic prior hessians of normal priors."""

    @staticmethod
    def hessian(params, center):
        H = np.zeros((len(params), len(params)))
        for i, p in enumerate(params):
            if p.prior is not None and p.prior.dist == 'norm':
                H[i, i] = -p.prior.scale ** -2
        return H


class Fisher(BaseClass):
    """Fisher forecast of a likelihood at one point, over its varied and
    solved parameters, on the pipeline's device (the card unless the
    likelihood was built with ``device='cpu'``), in the compute dtype.

    For Gaussian likelihoods F = J_w^T J_w, with J_w the whitened design
    matrix from one ``torch.func.jacfwd``; for non-Gaussian ones the Hessian
    of the log-likelihood (``torch.func.hessian``). ``method='finite'`` takes
    the central differences of ``Differentiation``
    (:func:`~desilike_tpu_torch.differentiation.finite_derivatives`: accuracy
    2 or 4, steps scaled by ``delta_scale`` and clamped inside the prior
    limits) instead. ``mpicomm`` is accepted for the reference's signature
    and ignored.
    """

    def __init__(self, likelihood, method='auto', accuracy=2, delta_scale=1., mpicomm=None):
        self.likelihood = likelihood
        self.pipeline = likelihood.pipeline
        self.varied_params = ParameterCollection(
            [p.clone() for p in self.pipeline.varied_params]
            + [p.clone(derived=False, fixed=False) for p in self.pipeline.solved_params])
        self.names = self.varied_params.names()
        self.method = method
        self.accuracy = int(accuracy)
        self.delta_scale = float(delta_scale)

    def run(self, **params):
        """Reference name for one Fisher evaluation."""
        return self(**params)

    def __call__(self, **params):
        center = {p.name: p.value for p in self.varied_params}
        for name, v in params.items():
            matches = [p.name for p in self.varied_params if p.name == name or p.basename == name]
            if matches:
                center[matches[0]] = float(v)
        theta0 = np.array([center[n] for n in self.names], dtype='f8')
        likelihoods = self.likelihood.likelihoods
        from .likelihoods.base import BaseGaussianLikelihood
        if all(isinstance(like, BaseGaussianLikelihood) for like in likelihoods):
            fn = evaluator(self.pipeline, self.names,
                           lambda: torch.cat([like.flatdiff_white for like in likelihoods], dim=-1))
            d = fn(torch.as_tensor(theta0[None]))[0].detach().cpu().double().numpy()
            if self.method == 'finite':
                J = np.stack([v for _, v in self._finite(fn, theta0, 1)], axis=-1)  # (ndata, ndim)
            else:
                theta = torch.as_tensor(theta0, dtype=config.get_dtype(), device=self.pipeline.device)
                J = jacfwd(lambda t: fn(t[None])[0])(theta).detach().cpu().double().numpy()  # (ndata, ndim)
            H_like = -(J.T @ J)
            g_like = -(J.T @ d)
        else:
            fn = evaluator(self.pipeline, self.names, lambda: sum(like.loglikelihood for like in likelihoods))
            if self.method == 'finite':
                derivs = dict(self._finite(fn, theta0, 2))
                g_like = np.array([derivs[Deriv((n,))] for n in self.names])
                H_like = np.array([[derivs[Deriv((n, m))] for m in self.names] for n in self.names])
            else:
                theta = torch.as_tensor(theta0, dtype=config.get_dtype(), device=self.pipeline.device)

                def loglike(t):
                    return fn(t[None])[0]

                H_like = hessian(loglike)(theta).detach().cpu().double().numpy()
                g_like = grad(loglike)(theta).detach().cpu().double().numpy()
        H = H_like + PriorFisher.hessian(self.varied_params, theta0)
        return LikelihoodFisher(theta0, self.varied_params, H, gradient=g_like)

    def _finite(self, fn, theta0, order):
        """[(Deriv, value)] of the batched ``fn`` by central differences, up
        to ``order`` in every parameter."""
        return finite_derivatives(fn, self.varied_params, theta0, {n: order for n in self.names}, self.accuracy,
                                  self.delta_scale)
