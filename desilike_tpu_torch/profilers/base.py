"""Profilers: posterior maximization, parabolic errors, Delta-chi2 intervals.

Counterpart of ``desilike_tpu/profilers/base.py`` (the reference's
profilers/base.py:125). Each objective is a one-chain closure: the
likelihood's batched ``logpost_fn`` on a (1,) batch, its gradient by
``torch.autograd.grad``; the parabolic errors come from the Hessian by
double backward (one batch of ``ndim`` copies of the best fit, as the
samplers' start-point Hessian). ``OptaxProfiler`` runs all its starts as
one batch, Adam and the warmup-cosine schedule written out as torch ops.
"""

import numpy as np
import torch

from ..utils import BaseClass
from ..samples.profiles import Profiles


class BaseProfiler(BaseClass):

    def __init__(self, likelihood, seed=42, max_tries=200):
        self.likelihood = likelihood
        self.pipeline = likelihood.pipeline
        self.varied_params = self.pipeline.varied_params
        self.names = self.varied_params.names()
        self.ndim = len(self.names)
        self.device = self.pipeline.device
        self.generator = torch.Generator(self.device).manual_seed(int(seed))
        self.max_tries = max_tries
        self._fn = likelihood.logpost_fn()
        self._scales = np.array([p.proposal if p.proposal else
                                 (p.prior.std if p.prior is not None and np.isfinite(p.prior.std) else 1.)
                                 for p in self.varied_params])
        self.profiles = Profiles(self.varied_params)
        self.evaluations = self.evaluated_points = 0  # batched calls, and the points in them

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    def logpost_batch(self, thetas):
        """(B, ndim) tensor -> (B,) logposterior."""
        self.evaluations += 1
        self.evaluated_points += thetas.shape[0]
        return self._fn(dict(zip(self.names, thetas.unbind(-1))))[0]

    def logpost(self, theta):
        """logposterior of one flat parameter vector (ndim,) tensor, a 0-dim tensor."""
        return self.logpost_batch(theta[None])[0]

    def chi2(self, theta):
        """-2 logposterior of one flat parameter vector (ndim,) tensor."""
        return -2. * self.logpost(theta)

    def _bounds(self):
        bounds = []
        for p in self.varied_params:
            lims = p.prior.limits if p.prior is not None else (-np.inf, np.inf)
            bounds.append((None if not np.isfinite(lims[0]) else lims[0],
                           None if not np.isfinite(lims[1]) else lims[1]))
        return bounds

    def _starts(self, niterations):
        """The parameters' values, then draws from their reference distributions."""
        starts = [np.array([p.value for p in self.varied_params])]
        if niterations > 1:
            draws = [p.sample_ref(self.generator, (niterations - 1,), device=self.device) for p in self.varied_params]
            starts += list(torch.stack(draws, dim=-1).double().cpu().numpy())
        return np.array(starts)

    def _minimize_one(self, start):
        raise NotImplementedError

    def _minimize_all(self, starts):
        """(nstarts, ndim) starts -> ((nstarts, ndim) best fits, (nstarts,) logposteriors)."""
        results = [self._minimize_one(s) for s in starts]
        return np.array([r[0] for r in results]), np.array([r[1] for r in results])

    def hessian(self, theta):
        """Hessian of the logposterior at ``theta`` (ndim,) by double
        backward: ``ndim`` copies in one batch with ``create_graph``, then
        one backward of sum_i g[i, i], whose row i is the Hessian's row i
        since the copies are independent. Returns (ndim, ndim) float64 numpy."""
        with torch.enable_grad():
            u = self._tensor(theta).expand(self.ndim, self.ndim).clone().requires_grad_(True)
            lp = self.logpost_batch(u)
            (grad,) = torch.autograd.grad(lp.sum(), u, create_graph=True)
            (hessian,) = torch.autograd.grad(torch.diagonal(grad).sum(), u)
        return hessian.double().cpu().numpy()

    def maximize(self, niterations=3):
        """Multi-start maximization; fills profiles.bestfit/error/covariance."""
        xs, lps = self._minimize_all(self._starts(niterations))
        for i, name in enumerate(self.names):
            self.profiles.bestfit[self.varied_params[name]] = xs[:, i]
        self.profiles.bestfit['logposterior'] = lps
        # parabolic errors from the Hessian at the best start
        H = self.hessian(xs[int(np.argmax(lps))])
        try:
            cov = np.linalg.inv(-H)
            self.profiles.covariance = cov
            for i, name in enumerate(self.names):
                self.profiles.error[name] = float(np.sqrt(max(cov[i, i], 0.)))
        except np.linalg.LinAlgError:
            self.profiles.covariance = None
        return self.profiles

    def interval(self, params=None, cl=1., grid_size=30):
        r"""Delta-chi2 = cl^2 likelihood intervals by root-finding on the
        profiled chi2 (reference profilers/base.py:500): the other
        parameters are re-optimized at each scan point."""
        if params is None:
            params = self.names
        if not self.profiles.start_size:
            self.maximize()
        best = self.profiles.choice()
        chi2_min = -2. * best['logposterior']
        for name in [getattr(p, 'name', p) for p in params]:
            i = self.names.index(name)
            sigma = self.profiles.error.get(name) or self._scales[i]
            target = chi2_min + cl ** 2
            lims = []
            for sign in (-1., 1.):
                # expand until bracketing, then bisection on the profiled chi2
                step, val = sigma, best[name]
                for _ in range(30):
                    val = val + sign * step
                    if self._profiled_chi2(name, val, best) >= target:
                        break
                a, b = val - sign * step, val
                for _ in range(20):
                    m = 0.5 * (a + b)
                    if self._profiled_chi2(name, m, best) < target:
                        a = m
                    else:
                        b = m
                lims.append(0.5 * (a + b))
            self.profiles.interval[name] = tuple(sorted(lims))
        return self.profiles

    def _sub_chi2(self, fixed):
        """chi2 as a function of the parameters not in ``fixed`` (a dict
        name -> value), the others held at their values."""
        others = [n for n in self.names if n not in fixed]
        idx = torch.as_tensor([self.names.index(n) for n in others], device=self.device)

        def chi2_sub(theta_sub):
            theta = torch.zeros(self.ndim, dtype=theta_sub.dtype, device=self.device)
            theta[idx] = theta_sub
            for name, value in fixed.items():
                theta[self.names.index(name)] = value
            return self.chi2(theta)

        return others, chi2_sub

    def _profiled_chi2(self, name, value, best):
        """chi2 minimized over all other parameters with ``name`` fixed."""
        others, chi2_sub = self._sub_chi2({name: value})
        if not others:
            return float(self.chi2(self._tensor([value])))
        x0 = np.array([best[n] for n in others])
        _, fun = self._minimize_fn(chi2_sub, x0, [self._bounds()[self.names.index(n)] for n in others])
        return float(fun)

    def _minimize_fn(self, chi2_fn, x0, bounds):
        """L-BFGS-B on chi2_fn, its value and gradient from one call and one
        backward on the device. Returns (x, chi2)."""
        from scipy import optimize

        def f(x):
            with torch.enable_grad():
                t = self._tensor(x).requires_grad_(True)
                v = chi2_fn(t)
                (g,) = torch.autograd.grad(v, t)
            return float(v.detach()), g.double().cpu().numpy()

        res = optimize.minimize(f, x0, jac=True, bounds=bounds, method='L-BFGS-B',
                                options={'maxiter': 500, 'ftol': 1e-12, 'gtol': 1e-8})
        return res.x, res.fun

    def contour(self, name1, name2, size=15, sigmas=2.5, cl=(1., 2.)):
        """2D profiled-chi2 contour grid (reference profilers/base.py:656):
        chi2 minimized over the other parameters on a (size x size) grid;
        stores {cl: [(x, y), ...]} paths at Delta chi2 = cl^2 and the grid."""
        from ..utils import marching_squares
        if not self.profiles.start_size:
            self.maximize()
        best = self.profiles.choice()
        chi2_min = -2. * best['logposterior']
        grids = []
        for name in (name1, name2):
            sig = self.profiles.error.get(name) or self._scales[self.names.index(name)]
            grids.append(np.linspace(best[name] - sigmas * sig, best[name] + sigmas * sig, size))
        chi2_grid = np.zeros((size, size))
        for a, v1 in enumerate(grids[0]):
            for b, v2 in enumerate(grids[1]):
                others, chi2_sub = self._sub_chi2({name1: v1, name2: v2})
                if others:
                    x0 = np.array([best[n] for n in others])
                    _, val = self._minimize_fn(chi2_sub, x0, [self._bounds()[self.names.index(n)] for n in others])
                else:
                    theta = np.array([best[n] for n in self.names])
                    theta[self.names.index(name1)], theta[self.names.index(name2)] = v1, v2
                    val = float(self.chi2(self._tensor(theta)))
                chi2_grid[a, b] = val
        paths = {}
        for c in cl:
            segs = marching_squares(grids[0], grids[1], chi2_grid - chi2_min, c ** 2)
            if segs:
                paths[c] = [(seg[:, 0], seg[:, 1]) for seg in segs]
        self.profiles.contour[(name1, name2)] = {'grid': (grids[0], grids[1], chi2_grid), 'paths': paths}
        return self.profiles

    def grid(self, name, values):
        """1D profile: chi2 minimized over the other parameters along a grid."""
        if not self.profiles.start_size:
            self.maximize()
        best = self.profiles.choice()
        chi2s = np.array([self._profiled_chi2(name, v, best) for v in values])
        self.profiles.profile[name] = (np.asarray(values), chi2s)
        return self.profiles


class ScipyProfiler(BaseProfiler):
    """L-BFGS-B with autograd gradients (reference profilers/scipy.py:8).

    ``method='nelder-mead'`` or ``'powell'`` switch to derivative-free
    minimization (the reference's Minuit/BOBYQA role) for posteriors whose
    gradients are unreliable; ``fallback`` re-polishes a start with it when
    the gradient-based solve ends on a non-finite value."""

    def __init__(self, likelihood, method='l-bfgs-b', fallback=None, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.method = str(method).lower().replace('_', '-')
        self.fallback = str(fallback).lower().replace('_', '-') if fallback else None

    def _minimize_one(self, start):
        x, lp = self._minimize_with(self.method, start)
        if self.fallback and self.fallback != self.method and not np.isfinite(lp):
            x, lp = self._minimize_with(self.fallback, start)
        return x, lp

    def _minimize_with(self, method, start):
        if method in ('l-bfgs-b', 'lbfgsb'):
            x, fun = self._minimize_fn(self.chi2, start, self._bounds())
            return x, -0.5 * fun
        from scipy import optimize

        def f(x):
            with torch.no_grad():
                val = float(self.chi2(self._tensor(x)))
            return val if np.isfinite(val) else 1e30

        res = optimize.minimize(f, np.asarray(start), method=method, bounds=self._bounds(),
                                options={'maxiter': 5000, 'xatol': 1e-8, 'fatol': 1e-10}
                                if method == 'nelder-mead' else None)
        return np.asarray(res.x), -0.5 * float(res.fun)


def warmup_cosine_decay(step, peak, warmup_steps, decay_steps):
    """``optax.warmup_cosine_decay_schedule(0., peak, warmup_steps,
    decay_steps)`` at the integer ``step``: a linear ramp from 0 to ``peak``
    over ``warmup_steps``, then a cosine decay to 0 over the remaining
    ``decay_steps - warmup_steps``."""
    if step < warmup_steps:
        count = min(max(step, 0), warmup_steps)
        return -peak * (1. - count / warmup_steps) + peak
    count = min(float(step - warmup_steps), float(decay_steps - warmup_steps))
    return peak * (0.5 * (1. + np.cos(np.pi * count / (decay_steps - warmup_steps))))


def adam_update(g, m, v, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax's Adam (``scale_by_adam`` with eps outside the square root,
    eps_root 0, then the learning rate): the moments updated by the
    gradient g, bias-corrected at step ``count`` (1 at the first update).
    Returns (update, m, v), the update to add to the parameters."""
    m = (1. - b1) * g + b1 * m
    v = (1. - b2) * g ** 2 + b2 * v
    # the bias corrections in float32 as optax forms them (1 - 0.999 in float32 is 1.3e-5 off 0.001): b's
    # float32 power, on the host, as numpy rounds it
    m_hat = m / (1. - torch.tensor(np.float32(b1) ** count, dtype=g.dtype, device=g.device))
    v_hat = v / (1. - torch.tensor(np.float32(b2) ** count, dtype=g.dtype, device=g.device))
    return -lr * (m_hat / (torch.sqrt(v_hat) + eps)), m, v


class OptaxProfiler(BaseProfiler):
    """Adam with a warmup-cosine learning-rate schedule (reference
    profilers/optax.py:37), every start at once: the starts are one
    (nstarts, ndim) batch, whose rows move independently (Adam is
    elementwise), one batched call and one backward a step. Each start keeps
    its best-so-far point as the JAX package's does."""

    def __init__(self, likelihood, learning_rate=0.1, nsteps=500, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.learning_rate = float(learning_rate)
        self.nsteps = int(nsteps)

    def _minimize_one(self, start):
        xs, lps = self._minimize_all(np.asarray(start)[None])
        return xs[0], lps[0]

    def _minimize_all(self, starts):
        scales = self._tensor(self._scales)
        warmup = int(0.1 * self.nsteps) + 1
        u = self._tensor(starts) / scales
        m, v = torch.zeros_like(u), torch.zeros_like(u)
        best_u, best_v = u, torch.full(u.shape[:1], np.inf, device=self.device)
        for i in range(self.nsteps):
            with torch.enable_grad():
                ug = u.detach().requires_grad_(True)
                chi2 = -2. * self.logpost_batch(ug * scales)
                (g,) = torch.autograd.grad(chi2.sum(), ug)
            update, m, v = adam_update(g, m, v, i + 1, warmup_cosine_decay(i, self.learning_rate, warmup,
                                                                           self.nsteps))
            u = u + update
            # as the JAX package: the point after the step is kept with the value before it
            better = chi2.detach() < best_v
            best_u, best_v = torch.where(better[:, None], u, best_u), torch.where(better, chi2.detach(), best_v)
        return (best_u * scales).double().cpu().numpy(), -0.5 * best_v.double().cpu().numpy()
