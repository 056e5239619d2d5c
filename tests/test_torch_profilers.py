"""The port's profilers against the JAX package's and the analytic optimum,
on the CPU.

On the 2-parameter Gaussian of ``tests/test_samplers.py`` (optimum (1, -0.5),
covariance ``analytic_cov()``), from the three starts the JAX package's runs
were frozen from (``tests/data/torch_port_samplers_reference.npz``,
``scripts/make_torch_port_reference.py samplers``): the L-BFGS-B best fits
within 1e-4 sigma of the JAX package's and of the optimum; the Hessian by
double backward against ``jax.hessian``; the parabolic errors within 1% of
the analytic ones; the Delta-chi2 intervals, the contour grid and the 1D
profile from the JAX package's best fit. ``OptaxProfiler`` runs the three
starts as one batch: its best fits within 1e-4 sigma of the JAX package's
(one start at a time there), and both within 2e-2 sigma of the optimum (the
JAX package's own distance after 300 steps at its learning rate: 1.5e-2);
20 Adam steps against optax's, the schedule against
``optax.warmup_cosine_decay_schedule``.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch.profilers import ScipyProfiler, OptaxProfiler
from desilike_tpu_torch.profilers.base import adam_update, warmup_cosine_decay
from test_torch_sampler_steps import GaussianModel, analytic_cov, close, t

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_samplers_reference.npz'))
COV = analytic_cov()
SIGMA = np.sqrt(np.diag(COV))
OPTIMUM = np.array([1., -0.5])


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The per-step ops here are tiny: one thread each (more only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_scipy_best_fits_and_errors():
    profiler = ScipyProfiler(GaussianModel(device='cpu'))
    xs, lps = profiler._minimize_all(REFERENCE['profiler_starts'])
    assert np.abs((xs - REFERENCE['profiler_x']) / SIGMA).max() < 1e-4
    assert np.abs((xs - OPTIMUM) / SIGMA).max() < 1e-4
    close(lps, REFERENCE['profiler_lp'])
    close(profiler.hessian(REFERENCE['profiler_x'][0]), REFERENCE['profiler_hessian'])
    # maximize from the port's own starts: the parabolic errors and covariance
    profiles = profiler.maximize(niterations=2)
    assert profiles.start_size == 2
    np.testing.assert_allclose([profiles.error[n] for n in 'ab'], SIGMA, rtol=1e-2)
    np.testing.assert_allclose(profiles.covariance, COV, rtol=1e-2, atol=1e-2 * SIGMA.min() ** 2)
    best = profiles.choice()
    assert np.abs((np.array([best[n] for n in 'ab']) - OPTIMUM) / SIGMA).max() < 1e-4


def jax_profiler():
    """A port profiler holding the JAX package's best fits and errors, so
    that its scans use the same grid."""
    profiler = ScipyProfiler(GaussianModel(device='cpu'))
    xs = REFERENCE['profiler_x']
    profiles = profiler.profiles
    profiles.bestfit[profiler.varied_params['a']] = xs[:, 0]
    profiles.bestfit[profiler.varied_params['b']] = xs[:, 1]
    profiles.bestfit['logposterior'] = REFERENCE['profiler_lp']
    cov = np.linalg.inv(-REFERENCE['profiler_hessian'])
    profiles.covariance = cov
    profiles.error.update({n: float(np.sqrt(cov[i, i])) for i, n in enumerate('ab')})
    return profiler


def test_interval_contour_and_grid():
    profiler = jax_profiler()
    profiles = profiler.interval()
    got = np.array([profiles.interval[n] for n in 'ab'])
    assert np.abs((got - REFERENCE['profiler_interval']) / SIGMA[:, None]).max() < 1e-4
    assert np.abs((got - (OPTIMUM[:, None] + np.array([-1., 1.]) * SIGMA[:, None])) / SIGMA[:, None]).max() < 1e-4
    profiler.contour('a', 'b', size=7)
    entry = profiles.contour[('a', 'b')]
    np.testing.assert_allclose(np.stack(entry['grid'][:2]), REFERENCE['profiler_contour_grid'], rtol=1e-12)
    close(entry['grid'][2], REFERENCE['profiler_contour_chi2'])
    assert sorted(entry['paths']) == [1., 2.] and profiles.contour_paths(('a', 'b'))[1.]
    profiler.grid('a', np.linspace(0.9, 1.1, 5))
    close(np.stack(profiles.profile['a']), REFERENCE['profiler_profile'])


def test_derivative_free_and_fallback():
    profiler = ScipyProfiler(GaussianModel(device='cpu'), method='nelder-mead')
    x, lp = profiler._minimize_one(REFERENCE['profiler_starts'][0])
    assert np.abs((x - OPTIMUM) / SIGMA).max() < 1e-3
    assert lp == pytest.approx(float(REFERENCE['profiler_lp'][0]), abs=1e-5)
    # a gradient solve that ends on a non-finite value is redone derivative-free
    fallback = ScipyProfiler(GaussianModel(device='cpu'), fallback='powell')
    fallback._minimize_fn = lambda chi2_fn, x0, bounds: (np.asarray(x0), np.inf)
    x, lp = fallback._minimize_one(REFERENCE['profiler_starts'][1])
    assert np.isfinite(lp) and np.abs((x - OPTIMUM) / SIGMA).max() < 1e-2


def test_optax_batched_starts():
    profiler = OptaxProfiler(GaussianModel(device='cpu'), nsteps=300)
    evaluations = profiler.evaluations
    xs, lps = profiler._minimize_all(REFERENCE['profiler_starts'])
    assert profiler.evaluations - evaluations == 300  # one batched call a step for the three starts
    assert np.abs((xs - REFERENCE['optax_x']) / SIGMA).max() < 1e-4
    close(lps, REFERENCE['optax_lp'])
    assert np.abs((xs - OPTIMUM) / SIGMA).max() < 2e-2
    assert np.abs((REFERENCE['optax_x'] - OPTIMUM) / SIGMA).max() < 2e-2


def test_adam_steps_and_schedule():
    """20 steps of the JAX package's optax Adam from the first start, its
    gradient, update and new point each step; the schedule over 300 steps."""
    import optax
    profiler = OptaxProfiler(GaussianModel(device='cpu'), nsteps=300)
    scales = t(profiler._scales)
    u = t(REFERENCE['adam_u0'])
    m, v = torch.zeros_like(u), torch.zeros_like(u)
    for i, (g_ref, update_ref, u_ref) in enumerate(zip(*np.split(REFERENCE['adam'], 3, axis=1))):
        with torch.enable_grad():
            ug = u.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(profiler.chi2(ug * scales), ug)
        close(g, g_ref)
        update, m, v = adam_update(g, m, v, i + 1, warmup_cosine_decay(i, 0.1, 31, 300))
        close(update, update_ref)
        u = u + update
        close(u, u_ref)
    sched = optax.warmup_cosine_decay_schedule(0., 0.1, 31, 300)
    ours = np.array([warmup_cosine_decay(i, 0.1, 31, 300) for i in range(300)])
    np.testing.assert_allclose(ours, [float(sched(i)) for i in range(300)], rtol=0., atol=1e-7)
    np.testing.assert_allclose(ours, REFERENCE['schedule'], rtol=0., atol=1e-7)
