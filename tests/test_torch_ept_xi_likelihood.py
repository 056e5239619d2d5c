"""Config 3xi in the PyTorch port on the CPU: config 3's 1-loop EPT theory in
configuration space (``chip_smoke.build_ept_xi_likelihood``), its
counterterms solved by the linearize path, against the frozen JAX values of
``tests/data/torch_port_marg_reference.npz``
(``scripts/make_torch_port_reference.py marg``); and the derivative modes
that path runs on the card, on CPU tensors: forward mode under ``vmap``
through the float64 landing and the rfft/irfft pair, and reverse over
forward-under-vmap through the kernels' autograd Functions (``_Clenshaw``,
``_ClenshawCoeffGrad``), against the plain recurrence. The same likelihood
on the card is checked by ``chip_smoke.py`` phase 3.

Tolerances: config 3's, 2e-2 on the log-posterior and 5e-4 of the
gradient's norm against JAX x64 in float32; in float64 1e-8 and 1e-8; the
solved counterterms within 1e-3 of their prior width (100) or of their value;
the derivative modes 1e-6 of their magnitude (both sides float64).
"""

import os

import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from desilike_tpu_torch import config
from desilike_tpu_torch.ops import chebyshev
from desilike_tpu_torch.ops.cuda_kernels import _Clenshaw, _ClenshawCoeffGrad, clenshaw_reference
from chip_smoke import build_ept_xi_likelihood

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_marg_reference.npz'))
X64_ATOL, X64_GRAD_RTOL = 2e-2, 5e-4  # config 3's, against JAX x64
SOLVED_RTOL = 1e-3                     # of the prior width (100) or of the value
SOLVED = ['ct0_2', 'ct2_2', 'ct4_2']


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def full_width():
    return build_ept_xi_likelihood('cpu')


def evaluate(like, names, points, dtype=torch.float32):
    """Port log-posterior, gradient (B, nvaried) and solved (B, nsolved) at ``points``."""
    values = {n: torch.tensor(points[:, i], dtype=dtype, requires_grad=True) for i, n in enumerate(names)}
    logpost, aux = like.logpost_fn()(values)
    logpost.sum().backward()
    grad = torch.stack([values[n].grad for n in names], dim=-1)
    solved = torch.stack([aux['solved'][n] for n in like.pipeline.solved_params.names()], dim=-1)
    return logpost.detach().numpy(), grad.numpy(), solved.detach().numpy()


def assert_matches(prefix, logpost, grad, solved, atol, grad_rtol, solved_rtol=SOLVED_RTOL):
    np.testing.assert_allclose(logpost, REFERENCE[prefix + '_logpost_x64'], rtol=0., atol=atol)
    ref_grad = REFERENCE[prefix + '_grad_x64']
    err = np.linalg.norm(grad - ref_grad, axis=-1) / np.linalg.norm(ref_grad, axis=-1)
    assert err.max() < grad_rtol, err
    ref_solved = REFERENCE[prefix + '_solved_x64']
    assert np.all(np.abs(solved - ref_solved) <= solved_rtol * np.maximum(100., np.abs(ref_solved)))


def test_full_width_layout(full_width):
    """10 varied, the three counterterms solved on the linearize path (no
    static row, no analytic basis through xi), 90 data (30 bins a multipole
    over 30-150 Mpc/h); nothing cut: the EPT P(k) model on k =
    geomspace(1e-4, 0.6, 300), ShapeFit on 1200 points (order 320), FFTLog on
    2048 points."""
    pipe = full_width.pipeline
    assert pipe.varied_params.names() == list(REFERENCE['ept_xi_names'])
    assert pipe.solved_params.names() == list(REFERENCE['ept_xi_solved_names']) == SOLVED
    assert full_width.size == 90
    solved = pipe.solved_params
    assert full_width._static_linear_indices(pipe, solved) == []
    assert all(full_width.solved_flat_basis_fn(p) is False for p in solved)
    theory = full_width.observables[0].wmatrix.theory
    assert (theory.kin.size, theory.k.size, theory.ells) == (300, 2048, (0, 2, 4))
    assert theory.template._cheb.order == 320


def test_logpost_matches_jax_x64(full_width):
    """At the 16 frozen points (those ``chip_smoke.py`` holds the card to)."""
    assert_matches('ept_xi', *evaluate(full_width, list(REFERENCE['ept_xi_names']), REFERENCE['ept_xi_points']),
                   X64_ATOL, X64_GRAD_RTOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64], ids=['float32', 'float64'])
def test_small_config_matches_jax_x64(dtype):
    """Config 3xi reduced to the multipoles (0, 2) in 8 Mpc/h bins (30 data),
    at 4 frozen points: float32 at config 3's limits, float64 to 1e-8."""
    like = build_ept_xi_likelihood('cpu', ells=(0, 2), step=8.)
    assert like.size == 30 and like.pipeline.solved_params.names() == ['ct0_2', 'ct2_2']
    config.set_dtype(dtype)
    try:
        got = evaluate(like, list(REFERENCE['ept_xi_small_names']), REFERENCE['ept_xi_small_points'], dtype=dtype)
    finally:
        config.set_dtype('float32')
    if dtype == torch.float32:
        assert_matches('ept_xi_small', *got, X64_ATOL, X64_GRAD_RTOL)
    else:
        assert_matches('ept_xi_small', *got, 1e-8, 1e-8, solved_rtol=1e-8)


def test_forward_mode_through_the_xi_step_under_vmap(full_width):
    """The pk -> xi step (float64 landing, rfft/irfft) is linear: forward
    mode under ``vmap`` over 3 tangents gives the step of each tangent (1e-6
    of its magnitude), and reverse mode flows through it."""
    theory = full_width.observables[0].wmatrix.theory
    rng = np.random.default_rng(0)
    power = torch.tensor(rng.normal(size=(4, 3, theory.kin.size)), dtype=torch.float64, requires_grad=True)
    tangents = torch.tensor(rng.normal(size=(3, 4, 3, theory.kin.size)), dtype=torch.float64)
    theory.dtype, theory.device = torch.float64, torch.device('cpu')
    corr, dcorr = vmap(lambda t: jvp(theory.get_corr, (power,), (t,)), out_dims=(None, 0))(tangents)
    expected = torch.stack([theory.get_corr(t) for t in tangents])
    assert float((dcorr - expected).abs().max() / expected.abs().max()) < 1e-6
    (corr[None] * dcorr).sum().backward()
    assert power.grad is not None and bool(torch.isfinite(power.grad).all())


def per_row_inputs(seed=0, rows=4, q=16, order=24):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1., 1., (rows, q)), dtype=torch.float64, requires_grad=True)
    c = rng.normal(size=(rows, order)) / (1. + np.arange(order)) ** 2
    c[:, 0] += 1.
    return x, torch.tensor(c, dtype=torch.float64, requires_grad=True)


def test_reverse_over_forward_under_vmap_through_the_functions():
    """What the linearize path's gradient runs on the card: reverse mode over
    ``vmap`` of ``jvp`` through ``_Clenshaw`` (per-row coefficients, exp'd,
    as ShapeFit's table), whose tangent rule and backward reach
    ``_ClenshawCoeffGrad``. ``gradcheck`` against central differences in
    float64, and the gradient against the same transforms of the plain
    recurrence (1e-6)."""
    x, c = per_row_inputs()
    tangents = torch.tensor(np.random.default_rng(1).normal(size=(3,) + tuple(c.shape)), dtype=torch.float64)

    def rows(series, x, c):
        primal, tangent = vmap(lambda t: jvp(lambda cc: series(x, cc, True), (c,), (t,)), out_dims=(None, 0))(tangents)
        return (tangent ** 2).sum() + (primal * tangent).sum()

    kernel = lambda x, c, lv: _Clenshaw.apply(x, c, lv)  # noqa: E731
    calls = []
    original = _ClenshawCoeffGrad.forward
    _ClenshawCoeffGrad.forward = staticmethod(lambda *args: calls.append(1) or original(*args))
    try:
        assert torch.autograd.gradcheck(lambda x, c: rows(kernel, x, c), (x, c))
        got = torch.autograd.grad(rows(kernel, x, c), (x, c))
    finally:
        _ClenshawCoeffGrad.forward = original
    assert calls
    expected = torch.autograd.grad(rows(clenshaw_reference, x, c), (x, c))
    for g, e in zip(got, expected):
        assert float((g - e).abs().max() / e.abs().max()) < 1e-6


def test_linearize_path_through_the_functions(full_width, monkeypatch):
    """Config 3xi with its lookups through the autograd Functions the card
    launches (on CPU tensors they run the plain recurrence, with their own
    derivative rules): the log-posterior, its gradient and the solved
    counterterms at 4 frozen points as those of autograd through the plain
    recurrence (1e-5 relative), and the coefficient gradient's Function
    reached."""
    names, points = list(REFERENCE['ept_xi_names']), REFERENCE['ept_xi_points'][:4]
    with monkeypatch.context() as plain:
        plain.setattr(chebyshev, 'clenshaw', clenshaw_reference)
        expected = evaluate(full_width, names, points)
    calls = []
    original = _ClenshawCoeffGrad.forward

    def counted(*args):
        calls.append(1)
        return original(*args)

    monkeypatch.setattr(_ClenshawCoeffGrad, 'forward', staticmethod(counted))
    got = evaluate(full_width, names, points)
    assert calls
    for g, e in zip(got, expected):
        assert float(np.abs(g - e).max() / np.abs(e).max()) < 1e-5
