"""The 1-loop EPT full-shape likelihood (BASELINE config 3) in the PyTorch
port, on the CPU, at full width (``chip_smoke.build_ept_likelihood``: the
calls of ``scripts/bench_ept.py``), against the frozen JAX values of
``tests/data/torch_port_ept_reference.npz``
(``scripts/make_torch_port_reference.py ept``), with the port's own host
state and with the JAX package's (``interop.state_from_numpy``). The same
likelihood on the card is checked by ``chip_smoke.py`` phase 3.

Tolerances: config 4's (``chip_smoke.EPT_*``). At the 16 frozen points the
port in float32 is within 1.9e-3 of the JAX x64 log-posterior and 7.4e-5 of
the gradient's norm, and 1.5e-2 and 3.6e-4 from the JAX package's float32
values, which carry that package's own float32 error; in float64 the two
packages agree to 2e-10 and 2e-12 (measured).
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import config
from desilike_tpu_torch.interop import state_from_numpy, state_keys
from chip_smoke import build_ept_likelihood, EPT_F32_ATOL, EPT_F32_GRAD_RTOL, EPT_X64_ATOL, EPT_X64_GRAD_RTOL

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_ept_reference.npz'))
NAMES = list(REFERENCE['names'])
SOLVED = list(REFERENCE['solved_names'])


def evaluate(like, points, names=NAMES, dtype=torch.float32):
    """Port log-posterior, gradient (B, nvaried) and aux at ``points``."""
    values = {n: torch.tensor(points[:, i], dtype=dtype, requires_grad=True) for i, n in enumerate(names)}
    logpost, aux = like.logpost_fn()(values)
    logpost.sum().backward()
    grad = torch.stack([values[n].grad for n in names], dim=-1)
    return logpost.detach().numpy(), grad.numpy(), aux


def assert_matches(logpost, grad, ref_logpost, ref_grad, atol, grad_rtol):
    np.testing.assert_allclose(logpost, ref_logpost, rtol=0., atol=atol)
    err = np.linalg.norm(grad - ref_grad, axis=-1) / np.linalg.norm(ref_grad, axis=-1)
    assert err.max() < grad_rtol, err


@pytest.fixture(scope='module')
def own_likelihood():
    return build_ept_likelihood('cpu')


def test_full_width_layout(own_likelihood):
    """8 varied, 6 solved (3 counterterms with per-chain rows; sn0, sn2_2 and
    sn4_2 static), 108 data; nothing cut: the template on 1200 points (order
    320), the loop on 96 (order 105), FFTLog at nfft 128 with its matrices
    from nr 256, nx 96; 36 k x 8 mu = 288 AP-remapped queries a chain."""
    pipe = own_likelihood.pipeline
    assert pipe.varied_params.names() == NAMES == ['qpar', 'qper', 'df', 'dm', 'b1', 'b2', 'bs', 'b3nl']
    assert pipe.solved_params.names() == SOLVED == ['sn0', 'ct0_2', 'ct2_2', 'ct4_2', 'sn2_2', 'sn4_2']
    assert own_likelihood.size == 108
    theory = own_likelihood.observables[0].wmatrix.theory
    assert theory.template.k.size == 1200 and theory.template._cheb.order == 320
    assert theory.k_work.size == 96 and theory._work_cheb.order == 105
    assert (theory.loop.nfft, theory.loop.r.size, theory.k.size, theory.mu.size) == (128, 256, 36, 8)
    assert theory._loop_eval_mat.shape == (25056, 320) and theory.resum == 'full'
    assert theory.solved_basis_names == ('ct0_2', 'ct2_2', 'ct4_2')
    assert sorted(state_keys(1)) == sorted(key for key in REFERENCE.files if key not in (
        'names', 'solved_names', 'points', 'logpost', 'grad', 'solved', 'logpost_x64', 'grad_x64', 'solved_x64'))


def test_logpost_with_own_initialization_matches_jax(own_likelihood):
    logpost, grad, aux = evaluate(own_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], EPT_F32_ATOL, EPT_F32_GRAD_RTOL)
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], EPT_X64_ATOL, EPT_X64_GRAD_RTOL)
    assert list(aux['solved']) == SOLVED


def test_logpost_with_loaded_state_matches_jax():
    """With the JAX package's host state (its template tables, window, data,
    whitening and static rows) the port stays as close to its values."""
    like = state_from_numpy(build_ept_likelihood('cpu'), REFERENCE)
    logpost, grad, _ = evaluate(like, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], EPT_F32_ATOL, EPT_F32_GRAD_RTOL)
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], EPT_X64_ATOL, EPT_X64_GRAD_RTOL)


def test_logpost_float64_matches_jax_x64(own_likelihood):
    """Both packages in float64 with their own initialization: the same
    numbers to rounding, solved parameters included."""
    config.set_dtype('float64')
    try:
        logpost, grad, aux = evaluate(own_likelihood, REFERENCE['points'], dtype=torch.float64)
    finally:
        config.set_dtype('float32')
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], 1e-8, 1e-8)
    solved = torch.stack([aux['solved'][name] for name in SOLVED], dim=-1).detach().numpy()
    scale = np.abs(REFERENCE['solved_x64']).max(axis=0)
    np.testing.assert_allclose(solved / scale, REFERENCE['solved_x64'] / scale, rtol=0., atol=1e-7)


def test_batch_rows_match_single_evaluations(own_likelihood):
    fn = own_likelihood.logpost_fn()
    points = REFERENCE['points'][:3]
    batch, aux = fn({n: torch.tensor(points[:, i], dtype=torch.float32) for i, n in enumerate(NAMES)})
    assert batch.shape == (3,) and aux['solved']['ct4_2'].shape == (3,)
    assert aux['solved_hessian'].shape == (3, 6, 6)
    single = [float(fn(dict(zip(NAMES, row)))[0][0]) for row in points]
    np.testing.assert_allclose(batch.numpy(), single, rtol=0., atol=EPT_X64_ATOL)


def test_solved_power_basis_is_the_counterterms_step(own_likelihood):
    """d power / d ct, which the analytic marginalization reads after the
    primal run, equals a unit step of the counterterm (the term is exactly
    linear), (B, 3, 36) for each of the three."""
    from desilike_tpu_torch import Pipeline
    theory = own_likelihood.observables[0].wmatrix.theory
    pipe = Pipeline(theory)
    values = {n: torch.tensor(REFERENCE['points'][:2, i], dtype=torch.float32) for i, n in enumerate(NAMES)}
    pipe.evaluate(values, device='cpu')
    power = theory.power.clone()
    bases = {name: theory.solved_power_basis(name) for name in theory.solved_basis_names}
    for name, basis in bases.items():
        assert basis.shape == (2, 3, 36)
        pipe.evaluate(dict(values, **{name: torch.ones(2)}), device='cpu')
        scale = float(power.abs().max())  # a difference of two float32 powers
        np.testing.assert_allclose((theory.power - power).numpy(), basis.numpy(), rtol=0., atol=2e-6 * scale)


def test_forward_mode_and_second_derivatives(own_likelihood):
    """What the gradient samplers take through the FFT, the static landing
    and the lookups, in float64: ``torch.func.jvp`` of the log-posterior
    equals the gradient along the tangent, and a double backward
    (Hessian-vector product) the central difference of the gradient."""
    from torch.func import jvp
    rng = np.random.default_rng(2)
    point = torch.tensor(REFERENCE['points'][:2], dtype=torch.float64)
    tangent = torch.tensor(rng.normal(size=point.shape) * [0.01, 0.01, 0.02, 0.01, 0.05, 0.1, 0.1, 0.1],
                           dtype=torch.float64)
    config.set_dtype('float64')
    try:
        fn = own_likelihood.logpost_fn()

        def logpost(theta):
            return fn(dict(zip(NAMES, theta.unbind(-1))))[0]

        def gradient(theta, create_graph=False):
            theta = theta.clone().requires_grad_(True)
            return torch.autograd.grad(logpost(theta).sum(), theta, create_graph=create_graph)[0], theta

        _, directional = jvp(logpost, (point,), (tangent,))
        grad, theta = gradient(point, create_graph=True)
        hvp = torch.autograd.grad((grad * tangent).sum(), theta)[0]
        step = 1e-4
        difference = (gradient(point + step * tangent)[0] - gradient(point - step * tangent)[0]) / (2. * step)
    finally:
        config.set_dtype('float32')
    np.testing.assert_allclose(directional.numpy(), (grad * tangent).sum(-1).detach().numpy(), rtol=1e-10)
    np.testing.assert_allclose(hvp.numpy(), difference.numpy(), rtol=0., atol=1e-5 * float(hvp.abs().max()))
