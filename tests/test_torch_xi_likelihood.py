"""The correlation-function BAO likelihood (config xi: config 1 in
configuration space, ``chip_smoke.build_xi_likelihood``) in the PyTorch port,
on the CPU, at full width, against the frozen JAX values of
``tests/data/torch_port_xi_reference.npz``
(``scripts/make_torch_port_reference.py xi``), with the port's own host
state and with the JAX package's (``interop.state_from_numpy``). The same
likelihood on the card is checked by ``chip_smoke.py`` phase 3.

Tolerances: config 1's. At the 16 frozen points the port in float32 is
within 1.0e-4 of the JAX x64 log-posterior and 8.5e-5 of the gradient's norm
(limits 2e-3 and 5e-4; its pk -> xi step runs in float64), and 3.8e-4 and
2.7e-4 from the JAX package's float32 values, which are themselves 4.4e-4
and 2.6e-4 from its x64 ones (limits 5e-2 and 1e-2,
``tests/test_torch_bao_likelihood.py``'s); with the JAX package's float32
host state (its data vector carries that package's float32 error) 5.0e-4
and 7.8e-4 from its float32 values. In float64 the two packages agree to
3.0e-12 and 6.5e-13, the solved broadband to 2.1e-12 of its largest value
and the covariance to 1.9e-15 (all measured).
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import config
from desilike_tpu_torch.interop import state_from_numpy, state_keys
from desilike_tpu_torch.samplers import NUTSSampler
from chip_smoke import build_xi_likelihood, HESSIAN_RTOL

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_xi_reference.npz'))
NAMES = list(REFERENCE['names'])
SOLVED = list(REFERENCE['solved_names'])
X64_ATOL, X64_GRAD_RTOL = 2e-3, 5e-4      # config 1's, against JAX x64
F32_ATOL, F32_GRAD_RTOL = 5e-2, 1e-2      # config 1's, against JAX float32


def evaluate(like, points, dtype=torch.float32):
    """Port log-posterior, gradient (B, nvaried) and aux at ``points``."""
    values = {n: torch.tensor(points[:, i], dtype=dtype, requires_grad=True) for i, n in enumerate(NAMES)}
    logpost, aux = like.logpost_fn()(values)
    logpost.sum().backward()
    grad = torch.stack([values[n].grad for n in NAMES], dim=-1)
    return logpost.detach().numpy(), grad.numpy(), aux


def assert_matches(logpost, grad, ref_logpost, ref_grad, atol, grad_rtol):
    np.testing.assert_allclose(logpost, ref_logpost, rtol=0., atol=atol)
    err = np.linalg.norm(grad - ref_grad, axis=-1) / np.linalg.norm(ref_grad, axis=-1)
    assert err.max() < grad_rtol, err


@pytest.fixture(scope='module')
def own_likelihood():
    return build_xi_likelihood('cpu')


def test_full_width_layout(own_likelihood):
    """4 varied, the 6 broadband terms solved with a static design matrix,
    52 data (26 bins a multipole over 48-152 Mpc/h); nothing cut: the P(k)
    model on k = geomspace(1e-4, 0.6, 300) x 10 mu nodes, the template on 2000
    points to 1.2 (order 230), FFTLog on 2048 points, the theory on the
    window's 78 s points a multipole."""
    pipe = own_likelihood.pipeline
    assert pipe.varied_params.names() == NAMES == ['qpar', 'qper', 'b1', 'dbeta']
    assert pipe.solved_params.names() == SOLVED == ['al0_-2', 'al0_-1', 'al0_0', 'al2_-2', 'al2_-1', 'al2_0']
    assert own_likelihood.size == 52
    assert len(own_likelihood._static_linear_indices(pipe, pipe.solved_params)) == 6
    theory = own_likelihood.observables[0].wmatrix.theory
    assert (theory.kin.size, theory.power.mu.size, theory.k.size, theory.s.size) == (300, 10, 2048, 78)
    assert theory.template.k.size == 2000 and theory.template.k[-1] == 1.2 and theory.template._cheb.order == 230
    assert sorted(state_keys(1)) == sorted(key for key in REFERENCE.files if key in state_keys(1))
    np.testing.assert_allclose(own_likelihood.covariance, REFERENCE['covariance_xi'], rtol=0.,
                               atol=1e-10 * np.abs(REFERENCE['covariance_xi']).max())


def test_logpost_with_own_initialization_matches_jax(own_likelihood):
    logpost, grad, aux = evaluate(own_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], F32_ATOL, F32_GRAD_RTOL)
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], X64_ATOL, X64_GRAD_RTOL)
    assert list(aux['solved']) == SOLVED and aux['solved_hessian'].shape == (6, 6)


def test_logpost_with_loaded_state_matches_jax():
    """With the JAX package's host state (its template tables, window, data,
    whitening and static rows) the port stays as close to its values."""
    like = state_from_numpy(build_xi_likelihood('cpu'), REFERENCE)
    logpost, grad, _ = evaluate(like, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], F32_ATOL, F32_GRAD_RTOL)


def test_logpost_float64_matches_jax_x64(own_likelihood):
    """Both packages in float64 with their own initialization: the same
    numbers to rounding, the solved broadband included."""
    config.set_dtype('float64')
    try:
        logpost, grad, aux = evaluate(own_likelihood, REFERENCE['points'], dtype=torch.float64)
    finally:
        config.set_dtype('float32')
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], 1e-8, 1e-8)
    solved = torch.stack([aux['solved'][name] for name in SOLVED], dim=-1).detach().numpy()
    scale = np.abs(REFERENCE['solved_x64']).max(axis=0)
    np.testing.assert_allclose(solved / scale, REFERENCE['solved_x64'] / scale, rtol=0., atol=1e-8)


def test_batch_rows_match_single_evaluations(own_likelihood):
    fn = own_likelihood.logpost_fn()
    points = REFERENCE['points'][:3]
    batch, aux = fn({n: torch.tensor(points[:, i], dtype=torch.float32) for i, n in enumerate(NAMES)})
    assert batch.shape == (3,) and aux['solved']['al2_0'].shape == (3,)
    single = [float(fn(dict(zip(NAMES, row)))[0][0]) for row in points]
    np.testing.assert_allclose(batch.numpy(), single, rtol=0., atol=1e-4)


def test_start_hessian_matches_jax_x64(own_likelihood):
    """The samplers' start-point Hessian in their unconstrained space, by
    double backward through the lookups, the landing and the rfft/irfft
    pair, in float32: its diagonal within HESSIAN_RTOL of the largest entry
    of the JAX package's x64 central differences."""
    sampler = NUTSSampler(own_likelihood, nchains=1)
    assert sampler.names == list(REFERENCE['hessian_names'])
    np.testing.assert_allclose(sampler._unconstrain(REFERENCE['hessian_point']), REFERENCE['hessian_u'], rtol=1e-12)
    u = torch.tensor(REFERENCE['hessian_u'], dtype=torch.float32)[None]
    logdens, grad = sampler._logdens_grad()(u)
    assert abs(float(logdens[0]) - float(REFERENCE['hessian_logdens'])) <= X64_ATOL
    expected = REFERENCE['hessian_grad']
    assert np.linalg.norm(grad[0].numpy() - expected) <= X64_GRAD_RTOL * np.linalg.norm(expected)
    sampler.initial_mass(u)
    diag, expected = np.diag(sampler.start_hessian.numpy()), np.diag(REFERENCE['hessian'])
    assert np.abs(diag - expected).max() <= HESSIAN_RTOL * np.abs(expected).max()


def test_forward_mode_and_second_derivatives(own_likelihood):
    """What the gradient samplers take through the lookups and the FFTs, in
    float64: ``torch.func.jvp`` of the log-posterior equals the gradient
    along the tangent, and a double backward (Hessian-vector product) the
    central difference of the gradient."""
    from torch.func import jvp
    rng = np.random.default_rng(2)
    point = torch.tensor(REFERENCE['points'][:2], dtype=torch.float64)
    tangent = torch.tensor(rng.normal(size=point.shape) * [0.01, 0.01, 0.05, 0.02], dtype=torch.float64)
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
