"""The joint two-tracer full-shape + BAO likelihood (BASELINE config 4) in
the PyTorch port, on the CPU.

- A reduced build (k bins of 0.02 instead of 0.005, 4 points) in both
  packages, live: parameter names and order, log-posterior and best-fit
  solved parameters. Its gradient is held against the JAX package's in
  ``tests/test_torch_joint_gradient.py``, a file of its own because the JAX
  package's derivative takes most of a minute to compile here.
- The full-width port (``chip_smoke.build_joint_likelihood``) against the
  frozen JAX values of ``tests/data/torch_port_joint_reference.npz``
  (``scripts/make_torch_port_reference.py joint``), with its own host state
  and with the JAX package's (``interop.state_from_numpy``).
  ``tests/test_torch_joint_reference.py`` recomputes points of that file
  with the live JAX package. The same likelihood on the card is tested by
  ``tests/test_torch_gpu.py``.

Tolerances. At the 16 frozen points the JAX package's float32 log-posterior
differs from its own float64 (x64) value by up to 5.5e-2 and its gradient by
2.0e-3 of the gradient's norm: it forms the marginalized chi2 by cancelling
terms of ~1e4. The port in float32 is within 8.1e-3 and 5.6e-5 of the x64
values (the float32 rounding of the theory vector, 1e-6 relative against data
errors of ~2%, over 368 data), and within 9e-11 and 3e-12 in float64.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from desilike_tpu_torch import config
from desilike_tpu_torch.interop import state_from_numpy, state_keys
from chip_smoke import build_joint_likelihood, JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL, JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_joint_reference.npz'))
NAMES = list(REFERENCE['names'])
SOLVED = list(REFERENCE['solved_names'])


REDUCED_ATOL = 0.5  # log-posterior of the reduced build against the JAX float32 values: see the test


def expected_names():
    """Varied and solved names of config 4 in the pipeline's order: per tracer
    (ELG first: the last observable's calculators come first in the walk) the
    BAO observable, then the full-shape one."""
    varied, solved = [], []
    for tracer in ('ELG', 'LRG'):
        varied += ['{}bao.{}'.format(tracer, b) for b in ('qpar', 'qper', 'b1', 'dbeta')]
        varied += ['{}.{}'.format(tracer, b) for b in ('qpar', 'qper', 'df', 'dm', 'b1')]
        solved += ['{}bao.al{:d}_{:d}'.format(tracer, ell, p) for ell in (0, 2) for p in range(-3, 2)]
        solved += ['{}.{}'.format(tracer, b) for b in ('sn0', 'ct0_2', 'sn0_2', 'ct2_2', 'sn2_2')]
    return varied, solved


def build_reduced(package, step=0.02, **device):
    """bench.build_likelihood() with wider k bins, in ``package``."""
    import importlib
    theories = importlib.import_module(package + '.theories')
    full_shape = importlib.import_module(package + '.theories.full_shape')
    observables_module = importlib.import_module(package + '.observables')
    likelihoods = importlib.import_module(package + '.likelihoods')
    observables, footprints = [], []
    for tracer, z, b1 in [('LRG', 0.8, 2.0), ('ELG', 1.1, 1.3)]:
        fs_theory = full_shape.EFTLikeKaiserTracerPowerSpectrumMultipoles(
            ells=(0, 2), template=theories.ShapeFitPowerSpectrumTemplate(z=z, namespace=tracer), namespace=tracer)
        fs_theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
        observables.append(observables_module.TracerPowerSpectrumMultipolesObservable(
            data={'{}.b1'.format(tracer): b1}, klim={0: (0.02, 0.2, step), 2: (0.02, 0.2, step)}, theory=fs_theory))
        footprints.append(observables_module.BoxFootprint(volume=2e9, nbar=5e-4))
        bao_theory = theories.DampedBAOWigglesTracerPowerSpectrumMultipoles(
            ells=(0, 2), template=theories.BAOPowerSpectrumTemplate(z=z, namespace=tracer + 'bao'),
            namespace=tracer + 'bao')
        bao_theory.init.params = {'al*': dict(derived='.marg')}
        observables.append(observables_module.TracerPowerSpectrumMultipolesObservable(
            data={'{}bao.b1'.format(tracer): b1}, klim={0: (0.02, 0.3, step), 2: (0.02, 0.3, step)},
            theory=bao_theory))
        footprints.append(observables_module.BoxFootprint(volume=2e9, nbar=5e-4))
    return likelihoods.ObservablesGaussianLikelihood(observables=observables, footprints=footprints, **device)


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
def reduced():
    """(port likelihood, JAX likelihood, points, JAX logpost, solved) of the reduced build."""
    port = build_reduced('desilike_tpu_torch', device='cpu')
    ref = build_reduced('desilike_tpu')
    names = ref.pipeline.varied_params.names()
    solved_names = ref.pipeline.solved_params.names()
    logpost = ref.logpost_fn(jit=False)

    def scalar(theta):
        value, aux = logpost(dict(zip(names, theta)))
        return value, jnp.stack([aux['solved'][name] for name in solved_names])

    points = REFERENCE['points'][:4].astype('f4')
    values, solved = jax.jit(jax.vmap(scalar))(jnp.asarray(points))
    return port, ref, points, np.asarray(values, dtype='f8'), np.asarray(solved, dtype='f8')


@pytest.fixture(scope='module')
def own_likelihood():
    return build_joint_likelihood('cpu')


@pytest.fixture(scope='module')
def loaded_likelihood():
    return state_from_numpy(build_joint_likelihood('cpu'), REFERENCE)


def test_reduced_layout_matches_jax(reduced):
    port, ref = reduced[:2]
    varied, solved = expected_names()
    assert port.pipeline.varied_params.names() == ref.pipeline.varied_params.names() == varied == NAMES
    assert port.pipeline.solved_params.names() == ref.pipeline.solved_params.names() == solved == SOLVED
    assert port.pipeline.params.names() == ref.pipeline.params.names()
    assert [type(c).__name__ for c in port.pipeline.calculators] == [type(c).__name__ for c in ref.pipeline.calculators]
    assert [len(obs.flatdata) for obs in port.observables] == [len(obs.flatdata) for obs in ref.observables] \
        == [18, 28, 18, 28]
    np.testing.assert_allclose(port.flatdata, ref.flatdata, rtol=2e-5, atol=2e-5 * np.abs(ref.flatdata).max())
    # block-diagonal over the four observables (each has its own footprint), equal within a block
    scale = np.sqrt(np.outer(np.diag(ref.covariance), np.diag(ref.covariance)))
    np.testing.assert_allclose(port.covariance / scale, ref.covariance / scale, rtol=0., atol=1e-4)
    assert not port.covariance[:18, 18:].any() and not port.covariance[46:64, 64:].any()
    static = port._static_linear_indices(port.pipeline, port.pipeline.solved_params)
    assert static == ref._static_linear_indices(ref.pipeline, ref.pipeline.solved_params, ref.likelihoods)
    assert [SOLVED[i] for i in range(30) if i not in static] == ['ELG.ct0_2', 'ELG.ct2_2', 'LRG.ct0_2', 'LRG.ct2_2']


def test_reduced_logpost_matches_jax(reduced):
    """Float32 in both packages. With 7 to 14 wide bins a multipole under 5
    broadband powers the solve is badly conditioned, and the JAX package's
    float32 chi2 (a cancellation of terms of ~1e4) is off by a few 1e-1: the
    tolerances are those of its error, not the port's (in float64 the port
    reproduces its x64 values to 1e-10 at full width, see below)."""
    port, _, points, ref_logpost, ref_solved = reduced
    logpost, _, aux = evaluate(port, points)
    np.testing.assert_allclose(logpost, ref_logpost, rtol=0., atol=REDUCED_ATOL)
    assert list(aux['solved']) == SOLVED and aux['solved_hessian'].shape == (4, 30, 30)
    solved = torch.stack(list(aux['solved'].values()), dim=-1).detach().numpy()
    # the stochastic and counter terms are well determined; the broadband
    # powers are nearly degenerate among themselves and move by tens of percent
    # with float32 rounding in either package
    for i, name in enumerate(SOLVED):
        scale = np.abs(ref_solved[:, i]).max()
        np.testing.assert_allclose(solved[:, i], ref_solved[:, i], rtol=0.,
                                   atol=(0.5 if '.al' in name else 2e-2) * scale, err_msg=name)


def test_reduced_theory_and_residual_match_jax(reduced):
    """A live check that does not inherit the JAX package's float32
    cancellation: with all 48 parameters given (the solved ones at seeded
    values, nothing solved), the joint theory vector and the whitened
    residual of the two packages, float32 in both, agree to 1e-5 of their
    largest entry (measured 1.1e-7 and 1.1e-6)."""
    port, ref, points = reduced[:3]
    rng = np.random.default_rng(3)
    for row in points[:2]:
        values = dict(zip(NAMES, (float(v) for v in row)))
        for name in SOLVED:
            values[name] = float(np.float32(rng.normal() * (1. if '.ct' in name else 100.)))
        ref.pipeline.evaluate(values)
        port.pipeline.evaluate(values)
        for expected, got in [(ref.flattheory(), port.flattheory()), (ref.flatdiff_white, port.flatdiff_white)]:
            expected = np.asarray(expected, dtype='f8')
            got = got.detach().numpy().astype('f8').reshape(expected.shape)
            np.testing.assert_allclose(got, expected, rtol=0., atol=1e-5 * np.abs(expected).max())


def test_reduced_hessian_and_solved_are_consistent(reduced):
    """aux['solved_hessian'] in the solved order, in float64: H is -(J J^T +
    P) with the analytic rows per chain, and the best fit zeroes the gradient
    H_like-wise: the marginalized log-likelihood equals the profile minus
    half the log-determinant."""
    port, _, points = reduced[:3]
    config.set_dtype('float64')
    try:
        logpost, _, aux = evaluate(port, points.astype('f8'), dtype=torch.float64)
        hessian = aux['solved_hessian'].detach().numpy()
        best = {name: value.detach() for name, value in aux['solved'].items()}
        # at the best fit, with the solved parameters fixed there, the plain Gaussian likelihood
        values = {n: torch.tensor(points[:, i].astype('f8')) for i, n in enumerate(NAMES)}
        pipe = port.pipeline
        pipe.run_once(pipe._resolve_values(dict(values, **best), device=torch.device('cpu'), dtype=torch.float64))
        profile = port.loglikelihood.numpy()
    finally:
        config.set_dtype('float32')
    assert np.allclose(hessian, np.swapaxes(hessian, -1, -2))
    logdet = np.linalg.slogdet(-hessian)[1]
    loglike = aux['loglikelihood'].detach().numpy()
    # profile + Gaussian prior of the solved parameters at the best fit - 1/2 logdet(-H): the
    # priors enter 'logprior' up to their normalization, which the likelihood does not carry
    quad = np.zeros(len(points))
    for name, value in best.items():
        prior = pipe.params[name].prior
        if prior is not None:
            quad = quad - 0.5 * ((value.numpy() - prior.loc) / prior.scale) ** 2
    np.testing.assert_allclose(loglike, profile - 0.5 * logdet, rtol=0., atol=1e-6 * np.abs(loglike).max() + np.abs(quad).max() + 1e-8)


def test_full_width_layout(own_likelihood):
    pipe = own_likelihood.pipeline
    assert pipe.varied_params.names() == NAMES and pipe.solved_params.names() == SOLVED
    assert len(NAMES) == 18 and len(SOLVED) == 30
    assert [len(obs.flatdata) for obs in own_likelihood.observables] == [72, 112, 72, 112]
    assert own_likelihood.size == 368
    templates = [obs.wmatrix.theory.template for obs in own_likelihood.observables]
    assert [t.k.size for t in templates] == [500, 2000, 500, 2000]
    assert [t._cheb.order for t in templates] == [202] * 4
    assert sorted(state_keys(4)) == sorted(key for key in REFERENCE.files if key not in (
        'names', 'solved_names', 'points', 'logpost', 'grad', 'solved', 'logpost_x64', 'grad_x64', 'solved_x64'))


def test_logpost_with_own_initialization_matches_jax(own_likelihood):
    logpost, grad, aux = evaluate(own_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL)
    # against the JAX package in float64: the port's float32 error alone (measured 8.1e-3 and 5.6e-5)
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL)
    assert list(aux['solved']) == SOLVED


def test_logpost_with_loaded_state_matches_jax(loaded_likelihood):
    """With the JAX package's float32 host state the port stays as close to
    its float32 values (measured 6.2e-2 and 5.8e-4)."""
    logpost, grad, _ = evaluate(loaded_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL)


def test_logpost_float64_matches_jax_x64(own_likelihood):
    """Both packages in float64 with their own initialization: the same
    numbers to rounding (measured 9e-11 on the log-posterior, 3e-12 on the
    gradient, 3e-10 of their largest value on the solved parameters)."""
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
    assert batch.shape == (3,) and aux['solved']['LRG.ct0_2'].shape == (3,)
    single = [float(fn(dict(zip(NAMES, row)))[0][0]) for row in points]
    # another batch size sums its matrix products in another order: the float32 level stated above
    np.testing.assert_allclose(batch.numpy(), single, rtol=0., atol=JOINT_X64_ATOL)


def test_not_positive_definite_raises(own_likelihood):
    """A chain whose Schur complement is not positive definite must not pass
    silently: NaN parameters poison it, and cholesky_ex's info is read."""
    fn = own_likelihood.logpost_fn()
    values = {n: torch.tensor(REFERENCE['points'][:2, i], dtype=torch.float32) for i, n in enumerate(NAMES)}
    values['LRG.dm'] = torch.tensor([0., float('nan')])
    with pytest.raises(ValueError, match='not negative definite for 1 chain'):
        fn(values)


def test_unsolvable_parameters_raise():
    """A solved parameter with neither a static design row nor an analytic
    basis (b1 enters quadratically) waits for the linearize path."""
    from desilike_tpu_torch import (ShapeFitPowerSpectrumTemplate, EFTLikeKaiserTracerPowerSpectrumMultipoles,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    theory = EFTLikeKaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=ShapeFitPowerSpectrumTemplate(z=0.8))
    theory.init.params = {'b1': dict(derived='.marg'), 'ct*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(data={'b1': 2.}, klim={0: (0.02, 0.2, 0.02), 2: (0.02, 0.2, 0.02)},
                                                         theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device='cpu')
    with pytest.raises(NotImplementedError, match=r"\['b1'\].*A8"):
        like.logpost_fn()
