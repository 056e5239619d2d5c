"""The joint two-tracer likelihood (BASELINE config 4) on a reduced build
(k bins of 0.02 instead of 0.005, 4 points) in the PyTorch port, on the CPU,
against the JAX package: parameter names and order, data and covariance,
log-posterior, best-fit solved parameters, theory vector and whitened
residual, directional derivatives of the log-posterior, and the consistency
of the solved hessian.

The JAX side is frozen in ``tests/data/torch_port_tier1_reference.npz``
(``scripts/make_torch_port_reference.py tier1``; it took ~80 worker-seconds
of the tier-1 run live): the reduced build evaluated once, in float32, by
one forward-mode derivative (``jax.jvp``, which returns the values with the
derivatives), eagerly over all points and directions at once. The port's
gradient comes from one backward pass and is projected on the same
directions; on the CPU it runs through the plain versions of the kernels
and autograd, the coefficients of the ShapeFit tables included. The
full-width build is tested in ``tests/test_torch_joint_likelihood.py``.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import config
from test_torch_joint_likelihood import NAMES, REFERENCE, SOLVED, evaluate, expected_names

torch.set_num_threads(2)

REDUCED_ATOL = 0.5  # log-posterior of the reduced build against the JAX float32 values: see the test


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


def directions():
    """Unit directions in the space of the 18 varied parameters: along dm
    and df of each tracer (the ShapeFit table and the growth rate), and three
    seeded random ones."""
    rows = [np.eye(len(NAMES))[NAMES.index(name)] for name in ('LRG.dm', 'ELG.dm', 'LRG.df', 'ELG.df')]
    rng = np.random.default_rng(11)
    rows += [v / np.linalg.norm(v) for v in rng.normal(size=(3, len(NAMES)))]
    return np.array(rows, dtype='f4')


@pytest.fixture(scope='module')
def reduced():
    """(port likelihood, the frozen JAX arrays, points, JAX logpost, solved,
    directions, JAX directional derivatives (points, directions)) of the
    reduced build."""
    port = build_reduced('desilike_tpu_torch', device='cpu')
    ref = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tier1_reference.npz'))
    assert list(ref['reduced_names']) == NAMES
    points = REFERENCE['points'][:4].astype('f4')
    np.testing.assert_array_equal(ref['reduced_points'], points)
    np.testing.assert_array_equal(ref['reduced_directions'], directions())
    return (port, ref, points, ref['reduced_logpost'], ref['reduced_solved'], ref['reduced_directions'],
            ref['reduced_derivatives'])


def test_reduced_layout_matches_jax(reduced):
    port, ref = reduced[:2]
    varied, solved = expected_names()
    assert port.pipeline.varied_params.names() == list(ref['reduced_names']) == varied == NAMES
    assert port.pipeline.solved_params.names() == list(ref['reduced_solved_names']) == solved == SOLVED
    assert port.pipeline.params.names() == list(ref['reduced_param_names'])
    assert [type(c).__name__ for c in port.pipeline.calculators] == list(ref['reduced_calculators'])
    assert [len(obs.flatdata) for obs in port.observables] == list(ref['reduced_sizes']) == [18, 28, 18, 28]
    flatdata, covariance = ref['reduced_flatdata'], ref['reduced_covariance']
    np.testing.assert_allclose(port.flatdata, flatdata, rtol=2e-5, atol=2e-5 * np.abs(flatdata).max())
    # block-diagonal over the four observables (each has its own footprint), equal within a block
    scale = np.sqrt(np.outer(np.diag(covariance), np.diag(covariance)))
    np.testing.assert_allclose(port.covariance / scale, covariance / scale, rtol=0., atol=1e-4)
    assert not port.covariance[:18, 18:].any() and not port.covariance[46:64, 64:].any()
    static = port._static_linear_indices(port.pipeline, port.pipeline.solved_params)
    assert static == list(ref['reduced_static'])
    assert [SOLVED[i] for i in range(30) if i not in static] == ['ELG.ct0_2', 'ELG.ct2_2', 'LRG.ct0_2', 'LRG.ct2_2']


def test_reduced_logpost_matches_jax(reduced):
    """Float32 in both packages. With 7 to 14 wide bins a multipole under 5
    broadband powers the solve is badly conditioned, and the JAX package's
    float32 chi2 (a cancellation of terms of ~1e4) is off by a few 1e-1: the
    tolerances are those of its error, not the port's (in float64 the port
    reproduces its x64 values to 1e-10 at full width, see below)."""
    port, _, points, ref_logpost, ref_solved = reduced[:5]
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


def test_reduced_gradient_matches_jax(reduced):
    """Directional derivatives of the log-posterior, float32 in both
    packages: within 1e-2 of the gradient's norm (the JAX package's float32
    gradient is 2.0e-3 from its own x64 value at full width; the port's 6e-5)."""
    port, _, points = reduced[:3]
    toward, expected = reduced[5:]
    _, grad, _ = evaluate(port, points)
    assert grad.shape == (4, len(NAMES)) and np.isfinite(grad).all()
    norm = np.linalg.norm(grad, axis=-1, keepdims=True)
    got = grad @ toward.T.astype('f8')
    err = np.abs(got - expected) / norm
    print('directional derivatives: error over the gradient\'s norm\n', err, '\nport\n', got, '\nJAX\n', expected)
    assert err.max() < 1e-2, err
    # the ShapeFit parameters do move the posterior, through the coefficients of the per-chain
    # tables: their own partial derivatives agree with the JAX package's, not only within the norm
    single = slice(0, 4)
    assert (got[:, single] != 0.).all()
    np.testing.assert_allclose(got[:, single], expected[:, single], rtol=5e-2, atol=1e-3 * norm.max())


def test_reduced_theory_and_residual_match_jax(reduced):
    """A live check that does not inherit the JAX package's float32
    cancellation: with all 48 parameters given (the solved ones at seeded
    values, nothing solved), the joint theory vector and the whitened
    residual of the two packages, float32 in both, agree to 1e-5 of their
    largest entry (measured 1.1e-7 and 1.1e-6)."""
    port, ref, points = reduced[:3]
    rng = np.random.default_rng(3)
    for i, row in enumerate(points[:2]):
        values = dict(zip(NAMES, (float(v) for v in row)))
        for name in SOLVED:
            values[name] = float(np.float32(rng.normal() * (1. if '.ct' in name else 100.)))
        np.testing.assert_array_equal([values[name] for name in SOLVED], ref['reduced_given_solved'][i])
        port.pipeline.evaluate(values)
        for expected, got in [(ref['reduced_flattheory'][i], port.flattheory()),
                              (ref['reduced_flatdiff_white'][i], port.flatdiff_white)]:
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
