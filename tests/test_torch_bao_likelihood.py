"""The single-tracer BAO likelihood (BASELINE config 1) in the PyTorch port.

The port's modules and its full-width log-posterior, on the CPU, against
the JAX package: live for the cheap module functions, and through
``tests/data/torch_port_bao_reference.npz`` for the likelihood (written by
``scripts/make_torch_port_reference.py bao``). The JAX sides that built
likelihoods or compiled (the host cosmology functions, the observable's
data vector, the damped-BAO variants, the small config's branches, and one
jitted, batched value and gradient of config 1 with its host state, which
hold the reference file against a second computation of it) are frozen in
``tests/data/torch_port_tier1b_reference.npz`` (``make_torch_port_reference.py
tier1b``) for the tier-1 clock, at the tolerances they had live. The same
likelihood on the card is tested by ``tests/test_torch_gpu.py``.

Tolerances against the JAX float32 values are set by the JAX package's own
float32 error: at the 16 frozen points its log-posterior differs from the
same package run in float64 (x64) by up to 0.036, and its gradient by up to
0.71% of the gradient's norm. The port in float32 is within 2e-4 and 3e-5
of the x64 values, and within 1e-10 in float64.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from desilike_tpu.ops.legendre import to_poles as jax_to_poles, multipole_weights, weights_mu
from desilike_tpu.ops.linalg import whiten_factor as jax_whiten_factor
from desilike_tpu.observables.window import window_matrix_bininteg as jax_window_matrix_bininteg
from desilike_tpu.theories.base import ap_k_mu as jax_ap_k_mu
from desilike_tpu_torch import config, DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate, Pipeline
from desilike_tpu_torch.cosmology import background, linear
from desilike_tpu_torch.interop import state_from_numpy
from desilike_tpu_torch.observables.window import window_matrix_bininteg
from desilike_tpu_torch.ops.legendre import (to_poles, weights_mu as port_weights_mu,
                                              multipole_weights as port_multipole_weights)
from desilike_tpu_torch.ops.linalg import cholesky, whiten_factor
from desilike_tpu_torch.theories.base import ap_k_mu
from chip_smoke import build_likelihood

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_bao_reference.npz'))
TIER1B = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tier1b_reference.npz'))
JAX_F32_ATOL = 5e-2      # logpost, against the JAX float32 values (see module docstring)
JAX_F32_GRAD_RTOL = 1e-2  # gradient, relative to its norm


def logpost_and_grad(like, points, dtype=torch.float32, device='cpu'):
    names = list(REFERENCE['names'])
    values = {n: torch.tensor(points[:, i], dtype=dtype, device=device, requires_grad=True)
              for i, n in enumerate(names)}
    logpost, _ = like.logpost_fn()(values)
    logpost.sum().backward()
    grad = torch.stack([values[n].grad for n in names], dim=-1)
    return logpost.detach().cpu().numpy(), grad.cpu().numpy()


def assert_matches(logpost, grad, ref_logpost, ref_grad, atol, grad_rtol):
    np.testing.assert_allclose(logpost, ref_logpost, rtol=0., atol=atol)
    err = np.linalg.norm(grad - ref_grad, axis=-1) / np.linalg.norm(ref_grad, axis=-1)
    assert err.max() < grad_rtol, err


@pytest.fixture(scope='module')
def own_likelihood():
    return build_likelihood('cpu')


@pytest.fixture(scope='module')
def loaded_likelihood():
    return state_from_numpy(build_likelihood('cpu'), REFERENCE)


def test_pipeline_matches_jax_layout(own_likelihood):
    pipe = own_likelihood.pipeline
    assert pipe.varied_params.names() == list(REFERENCE['names'])
    assert pipe.solved_params.names() == ['al{:d}_{:d}'.format(ell, p) for ell in (0, 2) for p in range(-3, 2)]
    assert [type(c).__name__ for c in pipe.calculators] == [
        'APEffect', 'BAOPowerSpectrumTemplate', 'DampedBAOWigglesPowerSpectrumMultipoles',
        'DampedBAOWigglesTracerPowerSpectrumMultipoles', 'WindowedPowerSpectrumMultipoles',
        'TracerPowerSpectrumMultipolesObservable', 'ObservablesGaussianLikelihood']
    template = pipe.calculators[1]
    assert template._cheb.order == 202 and template.k.size == 2000


def test_host_cosmology_matches_jax():
    """Fiducial tables: port float64 numpy against JAX float32 (rtol 1e-5 is
    the float32 growth integration's level; the JAX values frozen)."""
    p = background.resolve()
    k = np.geomspace(1e-4, 1., 200)
    pk, scalars = TIER1B['host_cosmology_pk'], TIER1B['host_cosmology_scalars']
    for got, expected in [(linear.pk_lin(p, k, 0.8), pk[0]), (linear.pk_lin(p, k, 0.8, nowiggle=True), pk[1]),
                          (background.growth_rate(p, 0.8), scalars[0]), (linear.sigma_r(p, 8., 0.8), scalars[1]),
                          (background.rs_drag(p), scalars[2]), (background.hubble_distance(p, 0.8), scalars[3]),
                          (background.comoving_angular_distance(p, 0.8), scalars[4])]:
        np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_ap_k_mu_matches_jax():
    rng = np.random.default_rng(3)
    k = np.linspace(0.02, 0.3, 56).astype('f4')
    mu = weights_mu(10)[0].astype('f4')
    q = rng.uniform(0.95, 1.05, size=(5, 2)).astype('f4')
    jac, kap, muap = ap_k_mu(torch.from_numpy(k), torch.from_numpy(mu), torch.from_numpy(q[:, 0]),
                             torch.from_numpy(q[:, 1]))
    for b in range(len(q)):
        jj, kk, mm = jax_ap_k_mu(jnp.asarray(k), jnp.asarray(mu), qpar=q[b, 0], qper=q[b, 1])
        np.testing.assert_allclose(jac[b].numpy(), np.asarray(jj), rtol=1e-6)
        np.testing.assert_allclose(kap[b].numpy(), np.asarray(kk), rtol=1e-6)
        np.testing.assert_allclose(muap[b, 0].numpy(), np.asarray(mm), rtol=1e-6)


@pytest.mark.parametrize('mu, method', [(10, 'leggauss'), (12, 'trapz'), (np.linspace(0., 1., 7), None)])
def test_to_poles_matches_jax(mu, method):
    rng = np.random.default_rng(4)
    port_mu, port_wmu = port_weights_mu(mu, method=method)
    jax_mu, jax_wmu = weights_mu(mu, method=method)
    np.testing.assert_allclose(port_mu, jax_mu, rtol=1e-14)
    np.testing.assert_allclose(port_wmu, jax_wmu, rtol=1e-14)
    weights = port_multipole_weights((0, 2, 4), port_mu, port_wmu)
    np.testing.assert_allclose(weights, multipole_weights((0, 2, 4), jax_mu, jax_wmu), rtol=1e-14, atol=1e-15)
    pkmu = rng.normal(size=(3, 56, len(port_mu))).astype('f4')
    got = to_poles(torch.from_numpy(pkmu), weights).numpy()
    expected = np.asarray(jax_to_poles(jnp.asarray(pkmu), weights))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('wmatrix', [None, {'resolution': 3}], ids=['centers', 'resolution3'])
def test_observable_data_matches_jax(wmatrix):
    """Window calculator and the self-generated data vector (host float64 in
    the port, float32 in JAX; the JAX vector frozen)."""
    from desilike_tpu_torch import TracerPowerSpectrumMultipolesObservable
    klim = {0: (0.02, 0.2, 0.01), 2: (0.02, 0.2, 0.01)}
    expected = TIER1B['observable_data_' + ('centers' if wmatrix is None else 'resolution3')]
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8))
    observable = TracerPowerSpectrumMultipolesObservable(data={'qpar': 1.01, 'qper': 0.99, 'b1': 2.}, klim=klim,
                                                         wmatrix=wmatrix, theory=theory)
    observable.runtime_info.initialize()
    np.testing.assert_allclose(observable.flatdata, expected, rtol=2e-5, atol=2e-5 * np.abs(expected).max())


@pytest.mark.parametrize('resolution', [1, 3])
def test_window_matrix_matches_jax(resolution):
    edges = [np.arange(0.02, 0.3025, 0.005)] * 2
    kin, matrix = window_matrix_bininteg(edges, resolution=resolution)
    kin_jax, matrix_jax = jax_window_matrix_bininteg(edges, resolution=resolution)
    np.testing.assert_allclose(kin, kin_jax, rtol=1e-14)
    np.testing.assert_allclose(matrix, matrix_jax, rtol=1e-14, atol=1e-15)


def test_whitening_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(12, 12))
    cov = a @ a.T + 12. * np.eye(12)
    np.testing.assert_allclose(whiten_factor(cov), jax_whiten_factor(cov), rtol=1e-12, atol=1e-14)


def test_cholesky_raises_on_non_spd():
    with pytest.raises(ValueError, match='not positive definite'):
        cholesky(torch.tensor([[1., 2.], [2., 1.]], dtype=torch.float64))


def test_damped_bao_matches_golden():
    """The golden vector of tests/test_golden.py, at its tolerance, from a
    float32 evaluation in the port."""
    from test_golden import GOLDEN, K, VALUES
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=K, template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper'), device='cpu')
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames()) | set(pipe.params.names())
    pipe.evaluate({k: v for k, v in VALUES.items() if k in allowed})
    got = theory.power[0].numpy().astype('f8')
    ref = GOLDEN['damped_bao']
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=2e-5)


BAO_VARIANTS = [('fog-damping', '', 'qparqper', 'power', {}),
                ('move-all', '', 'qiso', 'power', {}),
                ('fix-damping', 'recsym', 'qap', 'power3', {}),
                ('standard', 'reciso', 'qisoqap', 'power', {}),
                ('standard', '', 'qparqper', 'power3', {'sigmapar': dict(derived='{sigmaper} * 1.5')})]


@pytest.mark.parametrize('model, mode, apmode, broadband, params', BAO_VARIANTS)
def test_damped_bao_variants_match_jax(model, mode, apmode, broadband, params):
    """The Howlett et al. 2023 models, reconstruction modes, AP modes, the
    3-power broadband and a derived parameter expression, float32 in both
    packages (the JAX power frozen, ``scripts/make_torch_port_reference.py``'s
    ``BAO_VARIANTS`` in the same order), at the golden tolerance."""
    k = np.linspace(0.02, 0.3, 29)
    values = {'qpar': 1.02, 'qper': 0.98, 'qiso': 1.01, 'qap': 0.97, 'b1': 1.8, 'sigmas': 2., 'sigmaper': 5.,
              'dbeta': 1.1, 'df': 1.05, 'al0_0': 300., 'al0_1': -200., 'al2_-2': 50.}
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0, 2), k=k, model=model, mode=mode,
                                                           broadband=broadband,
                                                           template=BAOPowerSpectrumTemplate(z=0.8, apmode=apmode),
                                                           device='cpu')
    if params:
        theory.init.params = params
    pipe = Pipeline(theory)
    pipe.evaluate({name: value for name, value in values.items()
                   if name in pipe.params and not pipe.params[name].fixed})
    got = np.asarray(theory.power, dtype='f8').reshape(2, -1)
    expected = TIER1B['bao_variant_{:d}'.format(BAO_VARIANTS.index((model, mode, apmode, broadband, params)))]
    np.testing.assert_allclose(got, expected, atol=2e-5 * np.max(np.abs(expected)), rtol=2e-5)


@pytest.mark.parametrize('solved', ['.best', None], ids=['best', 'no_solved'])
def test_small_logpost_matches_jax(solved):
    """The other branches of logpost_fn: broadband solved at its best fit
    without the log-determinant ('.best'), and no solved parameters (the
    broadband fixed at 0), on the small config of __graft_entry__ (the JAX
    log-posterior frozen)."""
    from desilike_tpu_torch import TracerPowerSpectrumMultipolesObservable, BoxFootprint, ObservablesGaussianLikelihood
    klim = {0: (0.02, 0.2, 0.01), 2: (0.02, 0.2, 0.01)}
    spec = dict(derived=solved) if solved else dict(fixed=True)
    points = REFERENCE['points'][:4]
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0, 2),
                                                           template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper'))
    theory.init.params = {'al*': spec}
    observable = TracerPowerSpectrumMultipolesObservable(data={'qpar': 1., 'qper': 1., 'b1': 2.}, klim=klim,
                                                         theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device='cpu')
    assert len(like.pipeline.solved_params) == (10 if solved else 0)
    logpost = logpost_and_grad(like, points)[0]
    expected = TIER1B['small_logpost_' + ('best' if solved else 'no_solved')]
    # float32 in both: JAX's own float32 error here is up to 0.032 (against
    # its x64 value), the port's 1.2e-4; in float64 the two agree to 1e-10
    np.testing.assert_allclose(logpost, expected, rtol=0., atol=JAX_F32_ATOL)


def test_logpost_with_loaded_state_matches_jax(loaded_likelihood):
    logpost, grad = logpost_and_grad(loaded_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], JAX_F32_ATOL, JAX_F32_GRAD_RTOL)


def test_logpost_with_own_initialization_matches_jax(own_likelihood):
    logpost, grad = logpost_and_grad(own_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], JAX_F32_ATOL, JAX_F32_GRAD_RTOL)
    # against the JAX package in float64: the port's float32 error alone
    # (measured 2e-4 and 3e-5)
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], 2e-3, 5e-4)


def test_logpost_float64_matches_jax_x64(own_likelihood):
    """Both packages in float64 with their own initialization: the same
    numbers to rounding (measured 1e-10)."""
    config.set_dtype('float64')
    try:
        logpost, grad = logpost_and_grad(own_likelihood, REFERENCE['points'], dtype=torch.float64)
    finally:
        config.set_dtype('float32')
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], 1e-8, 1e-8)


def test_explicit_covariance_matches_footprint(own_likelihood):
    from desilike_tpu_torch import ObservablesGaussianLikelihood
    like = ObservablesGaussianLikelihood(observables=own_likelihood.observables,
                                         covariance=own_likelihood.covariance, device='cpu')
    points = REFERENCE['points'][:4]
    got = logpost_and_grad(like, points)
    expected = logpost_and_grad(own_likelihood, points)
    np.testing.assert_array_equal(got[0], expected[0])
    np.testing.assert_array_equal(got[1], expected[1])


def test_batch_rows_match_single_evaluations(own_likelihood):
    fn = own_likelihood.logpost_fn()
    names = list(REFERENCE['names'])
    points = REFERENCE['points'][:4]
    batch, aux = fn({n: torch.tensor(points[:, i], dtype=torch.float32) for i, n in enumerate(names)})
    assert batch.shape == (4,) and aux['solved']['al0_0'].shape == (4,)
    single = [float(fn(dict(zip(names, row)))[0][0]) for row in points]
    np.testing.assert_allclose(batch.numpy(), single, rtol=0., atol=1e-4)
    assert float(own_likelihood.logpost(**dict(zip(names, points[0])))[0]) == single[0]


def test_reference_file_matches_live_jax():
    """4 points of the reference file, and its state, against a second
    computation of them by the JAX package (config 1 built by
    ``__graft_entry__._build_likelihood`` and one ``jax.jit(jax.vmap(
    jax.value_and_grad))``, frozen by ``make_torch_port_reference.py
    tier1b``). Both files come from the same script, so this runs neither
    package; after a change to the JAX package, regenerating both (``bao``,
    then ``tier1b``) is what keeps them from going stale."""
    names = list(TIER1B['live_names'])
    assert names == list(REFERENCE['names'])
    np.testing.assert_allclose(TIER1B['live_pk_dd_fid'], REFERENCE['pk_dd_fid'], rtol=1e-6)
    np.testing.assert_allclose(TIER1B['live_pknow_dd_fid'], REFERENCE['pknow_dd_fid'], rtol=1e-6)
    np.testing.assert_allclose(TIER1B['live_flatdata'], REFERENCE['flatdata'], rtol=1e-6)
    np.testing.assert_allclose(TIER1B['live_whiten'], REFERENCE['whiten'], rtol=1e-6, atol=1e-12)
    values, grads = TIER1B['live_logpost'], TIER1B['live_grad']
    # same package and dtype: only a different XLA build could move the
    # float32 rounding, which is bounded by the tolerance stated above
    assert_matches(values, grads, REFERENCE['logpost'][:4], REFERENCE['grad'][:4], JAX_F32_ATOL, JAX_F32_GRAD_RTOL)
    assert_matches(values, grads, REFERENCE['logpost_x64'][:4], REFERENCE['grad_x64'][:4], JAX_F32_ATOL, JAX_F32_GRAD_RTOL)


def _golden_theory(**kwargs):
    return DampedBAOWigglesTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=np.linspace(0.02, 0.3, 29), template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper'),
        **kwargs)


@pytest.mark.parametrize('entry', ['likelihood', 'theory'])
def test_default_device_is_the_card(entry):
    """Built with no device, a likelihood or a theory pipeline initializes on
    the host (mock data, covariance, fiducial tables: float64 on the CPU by
    name), and evaluates on the card: here, without one, the first
    evaluation raises instead of returning a CPU result."""
    if entry == 'likelihood':
        like = build_likelihood(device=None)
        assert like.flatdata.shape == (112,) and like.covariance.shape == (112, 112)
        pipe = like.pipeline

        def evaluate():
            return like.logpost(qpar=1., qper=1., b1=2., dbeta=1.)
    else:
        pipe = Pipeline(_golden_theory())
        assert pipe.calculators[1].pk_dd_coeffs_fid.shape == (202,)
        pipe.host_evaluate({'b1': 2.})   # asked for the CPU by name

        def evaluate():
            return pipe.evaluate({'b1': 2.})
    if torch.cuda.is_available():
        assert pipe.device.type == 'cuda' and evaluate().device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            evaluate()
        with pytest.raises(RuntimeError, match='cuda'):
            pipe.run_once({})


def test_cpu_by_name_evaluates_on_the_cpu():
    theory = _golden_theory(device='cpu')
    pipe = Pipeline(theory)
    assert pipe.device == torch.device('cpu')
    pipe.evaluate({'b1': torch.tensor([1.8, 2.])})
    assert theory.power.device.type == 'cpu' and theory.power.dtype == torch.float32
    assert theory.power.shape == (2, 2, 29)


def test_cuda_likelihood_request_raises_without_cuda():
    if torch.cuda.is_available():
        assert build_likelihood(device='cuda').pipeline.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            build_likelihood(device='cuda')
