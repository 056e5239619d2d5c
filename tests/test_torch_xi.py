"""The correlation-function modules of the PyTorch port (``theories``' xi
classes, ``observables/window.py``'s xi window and RR-count window,
``observables/correlation_function.py``, the xi-xi and P(k)-xi branches of
``observables/covariance.py``), on the CPU, against the live JAX package
(its numpy host functions), the golden vectors of
``tests/data/golden_theories.npz`` and the frozen JAX values of
``tests/data/torch_port_xi_reference.npz``.

Tolerances of the theory vectors, at ``tests/test_golden.py``'s parameter
values (2e-5 of the largest value plus 2e-5 relative, its tolerance, unless
said otherwise):

- the port in float64 against the JAX package in float64 (x64): the
  golden tolerance (measured: 3e-13 to 4.4e-9);
- ``damped_bao_xi`` in float32 against its golden vector: the golden
  tolerance (measured 4.7e-6; the JAX package's own float32 is 4.9e-6 from
  its x64 value, the port's 6.6e-7);
- the four with a shot noise, ``ept_xi``, ``ept_xi_resum``, ``kaiser_xi``
  and ``eft_kaiser_xi``: at the golden sn0 = 500 the P(k) monopole holds a
  constant 5e6 beside a signal of 1e4, and its float32 rounding, spread over
  every s by the transform, sets the float32 error. The JAX package's
  float32 vectors (the goldens and ``kaiser_xi``, ``eft_kaiser_xi``) are
  1.1e-2, 2.8e-2, 4.2e-2 and 2.5e-2 of their largest value from its own x64
  ones, so no other float32 evaluation can meet the golden tolerance
  against them. The port in float32 is held against the x64 vectors within
  1e-3 of the largest value (measured: 2.3e-4, 2.7e-4, 1.4e-4 and 3.0e-4,
  the P(k) node's own float32 rounding: the pk -> xi step runs in float64,
  see ``BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles``), and
  against the JAX float32 vectors within the JAX package's own gap to x64
  plus that 1e-3.

Host float64 (windows, covariances): 1e-10 of the largest value (the
covariances measured at 2e-15).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from desilike_tpu.observables.window import window_matrix_RR as jax_window_matrix_RR
from desilike_tpu.observables.window import window_matrix_bininteg as jax_window_matrix_bininteg
from desilike_tpu.theories.base import ap_s_mu as jax_ap_s_mu
from desilike_tpu_torch import (Pipeline, BAOPowerSpectrumTemplate, ShapeFitPowerSpectrumTemplate,
                                DampedBAOWigglesTracerPowerSpectrumMultipoles,
                                DampedBAOWigglesTracerCorrelationFunctionMultipoles,
                                DampedBAOWigglesCorrelationFunctionMultipoles,
                                EPTTracerCorrelationFunctionMultipoles, KaiserTracerCorrelationFunctionMultipoles,
                                EFTLikeKaiserTracerCorrelationFunctionMultipoles,
                                TracerPowerSpectrumMultipolesObservable, TracerCorrelationFunctionMultipolesObservable,
                                BoxFootprint)
from desilike_tpu_torch.observables import (ObservablesCovarianceMatrix, WindowedCorrelationFunctionMultipoles,
                                            window_matrix_RR)
from desilike_tpu_torch.theories import ap_s_mu
from test_golden import GOLDEN, VALUES

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_xi_reference.npz'))
S = np.linspace(40., 140., 26)
SHOT_NOISE_F32_RTOL = 1e-3  # see the module docstring


def build_theory(name):
    """The xi theories of tests/test_golden.py (and the Kaiser ones, built
    alike), on the CPU."""
    if name == 'damped_bao_xi':
        return DampedBAOWigglesTracerCorrelationFunctionMultipoles(
            ells=(0, 2), s=S, template=BAOPowerSpectrumTemplate(z=0.8), device='cpu')
    kwargs = dict(ells=(0, 2), s=S, template=ShapeFitPowerSpectrumTemplate(z=0.8), device='cpu')
    if name == 'ept_xi':
        return EPTTracerCorrelationFunctionMultipoles(resum=None, **kwargs)
    if name == 'ept_xi_resum':
        return EPTTracerCorrelationFunctionMultipoles(**kwargs)
    if name == 'kaiser_xi':
        return KaiserTracerCorrelationFunctionMultipoles(**dict(kwargs, ells=(0, 2, 4)))
    return EFTLikeKaiserTracerCorrelationFunctionMultipoles(**kwargs)


def scaled_error(got, expected):
    return float(np.abs(got - expected).max() / np.abs(expected).max())


@pytest.mark.parametrize('name', ['damped_bao_xi', 'ept_xi', 'ept_xi_resum', 'kaiser_xi', 'eft_kaiser_xi'])
def test_xi_theory_matches_jax(name):
    theory = build_theory(name)
    pipe = Pipeline(theory)
    values = {key: value for key, value in VALUES.items() if key in set(pipe.params.basenames())}
    pipe.evaluate(values, dtype=torch.float64)
    got64 = theory.corr[0].numpy()
    pipe.evaluate(values)
    got32 = theory.corr[0].numpy().astype('f8')
    x64 = REFERENCE[name + '_x64']
    jax32 = GOLDEN[name] if name in GOLDEN.files else REFERENCE[name]
    assert got32.shape == got64.shape == x64.shape == jax32.shape
    np.testing.assert_allclose(got64, x64, atol=2e-5 * np.abs(x64).max(), rtol=2e-5)
    if name == 'damped_bao_xi':
        np.testing.assert_allclose(got32, jax32, atol=2e-5 * np.abs(jax32).max(), rtol=2e-5)
        # the wiggle-only class is the tracer one with no broadband (al* = 0 at these values)
        wiggles = DampedBAOWigglesCorrelationFunctionMultipoles(ells=(0, 2), s=S, template=BAOPowerSpectrumTemplate(z=0.8),
                                                                device='cpu')
        pipe = Pipeline(wiggles)
        assert 'al0_0' not in pipe.params.basenames()
        pipe.evaluate({key: value for key, value in VALUES.items() if key in set(pipe.params.basenames())})
        np.testing.assert_array_equal(wiggles.corr[0].numpy(), got32)
    else:
        assert scaled_error(got32, x64) <= SHOT_NOISE_F32_RTOL
        assert scaled_error(got32, jax32) <= scaled_error(jax32, x64) + SHOT_NOISE_F32_RTOL


def test_window_matrix_RR_matches_jax():
    """The RR-count window with ``tests/test_correlation_observable.py``'s
    inputs: uniform volumetric counts, and counts cut at mu > 0.8, which mix
    the quadrupole into the monopole rows."""
    sedges = np.arange(20., 160.1, 4.)
    muedges = np.linspace(0., 1., 101)
    volume = sedges[1:] ** 3 - sedges[:-1] ** 3
    uniform = np.broadcast_to(volume[:, None], (len(sedges) - 1, len(muedges) - 1)).copy()
    cut = uniform.copy()
    cut[:, muedges[1:] > 0.8] = 0.
    edges = np.arange(40., 120.1, 8.)
    soutedges = {ell: np.column_stack([edges[:-1], edges[1:]]) for ell in (0, 2)}
    for counts in (uniform, cut):
        for resolution, ellsin in ((2, (0, 2)), (1, (0, 2, 4))):
            got = window_matrix_RR(soutedges, sedges, muedges, counts, ellsin=ellsin, resolution=resolution)
            expected = jax_window_matrix_RR(soutedges, sedges, muedges, counts, ellsin=ellsin, resolution=resolution)
            for mine, theirs in zip(got, expected):
                np.testing.assert_allclose(mine, theirs, rtol=0., atol=1e-12 * np.abs(theirs).max())
    assert np.abs(got[1][:len(edges) - 1, len(got[0]):2 * len(got[0])]).max() > 1e-3


def test_xi_window_and_observable():
    """The xi window on ``slim`` (resolution-3 bin integration) and on the RR
    counts feeds its grid to the theory; the observable's data vector is
    the windowed theory at the data parameters."""
    theory = DampedBAOWigglesTracerCorrelationFunctionMultipoles(ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8))
    slim = {0: (48., 152., 4.), 2: (48., 152., 4.)}
    observable = TracerCorrelationFunctionMultipolesObservable(data={'b1': 2.}, slim=slim, theory=theory,
                                                               device='cpu')
    observable.runtime_info.initialize()
    window = observable.wmatrix
    sin, matrix = jax_window_matrix_bininteg(window.sedges, resolution=3)
    np.testing.assert_array_equal(window.sin, sin)
    np.testing.assert_array_equal(window.wmatrix, matrix)
    assert window.wmatrix.shape == (52, 156) and [len(s) for s in window.s] == [26, 26]
    np.testing.assert_array_equal(theory.s, sin)
    assert theory.ells == window.ells == (0, 2)
    pipe = Pipeline(observable)
    flat = pipe.evaluate({'b1': 2.}, dtype=torch.float64)
    np.testing.assert_allclose(flat[0].numpy(), observable.flatdata, rtol=1e-12)
    np.testing.assert_allclose(flat[0].numpy(), matrix @ theory.corr[0].numpy().ravel(), rtol=1e-12)
    sedges = np.arange(20., 160.1, 4.)
    counts = np.ones((len(sedges) - 1, 100))
    rr = WindowedCorrelationFunctionMultipoles(slim={0: (40., 120., 8.), 2: (40., 120., 8.)}, theory=theory,
                                               wmatrix=dict(sedges=sedges, muedges=np.linspace(0., 1., 101),
                                                            wcounts=counts, ellsin=(0, 2, 4)), device='cpu')
    rr.runtime_info.initialize()
    assert rr.wmatrix.shape == (20, 3 * rr.sin.size) and theory.ells == (0, 2, 4)
    assert np.isfinite(Pipeline(rr).evaluate({'b1': 2.})[0].numpy()).all()


def test_pk_xi_covariance_matches_jax():
    """Config 1's P(k) observable beside config xi's observable on one
    footprint: the pk-pk, pk-xi and xi-xi blocks, host float64, against the
    JAX package's x64 matrix."""
    footprint = BoxFootprint(volume=2e9, nbar=5e-4)
    pk = TracerPowerSpectrumMultipolesObservable(
        data={'qpar': 1.0, 'qper': 1.0, 'b1': 2.0}, klim={0: (0.02, 0.3, 0.005), 2: (0.02, 0.3, 0.005)},
        theory=DampedBAOWigglesTracerPowerSpectrumMultipoles(
            ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper')))
    xi = TracerCorrelationFunctionMultipolesObservable(
        data={'qpar': 1.0, 'qper': 1.0, 'b1': 2.0}, slim={0: (48., 152., 4.), 2: (48., 152., 4.)},
        theory=DampedBAOWigglesTracerCorrelationFunctionMultipoles(
            ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper')))
    covariance = ObservablesCovarianceMatrix([pk, xi], footprints=footprint)()
    expected = REFERENCE['covariance_pk_xi']
    assert covariance.shape == expected.shape == (164, 164)
    np.testing.assert_allclose(covariance, expected, rtol=0., atol=1e-10 * np.abs(expected).max())
    assert np.abs(covariance[:112, 112:]).max() > 0.


def test_ap_s_mu_matches_jax():
    """The configuration-space AP remap over a chain batch and without one."""
    s, mu = np.linspace(20., 200., 31), np.linspace(0., 1., 9)
    qpar, qper = np.array([0.97, 1.03]), np.array([1.02, 0.99])
    jac, sap, muap = ap_s_mu(torch.tensor(s), torch.tensor(mu), torch.tensor(qpar), torch.tensor(qper))
    assert jac == 1. and sap.shape == (2, 31, 9) and muap.shape == (2, 1, 9)
    for i in range(2):
        _, expected_s, expected_mu = jax_ap_s_mu(jnp.asarray(s), jnp.asarray(mu), qpar=qpar[i], qper=qper[i])
        np.testing.assert_allclose(sap[i].numpy(), expected_s, rtol=1e-6)
        np.testing.assert_allclose(muap[i, 0].numpy(), expected_mu, rtol=1e-6, atol=1e-7)
    _, sap, _ = ap_s_mu(torch.tensor(s), torch.tensor(mu), 0.97, 1.02)
    assert sap.shape == (31, 9)
