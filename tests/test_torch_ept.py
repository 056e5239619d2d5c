"""The 1-loop EPT modules of the PyTorch port (``desilike_tpu_torch/ops/spt.py``,
``ops/spt_fftlog.py``, ``ops/chebyshev.py``'s static design matrix and
``theories/ept.py``), on the CPU, against the live JAX package and the
golden vectors of ``tests/data/golden_theories.npz``.

Tolerances:

- host-side tables (the P13 radial kernels, the FFTLog kernel matrices and
  their real forms, the design matrix), float64 numpy in both packages by
  the same arithmetic: 1e-12 of their largest value;
- float32 per-evaluation work in both packages: the static-matrix landing
  (an exp'd sum of 320 terms) within 1e-5 of its largest value of the same
  product in float64, and of the JAX package's up to that package's own
  float32 error (1.2e-5, measured), the 1-loop tables within 1e-4 of each
  table's largest value (the b22-type tables subtract two terms of similar
  size, 2 int r^2 dr P(kr)^2, in float32);
- the theory against the goldens at the tolerance of ``tests/test_golden.py``
  (2e-5 of the largest value plus 2e-5 relative).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from desilike_tpu.ops import spt as jax_spt
from desilike_tpu.ops.chebyshev import ChebyshevLogInterp as JaxChebyshev
from desilike_tpu.ops.spt_fftlog import FFTLogOneLoop as JaxFFTLog, SIGMA_V2_Q as JAX_SIGMA_V2_Q
from desilike_tpu_torch import Pipeline, EPTTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate
from desilike_tpu_torch.cosmology import background, linear
from desilike_tpu_torch.ops import spt
from desilike_tpu_torch.ops.chebyshev import ChebyshevLogInterp
from desilike_tpu_torch.ops.spt_fftlog import FFTLogOneLoop, SIGMA_V2_Q
from test_golden import GOLDEN, K, VALUES

torch.set_num_threads(2)

K_WORK = np.geomspace(0.012, 0.34, 96)  # config 3's loop working grid: 96 points over the AP-shifted range
K_TEMPLATE = np.geomspace(1e-4, 20., 1200)  # the template grid EPT sets


def assert_host_equal(got, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=0., atol=1e-12 * np.abs(expected).max())


@pytest.fixture(scope='module')
def engines():
    """The FFTLog engine of both packages on config 3's working grid."""
    return FFTLogOneLoop(K_WORK), JaxFFTLog(K_WORK)


def fiducial_pk(k):
    return linear.pk_lin(background.resolve(), np.asarray(k, dtype='f8'), 0.8)


def analytic_pk(k):
    """A smooth pk of k (a torch tensor or a jax array)."""
    return 2e4 * k / (1. + (k / 0.02) ** 2) ** 1.3


def assert_tables_close(got, expected, row=None):
    assert sorted(got) == sorted(expected)
    for name, table in expected.items():
        table = np.asarray(table)
        mine = got[name].numpy() if row is None else got[name][row].numpy()
        assert mine.shape == table.shape, name
        np.testing.assert_allclose(mine, table, rtol=0., atol=1e-4 * np.abs(table).max(), err_msg=name)


def test_spt_kernels_match_jax():
    """The recursion-generated P13 kernels, the b3nl kernel and the analytic
    delta-delta kernel in float64; F2, G2, S2 on an (r, x) grid in float32."""
    r = np.geomspace(1e-3, 1e2, 61)
    for got, expected in zip(spt.p13_radial_kernels(r, nx=64), jax_spt.p13_radial_kernels(r, nx=64)):
        assert_host_equal(got, expected)
    assert_host_equal(spt.sigma3sq_radial_kernel(r), jax_spt.sigma3sq_radial_kernel(r))
    assert_host_equal(spt.p13_kernel_dd_analytic(r), jax_spt.p13_kernel_dd_analytic(r))
    # the recursion against the closed form, as the JAX package checks it (tests/test_spt.py)
    analytic = spt.p13_kernel_dd_analytic(r)
    assert np.abs(spt.p13_radial_kernels(r, nx=120)[0] - analytic).max() / np.abs(analytic).max() < 1e-5
    rr, xx = np.meshgrid(np.geomspace(1e-2, 10., 17), np.linspace(-0.99, 0.99, 9), indexing='ij')
    for name in ('F2_rx', 'G2_rx', 'S2_rx'):
        got = getattr(spt, name)(torch.tensor(rr, dtype=torch.float32), torch.tensor(xx, dtype=torch.float32))
        expected = np.asarray(getattr(jax_spt, name)(jnp.asarray(rr, dtype='f4'), jnp.asarray(xx, dtype='f4')))
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6, atol=1e-6 * np.abs(expected).max())


def test_fftlog_matrices_match_jax(engines):
    """Kernel matrices, their real half-spectrum forms (7 and 3 of (130,
    130)), the exponents, grids and radial kernels, all host float64."""
    port, ref = engines
    assert port._Mr.shape == (7, 130, 130) and port._Mr_b22.shape == (3, 130, 130)
    assert port._names_M == ref._names_M and port._names_b22 == ref._names_b22
    for name in ('_Mr', '_Mr_b22', '_nu_half', '_nu_half_b22', 'x_grid', 'r', 'wr2', 'eta'):
        assert_host_equal(getattr(port, name), getattr(ref, name))
    for group in ('M', 'M_b22', 'K13'):
        assert sorted(getattr(port, group)) == sorted(getattr(ref, group))
        for name, matrix in getattr(ref, group).items():
            assert_host_equal(getattr(port, group)[name], matrix)
    assert_host_equal(SIGMA_V2_Q, JAX_SIGMA_V2_Q)


def test_evaluate_static_matches_jax():
    """The template basis (1200 points, order 320) landed on static points by
    one matrix product, per-chain coefficients, float32: within 1e-5 of the
    largest value; the design matrix equal in float64."""
    port, ref = ChebyshevLogInterp(K_TEMPLATE), JaxChebyshev(K_TEMPLATE)
    assert port.order == ref.order == 320
    points = np.concatenate([np.geomspace(5e-5, 1e2, 128), np.geomspace(2e-4, 15., 500)])
    matrix = port.evaluation_matrix(points)
    assert matrix.shape == (628, 320)
    assert_host_equal(matrix, ref.evaluation_matrix(points))
    rng = np.random.default_rng(0)
    coeffs = port.coeffs(fiducial_pk(K_TEMPLATE)) + 1e-3 * rng.normal(size=(3, 320)) / (1. + np.arange(320))
    got = port.evaluate_static(torch.tensor(coeffs, dtype=torch.float32),
                               torch.tensor(matrix, dtype=torch.float32)).numpy()
    assert got.shape == (3, 628) and got.dtype == np.float32
    expected = np.asarray(ref.evaluate_static(jnp.asarray(coeffs, dtype='f4'), matrix))
    # the same product in float64 on the float32 coefficients: the port is within 2.3e-6 of its largest
    # value, the JAX package's float32 within 1.2e-5 (measured), so the two agree to the JAX package's
    # own error plus 1e-5
    exact = np.exp(coeffs.astype('f4').astype('f8') @ matrix.T)
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1e-5 * scale
    assert np.abs(got - expected).max() <= np.abs(expected - exact).max() + 1e-5 * scale


@pytest.mark.parametrize('batch', [None, 3])
def test_fftlog_tables_match_jax(engines, batch):
    """``tables_from_arrays`` on seeded pk arrays (the fiducial pk tilted by
    a seeded amount a chain), float32 in both packages, with and without a
    chain batch: within 1e-4 of each table's largest value; without, also
    ``tables`` of a pk function."""
    port, ref = engines
    rng = np.random.default_rng(1)
    grids = [port.x_grid, port.k, np.outer(port.k, port.r), SIGMA_V2_Q]
    tilts = 0.1 * rng.normal(size=(batch or 1,))
    arrays = [np.stack([fiducial_pk(g) * np.exp(t * np.log(g / 0.1)) * ((g > 1e-4) & (g < 20.)) for t in tilts])
              for g in grids]
    if batch is None:
        arrays = [a[0] for a in arrays]
    got = port.tables_from_arrays(*(torch.tensor(a, dtype=torch.float32) for a in arrays))
    assert len(got) == 15
    for b in range(batch or 1):
        rows = [a if batch is None else a[b] for a in arrays]
        expected = ref.tables_from_arrays(*(jnp.asarray(a, dtype='f4') for a in rows))
        assert_tables_close(got, expected, None if batch is None else b)
    if batch is None:
        assert_tables_close(port.tables(analytic_pk, device='cpu'), ref.tables(analytic_pk))


def test_quadrature_tables_match_jax():
    """``OneLoopIntegrals.tables`` (the quadrature engine) at nr = 32, nx = 16
    on 20 k, a smooth analytic pk with two chains' amplitudes in the port
    and one call a chain in the JAX package: within 1e-4 of each table's
    largest value. Then the IR-resummed theory through it
    (``loop_method='quadrature'``), two chains in the port, against the
    JAX package's at the golden point and 1.01 times it (frozen: building
    and evaluating the JAX theory took ~20 s of the tier-1 run), at the
    golden tolerance."""
    k = np.geomspace(0.02, 0.3, 20)
    port, ref = spt.OneLoopIntegrals(k, nr=32, nx=16), jax_spt.OneLoopIntegrals(k, nr=32, nx=16)
    assert_host_equal(port.F2, ref.F2)
    for ab in ('dd', 'dt', 'tt'):
        assert_host_equal(port.K13[ab], ref.K13[ab])
    amplitudes = (1., 1.3)

    def batched(kq):
        return torch.tensor(amplitudes, dtype=kq.dtype).reshape((-1,) + (1,) * kq.ndim) * analytic_pk(kq)

    got = port.tables(batched, device='cpu')
    assert len(got) == 15 and got['p22_dd'].shape == (2, 20) and got['sigma_v2'].shape == (2,)
    for b, amplitude in enumerate(amplitudes):
        assert_tables_close(got, ref.tables(lambda kq: amplitude * analytic_pk(kq)), b)
    kwargs = dict(ells=(0, 2), k=K, loop_method='quadrature', nr=32, nx=16)
    theory = EPTTracerPowerSpectrumMultipoles(template=ShapeFitPowerSpectrumTemplate(z=0.8), device='cpu', **kwargs)
    pipe = Pipeline(theory)
    values = {key: value for key, value in VALUES.items() if key in set(pipe.params.basenames())}
    pipe.evaluate({key: torch.tensor([value, 1.01 * value]) for key, value in values.items()})
    # the JAX theory's multipoles at the same points, frozen (float32) by scripts/make_torch_port_reference.py tier1
    frozen = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tier1_reference.npz'))
    for b, scale in enumerate((1., 1.01)):
        expected = frozen['ept_quadrature_power'][b]
        np.testing.assert_allclose(theory.power[b].numpy(), expected, atol=2e-5 * np.abs(expected).max(), rtol=2e-5)


@pytest.mark.parametrize('name, kwargs', [('ept', dict(resum=None)), ('ept_resum', {}),
                                          ('ept_physical', dict(prior_basis='physical', tracer='LRG'))])
def test_theory_matches_golden(name, kwargs):
    """The golden vectors of tests/test_golden.py from a float32 evaluation in
    the port, without and with IR resummation and in the physical basis."""
    theory = EPTTracerPowerSpectrumMultipoles(ells=(0, 2), k=K, template=ShapeFitPowerSpectrumTemplate(z=0.8),
                                              device='cpu', **kwargs)
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames())
    pipe.evaluate({key: value for key, value in VALUES.items() if key in allowed})
    got = theory.power[0].numpy().astype('f8')
    assert theory.power.dtype == torch.float32 and got.shape == GOLDEN[name].shape
    np.testing.assert_allclose(got, GOLDEN[name], atol=2e-5 * np.abs(GOLDEN[name]).max(), rtol=2e-5)
