"""The TNS path of the PyTorch port on the CPU: the A/B correction tables
(``desilike_tpu_torch/ops/tns.py``), the Clenshaw Functions with one row of
x read by every coefficient row (the tables' lookup), and config tns (the
EFT-like TNS full-shape likelihood of ``chip_smoke.build_tns_likelihood``)
at a small width.

Tolerances:

- the A-term's 1D radial kernels, float64 numpy by the same arithmetic in
  both packages: 1e-12 of their largest value;
- the folded contraction (22 static kernels, two batched products) against
  the JAX package's 17 separate products (``TNSCorrections.tables``) on the
  same pk at nq 40, nmu 8: in float64 (the JAX package in x64) 1e-12 of
  each table's largest value (measured 7e-15); in float32 2e-5 (measured
  1.3e-6 against the JAX package's x64 tables);
- a shared x through the Functions against the plain recurrence on the
  expanded x: equal up to the float64 rounding of the same operations
  (1e-12 of the magnitude);
- the TNS xi theories at nq 40, nmu 8 in float32 against the JAX package's
  x64 multipoles frozen in ``tests/data/torch_port_theories_reference.npz``:
  2e-5 of their largest value, as the BAO xi models (measured 1.4e-6 to
  4.4e-6);
- config tns at the small width (nq 40, nmu 8, 48 working points) against
  the frozen JAX x64 values of ``tests/data/torch_port_tns_reference.npz``
  at 16 points: config 3's limits, 2e-2 on the log-posterior and 5e-4 of the
  gradient's norm.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from desilike_tpu.ops import tns as jax_tns
from desilike_tpu_torch.ops import tns, cuda_kernels
from desilike_tpu_torch import Pipeline, theories
import chip_smoke

torch.set_num_threads(2)

REFERENCE = os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tns_reference.npz')
THEORIES = os.path.join(os.path.dirname(__file__), 'data', 'torch_port_theories_reference.npz')
# the two chains of the xi theories, as ``scripts/make_torch_port_reference.py`` froze them
TNS_XI_CHAINS = ({'qpar': 1.02, 'qper': 0.98, 'df': 1.05, 'dm': 0.02, 'b1': 1.8, 'b2': 0.5, 'bs': -0.2, 'b3': 0.3,
                  'sigmav': 3., 'sn0': 0.5, 'ct0_2': 10., 'ct2_2': 5.},
                 {'qpar': 0.99, 'qper': 1.01, 'df': 0.97, 'dm': -0.01, 'b1': 2.1, 'b2': -0.3, 'bs': 0.1, 'b3': -0.4,
                  'sigmav': 5., 'sn0': -0.3, 'ct0_2': -5., 'ct2_2': 2.})
K_WORK = np.geomspace(0.012, 0.34, 48)
LO, HI = 1e-4, 20.


def smooth_pk(k):
    """A positive pk with BAO-like wiggles, zero outside (LO, HI) (numpy)."""
    k = np.asarray(k, dtype='f8')
    kc = np.clip(k, LO, HI)
    return 2e4 * (kc / 0.02) / (1. + (kc / 0.02) ** 2.5) * (1. + 0.05 * np.sin(100. * kc)) * ((k > LO) & (k < HI))


def test_a_correction_kernels_match_jax():
    x = np.concatenate([np.geomspace(1e-3, 100., 700), [0.05, 1., 20.]])
    expected = jax_tns.a_correction_kernels(x)
    np.testing.assert_allclose(tns.a_correction_kernels(x), expected, rtol=0., atol=1e-12 * np.abs(expected).max())


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['float64', 'float32'])
def test_tables_match_jax(dtype):
    """The folded contraction against ``TNSCorrections.tables`` of the JAX
    package in x64 on the same pk, at nq 40, nmu 8, over a batch of two
    chains (the second pk 1.1 times the first)."""
    with jax.enable_x64(True):
        expected = jax_tns.TNSCorrections(K_WORK, qrange=(LO, 10.), nq=40, nmu=8).tables(
            lambda k: jnp.asarray(smooth_pk(np.asarray(k))))
        expected = {key: np.asarray(value) for key, value in expected.items()}
    corrections = tns.TNSCorrections(K_WORK, qrange=(LO, 10.), nq=40, nmu=8, prange=(LO, HI))
    scale = torch.tensor([[1.], [1.1]], dtype=dtype)
    pk_q = torch.tensor(smooth_pk(np.clip(corrections.q, LO, HI)), dtype=dtype) * scale
    pk_k = torch.tensor(smooth_pk(corrections.k), dtype=dtype) * scale
    pk_y = torch.tensor(smooth_pk(np.clip(corrections.y, LO, HI)), dtype=dtype)[None]  # one row: shared
    got = corrections.tables(pk_q, pk_k, pk_y * scale, torch.as_tensor(corrections.kernels, dtype=dtype),
                             torch.as_tensor(corrections.q_kernels, dtype=dtype))
    assert got['A'].shape == (2, 5, 48) and got['B'].shape == (2, 12, 48) and got['sig3sq'].shape == (2, 48)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    for key, table in expected.items():
        for b, factor in enumerate((1., 1.1)):
            # A and B are quadratic in pk, sigma3^2 linear
            want = table * factor ** (1 if key == 'sig3sq' else 2)
            for row_got, row_want in zip(got[key][b].reshape(-1, 48).numpy(), want.reshape(-1, 48)):
                np.testing.assert_allclose(row_got, row_want, rtol=0., atol=tol * np.abs(row_want).max())


def test_shared_x_through_the_functions():
    """One row of x read by every coefficient row (the TNS lookup) through
    :func:`cuda_kernels.clenshaw` on the CPU (the autograd Functions, their
    derivative formulas on the plain versions): the series, the gradient in
    the coefficients, forward mode and vmap against the plain recurrence on
    the expanded x."""
    generator = torch.Generator().manual_seed(0)
    x = torch.rand(1, 37, generator=generator, dtype=torch.float64) * 2. - 1.
    coeffs = torch.randn(5, 20, generator=generator, dtype=torch.float64) / (1. + torch.arange(20.)) ** 2
    weight = torch.randn(5, 37, generator=generator, dtype=torch.float64)
    expanded = x.expand(5, 37)

    def close(got, want):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0.,
                                   atol=1e-12 * float(want.abs().max()))

    for log_values in (True, False):
        c1, c2 = coeffs.clone().requires_grad_(True), coeffs.clone().requires_grad_(True)
        y = cuda_kernels.clenshaw(x, c1, log_values)
        want = cuda_kernels.clenshaw_reference(expanded, c2, log_values)
        close(y, want)
        (y * weight).sum().backward()
        (want * weight).sum().backward()
        close(c1.grad, c2.grad)
        tangent = torch.randn(5, 20, generator=generator, dtype=torch.float64) * 1e-2
        _, got = torch.func.jvp(lambda c: cuda_kernels.clenshaw(x, c, log_values), (coeffs,), (tangent,))
        _, want = torch.func.jvp(lambda c: cuda_kernels.clenshaw_reference(expanded, c, log_values), (coeffs,),
                                 (tangent,))
        close(got, want)
        stacked = coeffs + 1e-2 * torch.randn(3, 5, 20, generator=generator, dtype=torch.float64)
        got = torch.func.vmap(lambda c: cuda_kernels.clenshaw(x, c, log_values))(stacked)
        close(got, torch.stack([cuda_kernels.clenshaw_reference(expanded, c, log_values) for c in stacked]))


def test_config_tns_small_matches_jax_x64():
    """Config tns at the small width on the CPU (float32) against the frozen
    JAX x64 values at 16 points: the log-posterior, its gradient and the
    solved parameters' layout."""
    reference = np.load(REFERENCE)
    like = chip_smoke.build_tns_likelihood('cpu', small=True)
    pipe = like.pipeline
    names = list(reference['small_names'])
    assert pipe.varied_params.names() == names and pipe.solved_params.names() == list(reference['small_solved_names'])
    points = reference['small_points']
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, aux = like.logpost_fn()(values)
    logpost.sum().backward()
    np.testing.assert_allclose(logpost.detach().numpy(), reference['small_logpost_x64'], rtol=0., atol=2e-2)
    grad, ref = torch.stack([values[n].grad for n in names], dim=-1).numpy(), reference['small_grad_x64']
    assert np.max(np.linalg.norm(grad - ref, axis=-1) / np.linalg.norm(ref, axis=-1)) < 5e-4


@pytest.mark.parametrize('cls', ['EFTLikeTNSTracerCorrelationFunctionMultipoles', 'TNSTracerCorrelationFunctionMultipoles'])
def test_xi_forms(cls):
    """The TNS xi theories at nq 40, nmu 8: each builds and, in float32 (the
    pk -> xi step in float64), both chains of one batch give the JAX
    package's x64 multipoles (0, 2) on s = 40-140 Mpc/h, frozen in
    ``tests/data/torch_port_theories_reference.npz``, within 2e-5 of their
    largest value (measured 1.4e-6 to 4.4e-6). sn0 stays inside the width
    the frozen points give it (1): the constant sn0 / nbar has no xi at s >
    0, but at sn0 = 500 (5e6 (Mpc/h)^3) its float32 rounding at every k
    reaches xi at 2.7e-4 of its largest value (measured against the port in
    float64, which is 4e-9 from JAX x64)."""
    reference = np.load(THEORIES)
    theory = getattr(theories, cls)(ells=(0, 2), s=np.linspace(40., 140., 26), nq_tns=40, nmu_tns=8, device='cpu',
                                    template=theories.ShapeFitPowerSpectrumTemplate(z=0.8))
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames())
    pipe.evaluate({key: torch.tensor([chain[key] for chain in TNS_XI_CHAINS]) for key in TNS_XI_CHAINS[0]
                   if key in allowed})
    assert theory.corr.dtype == torch.float32 and theory.corr.shape == (2, 2, 26)
    for i in range(len(TNS_XI_CHAINS)):
        expected = reference['vector:{}_{:d}'.format(cls, i)]
        np.testing.assert_allclose(theory.corr[i].numpy().astype('f8'), expected, rtol=0.,
                                   atol=2e-5 * np.abs(expected).max())
