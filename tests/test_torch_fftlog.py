"""The FFTLog Hankel transforms of the PyTorch port (``desilike_tpu_torch/ops/fftlog.py``)
and the static matrices of its pk -> xi step
(``theories/base.py``, ``BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles``),
on the CPU, against the live JAX package and numpy.

Tolerances:

- host-side float64 (output grids, Mellin kernels, the interpolation
  matrices against the functions they stand for): 1e-12 of the largest value;
- the transforms in float64 against the JAX package's, which runs in float32
  here: 2e-6 of the largest value (measured: 7.6e-7, the JAX package's own
  float32 error), and in float32: 5e-6 (measured: 1.5e-6);
- the cubic landing against the JAX package's ``interp1d``, which runs in
  float32 here: 5e-6 of the largest value (measured: 2.5e-6);
- the folded pk -> xi step on rows with 1% noise, whose float32 rounding
  the transform spreads over every s: in float64 against the JAX package's
  loop over multipoles in float32, 2e-5 of the largest value (measured:
  7.3e-6, the JAX side's float32 error), and in float32 against float64,
  1e-5 (measured: 8.2e-8).
"""

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from desilike_tpu.ops import fftlog as jax_fftlog
from desilike_tpu.ops.interp import interp1d
from desilike_tpu.theories.base import BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles as JaxFromPower
from desilike_tpu_torch.ops import fftlog
from desilike_tpu_torch.theories.base import BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles

torch.set_num_threads(2)

K = np.logspace(-4., 3., 2048)  # the grid of the xi theories
S = np.linspace(40., 140., 26)


def smooth_pk(k):
    return 2e4 * k / (1. + (k / 0.02) ** 2) ** 1.3


def batch_rows(shape, seed=0):
    """Rows of pk-like values on K, (*shape, 2048), float64."""
    rng = np.random.default_rng(seed)
    return smooth_pk(K) * (1. + 0.01 * rng.normal(size=tuple(shape) + (K.size,)))


def assert_close(got, expected, rtol):
    expected = np.asarray(expected, dtype='f8')
    np.testing.assert_allclose(np.asarray(got, dtype='f8'), expected, rtol=0., atol=rtol * np.abs(expected).max())


@pytest.mark.parametrize('name', ['SphericalBesselTransform', 'PowerToCorrelation', 'CorrelationToPower'])
def test_transforms_match_jax(name):
    """All three classes at ells (0, 2, 4) over a (2, 3) batch, and a 1D input
    broadcast to every ell: the output grids and the Mellin kernels equal in
    float64, the transforms in float64 and float32."""
    kwargs = dict(ells=(0, 2, 4)) if name == 'SphericalBesselTransform' else dict(ells=(0, 2, 4), q=0)
    port, ref = getattr(fftlog, name)(K, **kwargs), getattr(jax_fftlog, name)(K, **kwargs)
    sbt, ref_sbt = (port, ref) if name == 'SphericalBesselTransform' else (port._sbt, ref._sbt)
    for attr in ('y', '_kernels', '_xq', '_yq'):
        assert_close(getattr(sbt, attr).view('f8') if attr == '_kernels' else getattr(sbt, attr),
                     np.asarray(getattr(ref_sbt, attr)).view('f8') if attr == '_kernels' else getattr(ref_sbt, attr),
                     1e-12)
    f = batch_rows((2, 3, 3))
    expected_grid, expected = ref(jnp.asarray(f))
    grid, got = port(torch.tensor(f))
    assert got.shape == (2, 3, 3, 2048) and got.dtype == torch.float64
    assert_close(grid, expected_grid, 1e-12)
    assert_close(got.numpy(), expected, 2e-6)
    _, got32 = port(torch.tensor(f, dtype=torch.float32))
    assert got32.dtype == torch.float32
    assert_close(got32.numpy(), expected, 5e-6)
    _, got1 = port(torch.tensor(f[0, 0, 0]))
    assert_close(got1.numpy(), ref(jnp.asarray(f[0, 0, 0]))[1], 2e-6)


def test_transform_gradients_through_the_ffts():
    """The transform is linear: in float64, ``gradcheck`` and
    ``gradgradcheck`` through rfft, the real-arithmetic kernel product and
    irfft, and ``torch.func.jvp`` equals the transform of the tangent; an
    input with a zero tail, given short and flipped (``transform_flipped``),
    transforms as the full one, and gradchecks twice."""
    k = np.logspace(-3., 1., 64)
    port = fftlog.PowerToCorrelation(k, ells=(0, 2))
    rng = np.random.default_rng(1)
    pk = torch.tensor(smooth_pk(k) * (1. + 0.01 * rng.normal(size=(3, 2, 64))), requires_grad=True)

    def xi(pk):
        return port(pk)[1]

    assert torch.autograd.gradcheck(xi, (pk,))
    assert torch.autograd.gradgradcheck(xi, (pk,))
    tangent = torch.tensor(rng.normal(size=pk.shape))
    _, directional = torch.func.jvp(xi, (pk.detach(),), (tangent,))
    torch.testing.assert_close(directional, xi(tangent), rtol=1e-10, atol=1e-12 * float(directional.abs().max()))
    # an input zero from its 40th sample on, given as its first 40 samples flipped (zero-padded in the rfft)
    head = pk.detach()[..., :40].clone().requires_grad_(True)
    expected = port._sbt.transform(torch.cat([head.detach(), torch.zeros(3, 2, 24, dtype=head.dtype)], dim=-1))
    torch.testing.assert_close(port._sbt.transform_flipped(head.flip(-1)), expected, rtol=0.,
                               atol=1e-12 * float(expected.abs().max()))
    assert torch.autograd.gradcheck(lambda g: port._sbt.transform_flipped(g), (head,))
    assert torch.autograd.gradgradcheck(lambda g: port._sbt.transform_flipped(g), (head,))


@pytest.fixture(scope='module')
def transforms():
    """The port's pk -> xi node and the JAX package's, initialized on the
    same grids (kin: the default geomspace(1e-4, 0.6, 300)) with a stand-in
    for the power node."""
    port = BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles(
        s=S, power=types.SimpleNamespace(init={'ells': (0, 2)}), ells=(0, 2))
    port.runtime_info.initialize()
    ref = types.SimpleNamespace()
    JaxFromPower.initialize(ref, s=S, power=types.SimpleNamespace(init={'ells': (0, 2)}), ells=(0, 2))
    return port, ref


def test_static_matrices_match_interp1d_and_numpy_interp(transforms):
    """On random rows: the cubic landing equals the JAX package's
    ``interp1d(log10 k, log10 kin, pk, 'cubic')``, the tail its log-slope
    extrapolation, and each multipole's interpolation ``numpy.interp`` from
    the FFTLog output grid onto s."""
    port, ref = transforms
    rng = np.random.default_rng(2)
    pk = smooth_pk(port.kin) * (1. + 0.05 * rng.normal(size=(4, port.kin.size)))
    assert port.landing_mid.shape == (1105, 300) and port.landing_high.shape == (943, 2)
    expected = np.asarray(interp1d(jnp.log10(ref._k_mid), np.log10(ref.kin), jnp.asarray(pk), method='cubic'))
    assert_close(pk @ port.landing_mid.T, expected, 5e-6)  # the JAX side in float32: 2.5e-6 (measured)
    # float64 against the same cubic Hermite written out with numpy
    x, xq = np.log10(port.kin), np.log10(ref._k_mid)
    dx = np.diff(x)
    d = np.diff(pk, axis=-1) / dx
    w = dx[1:] / (dx[:-1] + dx[1:])
    m = np.concatenate([d[:, :1], w * d[:, :-1] + (1. - w) * d[:, 1:], d[:, -1:]], axis=-1)
    i = np.clip(np.searchsorted(x, xq, side='right') - 1, 0, x.size - 2)
    h = dx[i]
    t = (np.clip(xq, x[0], x[-1]) - x[i]) / h
    hermite = ((2 * t ** 3 - 3 * t ** 2 + 1) * pk[:, i] + (t ** 3 - 2 * t ** 2 + t) * h * m[:, i]
               + (-2 * t ** 3 + 3 * t ** 2) * pk[:, i + 1] + (t ** 3 - t ** 2) * h * m[:, i + 1])
    assert_close(pk @ port.landing_mid.T, hermite, 1e-12)
    slope = (pk[:, -1:] - pk[:, -2:-1]) / np.log10(ref.kin[-1] / ref.kin[-2])
    tail = (pk[:, -1:] + slope * ref._logk_high) * ref._damp_high
    assert_close(np.stack([pk[:, -1], pk[:, -1] - pk[:, -2]], axis=-1) @ port.landing_high.T, tail, 1e-12)
    for ill, grid in enumerate(port.fftlog.s):
        rows = rng.normal(size=(4, grid.size))
        assert_close(rows @ port.interp_s[ill].T, [np.interp(S, grid, row) for row in rows], 1e-12)


def test_get_corr_matches_jax(transforms):
    """The folded step, landing, transform and interpolation on a (3, 2, 300)
    batch: in float64 against the JAX package's per-multipole loop, in
    float32 against float64."""
    port, ref = transforms
    rng = np.random.default_rng(3)
    power = smooth_pk(port.kin) * (1. + 0.01 * rng.normal(size=(3, 2, port.kin.size)))
    power[:, 1] *= 0.4
    expected = np.stack([np.asarray(JaxFromPower.get_corr(ref, jnp.asarray(row))) for row in power])
    got = {}
    for dtype in (torch.float64, torch.float32):
        port.dtype = dtype
        got[dtype] = port.get_corr(torch.tensor(power, dtype=dtype))
        assert got[dtype].shape == (3, 2, S.size) and got[dtype].dtype == dtype
    assert_close(got[torch.float64].numpy(), expected, 2e-5)
    assert_close(got[torch.float32].numpy(), got[torch.float64].numpy(), 1e-5)
