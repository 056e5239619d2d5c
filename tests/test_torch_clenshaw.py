"""The Clenshaw kernel of the PyTorch port (``desilike_tpu_torch/ops/cuda_kernels.py``).

On the CPU the wrapper takes the plain recurrence, which is held against the
JAX package's Pallas kernel (interpret mode) and its jnp evaluation
(``ChebyshevLogInterp.evaluate``); the derivative series that the kernel's
backward pass evaluates is held against ``jax.grad``. Those JAX values are
frozen in ``tests/data/torch_port_tier1b_reference.npz`` (the tier-1 clock);
the device fit is held against the live JAX package. The kernel itself is
held against the plain version on the card by ``tests/test_torch_gpu.py``.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from desilike_tpu.ops.chebyshev import ChebyshevLogInterp as JaxChebyshevLogInterp
from desilike_tpu_torch import config
from desilike_tpu_torch.cosmology import background, linear
from desilike_tpu_torch.ops import cuda_kernels
from desilike_tpu_torch.ops.chebyshev import ChebyshevLogInterp
from desilike_tpu_torch.ops.cuda_kernels import clenshaw, clenshaw_derivative_coeffs, clenshaw_reference

torch.set_num_threads(2)

# the config-1 template grid: 2000 points over [1e-4, 1], Chebyshev order 202
KGRID = np.geomspace(1e-4, 1., 2000)
# the JAX sides of the comparisons below on the inputs of the tables fixture (the Pallas kernel in
# interpret mode, evaluate, jax.grad in x and, jitted, in the coefficients), float32, frozen for the
# tier-1 clock by scripts/make_torch_port_reference.py tier1b
TIER1B = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tier1b_reference.npz'))


def _frozen(kind, log_values, shared=None):
    key = 'clenshaw_{}_{}'.format(kind, 'exp' if log_values else 'series')
    return TIER1B[key if shared is None else key + ('_shared' if shared else '_per_row')]


@pytest.fixture(scope='module')
def tables():
    """(port interpolator, ln pk coefficients (order,), per-row coefficients (B, order),
    queries x (B, Q)) from seeded numpy."""
    cheb = ChebyshevLogInterp(KGRID)
    coeffs = cheb.coeffs(linear.pk_lin(background.resolve(), KGRID, 0.8))
    rng = np.random.default_rng(0)
    nrows, nq = 6, 37
    rows = coeffs + 1e-3 * rng.normal(size=(nrows, cheb.order)) / (1. + np.arange(cheb.order))
    x = rng.uniform(-0.99, 0.99, size=(nrows, nq))
    out = cheb, coeffs.astype('f4'), rows.astype('f4'), x.astype('f4')
    # the inputs the frozen JAX values were computed on
    for name, value in zip(('coeffs', 'rows', 'x'), out[1:]):
        np.testing.assert_array_equal(value, TIER1B['clenshaw_' + name])
    return out


def _coeffs(tables, shared):
    _, coeffs, rows, x = tables
    return coeffs if shared else rows


# float32 on the CPU in both packages, same operation order: the rtol of
# tests/test_ops.py (1e-5) on the series and on its exp (measured: 2e-7 and
# 1e-6 at order 202).
RTOL = 1e-5


@pytest.mark.parametrize('shared', [True, False], ids=['shared', 'per_row'])
@pytest.mark.parametrize('log_values', [True, False], ids=['exp', 'series'])
def test_reference_matches_pallas_interpret(tables, shared, log_values):
    coeffs, x = _coeffs(tables, shared), tables[3]
    got = clenshaw_reference(torch.from_numpy(x), torch.from_numpy(coeffs), log_values=log_values).numpy()
    expected = _frozen('pallas', log_values, shared)  # clenshaw_pallas(x, coeffs per row, interpret=True)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=0.)


@pytest.mark.parametrize('shared', [True, False], ids=['shared', 'per_row'])
@pytest.mark.parametrize('log_values', [True, False], ids=['exp', 'series'])
def test_evaluate_matches_jax_chebyshev(tables, shared, log_values):
    cheb, coeffs, x = tables[0], _coeffs(tables, shared), tables[3]
    k = np.exp((x.astype('f8') + 1.) / 2. * (cheb.hi - cheb.lo) + cheb.lo).astype('f4')
    port = ChebyshevLogInterp(KGRID, log_values=log_values)
    got = port.evaluate(torch.from_numpy(coeffs), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(k, TIER1B['clenshaw_k'])
    expected = _frozen('evaluate', log_values, shared)  # the JAX evaluate (vmapped over the rows of per_row)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=0.)


@pytest.mark.parametrize('log_values', [True, False], ids=['exp', 'series'])
def test_x_gradient_matches_jax_grad(tables, log_values):
    """dy/dk two ways in the port (autograd through the plain recurrence, and
    the derivative series the kernel's backward evaluates) against jax.grad of
    the jnp evaluation."""
    cheb, coeffs, x = tables[0], tables[1], tables[3]
    k = np.exp((x.astype('f8') + 1.) / 2. * (cheb.hi - cheb.lo) + cheb.lo).astype('f4')
    np.testing.assert_array_equal(k, TIER1B['clenshaw_k'])
    expected = _frozen('x_grad', log_values)  # jax.grad of the JAX evaluate's sum in k

    port = ChebyshevLogInterp(KGRID, log_values=log_values)
    kt = torch.from_numpy(k).requires_grad_(True)
    port.evaluate(torch.from_numpy(coeffs), kt).sum().backward()

    xt = torch.from_numpy(x)
    dslope = clenshaw_reference(xt, clenshaw_derivative_coeffs(torch.from_numpy(coeffs)), log_values=False)
    if log_values:
        dslope = dslope * clenshaw_reference(xt, torch.from_numpy(coeffs), log_values=True)
    dxdk = 2. / ((cheb.hi - cheb.lo) * k)
    # float32 derivative of an order-202 series: the derivative coefficients
    # grow as 2 j c_j, so the relative rounding is ~order times the series'
    scale = np.abs(expected).max()
    np.testing.assert_allclose(kt.grad.numpy(), expected, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(dslope.numpy() * dxdk, expected, rtol=1e-4, atol=1e-5 * scale)


def test_derivative_coeffs_match_recurrence():
    """Closed form of clenshaw_derivative_coeffs against the textbook
    recurrence c'_{j-1} = c'_{j+1} + 2 j c_j, in float64."""
    rng = np.random.default_rng(1)
    c = rng.normal(size=(3, 25))
    d = np.zeros((3, 26))
    for j in range(24, 0, -1):
        d[:, j - 1] = d[:, j + 1] + 2 * j * c[:, j]
    d[:, 0] *= 0.5
    got = clenshaw_derivative_coeffs(torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, d[:, :25], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('order', [1, 2, 3, 5, 202])
def test_zero_padding_is_exact(order):
    """The kernel stages the coefficients zero-padded to a multiple of 4: the
    zero terms above the top degree leave b1 = b2 = 0, so the plain version
    gives bitwise the same values with and without the padding."""
    rng = np.random.default_rng(order)
    x = torch.from_numpy(rng.uniform(-1., 1., size=(3, 41)).astype('f4'))
    for coeffs in (rng.normal(size=order), rng.normal(size=(3, order))):
        c = torch.from_numpy(coeffs.astype('f4'))
        padded = torch.nn.functional.pad(c, (0, -order % 4 or 4))
        assert padded.shape[-1] % 4 == 0 and padded.shape[-1] > order
        for log_values in (True, False):
            assert torch.equal(clenshaw_reference(x, padded, log_values), clenshaw_reference(x, c, log_values))


def _launch_counts(geometry, rows, q):
    """How often the launch described by ``geometry`` evaluates each flat
    (row, query) index, by the index arithmetic of csrc/clenshaw.cu: block b
    walks tiles b, b + grid, ...; the tile-to-query maps are those of
    :class:`ClenshawGeometry`."""
    g, n = geometry, rows * q
    steps = -(-g.tiles // g.grid)
    walked = (np.arange(g.grid)[:, None] + g.grid * np.arange(steps)[None, :]).ravel()
    walked = np.sort(walked[walked < g.tiles])
    np.testing.assert_array_equal(walked, np.arange(g.tiles))  # every tile once
    tid = np.arange(g.threads)
    j = np.arange(g.k)
    counts = np.zeros(n, dtype='u1')
    chunk = max(1, (1 << 21) // (g.threads * g.k))
    for start in range(0, g.tiles, chunk):
        tile = np.arange(start, min(start + chunk, g.tiles))[:, None, None]
        if g.flat:
            flat = (tile * g.threads + tid[None, :, None]) * g.k + j[None, None, :]
            live = flat < n
            if g.per_row:  # a thread's queries lie in one row; a tile's rows fit its window
                row = np.where(live, flat // q, -1)
                first = np.where(live, row, rows).min(axis=2)
                assert (np.where(live, row, first[..., None]) == first[..., None]).all()
                spanned = row.max(axis=(1, 2)) - np.where(live, row, rows).min(axis=(1, 2)) + 1
                assert spanned.max() <= g.rows_per_block
        else:
            r, i = tid // g.row_threads, tid % g.row_threads
            group, col = tile // g.col_tiles, tile % g.col_tiles
            row = group * g.rows_per_block + r[None, :, None]
            qq = col * g.row_threads * g.k + i[None, :, None] + j[None, None, :] * g.row_threads
            live = (r[None, :, None] < g.rows_per_block) & (row < rows) & (qq < q)
            flat = row * q + qq
        flat = flat[live]
        if flat.size:
            lo = flat.min()
            counts[lo:flat.max() + 1] += np.minimum(np.bincount(flat - lo), 2).astype('u1')
    return counts


@pytest.mark.parametrize('rows', [1, 56, 4096, 70000])
@pytest.mark.parametrize('q', [1, 3, 290, 560, 561])
@pytest.mark.parametrize('per_row', [False, True], ids=['shared', 'per_row'])
def test_geometry_covers_every_query_once(rows, q, per_row):
    """The launch geometry, computed here in Python, covers every (row, query)
    once, with a grid stride too, in the flat layout (per-row coefficients
    where K divides Q) and in the row layout; blocks fit the card (threads a
    multiple of 32 up to 512, staged coefficients within 48 KB); at the main
    path's Q = 560 and the golden theory's Q = 290 at most 1/8 of the
    launched query slots idle."""
    order = 202
    per_row = per_row and rows > 1  # as the wrapper: one coefficient row is a shared one
    geometry = cuda_kernels.clenshaw_geometry(rows, q, order, per_row)
    assert geometry.flat == (not per_row or q % geometry.k == 0)
    assert geometry.threads % 32 == 0 and geometry.threads <= 512
    assert geometry.rows_per_block * -(-order // 4) * 16 <= 48 * 1024
    assert geometry.grid == min(geometry.tiles, cuda_kernels.MAX_GRID)
    assert (_launch_counts(geometry, rows, q) == 1).all()
    strided = cuda_kernels.clenshaw_geometry(rows, q, order, per_row, max_grid=7)
    assert strided.grid == min(7, geometry.tiles) and strided._replace(grid=geometry.grid) == geometry
    assert (_launch_counts(strided, rows, q) == 1).all()
    if q in (290, 560):
        assert geometry.idle <= cuda_kernels.IDLE_LIMIT == 1. / 8.


def test_kobs_lookup_is_one_block():
    """The (56, 1) lookup of pknow at the observed k: one block of 32 threads
    (the first design launched 56 blocks of 256)."""
    geometry = cuda_kernels.clenshaw_geometry(56, 1, 202, False)
    assert geometry.grid == geometry.tiles == 1 and geometry.threads == 32
    main = cuda_kernels.clenshaw_geometry(4096, 560, 202, False)
    assert main.k == cuda_kernels.QUERIES_PER_THREAD and main.tiles == 4096 * 560 // (256 * main.k)
    with pytest.raises(ValueError, match='queries_per_thread'):
        cuda_kernels.clenshaw_geometry(56, 1, 202, False, queries_per_thread=7)


def test_cpu_tensor_takes_plain_version(tables):
    coeffs, x = tables[1], tables[3]
    before = cuda_kernels.CLENSHAW_LAUNCHES
    got = clenshaw(torch.from_numpy(x), torch.from_numpy(coeffs))
    expected = clenshaw_reference(torch.from_numpy(x), torch.from_numpy(coeffs))
    assert torch.equal(got, expected)
    assert cuda_kernels.CLENSHAW_LAUNCHES == before


def test_other_device_raises_without_fallback(tables):
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor (no CUDA device to hand) must raise, not fall back."""
    x = torch.empty((2, 3), device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        clenshaw(x, torch.empty(5, device='meta'))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_kernels, '_LIBRARY', None)
    monkeypatch.setattr(cuda_kernels, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        cuda_kernels.library()


def test_cuda_device_request_raises_without_cuda():
    if torch.cuda.is_available():
        assert config.device('cuda').type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            config.device('cuda')


# --- the Chebyshev fit on the device and the coefficient gradient ---

def _shapefit_tables(nrows=5, seed=7):
    """Per-chain tables (B, nk): the ln pk table tilted as ShapeFit does, float32."""
    rng = np.random.default_rng(seed)
    pk = linear.pk_lin(background.resolve(), KGRID, 0.8)
    lnkkp = np.log(KGRID / 0.03)
    dm = rng.uniform(-0.1, 0.1, size=(nrows, 1))
    return (pk * np.exp(dm / 0.6 * np.tanh(0.6 * lnkkp))).astype('f4')


@pytest.mark.parametrize('log_values', [True, False], ids=['log', 'linear'])
def test_device_fit_matches_jax_coeffs(log_values):
    """coeffs() on a tensor of per-chain tables (two matmuls in float32)
    against the JAX package's coeffs() on the same float32 tables: both sum
    2000 and then 202 float32 products in another order, so they agree to
    1e-5 of the largest coefficient (measured 6e-7); and against the host
    float64 fit, to the same level."""
    tables = _shapefit_tables()
    port = ChebyshevLogInterp(KGRID, log_values=log_values)
    got = port.coeffs(torch.from_numpy(tables))
    assert got.dtype == torch.float32 and got.shape == (5, port.order)
    expected = np.asarray(JaxChebyshevLogInterp(KGRID, log_values=log_values).coeffs(jnp.asarray(tables)))
    scale = np.abs(expected).max()
    np.testing.assert_allclose(got.numpy(), expected, rtol=0., atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), port.coeffs(tables.astype('f8')), rtol=0., atol=1e-5 * scale)


def test_device_fit_is_differentiable():
    """The gradient of a lookup through the fit, with respect to the table,
    in float64: autograd against central differences."""
    port = ChebyshevLogInterp(KGRID)
    tables = torch.from_numpy(_shapefit_tables(2).astype('f8')).requires_grad_(True)
    k = torch.tensor([[0.02, 0.1], [0.05, 0.2]], dtype=torch.float64)
    port.evaluate(port.coeffs(tables), k).sum().backward()
    i, eps = 1200, 1e-3
    with torch.no_grad():
        step = torch.zeros_like(tables)
        step[0, i] = eps * tables[0, i]
        diff = (port.evaluate(port.coeffs(tables + step), k).sum()
                - port.evaluate(port.coeffs(tables - step), k).sum()) / (2. * step[0, i])
    np.testing.assert_allclose(tables.grad[0, i].item(), diff.item(), rtol=1e-5)


@pytest.mark.parametrize('shared', [True, False], ids=['shared', 'per_row'])
@pytest.mark.parametrize('log_values', [True, False], ids=['exp', 'series'])
def test_coeff_grad_reference_matches_jax_grad(tables, shared, log_values):
    """clenshaw_coeff_grad_reference (the forward T_j recurrence, float32)
    against jax.grad of the JAX package's evaluate with respect to the
    coefficients (autodiff of its backward recurrence, float32), and against
    autograd through the port's plain series in float64. The two float32
    recurrences differ by ~2e-5 of the gradient's magnitude at order 202, so
    1e-4 against JAX; 5e-5 against float64 (measured 6e-6)."""
    cheb, coeffs, x = tables[0], _coeffs(tables, shared), tables[3]
    k = np.exp((x.astype('f8') + 1.) / 2. * (cheb.hi - cheb.lo) + cheb.lo).astype('f4')
    grad_y = np.random.default_rng(8).normal(size=x.shape).astype('f4')
    np.testing.assert_array_equal(k, TIER1B['clenshaw_k'])
    np.testing.assert_array_equal(grad_y, TIER1B['clenshaw_grad_y'])
    # jax.jit(jax.grad) in the coefficients of sum(evaluate(c, k) * grad_y), the JAX evaluate vmapped per row
    expected = _frozen('coeff_grad', log_values, shared)
    # the queries as the port's evaluate() normalizes them, so that both differentiate at the same x
    lnk = torch.log(torch.from_numpy(k))
    xt = torch.clamp((lnk - cheb.lo) / (cheb.hi - cheb.lo) * 2. - 1., -1., 1.)
    w = torch.from_numpy(grad_y)
    if log_values:
        w = w * clenshaw_reference(xt, torch.from_numpy(coeffs), True)
    got = cuda_kernels.clenshaw_coeff_grad_reference(xt, w, cheb.order, per_row=not shared).numpy()
    assert got.shape == coeffs.shape
    scale = np.abs(expected).max()
    np.testing.assert_allclose(got, expected, rtol=0., atol=1e-4 * scale)

    c64 = torch.from_numpy(coeffs.astype('f8')).requires_grad_(True)
    (clenshaw_reference(xt.double(), c64, log_values) * torch.from_numpy(grad_y).double()).sum().backward()
    np.testing.assert_allclose(got, c64.grad.numpy(), rtol=0., atol=5e-5 * scale)


def test_cpu_coeff_grad_takes_plain_version(tables):
    """On the CPU the wrapper takes the plain version and launches nothing;
    its gradient and that of autograd through the plain recurrence agree
    (float64: to rounding), and clenshaw()'s backward gives it too."""
    coeffs, x = torch.from_numpy(tables[2]).double(), torch.from_numpy(tables[3]).double()
    w = torch.from_numpy(np.random.default_rng(9).normal(size=tuple(x.shape)))
    before = cuda_kernels.COEFF_GRAD_LAUNCHES
    got = cuda_kernels.clenshaw_coeff_grad(x, w, coeffs.shape[-1])
    assert torch.equal(got, cuda_kernels.clenshaw_coeff_grad_reference(x, w, coeffs.shape[-1]))
    for series in (clenshaw_reference, clenshaw):
        c = coeffs.clone().requires_grad_(True)
        (series(x, c, log_values=False) * w).sum().backward()
        np.testing.assert_allclose(got.numpy(), c.grad.numpy(), rtol=0., atol=1e-12 * float(c.grad.abs().max()))
    assert cuda_kernels.COEFF_GRAD_LAUNCHES == before
    with pytest.raises(ValueError, match='CUDA tensor'):
        cuda_kernels.clenshaw_coeff_grad(torch.empty((2, 3), device='meta'), torch.empty((2, 3), device='meta'), 5)


def _coeff_grad_walk(g, rows, q):
    """The units (row, tile) that the launch ``g`` computes and copies, by
    the index arithmetic of csrc/clenshaw_coeff_grad.cu: team t (of T =
    grid x warps x 2, half a warp each) walks rows t, t + T, ..., each tile
    by tile; the loop runs as often for both teams of a warp as for its first
    team. A prefetching team loads its unit 0 directly and calls
    copy_next(k), which copies unit k + 1 where it exists and its row is <
    rows, before the loop (k = 0) and in the iteration of each unit k >= 1.
    Returns the units computed and copied (row x tiles + tile), and, by team
    and unit, which were copied and which computed."""
    teams = g.grid * g.warps * 2
    first = np.arange(g.grid * g.warps) * 2  # each warp's first team
    units = np.where(first < rows, -(-(rows - first) // teams) * g.tiles, 0)
    team = (first[:, None] + np.arange(2)[None, :]).ravel()
    units = np.repeat(units, 2)
    k = np.arange(units.max(initial=0) + 1)[None, :]
    row = team[:, None] + (k // g.tiles) * teams
    unit = row * g.tiles + k % g.tiles
    active = k < units[:, None]
    live = active & (row < rows)
    calls = (k == 0) | ((k >= 1) & active)  # copy_next(k): before the loop, then in iterations 1, 2, ...
    issued = np.zeros_like(live)  # issued[:, k]: unit k copied, by copy_next(k - 1)
    issued[:, 1:] = calls[:, :-1] & (k[:, 1:] < units[:, None]) & (row[:, 1:] < rows)
    return unit[live], unit[issued], issued, live


@pytest.mark.parametrize('rows', [1, 15, 4096, 4097, 70000])
@pytest.mark.parametrize('q', [1, 3, 288, 560, 561, 1200])
@pytest.mark.parametrize('per_row', [False, True], ids=['shared', 'per_row'])
@pytest.mark.parametrize('sms', [132, 1])
def test_coeff_grad_geometry_covers_every_query_once(rows, q, per_row, sms):
    """The coefficient-gradient kernel's geometry, computed in Python, and
    its index arithmetic simulated (``_coeff_grad_walk``): teams of half a
    warp, a persistent grid of sms x resident blocks (2 an SM here; the
    card's occupancy on the card) and a cap of 7 blocks. Every row is
    computed once, tile by tile; every query of a tile is held by one (lane,
    slot) and copied by one 16-byte granule of one lane; a prefetching launch
    loads each team's first unit directly and copies every later unit it
    computes once, while the unit before it computes, and nothing past the
    last row. nq is a compiled value, blocks hold 1 to 8 warps, dynamic
    shared memory stays within 48 KB (within 227 KB with the prefetch
    buffers, which are 16-byte aligned and put the two teams of a warp on
    other banks), and the main path's Q = 288 idles no slot (Q = 560: two
    tiles of 288, 1/36)."""
    order, resident, lanes = 202, 2, cuda_kernels.COEFF_GRAD_LANES
    for max_grid in (cuda_kernels.MAX_GRID, 7):
        g = cuda_kernels.coeff_grad_geometry(rows, q, order, per_row, sms, resident, max_grid)
        assert g.nq in cuda_kernels._COEFF_GRAD_NQS and 1 <= g.warps <= 8
        assert g.warps == min(8, -(-rows // 2), 48 * 1024 // (4 * 208) if not per_row else 8)
        assert g.grid == min(-(-rows // (2 * g.warps)), max_grid, sms * resident, 1056 if not per_row else max_grid)
        assert g.prefetch == (per_row and q % 4 == 0)
        assert not cuda_kernels.coeff_grad_geometry(rows, q, order, per_row, sms, resident, max_grid,
                                                    aligned=False).prefetch
        floats = cuda_kernels.coeff_grad_buffer_floats(g.nq)
        if g.prefetch:
            assert floats >= 3 * lanes * g.nq and floats % 4 == 0 and floats % 32 == 16
            assert g.smem == 4 * floats * 2 * g.warps <= 227 * 1024 - 21504  # beside the static fold tiles
        else:
            assert g.smem == (0 if per_row else 4 * 208 * g.warps) <= 48 * 1024
        computed, prefetched, issued, live = _coeff_grad_walk(g, rows, q)
        np.testing.assert_array_equal(np.sort(computed), np.arange(rows * g.tiles))
        if g.prefetch:  # unit 0 loaded directly, each later one copied once, just before it is computed
            assert not issued[:, 0].any()
            np.testing.assert_array_equal(issued[:, 1:], live[:, 1:])
            assert prefetched.size == 0 or prefetched.max() < rows * g.tiles
        # queries of a tile: lane l, slot n -> 16 nq s + l + 16 n; copies: 16-byte granule i -> lane i % 16
        width = lanes * g.nq
        qq = (width * np.arange(g.tiles)[:, None, None] + np.arange(lanes)[None, :, None]
              + lanes * np.arange(g.nq)[None, None, :]).ravel()
        np.testing.assert_array_equal(np.sort(qq[qq < q]), np.arange(q))
        assert g.idle == pytest.approx(1. - q / qq.size)
        if g.prefetch:  # lane l of a team copies the granules l, l + 16, ... of the tile's floats
            copied = np.concatenate([width * s + 4 * np.arange(l, min(width, q - width * s) // 4, lanes)[:, None]
                                     + np.arange(4)[None, :] for s in range(g.tiles) for l in range(lanes)], axis=None)
            np.testing.assert_array_equal(np.sort(copied), np.arange(q))
        if q == 288:
            assert g.nq == 18 and g.tiles == 1 and g.idle == 0.
        if q == 560:
            assert g.nq == 18 and g.tiles == 2 and g.idle == pytest.approx(1. / 36.)
