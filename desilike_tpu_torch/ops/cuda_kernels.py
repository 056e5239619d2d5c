"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions.

Counterpart of ``desilike_tpu/ops/pallas_kernels.py``. Each kernel has:

- a wrapper that takes the plain version for a tensor on the CPU and, for a
  CUDA tensor, launches the kernel or raises (no fallback);
- the plain PyTorch version in this module, which is the CPU path and the
  oracle the kernel is checked against on the card;
- a launch counter (``CLENSHAW_LAUNCHES``, ``COEFF_GRAD_LAUNCHES``),
  increased only where the kernel is launched.

Two kernels: the Clenshaw series (:func:`clenshaw`, forward, and its
x-gradient by the same kernel on the derivative series) and its gradient
with respect to the coefficients (:func:`clenshaw_coeff_grad`), which
:func:`clenshaw` reaches in its backward pass when the coefficients require
a gradient (ShapeFit's per-chain tables). Both take x as (B, Q), or, with
one coefficient row a row, as one row (1, Q) that every row reads (shared
x: a static grid looked up with each chain's coefficients, such as the TNS
tables' 460800 points, with no (B, Q) copy of it).

The CUDA sources live in ``desilike_tpu_torch/csrc``. At first use they are
compiled with ``nvcc`` for ``sm_90a`` (one process a source, started
together) and linked into a plain-C shared library under
``desilike_tpu_torch/build/``, named by a hash of the sources and flags (an
edit rebuilds it), and loaded with ``ctypes``. The kernels' launch
geometries are computed here (:func:`clenshaw_geometry`,
:func:`coeff_grad_geometry`), so that the CPU tests can check that they
cover every query once.
"""

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

CLENSHAW_LAUNCHES = 0
"""Launches of the CUDA Clenshaw kernel (the series, and the derivative series of its x-gradient)
since the last reset."""

COEFF_GRAD_LAUNCHES = 0
"""Launches of the CUDA coefficient-gradient kernel since the last reset."""

LAST_GEOMETRY = None
"""The :class:`ClenshawGeometry` of the last launch of the Clenshaw kernel."""

LAST_COEFF_GRAD_GEOMETRY = None
"""The :class:`CoeffGradGeometry` of the last launch of the coefficient-gradient kernel."""

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = tuple(os.path.join(_PACKAGE_DIR, 'csrc', name) for name in ('clenshaw.cu', 'clenshaw_coeff_grad.cu'))
BUILD_DIR = os.path.join(_PACKAGE_DIR, 'build')
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
               '-Xptxas', '-v')

QUERIES_PER_THREAD = 4
"""K, the queries a thread of the Clenshaw kernel evaluates by default."""
_KS = (8, 4, 2)             # the K the kernel is compiled for
_ROW_KS = (4, 8, 2)         # per-row coefficients: the K tried, in turn, for the flat layout
_MAX_ORDER = 12288          # a padded coefficient row fits the 48 KB of shared memory that needs no opt-in
_SMEM_BYTES = 48 * 1024
_THREADS = 256              # most threads a block of the flat layout, and column tile of long rows
_MAX_ROW_THREADS = 512      # row layout: most threads a block, and longest row kept in one tile
MAX_GRID = 65535            # most blocks a launch; past it the blocks walk their tiles with a grid stride
IDLE_LIMIT = 1. / 8.        # K is lowered when it would leave more of the launched query slots idle
_ROW_IDLE = 1. / 16.        # row-layout blocks grow by a row only while more than this idles

ClenshawGeometry = collections.namedtuple(
    'ClenshawGeometry', ['k', 'per_row', 'flat', 'threads', 'rows_per_block', 'row_threads', 'col_tiles',
                         'tiles', 'grid', 'idle'])
ClenshawGeometry.__doc__ = """Launch geometry of the Clenshaw kernel (see ``csrc/clenshaw.cu``).

k: queries a thread; threads: a block; tiles: units of work, walked by ``grid``
blocks with a grid stride; rows_per_block: the coefficient rows a block
stages. Flat layout (``flat``): tile t is the flat queries [t threads k,
(t + 1) threads k) of the rows x q index space, k consecutive ones a thread;
per-row coefficients take it only when k divides q, and each tile stages the
rows it spans. Row layout (per-row coefficients otherwise): tile t is rows
[g R, g R + R) (g = t // col_tiles, R = rows_per_block) and, within each, the
queries s W k + i + j W (s = t % col_tiles, W = row_threads, thread r W + i,
j < k). idle: the share of the launched query slots (tiles x threads x k)
that hold no query."""


def _round_up(value, multiple):
    return -(-value // multiple) * multiple


def _flat_geometry(rows, q, order, per_row, k, max_grid):
    """The flat layout, or None where the rows a per-row tile spans do not fit 48 KB."""
    n = rows * q
    threads = min(_THREADS, _round_up(-(-n // k), 32))
    window = 1
    if per_row:
        most = _SMEM_BYTES // (_round_up(order, 4) * 4)
        while threads > 32 and (threads * k - 1) // q + 2 > most:
            threads -= 32
        window = min(rows, (threads * k - 1) // q + 2)
        if window > most:
            return None
    tiles = -(-n // (threads * k))
    return ClenshawGeometry(k, per_row, True, threads, window, 0, 1, tiles, min(tiles, max_grid),
                            1. - n / (tiles * threads * k))


def _row_geometry(rows, q, order, k, max_grid):
    n = rows * q
    row_threads = -(-q // k)
    if row_threads > _MAX_ROW_THREADS:
        col_tiles = -(-row_threads // _THREADS)
        row_threads = _THREADS
        candidates = [1]
    else:
        col_tiles = 1
        most = min(rows, _MAX_ROW_THREADS // row_threads, _SMEM_BYTES // (_round_up(order, 4) * 4))
        candidates = range(1, max(1, most) + 1)
    best = None
    for rows_per_block in candidates:  # the fewest rows that idle at most 1/16, else the least idle
        threads = _round_up(rows_per_block * row_threads, 32)
        tiles = -(-rows // rows_per_block) * col_tiles
        idle = 1. - n / (tiles * threads * k)
        if best is None or idle < best.idle:
            best = ClenshawGeometry(k, True, False, threads, rows_per_block, row_threads, col_tiles, tiles,
                                    min(tiles, max_grid), idle)
        if idle <= _ROW_IDLE:
            break
    return best


@functools.lru_cache(maxsize=256)
def clenshaw_geometry(rows, q, order, per_row, queries_per_thread=None, max_grid=MAX_GRID):
    """Launch geometry of the Clenshaw kernel for x (rows, q) and ``order``
    coefficients, shared or one row per row (``per_row``).

    Per-row coefficients take the flat layout with the first K (of
    ``queries_per_thread`` if given, else 4, 8, 2) that divides q and idles
    at most :data:`IDLE_LIMIT`, where the rows a tile spans fit 48 KB; else
    the row layout (odd q, such as 1, 3 or 561, or orders whose padded rows
    leave 48 KB too small for the rows a tile spans). For shared
    coefficients and the row layout, K is ``queries_per_thread`` (default
    :data:`QUERIES_PER_THREAD`) unless that leaves more than
    :data:`IDLE_LIMIT` of the launched slots idle (a launch of one small
    block, such as a (56, 1) lookup), and then the largest smaller K that
    does not (or, failing all, the one that idles least). Row-layout blocks
    hold the fewest rows that idle at most 1/16, within 512 threads and
    48 KB of staged coefficients. Returns a :class:`ClenshawGeometry`.
    """
    if queries_per_thread is not None and queries_per_thread not in _KS:
        raise ValueError('queries_per_thread {} not one of {}'.format(queries_per_thread, _KS))
    if per_row:
        for k in (_ROW_KS if queries_per_thread is None else (queries_per_thread,)):
            geometry = _flat_geometry(rows, q, order, True, k, max_grid) if q % k == 0 else None
            if geometry is not None and geometry.idle <= IDLE_LIMIT:
                return geometry
    wanted = QUERIES_PER_THREAD if queries_per_thread is None else queries_per_thread
    best = None
    for k in _KS:
        if k > wanted:
            continue
        geometry = _row_geometry(rows, q, order, k, max_grid) if per_row else \
            _flat_geometry(rows, q, order, False, k, max_grid)
        if geometry.idle <= IDLE_LIMIT:
            return geometry
        if best is None or geometry.idle < best.idle:
            best = geometry
    return best


_LIBRARY = None
BUILD_INFO = {}
"""Set by :func:`library`: 'path', 'seconds' (build and load) and 'log' (nvcc's output)."""


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH: '
                           'cannot build the CUDA kernels')
    return found


def library():
    """Build (once per source hash) and load the kernel library; raises on failure."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    t0 = time.perf_counter()
    digest = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
    for path in _SOURCES:
        with open(path, 'rb') as file:
            digest.update(file.read())
    target = os.path.join(BUILD_DIR, 'libdesilike_kernels_{}.so'.format(digest.hexdigest()[:16]))
    log = ''
    if not os.path.isfile(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # in a directory of its own, then renamed: concurrent processes never load a partial file
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objects = [os.path.join(tmp, os.path.basename(path) + '.o') for path in _SOURCES]
            cmds = [[nvcc, *_NVCC_FLAGS, '-c', '-o', obj, path] for obj, path in zip(objects, _SOURCES)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]  # one nvcc a source, all started together
            cmds.append([nvcc, '-shared', '-o', os.path.join(tmp, 'lib.so'), *objects])
            outputs = [proc.communicate()[0] for proc in procs]
            codes = [proc.returncode for proc in procs]
            if not any(codes):
                link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                outputs.append(link.stdout)
                codes.append(link.returncode)
            if any(codes):
                raise RuntimeError('building the CUDA kernels failed:\n{}'.format('\n'.join(
                    '{}\n{}'.format(' '.join(cmd), out) for cmd, out in zip(cmds, outputs))))
            os.replace(cmds[-1][3], target)
        log = ''.join(outputs)
    lib = ctypes.CDLL(target)
    lib.clenshaw_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.clenshaw_f32.restype = ctypes.c_int
    lib.clenshaw_coeff_grad_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.clenshaw_coeff_grad_f32.restype = ctypes.c_int
    lib.clenshaw_coeff_grad_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.clenshaw_coeff_grad_occupancy.restype = ctypes.c_int
    BUILD_INFO.update(path=target, seconds=time.perf_counter() - t0, log=log)
    _LIBRARY = lib
    return lib


def clenshaw_reference(x, coeffs, log_values=True):
    """Plain PyTorch Clenshaw recurrence (the kernel's oracle and CPU path).

    x : (B, Q) queries in [-1, 1], or (1, Q) read by every coefficient row
    coeffs : (order,) shared by all rows, or (B, order) one row per row of x
    Returns (B, Q) series values, exp'd if ``log_values``.
    """
    c = coeffs[:, None, :] if coeffs.ndim == 2 else coeffs
    two_x = 2. * x
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for j in range(coeffs.shape[-1] - 1, 0, -1):
        b1, b2 = two_x * b1 - b2 + c[..., j], b1
    out = c[..., 0] + x * b1 - b2
    if log_values:
        out = torch.exp(out)
    return out


def clenshaw_derivative_coeffs(coeffs):
    """Coefficients (same length, full c_0 convention) of dS/dx for the
    series S = sum_j c_j T_j(x) evaluated by :func:`clenshaw_reference`.

    Standard recurrence c'_{j-1} = c'_{j+1} + 2 j c_j (c'_{order-1} =
    c'_{order} = 0), written in closed form: c'_k = sum of 2 j c_j over j > k
    with j - k odd, i.e. reversed cumulative sums over odd and even j; c'_0
    is halved for the full-c_0 convention.
    """
    order = coeffs.shape[-1]
    j = torch.arange(order, device=coeffs.device)
    a = 2. * j.to(coeffs.dtype) * coeffs
    odd = (j % 2 == 1)
    zero = torch.zeros_like(a)

    def tail_sums(t):  # sum_{i >= k} t_i, shifted to start at k + 1
        s = t.flip(-1).cumsum(-1).flip(-1)
        return torch.cat([s[..., 1:], s[..., :1] * 0.], dim=-1)

    from_odd = tail_sums(torch.where(odd, a, zero))
    from_even = tail_sums(torch.where(odd, zero, a))
    deriv = torch.where(odd, from_even, from_odd)
    return torch.cat([0.5 * deriv[..., :1], deriv[..., 1:]], dim=-1)


def _shared_x(x, coeffs):
    """Whether x is one row (1, Q) read by each of several coefficient rows."""
    return coeffs.ndim == 2 and x.shape[0] == 1 and coeffs.shape[0] > 1


def _launch_clenshaw(x, coeffs, log_values, queries_per_thread=None, max_grid=MAX_GRID):
    global CLENSHAW_LAUNCHES, LAST_GEOMETRY
    if x.device.type != 'cuda':
        raise ValueError('the CUDA Clenshaw kernel needs a CUDA tensor, got one on {}'.format(x.device))
    if coeffs.device != x.device:
        raise ValueError('x is on {} but coeffs on {}'.format(x.device, coeffs.device))
    if x.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError('the CUDA Clenshaw kernel takes float32, got x {} and coeffs {}'.format(x.dtype, coeffs.dtype))
    if x.ndim != 2 or coeffs.ndim not in (1, 2):
        raise ValueError('expected x (B, Q) and coeffs (order,) or (B, order), got {} and {}'.format(
            tuple(x.shape), tuple(coeffs.shape)))
    rows, q = x.shape
    order = coeffs.shape[-1]
    shared_x = _shared_x(x, coeffs)
    if shared_x:
        rows = coeffs.shape[0]
    if coeffs.ndim == 2 and coeffs.shape[0] != rows:
        raise ValueError('coeffs has {} rows for {} rows of x'.format(coeffs.shape[0], rows))
    if not (x.is_contiguous() and coeffs.is_contiguous()):
        raise ValueError('the CUDA Clenshaw kernel takes contiguous tensors')
    if not 1 <= order <= _MAX_ORDER:
        raise ValueError('order {} outside [1, {}]: a padded coefficient row must fit 48 KB of shared '
                         'memory'.format(order, _MAX_ORDER))
    out = torch.empty((rows, q), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    per_row = coeffs.ndim == 2 and rows > 1  # one coefficient row is a shared one
    geometry = clenshaw_geometry(rows, q, order, per_row, queries_per_thread, max_grid)
    # float4 loads and stores: a view with a storage offset takes the scalar path
    vec = geometry.flat and geometry.k % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.clenshaw_f32(x.data_ptr(), coeffs.data_ptr(), out.data_ptr(), rows, q, order, int(per_row),
                               int(bool(log_values)), geometry.k, int(vec), int(geometry.flat), geometry.threads,
                               geometry.rows_per_block, geometry.row_threads, geometry.col_tiles,
                               geometry.tiles, geometry.grid, int(shared_x), stream)
    if err != 0:
        raise RuntimeError('CUDA Clenshaw kernel launch failed with cudaError {:d}'.format(err))
    CLENSHAW_LAUNCHES += 1
    LAST_GEOMETRY = geometry
    return out


CoeffGradGeometry = collections.namedtuple(
    'CoeffGradGeometry', ['nq', 'warps', 'grid', 'smem', 'prefetch', 'tiles', 'idle'])
CoeffGradGeometry.__doc__ = """Launch geometry of the coefficient-gradient kernel (see
``csrc/clenshaw_coeff_grad.cu``). A team of 16 lanes (half a warp) a row: team t of the launch
(``grid`` blocks of ``warps`` warps, teams numbered block by block and warp by warp, T = grid x
warps x 2 of them) takes rows t, t + T, ..., and within each the ``tiles`` column tiles of 16 nq
queries, in order: lane l of tile s holds queries 16 nq s + l + 16 n (n < nq). prefetch: each
team loads its first (row, tile) directly and copies each next one into shared memory while it
computes the one before (per-row coefficients whose rows are a multiple of 16 bytes). smem:
dynamic shared memory of a block in bytes (the teams' prefetch buffers, or for shared
coefficients a partial gradient per warp). idle: the share of the query slots (rows x tiles x
16 nq) that hold no query."""

COEFF_GRAD_LANES = 16         # a team of the coefficient-gradient kernel: the lanes a row
_COEFF_GRAD_NQS = (1, 9, 18)  # the queries a lane it is compiled for: Q <= 16, 144, and tiles of 288
_COEFF_GRAD_CHUNK = 16        # degrees reduced together
_COEFF_GRAD_SHARED_GRID = 1056  # shared coefficients: most blocks (8 an SM), each ends with `order` atomics


def coeff_grad_buffer_floats(nq):
    """Floats of a team's prefetch buffer (``buffer_floats`` in the CUDA source): x, grad_y and y
    of a tile, padded to 16 more than a multiple of 32 so that the two teams of a warp read on
    other banks."""
    return _round_up(3 * COEFF_GRAD_LANES * nq, 32) + 16


@functools.lru_cache(maxsize=256)
def coeff_grad_geometry(rows, q, order, per_row, sms=None, resident=None, max_grid=MAX_GRID, aligned=True):
    """Launch geometry of the coefficient-gradient kernel for x (rows, q).

    nq is the smallest compiled value that holds a row in one tile
    (ceil(q / 16) queries a lane), else the largest (tiles of 288
    queries). Blocks hold 8 warps, fewer for few rows or where 48
    KB of shared memory do not hold as many partial gradients of ``order``
    (shared coefficients). Per-row coefficients prefetch where q is a
    multiple of 4 and the arrays are 16-byte ``aligned``. The grid is one
    block for each 8 warps' worth of rows, capped by ``max_grid`` and, given
    the card's ``sms`` and the blocks of this instance an SM holds
    (``resident``), by sms x resident: persistent blocks whose teams walk
    the rows past it. Returns a :class:`CoeffGradGeometry`."""
    lanes = COEFF_GRAD_LANES
    nq = next((n for n in _COEFF_GRAD_NQS if n * lanes >= q), _COEFF_GRAD_NQS[-1])
    teams = 32 // lanes
    warps = min(8, -(-rows // teams))
    prefetch = bool(per_row and aligned and q % 4 == 0)
    smem = 4 * coeff_grad_buffer_floats(nq) * teams * warps if prefetch else 0
    if not per_row:
        padded = _round_up(order, _COEFF_GRAD_CHUNK)
        warps = min(warps, _SMEM_BYTES // (4 * padded))
        smem = 4 * padded * warps
        max_grid = min(max_grid, _COEFF_GRAD_SHARED_GRID)
    grid = min(-(-rows // (warps * teams)), max_grid)
    if sms is not None and resident is not None:
        grid = min(grid, sms * resident)
    tiles = -(-q // (lanes * nq))
    return CoeffGradGeometry(nq, warps, grid, smem, prefetch, tiles, 1. - q / (tiles * lanes * nq))


@functools.lru_cache(maxsize=64)
def coeff_grad_resident_blocks(nq, per_row, prefetch, warps, smem):
    """Blocks of this instance of the coefficient-gradient kernel that one SM
    of the current card holds at once (the CUDA occupancy calculator); raises
    if the call fails or none fits."""
    blocks = ctypes.c_int(0)
    err = library().clenshaw_coeff_grad_occupancy(int(per_row), nq, int(prefetch), warps, smem, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError('coefficient-gradient kernel (nq {}, per_row {}, prefetch {}, {} warps, {} B of dynamic '
                           'shared memory): occupancy query gave cudaError {:d} and {} blocks an SM'.format(
                               nq, per_row, prefetch, warps, smem, err, blocks.value))
    return blocks.value


@functools.lru_cache(maxsize=8)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def clenshaw_coeff_grad_reference(x, w, order, per_row=True):
    """Plain PyTorch gradient of the series with respect to its coefficients
    (the kernel's oracle and CPU path): gc[b, j] = sum_q w[b, q] T_j(x[b, q])
    by the forward recurrence T_{j+1} = 2 x T_j - T_{j-1}, carried as
    U_j = w T_j; summed over b too unless ``per_row``.

    x, w : (B, Q); returns (B, order), or (order,) for shared coefficients.
    """
    two_x = 2. * x
    ua, ub = w, w * x
    columns = []
    for _ in range(order):
        columns.append(ua.sum(-1))
        ua, ub = ub, two_x * ub - ua
    gc = torch.stack(columns, dim=-1)
    return gc if per_row else gc.sum(0)


def _launch_coeff_grad(x, grad_y, y, order, per_row, max_grid=MAX_GRID):
    global COEFF_GRAD_LAUNCHES, LAST_COEFF_GRAD_GEOMETRY
    tensors = [x, grad_y] + ([] if y is None else [y])
    if x.device.type != 'cuda':
        raise ValueError('the CUDA coefficient-gradient kernel needs a CUDA tensor, got one on {}'.format(x.device))
    if x.ndim != 2 or grad_y.ndim != 2:
        raise ValueError('expected x and grad_y (B, Q), got {} and {}'.format(tuple(x.shape), tuple(grad_y.shape)))
    shared_x = bool(per_row) and x.shape[0] == 1 and grad_y.shape[0] > 1
    for t in tensors:
        shape = grad_y.shape if shared_x else x.shape
        if t.device != x.device or t.dtype != torch.float32 or t.shape[-1] != x.shape[-1] or \
                (t is not x and t.shape != shape) or not t.is_contiguous():
            raise ValueError('the CUDA coefficient-gradient kernel takes contiguous float32 tensors of one shape '
                             '(x may be one row with per-row coefficients) on one device, got {} {} on {} beside x '
                             '{} on {}'.format(t.dtype, tuple(t.shape), t.device, tuple(x.shape), x.device))
    if not 1 <= order <= _MAX_ORDER:
        raise ValueError('order {} outside [1, {}]: a partial gradient must fit 48 KB of shared memory'.format(
            order, _MAX_ORDER))
    rows, q = grad_y.shape
    # the kernel adds into the shared gradient, and writes every entry of the per-row one
    gc = torch.empty((rows, order), dtype=x.dtype, device=x.device) if per_row else \
        torch.zeros(order, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return gc.zero_()
    per_row = bool(per_row)
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    lib = library()
    with torch.cuda.device(x.device):
        # the instance first, then the grid from the blocks of it that the card's SMs hold
        g = coeff_grad_geometry(rows, q, order, per_row, max_grid=max_grid, aligned=aligned)
        resident = coeff_grad_resident_blocks(g.nq, per_row, g.prefetch, g.warps, g.smem)
        geometry = coeff_grad_geometry(rows, q, order, per_row, _sm_count(x.device.index), resident, max_grid,
                                       aligned=aligned)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.clenshaw_coeff_grad_f32(x.data_ptr(), grad_y.data_ptr(), None if y is None else y.data_ptr(),
                                          gc.data_ptr(), rows, q, order, int(per_row), geometry.nq,
                                          int(geometry.prefetch), geometry.warps, geometry.smem, geometry.grid,
                                          int(shared_x), stream)
    if err != 0:
        raise RuntimeError('CUDA coefficient-gradient kernel launch failed with cudaError {:d}'.format(err))
    COEFF_GRAD_LAUNCHES += 1
    LAST_COEFF_GRAD_GEOMETRY = geometry
    return gc


def clenshaw_coeff_grad(x, w, order, per_row=True):
    """gc[b, j] = sum_q w[b, q] T_j(x[b, q]) for j < order: the gradient of a
    Chebyshev series at x (B, Q) with respect to its coefficients, given the
    gradient w (B, Q) with respect to the series (x may be one row (1, Q)
    for every row, with ``per_row``). Returns (B, order), or
    (order,) summed over b for shared coefficients (``per_row`` False). A CPU
    tensor takes :func:`clenshaw_coeff_grad_reference`; a CUDA tensor
    launches the kernel or raises."""
    if x.device.type == 'cpu':
        return clenshaw_coeff_grad_reference(x, w, order, per_row)
    return _launch_coeff_grad(x, w, None, order, per_row)


def _series(x, coeffs, log_values):
    """The series at x with no autograd of its own: the kernel on a CUDA
    tensor (which raises on a non-contiguous one), the plain recurrence on a
    CPU one."""
    if x.device.type == 'cpu':
        return clenshaw_reference(x, coeffs, log_values)
    return _launch_clenshaw(x, coeffs, log_values)


def _coeff_grad(x, w, y, order, per_row):
    """sum_q w y T_j(x) (y None: 1) with no autograd of its own: the kernel
    (y folded in at load) on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == 'cpu':
        return clenshaw_coeff_grad_reference(x, w if y is None else w * y, order, per_row)
    return _launch_coeff_grad(x.contiguous(), w.contiguous(), None if y is None else y.contiguous(), order, per_row)


@functools.lru_cache(maxsize=None)
def _derivative_adjoint(order, dtype, device):
    """M with M[j, k] = D[k, j], where D is the linear map
    :func:`clenshaw_derivative_coeffs` (T'_j = sum_k D[k, j] T_k): the
    adjoint that carries a gradient in the derivative series' coefficients
    back to the series' own. Exact: its entries are integers below 2 order.
    Kept for good (a graph captured on the card reads it by address)."""
    return clenshaw_derivative_coeffs(torch.eye(order, dtype=torch.float64)).to(dtype=dtype, device=device)


def _batch_rows(info, in_dims, *tensors):
    """For a ``vmap`` rule: move each batched tensor's vmapped dimension to the
    front and expand the others to it, then fold it into the rows, so that
    (V, B, ...) becomes (V B, ...). None stays None."""
    out = []
    for tensor, dim in zip(tensors, in_dims):
        if tensor is None:
            out.append(None)
            continue
        tensor = tensor.movedim(dim, 0) if dim is not None else tensor.expand(info.batch_size, *tensor.shape)
        out.append(tensor.reshape(-1, *tensor.shape[2:]))
    return out


def _unbatched_rows(x, x_dim):
    """Rows of the (B, Q) x that a vmapped slice sees."""
    return x.shape[0] if x_dim is None else x.movedim(x_dim, 0).shape[1]


class _Clenshaw(torch.autograd.Function):
    """y = S_c(x) = sum_j c_j T_j(x), exp'd if ``log_values``, through the
    kernel on a CUDA tensor and the plain recurrence on a CPU one, with every
    derivative built from this Function and :class:`_ClenshawCoeffGrad`, so
    that it is itself differentiable, to any order and in both modes:

    - in x: dy/dx = S_{D c}(x) (times y if ``log_values``), D c the
      derivative series' coefficients (:func:`clenshaw_derivative_coeffs`);
    - in c: sum_q w y T_j(x) (:class:`_ClenshawCoeffGrad`);
    - forward mode: dy = (S_{D c}(x) dx + S_{dc}(x)) (times y), since the
      series is linear in c;
    - ``vmap``: the vmapped dimension folds into the rows (per-row
      coefficients where either is batched)."""

    @staticmethod
    def forward(x, coeffs, log_values):
        return _series(x, coeffs, log_values)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, coeffs, log_values = inputs
        ctx.save_for_backward(x, coeffs, output)
        ctx.save_for_forward(x, coeffs, output)
        ctx.log_values = log_values

    @staticmethod
    def backward(ctx, grad_y):
        x, coeffs, y = ctx.saved_tensors
        grad_x = grad_coeffs = None
        if ctx.needs_input_grad[0]:
            slope = _Clenshaw.apply(x, clenshaw_derivative_coeffs(coeffs), False)
            grad_x = grad_y * (slope * y if ctx.log_values else slope)
            if grad_x.shape[0] != x.shape[0]:  # a shared x
                grad_x = grad_x.sum(0, keepdim=True)
        if ctx.needs_input_grad[1]:
            grad_coeffs = _ClenshawCoeffGrad.apply(x, grad_y, y if ctx.log_values else None, coeffs.shape[-1],
                                                   coeffs.ndim == 2)
        return grad_x, grad_coeffs, None

    @staticmethod
    def jvp(ctx, dx, dcoeffs, _):
        x, coeffs, y = ctx.saved_tensors
        dy = None
        if dx is not None:
            dy = _Clenshaw.apply(x, clenshaw_derivative_coeffs(coeffs), False) * dx
        if dcoeffs is not None:
            term = _Clenshaw.apply(x, dcoeffs.contiguous(), False)
            dy = term if dy is None else dy + term
        return dy * y if ctx.log_values else dy

    @staticmethod
    def vmap(info, in_dims, x, coeffs, log_values):
        x_dim, c_dim, _ = in_dims
        if x_dim is None and c_dim is not None and _shared_x(x, coeffs.select(c_dim, 0)):
            # a shared x stays one row: the vmapped dimension folds into the coefficient rows
            coeffs = coeffs.movedim(c_dim, 0)
            y = _Clenshaw.apply(x, coeffs.reshape(-1, coeffs.shape[-1]).contiguous(), log_values)
            return y.reshape(coeffs.shape[:2] + y.shape[-1:]), 0
        rows = _unbatched_rows(x, x_dim)
        if c_dim is not None:
            coeffs = coeffs.movedim(c_dim, 0)
            if coeffs.ndim == 2:  # a shared row a slice: one for each of the slice's rows of x
                coeffs = coeffs[:, None, :].expand(info.batch_size, rows, coeffs.shape[-1])
            c_dim = 0
        elif coeffs.ndim == 2:  # the same per-row coefficients in every slice
            coeffs, c_dim = coeffs.expand(info.batch_size, *coeffs.shape), 0
        # the kernel takes contiguous rows: a vmapped dimension that is not the
        # outermost in memory (a tangent of a sliced MLP output) folds into
        # strided ones
        if c_dim is None:  # shared coefficients, batched x
            (xb,) = _batch_rows(info, (x_dim,), x)
            y = _Clenshaw.apply(xb.contiguous(), coeffs.contiguous(), log_values)
        else:
            xb, cb = _batch_rows(info, (x_dim, c_dim), x, coeffs)
            y = _Clenshaw.apply(xb.contiguous(), cb.contiguous(), log_values)
        return y.reshape(info.batch_size, rows, y.shape[-1]), 0


class _ClenshawCoeffGrad(torch.autograd.Function):
    """gc[b, j] = sum_q w[b, q] y[b, q] T_j(x[b, q]) (y None: 1), summed over
    b too unless ``per_row``: the gradient of the series in its coefficients,
    through the coefficient-gradient kernel (y folded in at load) on a CUDA
    tensor and its plain version on a CPU one. Its own derivatives use the
    series (:class:`_Clenshaw`), with g the cotangent of gc and S_g(x) =
    sum_j g_j T_j(x):

    - backward: d/dw = y S_g(x), d/dy = w S_g(x), d/dx = w y S_{D g}(x);
    - forward mode: gc(x, d(w y)) + D^T gc(x, w y dx), D^T the adjoint of
      :func:`clenshaw_derivative_coeffs`;
    - ``vmap``: the vmapped dimension folds into the rows; a shared gradient
      is summed over each slice's rows."""

    @staticmethod
    def forward(x, w, y, order, per_row):
        return _coeff_grad(x, w, y, order, per_row)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, y, order, per_row = inputs
        ctx.save_for_backward(x, w, y)
        ctx.save_for_forward(x, w, y)
        ctx.order, ctx.per_row = order, per_row

    @staticmethod
    def backward(ctx, grad_gc):
        x, w, y = ctx.saved_tensors
        grad_x = grad_w = grad_y = None
        series = _Clenshaw.apply(x, grad_gc.contiguous(), False) if any(ctx.needs_input_grad[1:3]) else None
        if ctx.needs_input_grad[0]:
            weight = w if y is None else w * y
            grad_x = weight * _Clenshaw.apply(x, clenshaw_derivative_coeffs(grad_gc), False)
            if grad_x.shape[0] != x.shape[0]:  # a shared x
                grad_x = grad_x.sum(0, keepdim=True)
        if ctx.needs_input_grad[1]:
            grad_w = series if y is None else series * y
        if y is not None and ctx.needs_input_grad[2]:
            grad_y = series * w
        return grad_x, grad_w, grad_y, None, None

    @staticmethod
    def jvp(ctx, dx, dw, dy, _order, _per_row):
        x, w, y = ctx.saved_tensors
        dweight = None
        if dw is not None:
            dweight = dw if y is None else dw * y
        if dy is not None and y is not None:
            dweight = dy * w if dweight is None else dweight + dy * w
        dgc = None
        if dweight is not None:
            dgc = _ClenshawCoeffGrad.apply(x, dweight, None, ctx.order, ctx.per_row)
        if dx is not None:
            weight = w if y is None else w * y
            inner = _ClenshawCoeffGrad.apply(x, weight * dx, None, ctx.order, ctx.per_row)
            term = inner @ _derivative_adjoint(ctx.order, inner.dtype, inner.device).T
            dgc = term if dgc is None else dgc + term
        return dgc

    @staticmethod
    def vmap(info, in_dims, x, w, y, order, per_row):
        if in_dims[0] is None and per_row and x.shape[0] == 1 and \
                _unbatched_rows(w, in_dims[1]) > 1:  # a shared x stays one row
            rows = _unbatched_rows(w, in_dims[1])
            wb, yb = _batch_rows(info, in_dims[1:3], w, y)
            gc = _ClenshawCoeffGrad.apply(x, wb.contiguous(), None if yb is None else yb.contiguous(), order, True)
            return gc.reshape(info.batch_size, rows, order), 0
        rows = _unbatched_rows(x, in_dims[0])
        xb, wb, yb = _batch_rows(info, in_dims[:3], x, w, y)
        gc = _ClenshawCoeffGrad.apply(xb, wb, yb, order, True).reshape(info.batch_size, rows, order)
        return (gc if per_row else gc.sum(1)), 0


def clenshaw(x, coeffs, log_values=True):
    """Batched Chebyshev evaluation (signature of ``clenshaw_pallas``).

    x : (B, Q) normalized queries in [-1, 1], or (1, Q) read by every row
        of per-row coefficients (a shared x)
    coeffs : (order,) shared by all rows, or (B, order)
    Returns (B, Q) series values (exp'd if log_values). A CPU tensor takes
    :func:`clenshaw_reference`; a CUDA tensor launches the kernel or raises.
    Differentiable in x and in the coefficients, to any order and in both
    modes, through the same autograd Functions on both devices: on the CPU
    their derivative formulas run on the plain versions (no graph of the
    recurrence's steps is kept), on the card on the kernels.
    """
    return _Clenshaw.apply(x, coeffs, bool(log_values))
