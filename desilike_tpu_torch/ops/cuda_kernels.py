"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions.

Counterpart of ``desilike_tpu/ops/pallas_kernels.py``. Each kernel has:

- a wrapper that takes the plain version for a tensor on the CPU and, for a
  CUDA tensor, launches the kernel or raises (no fallback);
- the plain PyTorch version in this module, which is the CPU path and the
  oracle the kernel is checked against on the card;
- a launch counter (``CLENSHAW_LAUNCHES``), increased only where the kernel
  is launched.

The CUDA sources live in ``desilike_tpu_torch/csrc``. At first use they are
compiled with ``nvcc`` for ``sm_90a`` into a plain-C shared library under
``desilike_tpu_torch/build/``, named by a hash of the sources and flags (an
edit rebuilds it), and loaded with ``ctypes``. The Clenshaw kernel's launch
geometry is computed here (:func:`clenshaw_geometry`), so that the CPU tests
can check that it covers every query once.
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
"""Launches of the CUDA Clenshaw kernel (forward and backward) since the last reset."""

LAST_GEOMETRY = None
"""The :class:`ClenshawGeometry` of the last launch of the Clenshaw kernel."""

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = (os.path.join(_PACKAGE_DIR, 'csrc', 'clenshaw.cu'),)
BUILD_DIR = os.path.join(_PACKAGE_DIR, 'build')
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
               '-Xcompiler', '-fPIC', '-Xptxas', '-v')

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
        # build beside the target and rename: concurrent processes never load a partial file
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_NVCC_FLAGS, '-o', tmp, *_SOURCES]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError('building the CUDA kernels failed:\n{}\n{}{}'.format(
                ' '.join(cmd), proc.stdout, proc.stderr))
        os.replace(tmp, target)
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(target)
    lib.clenshaw_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    lib.clenshaw_f32.restype = ctypes.c_int
    BUILD_INFO.update(path=target, seconds=time.perf_counter() - t0, log=log)
    _LIBRARY = lib
    return lib


def clenshaw_reference(x, coeffs, log_values=True):
    """Plain PyTorch Clenshaw recurrence (the kernel's oracle and CPU path).

    x : (B, Q) queries in [-1, 1]
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
    if coeffs.ndim == 2 and coeffs.shape[0] != rows:
        raise ValueError('coeffs has {} rows for {} rows of x'.format(coeffs.shape[0], rows))
    if not (x.is_contiguous() and coeffs.is_contiguous()):
        raise ValueError('the CUDA Clenshaw kernel takes contiguous tensors')
    if not 1 <= order <= _MAX_ORDER:
        raise ValueError('order {} outside [1, {}]: a padded coefficient row must fit 48 KB of shared '
                         'memory'.format(order, _MAX_ORDER))
    out = torch.empty_like(x)
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
                               geometry.tiles, geometry.grid, stream)
    if err != 0:
        raise RuntimeError('CUDA Clenshaw kernel launch failed with cudaError {:d}'.format(err))
    CLENSHAW_LAUNCHES += 1
    LAST_GEOMETRY = geometry
    return out


class _Clenshaw(torch.autograd.Function):
    """The kernel with its x-gradient: the same kernel evaluates the
    derivative series S'(x), and dy/dx = S'(x) (times y when log_values)."""

    @staticmethod
    def forward(ctx, x, coeffs, log_values):
        y = _launch_clenshaw(x, coeffs, log_values)
        ctx.save_for_backward(x, coeffs, y)
        ctx.log_values = log_values
        return y

    @staticmethod
    def backward(ctx, grad_y):
        x, coeffs, y = ctx.saved_tensors
        dslope = _launch_clenshaw(x, clenshaw_derivative_coeffs(coeffs).contiguous(), False)
        if ctx.log_values:
            dslope = dslope * y
        return grad_y * dslope, None, None


def clenshaw(x, coeffs, log_values=True):
    """Batched Chebyshev evaluation (signature of ``clenshaw_pallas``).

    x : (B, Q) normalized queries in [-1, 1]
    coeffs : (order,) shared by all rows, or (B, order)
    Returns (B, Q) series values (exp'd if log_values). A CPU tensor takes
    :func:`clenshaw_reference`; a CUDA tensor launches the kernel or raises.
    Differentiable in x on both paths.
    """
    if x.device.type == 'cpu':
        return clenshaw_reference(x, coeffs, log_values)
    if coeffs.requires_grad:
        raise NotImplementedError('the coefficient gradient of the CUDA Clenshaw kernel is not '
                                  'implemented (ROADMAP A5: ShapeFit varies the table)')
    return _Clenshaw.apply(x, coeffs, bool(log_values))
