"""Small host-side utilities: logging, base class, name matching, safe expression evaluation.

Counterpart of ``desilike_tpu/utils.py``: ``setup_logging``, ``BaseClass``,
``tree_map``, ``is_sequence``, ``find_names``, ``expand_dict``,
``evaluate``, the profilers' contour extractor ``marching_squares``, and
the reference's helpers (``Monitor``, ``TaskManager``, ``deep_eq``,
``mkdir``, ``is_path``, ``import_class``, ``rebin``, ``cov_to_corrcoef``,
``subspace``, the quadrature weights, ``matrix_lininterp``, ``inv``,
``blockinv``, and ``forward_module_getattr`` for the import-path shims), as
numpy on the host.
"""

import fnmatch
import logging
import re
import sys

import numpy as np
import torch


def setup_logging(level='info', stream=sys.stdout):
    """Configure root logging; mirrors reference desilike.utils.setup_logging (utils.py:142)."""
    if isinstance(level, str):
        level = {'info': logging.INFO, 'debug': logging.DEBUG, 'warning': logging.WARNING,
                 'error': logging.ERROR}[level.lower()]
    handler = logging.StreamHandler(stream=stream)
    handler.setFormatter(logging.Formatter(fmt='[%(asctime)s %(name)-20s %(levelname)-8s] %(message)s',
                                           datefmt='%m-%d %H:%M'))
    root = logging.getLogger()
    root.handlers.clear()
    root.addHandler(handler)
    root.setLevel(level)


class BaseClass(object):
    """Mixin providing a class logger and shallow-copy helper."""

    @property
    def log(self):
        return logging.getLogger(self.__class__.__name__)

    def copy(self, **kwargs):
        import copy
        new = copy.copy(self)
        new.__dict__.update(kwargs)
        return new

    def deepcopy(self):
        import copy
        return copy.deepcopy(self)


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a nest of dicts, lists and tuples;
    anything else is returned as it is."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, value) for value in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def is_sequence(item):
    """True for list/tuple (not str/array)."""
    return isinstance(item, (list, tuple))


def find_names(allnames, name, quiet=True):
    """Match ``name`` (with * wildcards, or re.Pattern) against list of names;
    returns matching names in input order. With ``quiet=False`` a name with
    no wildcard that matches nothing raises ``ValueError``."""
    if is_sequence(name):
        toret = []
        for nn in name:
            toret += find_names(allnames, nn, quiet=quiet)
        return toret
    if isinstance(name, re.Pattern):
        return [nn for nn in allnames if name.fullmatch(nn)]
    pattern = fnmatch.translate(str(name))
    toret = [nn for nn in allnames if re.fullmatch(pattern, nn)]
    if not toret and not quiet and '*' not in str(name):
        raise ValueError('{} not found in {}'.format(name, allnames))
    return toret


def expand_dict(di, names):
    """Expand wildcard keys of ``di`` against ``names``.

    >>> expand_dict({'a*': 1}, ['a1', 'a2'])
    {'a1': 1, 'a2': 1}
    """
    toret = {name: None for name in names}
    if not hasattr(di, 'items'):
        di = {'*': di}
    for template, value in di.items():
        for name in find_names(names, template):
            toret[name] = value
    return toret


def evaluate(value, type=None, locals=None):
    """Evaluate a python expression with np/torch in scope, then cast the
    result with ``type`` if given.

    Used for derived-parameter expressions ('{a} + {b}') after placeholder
    substitution; the values are batched tensors, so expressions use
    arithmetic or ``torch`` functions.
    """
    gl = {'np': np, 'torch': torch}
    gl.update(locals or {})
    toret = eval(value, {'__builtins__': {'abs': abs, 'min': min, 'max': max}}, gl)
    if type is not None:
        toret = type(toret)
    return toret


def marching_squares(x, y, z, level):
    """All level-set polylines of ``z`` on a rectilinear grid: the numeric
    contour extractor of the profilers (no matplotlib in the numeric path;
    reference counterpart profilers/base.py:656 contour tracing).

    Parameters
    ----------
    x : (nx,) grid along the first axis of z
    y : (ny,) grid along the second axis of z
    z : (nx, ny) field, z[i, j] = f(x[i], y[j])
    level : float

    Returns
    -------
    list of (npts, 2) float arrays — every disjoint polyline (closed loops
    repeat their first point at the end). Linear interpolation along cell
    edges; saddle cells are disambiguated by the cell-center average.
    """
    x = np.asarray(x, dtype='f8')
    y = np.asarray(y, dtype='f8')
    z = np.asarray(z, dtype='f8')
    nx, ny = z.shape
    above = z > level

    def edge_point(kind, i, j):
        # ('h', i, j): edge (x[i], y[j]) - (x[i+1], y[j]);
        # ('v', i, j): edge (x[i], y[j]) - (x[i], y[j+1])
        if kind == 'h':
            z0, z1 = z[i, j], z[i + 1, j]
            t = (level - z0) / (z1 - z0)
            return (x[i] + t * (x[i + 1] - x[i]), y[j])
        z0, z1 = z[i, j], z[i, j + 1]
        t = (level - z0) / (z1 - z0)
        return (x[i], y[j] + t * (y[j + 1] - y[j]))

    # collect undirected segments between edge identities (exact keys, so
    # chaining across cells never depends on float tolerances)
    adjacency = {}

    def add_segment(e1, e2):
        adjacency.setdefault(e1, []).append(e2)
        adjacency.setdefault(e2, []).append(e1)

    for i in range(nx - 1):
        for j in range(ny - 1):
            b0, b1 = above[i, j], above[i + 1, j]
            b2, b3 = above[i + 1, j + 1], above[i, j + 1]
            case = int(b0) + 2 * int(b1) + 4 * int(b2) + 8 * int(b3)
            if case in (0, 15):
                continue
            B, T = ('h', i, j), ('h', i, j + 1)
            L, R = ('v', i, j), ('v', i + 1, j)
            table = {1: [(L, B)], 2: [(B, R)], 3: [(L, R)], 4: [(R, T)],
                     6: [(B, T)], 7: [(L, T)], 8: [(T, L)], 9: [(B, T)],
                     11: [(R, T)], 12: [(L, R)], 13: [(B, R)], 14: [(L, B)]}
            if case in (5, 10):
                center_above = 0.25 * (z[i, j] + z[i + 1, j] + z[i + 1, j + 1] + z[i, j + 1]) > level
                if (case == 5) == center_above:
                    segs = [(L, T), (B, R)]
                else:
                    segs = [(L, B), (T, R)]
            else:
                segs = table[case]
            for e1, e2 in segs:
                add_segment(e1, e2)

    # chain the segment soup into polylines: open paths start at degree-1
    # nodes, remaining cycles at any unvisited node
    visited = set()  # undirected (e1, e2) pairs, canonical order
    paths = []

    def seg_key(e1, e2):
        return (e1, e2) if e1 <= e2 else (e2, e1)

    def walk(start):
        path = [start]
        node = start
        while True:
            nxt = None
            for nb in adjacency[node]:
                if seg_key(node, nb) not in visited:
                    nxt = nb
                    break
            if nxt is None:
                break
            visited.add(seg_key(node, nxt))
            path.append(nxt)
            node = nxt
        return path

    starts = [e for e, nbs in adjacency.items() if len(nbs) == 1]
    for start in starts:
        if all(seg_key(start, nb) in visited for nb in adjacency[start]):
            continue
        path = walk(start)
        if len(path) > 1:
            paths.append(path)
    for e in adjacency:  # closed loops
        if any(seg_key(e, nb) not in visited for nb in adjacency[e]):
            paths.append(walk(e))
    return [np.array([edge_point(*e) for e in path]) for path in paths if len(path) > 1]


def deep_eq(obj1, obj2):
    """Deep equality of arrays, dicts and sequences."""
    if type(obj1) is not type(obj2):
        return False
    if isinstance(obj1, dict):
        if obj1.keys() != obj2.keys():
            return False
        return all(deep_eq(obj1[k], obj2[k]) for k in obj1)
    if isinstance(obj1, (tuple, list)):
        if len(obj1) != len(obj2):
            return False
        return all(deep_eq(o1, o2) for o1, o2 in zip(obj1, obj2))
    if isinstance(obj1, np.ndarray):
        return obj1.shape == obj2.shape and bool(np.all(obj1 == obj2))
    if isinstance(obj1, torch.Tensor):
        return obj1.shape == obj2.shape and bool(torch.all(obj1 == obj2))
    try:
        return bool(obj1 == obj2)
    except Exception:
        return obj1 is obj2


class Monitor(BaseClass):
    """Wall-time (and peak RSS) monitor, the reference's per-calculator
    ``Monitor`` (ref utils.py:734): a context manager, or start() / stop();
    ``get('time')`` returns the accumulated quantity, ``counter`` the number
    of stop() calls. Per-calculator timing of a pipeline is
    ``Pipeline.profile_speed``; this one times host-side sections (reading
    files, initialization, host-evaluated nodes)."""

    def __init__(self, quantities='time'):
        if isinstance(quantities, str):
            quantities = (quantities,)
        self.quantities = list(quantities)
        self.reset()

    def time(self):
        import time
        return time.perf_counter()

    def mem(self):
        import resource
        # peak RSS in MB (ru_maxrss is in KB on Linux)
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3

    def reset(self):
        self.counter = 0
        self._diffs = {q: 0. for q in self.quantities}
        self.start()

    def start(self):
        self._start = {q: getattr(self, q)() for q in self.quantities}

    def stop(self):
        now = {q: getattr(self, q)() for q in self.quantities}
        self.counter += 1
        for q in self.quantities:
            self._diffs[q] += now[q] - self._start[q]
        self._start = now

    def get(self, quantity, average=False):
        value = self._diffs[quantity]
        if average:
            return value / max(self.counter, 1)
        return value

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *exc):
        self.stop()


class TaskManager(BaseClass):
    """Deterministic task split over processes, the reference's MPI
    ``TaskManager`` (ref utils.py:1040) without a manager rank. In one
    process every task runs here; with a ``torch.distributed`` group up
    (:func:`desilike_tpu_torch.parallel.distributed.initialize`), each group
    of ``nprocs_per_task`` processes takes the tasks of its round-robin
    turn.

    >>> with TaskManager() as tm:
    ...     for task in tm.iterate(tasks):
    ...         ...
    """

    def __init__(self, nprocs_per_task=1):
        self.nprocs_per_task = max(int(nprocs_per_task), 1)

    @staticmethod
    def _world():
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size(), dist.get_rank()
        return 1, 0

    @property
    def nworkers(self):
        return max(self._world()[0] // self.nprocs_per_task, 1)

    @property
    def worker(self):
        return (self._world()[1] // self.nprocs_per_task) % self.nworkers

    def iterate(self, tasks):
        """Yield the tasks of this process's worker group (round-robin, the
        same on every process of the group)."""
        for i, task in enumerate(tasks):
            if i % self.nworkers == self.worker:
                yield task

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def mkdir(dirname, **kwargs):
    """Create directory ``dirname`` (nothing if it exists)."""
    import os
    kwargs.setdefault('exist_ok', True)
    if dirname:
        os.makedirs(dirname, **kwargs)


def is_path(item):
    """True if ``item`` is a path (str or os.PathLike)."""
    import os
    return isinstance(item, (str, os.PathLike))


def import_class(clsname, pythonpath=None, registry=None):
    """A class from ``'module.ClassName'`` (the module looked up under
    ``pythonpath`` first, if given), from a bare class name in ``registry``,
    or a type as it is."""
    import importlib
    if isinstance(clsname, type):
        return clsname
    name = str(clsname)
    if '.' in name:
        modname, name = name.rsplit('.', 1)
        if pythonpath is not None:
            sys.path.insert(0, str(pythonpath))
        try:
            module = importlib.import_module(modname)
        finally:
            if pythonpath is not None:
                sys.path.remove(str(pythonpath))
        return getattr(module, name)
    matches = [cls for cls in (registry or ()) if cls.__name__ == name]
    if len(matches) == 1:
        return matches[0]
    if len(matches) > 1:
        raise ImportError('multiple classes named {} in registry'.format(name))
    raise ImportError('unknown class {}; give module_name.ClassName or a registry'.format(name))


def rebin(array, new_shape, statistic=None):
    """Down-bin ``array`` to ``new_shape`` (each new size divides the old
    one), applying ``statistic`` (the sum by default) over each block."""
    array = np.asarray(array)
    if np.ndim(new_shape) == 0:
        new_shape = (int(new_shape),)
    new_shape = tuple(int(s) for s in new_shape)
    if array.ndim != len(new_shape):
        raise ValueError('cannot rebin {}-d array to {}-d shape'.format(array.ndim, len(new_shape)))
    if statistic is None:
        statistic = np.sum
    shape = []
    for new, old in zip(new_shape, array.shape):
        if old % new != 0:
            raise ValueError('new shape {} does not divide input shape {}'.format(new_shape, array.shape))
        shape += [new, old // new]
    reshaped = array.reshape(shape)
    # collapse every block axis (the odd positions), from the last, so that the indices stay valid
    for axis in range(len(new_shape) - 1, -1, -1):
        reshaped = statistic(reshaped, axis=2 * axis + 1)
    return reshaped


def cov_to_corrcoef(cov):
    """The correlation matrix of covariance ``cov`` (1 for a scalar)."""
    if np.ndim(cov) == 0:
        return 1.
    std = np.sqrt(np.diag(cov).real)
    return cov / std[:, None] / std[None, :]


def subspace(X, precision=None, npcs=None, chi2min=None, fweights=None, aweights=None):
    """Principal subspace of samples ``X`` (nsamples, ndim), whitened by
    ``precision`` if given (arXiv:2009.03311): the (ndim, npcs) projection
    onto the leading eigenvectors of the sample covariance. ``chi2min``
    keeps the fewest leading components whose eigenvalues sum above it."""
    X = np.asarray(X).reshape(np.shape(X)[0], -1)
    L = np.linalg.cholesky(precision) if precision is not None else np.array(1.)
    Xw = X.dot(L) if precision is not None else X
    cov = np.cov(Xw, rowvar=False, ddof=0, fweights=fweights, aweights=aweights)
    eigenvalues, eigenvectors = np.linalg.eigh(np.atleast_2d(cov))
    if npcs is None:
        npcs = (len(eigenvalues) if chi2min is None
                else len(eigenvalues) - int(np.sum(np.cumsum(eigenvalues) < chi2min)))
    if npcs > len(eigenvalues):
        raise ValueError('requested {} components > dimension {}'.format(npcs, len(eigenvalues)))
    basis = eigenvectors[..., len(eigenvalues) - npcs:]
    return L.dot(basis) if precision is not None else basis


def weights_trapz(x):
    """Trapezoidal integration weights at nodes ``x``."""
    x = np.asarray(x, dtype='f8')
    if x.size == 0:
        return np.array(1.)
    if x.size == 1:
        return np.ones(1)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2.
    w[1:] += dx / 2.
    return w


def weights_leggauss(nx, sym=False):
    """Gauss-Legendre nodes and weights on [-1, 1]; with ``sym``, a 2 nx rule
    folded onto [0, 1] (for integrands even in x)."""
    x, w = np.polynomial.legendre.leggauss((1 + bool(sym)) * int(nx))
    if sym:
        x, w = x[nx:], (w[nx:] + w[nx - 1::-1]) / 2.
    return x, w


def weights_mu(mu, method='leggauss'):
    """mu nodes and weights on [0, 1] for the multipole projection: a number
    of nodes, or the nodes themselves (``method='trapz'``)."""
    if method == 'trapz':
        if np.ndim(mu) == 0:
            mu = np.linspace(0., 1., int(mu))
        mu = np.asarray(mu, dtype='f8')
        return mu, weights_trapz(mu) / (mu[-1] - mu[0])
    if method == 'leggauss':
        if np.ndim(mu) != 0:
            raise ValueError('leggauss takes a node count, not a node array')
        return weights_leggauss(int(mu), sym=True)
    raise ValueError('unknown mu-integration method {}'.format(method))


def matrix_lininterp(xin, xout):
    """(nin, nout) linear-interpolation matrix in the reference's convention,
    f(xout) ~= f(xin) @ M (the window's ``matrix_lininterp`` transposed),
    with the columns outside the range of ``xin`` zero (no constant
    extrapolation)."""
    from .observables.window import matrix_lininterp as lininterp
    xin = np.asarray(xin, dtype='f8')
    xout = np.asarray(xout, dtype='f8')
    M = lininterp(xout, xin).T
    inside = (xout >= xin[0]) & (xout <= xin[-1] + 1e-12 * max(abs(xin[-1]), 1.))
    return M * inside[None, :]


def inv(mat, check_valid='raise'):
    """Inverse of a square matrix in float64 on the host; with
    ``check_valid`` other than 'raise', the pseudo-inverse of a singular
    one."""
    mat = np.asarray(mat, dtype='f8')
    if mat.ndim == 1 or (mat.ndim == 2 and mat.shape[0] != mat.shape[1]):
        raise ValueError('expected square matrix')
    try:
        return np.linalg.inv(mat)
    except np.linalg.LinAlgError:
        if check_valid == 'raise':
            raise
        return np.linalg.pinv(mat)


def blockinv(blocks, inv=None):
    """Inverse of a matrix given as a nested list of blocks, by the block
    decomposition (the Schur complement of the first block, recursively):
    stabler for ill-conditioned covariances of several observables."""
    if inv is None:
        inv = np.linalg.inv

    def _inv(mat):
        A = mat[0][0]
        if len(mat) == 1:
            return inv(A)
        B = np.concatenate(mat[0][1:], axis=-1)
        C = np.concatenate([row[0] for row in mat[1:]], axis=0)
        invD = _inv([row[1:] for row in mat[1:]])
        invD_C = invD.dot(C)
        schur = inv(A - B.dot(invD_C))
        return np.block([[schur, -schur.dot(B).dot(invD)],
                         [-invD_C.dot(schur), invD + invD_C.dot(schur).dot(B).dot(invD)]])

    return _inv([[np.atleast_2d(np.asarray(b, dtype='f8')) for b in row] for row in blocks])


def forward_module_getattr(*providers):
    """A module ``__getattr__`` (PEP 562) that looks names up in
    ``providers`` (module paths, in order): the reference's import-path
    shims (``desilike_tpu_torch.theories.galaxy_clustering`` mirrors
    ``desilike/theories/galaxy_clustering/__init__.py``) resolve without
    copying the exports."""
    import importlib

    def __getattr__(name):
        if not name.startswith('_'):
            for provider in providers:
                mod = importlib.import_module(provider)
                try:
                    return getattr(mod, name)
                except AttributeError:
                    pass
        raise AttributeError('module shim has no attribute {!r} (searched {})'.format(name, providers))
    return __getattr__
