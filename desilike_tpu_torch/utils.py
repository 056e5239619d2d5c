"""Small host-side utilities: base class, name matching, safe expression evaluation.

Counterpart of ``desilike_tpu/utils.py``, limited to what the port imports
(``BaseClass``, ``is_sequence``, ``find_names``, ``evaluate``, and the
profilers' contour extractor ``marching_squares``).
"""

import fnmatch
import logging
import re

import numpy as np
import torch


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


def is_sequence(item):
    """True for list/tuple (not str/array)."""
    return isinstance(item, (list, tuple))


def find_names(allnames, name):
    """Match ``name`` (with * wildcards, or re.Pattern) against list of names;
    returns matching names in input order."""
    if is_sequence(name):
        toret = []
        for nn in name:
            toret += find_names(allnames, nn)
        return toret
    if isinstance(name, re.Pattern):
        return [nn for nn in allnames if name.fullmatch(nn)]
    pattern = fnmatch.translate(str(name))
    return [nn for nn in allnames if re.fullmatch(pattern, nn)]


def evaluate(value, locals=None):
    """Evaluate a python expression with np/torch in scope.

    Used for derived-parameter expressions ('{a} + {b}') after placeholder
    substitution; the values are batched tensors, so expressions use
    arithmetic or ``torch`` functions.
    """
    gl = {'np': np, 'torch': torch}
    gl.update(locals or {})
    return eval(value, {'__builtins__': {'abs': abs, 'min': min, 'max': max}}, gl)


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
