"""Samples container: a name -> numpy array mapping, with its parameters.

Counterpart of ``desilike_tpu/parameters/samples.py``, backed by numpy on the
host (the samplers copy their records off the device once, at the end of a
run). Files are the same ``.npz`` layout: one ``arr:<name>`` array a column
and a JSON ``__meta__`` of the parameters and scalar attributes, so that a
file the JAX package saved loads here. ``DerivArray`` holds what
``Differentiation`` returns; such a column is saved as ``deriv:<name>`` (the
values) beside ``derivkeys:<name>`` (the derivative keys, one ``repr`` of
the sorted (name, count) items each), as the JAX package saves it.
"""

import ast
import json

import numpy as np

from ..utils import BaseClass
from .parameter import Parameter, ParameterCollection, Deriv


class DerivArray(object):
    """numpy array with a leading axis indexed by derivative keys:
    ``arr[()]`` is the value, ``arr[('a',)]`` d/da, ``arr[('a', 'b')]``
    d2/dadb."""

    def __init__(self, value, derivs=None):
        self.value = np.asarray(value)
        self.derivs = [d if isinstance(d, Deriv) else Deriv(d) for d in (derivs or [Deriv()])]

    def __getitem__(self, deriv):
        if isinstance(deriv, (tuple, list, str, Deriv, dict)):
            deriv = deriv if isinstance(deriv, Deriv) else Deriv(deriv)
            if deriv not in self.derivs:
                raise KeyError('derivative {} not stored; have {}'.format(deriv, self.derivs))
            return self.value[self.derivs.index(deriv)]
        return self.value[deriv]

    @property
    def shape(self):
        return self.value.shape[1:]

    def __repr__(self):
        return 'DerivArray(shape={}, derivs={})'.format(self.value.shape, self.derivs)


class Samples(BaseClass):
    """Mapping of parameter name -> array of samples (plus attrs).

    Arrays share the leading sample shape. Supports concatenation, selection,
    ravel/reshape, and .npz save/load.
    """

    def __init__(self, data=None, params=None, attrs=None):
        self.data = {}
        self.params = ParameterCollection(params)
        self.attrs = dict(attrs or {})
        if data:
            for name, value in dict(data).items():
                self[name] = value

    # --- mapping interface ---

    def __getitem__(self, name):
        return self.data[getattr(name, 'name', name)]

    def __setitem__(self, name, value):
        param = None
        if isinstance(name, Parameter):
            param = name
            name = param.name
        if name not in self.params:
            self.params.set(param if param is not None else Parameter(basename=name))
        self.data[name] = value if isinstance(value, DerivArray) else np.asarray(value)

    def __delitem__(self, name):
        name = getattr(name, 'name', name)
        del self.data[name]
        if name in self.params:
            del self.params[name]

    def __contains__(self, name):
        return getattr(name, 'name', name) in self.data

    def get(self, name, default=None):
        return self.data.get(getattr(name, 'name', name), default)

    def names(self):
        return list(self.data.keys())

    def __len__(self):
        return len(self.data)

    @property
    def shape(self):
        for value in self.data.values():
            return tuple(np.shape(value))
        return ()

    @property
    def size(self):
        return int(np.prod(self.shape, dtype='i8')) if self.shape else 0

    @property
    def ndim(self):
        return len(self.shape)

    def reshape(self, *shape):
        """Reshape the leading sample dimensions of every column."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        new = self.copy()
        new.data = {}
        for name, value in self.data.items():
            arr = np.asarray(value)
            new.data[name] = arr.reshape(tuple(shape) + arr.shape[len(self.shape):])
        return new

    def set(self, item, name=None):
        """Set a column from an array carrying its parameter (``item.param``)
        or from a plain array under ``name``."""
        param = getattr(item, 'param', None)
        if param is not None:
            self[param] = item
        elif name is not None:
            self[name] = item
        else:
            raise ValueError('provide a parameter-carrying array or name=')

    def update(self, other):
        """Merge the columns and attrs of another Samples."""
        for name in other.names():
            self[other.params[name] if name in other.params else name] = other[name]
        self.attrs.update(getattr(other, 'attrs', {}))

    def to_array(self, params=None, struct=True):
        """The columns as one numpy array: structured (``struct=True``, one
        field a column) or stacked, (nparams,) + shape float64."""
        names = [getattr(p, 'name', p) for p in (params or self.names())]
        if struct:
            arrays = [np.asarray(self[n]) for n in names]
            dtype = np.dtype([(n, a.dtype, a.shape[len(self.shape):]) for n, a in zip(names, arrays)])
            out = np.empty(self.shape, dtype=dtype)
            for n, a in zip(names, arrays):
                out[n] = a
            return out
        return np.stack([np.asarray(self[n], dtype='f8') for n in names], axis=0)

    def match(self, other, eps=1e-7, params=None):
        """The rows of ``other`` that lie within ``eps`` of a row of ``self``
        on ``params`` (default: the names both hold), by a k-d tree on the
        host: (indices in other, indices in self), each unravelled to its
        samples' shape (aligns resumed or merged grids)."""
        if params is None:
            params = sorted(set(self.names()) & set(other.names()))
        names = [getattr(p, 'name', p) for p in params]
        from scipy import spatial
        kdtree = spatial.cKDTree(np.column_stack(
            [np.asarray(self[n], dtype='f8').reshape(self.size, -1)[:, 0] for n in names]))
        queries = np.column_stack(
            [np.asarray(other[n], dtype='f8').reshape(other.size, -1)[:, 0] for n in names])
        _, indices = kdtree.query(queries, k=1, distance_upper_bound=eps)
        mask = indices < self.size
        return (np.unravel_index(np.flatnonzero(mask), other.shape),
                np.unravel_index(indices[mask], self.shape))

    def ravel(self):
        new = self.copy()
        new.data = {name: np.asarray(value).reshape(-1) for name, value in self.data.items()}
        return new

    def select(self, **kwargs):
        params = self.params.select(**kwargs)
        new = self.copy()
        new.params = params
        new.data = {p.name: self.data[p.name] for p in params if p.name in self.data}
        return new

    def to_dict(self, names=None):
        return {name: self.data[name] for name in (names or self.names())}

    @classmethod
    def concatenate(cls, others, axis=0):
        others = [o for o in others if len(o)]
        if not others:
            return cls()
        new = others[0].copy()
        new.data = {name: np.concatenate([np.asarray(o[name]) for o in others], axis=axis)
                    for name in others[0].names()}
        return new

    def copy(self):
        new = self.__class__.__new__(self.__class__)
        new.data = dict(self.data)
        new.params = self.params.copy()
        new.attrs = dict(self.attrs)
        return new

    # --- IO ---

    def save(self, filename):
        arrays = {}
        for name, value in self.data.items():
            if isinstance(value, DerivArray):
                arrays['deriv:' + name] = np.asarray(value.value)
                arrays['derivkeys:' + name] = np.array([repr(sorted(d.items())) for d in value.derivs])
            else:
                arrays['arr:' + name] = np.asarray(value)
        meta = {'params': self.params.__getstate__(),
                'attrs': {k: v for k, v in self.attrs.items() if isinstance(v, (int, float, str, bool, list, tuple))}}
        arrays['__meta__'] = np.array(json.dumps(meta, default=float))
        np.savez(str(filename), **arrays)

    @classmethod
    def load(cls, filename):
        loaded = np.load(str(filename), allow_pickle=False)
        new = cls()
        meta = json.loads(str(loaded['__meta__']))
        new.params = ParameterCollection([Parameter(**s) for s in meta['params']['params']])
        new.attrs = meta.get('attrs', {})
        for key in loaded.files:
            if key.startswith('arr:'):
                new.data[key[4:]] = loaded[key]
            elif key.startswith('deriv:'):
                name = key[6:]
                derivs = [Deriv(dict(ast.literal_eval(str(s)))) for s in loaded['derivkeys:' + name]]
                new.data[name] = DerivArray(loaded[key], derivs)
        return new

    def __repr__(self):
        return 'Samples(shape={}, names={})'.format(self.shape, self.names())
