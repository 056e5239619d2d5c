"""Parameter-indexed covariance and precision containers.

Counterpart of ``desilike_tpu/parameters/covariance.py``, numpy on the host
(bookkeeping, not a compute path): a covariance matrix whose rows and
columns are named parameters, with view/marginalize/fix algebra, conversion
to a ``LikelihoodFisher``, and ``.npz`` files in the JAX package's layout.
The getdist ``.covmat`` readers and writers and ``to_getdist`` wait for
ROADMAP A17.
"""

import numpy as np

from ..utils import BaseClass
from .parameter import Parameter, ParameterCollection


class ParameterCovariance(BaseClass):
    """Covariance over named parameters.

    Parameters
    ----------
    value : (n, n) array
    params : ParameterCollection, list of Parameter or names
    center : array, optional
        Parameter values the covariance is estimated around.
    """

    def __init__(self, value, params, center=None, attrs=None):
        self.params = ParameterCollection(params)
        self._value = np.atleast_2d(np.asarray(value, dtype='f8'))
        n = len(self.params)
        if self._value.shape != (n, n):
            raise ValueError('covariance shape {} != ({}, {})'.format(self._value.shape, n, n))
        self.center = np.asarray(center, dtype='f8') if center is not None \
            else np.array([p.value for p in self.params], dtype='f8')
        self.attrs = dict(attrs or {})

    # --- construction ---

    @classmethod
    def from_chain(cls, chain, params=None):
        """Sample covariance of a Chain (weighted)."""
        params = [getattr(p, 'name', p) for p in (params or chain.params.names())]
        params = [p for p in params if p not in chain._reserved]
        value = chain.covariance(params)
        center = np.array([chain.mean(p) for p in params])
        return cls(value, [chain.params[p] for p in params], center=center)

    @classmethod
    def from_fisher(cls, fisher, params=None):
        """Covariance view of a LikelihoodFisher."""
        params = [getattr(p, 'name', p) for p in (params or fisher.names())]
        return cls(fisher.covariance(params), params,
                   center=np.array([fisher.center[fisher.index([p])[0]] for p in params]))

    # --- views / algebra ---

    def names(self):
        return self.params.names()

    def index(self, params):
        names = self.names()
        return [names.index(getattr(p, 'name', p)) for p in params]

    def view(self, params=None, return_type='nparray'):
        """Covariance restricted to ``params`` (marginalized over the rest —
        for a covariance, restriction IS marginalization)."""
        if params is None:
            cov, params = self._value, list(self.params)
        else:
            params = [params] if isinstance(params, (str, Parameter)) else list(params)
            idx = self.index(params)
            cov = self._value[np.ix_(idx, idx)]
            params = [self.params[i] for i in idx]
        if return_type == 'nparray':
            return cov
        return ParameterCovariance(cov, params, center=self.center[self.index(params)])

    def marginalize(self, params):
        """Drop ``params`` (marginalized out)."""
        keep = [p for p in self.names() if p not in [getattr(q, 'name', q) for q in params]]
        return self.view(keep, return_type=None)

    def fix(self, params):
        """Condition on ``params`` held fixed (precision-submatrix inverse)."""
        fixed = set(getattr(p, 'name', p) for p in params)
        keep = [p for p in self.names() if p not in fixed]
        idx = self.index(keep)
        prec = np.linalg.inv(self._value)[np.ix_(idx, idx)]
        return ParameterCovariance(np.linalg.inv(prec), [self.params[i] for i in idx],
                                   center=self.center[idx])

    def std(self, param=None):
        sig = np.sqrt(np.diag(self._value))
        if param is None:
            return sig
        return sig[self.index([param])[0]]

    def corrcoef(self):
        sig = self.std()
        return self._value / np.outer(sig, sig)

    def fom(self):
        """Figure of merit: 1/sqrt(det C)."""
        return np.linalg.det(self._value) ** -0.5

    def to_fisher(self):
        from ..fisher import LikelihoodFisher
        return LikelihoodFisher(center=self.center, params=self.names(),
                                hessian=-np.linalg.inv(self._value))

    # --- getdist I/O: ROADMAP A17 ---

    def write_getdist(self, filename):
        """getdist-format ``.covmat`` writer: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    @classmethod
    def from_getdist(cls, filename):
        """getdist-format ``.covmat`` reader: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    read_getdist = from_getdist

    def var(self, params=None):
        """Marginalized variances (reference parameter.py var)."""
        idx = self.index([getattr(p, 'name', p) for p in (params or self.names())])
        return np.diag(self._value)[idx]

    def to_stats(self, params=None, sigfigs=5):
        """Plain-text stats table: name, center, sigma (reference
        parameter.py to_stats)."""
        params = [getattr(p, 'name', p) for p in (params or self.names())]
        idx = self.index(params)
        lines = ['{:<20s} {:>14s} {:>14s}'.format('parameter', 'center', 'sigma')]
        for i, name in zip(idx, params):
            lines.append('{:<20s} {:>14.{s}g} {:>14.{s}g}'.format(
                name, float(self.center[i]), float(np.sqrt(self._value[i, i])), s=sigfigs))
        return '\n'.join(lines)

    def to_getdist(self, params=None, label=None):
        """getdist export: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    # --- IO ---

    def __getstate__(self):
        return {'value': self._value, 'params': self.params.__getstate__(),
                'center': self.center,
                'attrs': {k: v for k, v in self.attrs.items()
                          if isinstance(v, (int, float, str, bool, list, tuple))}}

    def __setstate__(self, state):
        self.params = ParameterCollection([Parameter(**s) for s in state['params']['params']])
        self._value = np.asarray(state['value'])
        self.center = np.asarray(state['center'])
        self.attrs = dict(state.get('attrs', {}))

    def save(self, filename):
        import json
        state = self.__getstate__()
        np.savez(str(filename), value=state['value'], center=state['center'],
                 __meta__=np.array(json.dumps({'params': state['params'], 'attrs': state['attrs']},
                                              default=float)))

    @classmethod
    def load(cls, filename):
        import json
        loaded = np.load(str(filename), allow_pickle=False)
        meta = json.loads(str(loaded['__meta__']))
        new = cls.__new__(cls)
        new.__setstate__({'value': loaded['value'], 'center': loaded['center'],
                          'params': meta['params'], 'attrs': meta.get('attrs', {})})
        return new

    def to_precision(self, params=None):
        """Inverse as a :class:`ParameterPrecision` (restricted to ``params``
        AFTER inversion, i.e. marginalized over the rest)."""
        view = self.view(params, return_type=None) if params is not None else self
        return ParameterPrecision(np.linalg.inv(view._value), list(view.params),
                                  center=view.center, attrs=dict(view.attrs))

    def __repr__(self):
        return 'ParameterCovariance(params={})'.format(self.names())


class ParameterPrecision(BaseClass):
    """Precision (inverse-covariance) matrix over named parameters
    (reference parameter.py:2820 ``ParameterPrecision``). The algebra is
    dual to :class:`ParameterCovariance`: restricting a precision to a
    parameter subset conditions on the others being FIXED, and precisions
    of independent Gaussian constraints add (``sum``)."""

    def __init__(self, value, params, center=None, attrs=None):
        self.params = ParameterCollection(params)
        self._value = np.atleast_2d(np.asarray(value, dtype='f8'))
        n = len(self.params)
        if self._value.shape != (n, n):
            raise ValueError('precision shape {} != ({}, {})'.format(self._value.shape, n, n))
        self.center = np.asarray(center, dtype='f8') if center is not None \
            else np.array([p.value for p in self.params], dtype='f8')
        self.attrs = dict(attrs or {})

    def names(self):
        return self.params.names()

    def index(self, params):
        names = self.names()
        return [names.index(getattr(p, 'name', p)) for p in params]

    def view(self, params=None, return_type='nparray'):
        """Precision submatrix for ``params`` — this conditions on the
        remaining parameters held fixed (the dual of covariance restriction)."""
        if params is None:
            prec, params = self._value, list(self.params)
        else:
            params = [params] if isinstance(params, (str, Parameter)) else list(params)
            idx = self.index(params)
            prec = self._value[np.ix_(idx, idx)]
            params = [self.params[i] for i in idx]
        if return_type == 'nparray':
            return prec
        return ParameterPrecision(prec, params, center=self.center[self.index(params)])

    def to_covariance(self, params=None):
        """Invert to a :class:`ParameterCovariance`; an optional ``params``
        restriction is applied AFTER inversion (= marginalized covariance)."""
        cov = ParameterCovariance(np.linalg.inv(self._value), list(self.params),
                                  center=self.center, attrs=dict(self.attrs))
        return cov.view(params, return_type=None) if params is not None else cov

    @classmethod
    def sum(cls, *others):
        """Combine independent Gaussian constraints: precisions add on the
        union of their parameters (missing entries are zero)."""
        names = []
        for o in others:
            names += [n for n in o.names() if n not in names]
        n = len(names)
        value = np.zeros((n, n), dtype='f8')
        weighted_center = np.zeros(n, dtype='f8')
        params = ParameterCollection([])
        for o in others:
            idx = [names.index(nm) for nm in o.names()]
            value[np.ix_(idx, idx)] += o._value
            weighted_center[idx] += o._value @ o.center
            for p in o.params:
                if p.name not in params:
                    params.set(p)
        # combined center: (sum P_i)^-1 sum P_i c_i (pseudo-inverse: some
        # directions may be unconstrained)
        center = np.linalg.pinv(value) @ weighted_center
        return cls(value, [params[nm] for nm in names], center=center)

    def __add__(self, other):
        return self.sum(self, other)

    def fom(self):
        """Figure of merit: sqrt(det P)."""
        return np.linalg.det(self._value) ** 0.5

    def to_fisher(self):
        from ..fisher import LikelihoodFisher
        return LikelihoodFisher(center=self.center, params=self.names(),
                                hessian=-self._value)

    def __getstate__(self):
        return {'value': self._value, 'params': self.params.__getstate__(),
                'center': self.center,
                'attrs': {k: v for k, v in self.attrs.items()
                          if isinstance(v, (int, float, str, bool, list, tuple))}}

    def __setstate__(self, state):
        self.params = ParameterCollection([Parameter(**s) for s in state['params']['params']])
        self._value = np.asarray(state['value'])
        self.center = np.asarray(state['center'])
        self.attrs = dict(state.get('attrs', {}))

    def save(self, filename):
        import json
        state = self.__getstate__()
        np.savez(str(filename), value=state['value'], center=state['center'],
                 __meta__=np.array(json.dumps({'params': state['params'], 'attrs': state['attrs']},
                                              default=float)))

    @classmethod
    def load(cls, filename):
        import json
        loaded = np.load(str(filename), allow_pickle=False)
        meta = json.loads(str(loaded['__meta__']))
        new = cls.__new__(cls)
        new.__setstate__({'value': loaded['value'], 'center': loaded['center'],
                          'params': meta['params'], 'attrs': meta.get('attrs', {})})
        return new

    def __repr__(self):
        return 'ParameterPrecision(params={})'.format(self.names())
