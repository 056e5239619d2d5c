"""Calculator graph nodes.

Counterpart of ``desilike_tpu/core/calculator.py`` with the same lazy
two-phase lifecycle: ``__init__`` captures config; ``initialize()`` runs
once, host-side in float64 numpy, declaring parameters and dependencies and
building static tables; ``calculate(**param_values)`` runs per evaluation on
batched tensors (every parameter a ``(B,)`` tensor), eagerly, with no
tracing step.

Dependencies are discovered implicitly: any Calculator instance in
``self.__dict__`` after initialize, unless ``self.requires`` is set
explicitly. ``namespace='LRG'`` prefixes the node's parameter names
(``LRG.b1``) and passes to the sub-calculators it creates, unless one sets
``_propagate_namespace = False``. ``__getstate__`` snapshots a node's
per-evaluation outputs (its ``_state_attrs``), which the emulators and the
default getter of ``Differentiation`` read.

Host tables reach the per-evaluation path through :meth:`Calculator.const`,
which casts a numpy attribute to the dtype and device of the current
evaluation once and caches the tensor. The pipeline sets ``self.dtype`` and
``self.device`` from the parameter tensors before each ``calculate``: float64
on the CPU for initialization-time evaluations (mock data, covariance,
static design matrices), float32 on the likelihood's device for the
per-evaluation path.
"""

import numpy as np
import torch

from ..utils import BaseClass
from ..parameters import ParameterCollection
from .. import config


class InitConfig(dict):
    """Captured init configuration + parameter overrides.

    Mutating it (``calc.init.update(...)``, ``calc.init.params = ...``)
    marks the calculator for re-initialization.
    """

    def __init__(self, calculator, kwargs):
        params = kwargs.pop('params', None)
        namespace = kwargs.pop('namespace', None)
        super().__init__(kwargs)
        self._calculator = calculator
        self._namespace = namespace
        self._params = None
        self._param_updates = []
        if params is not None:
            self._set_params(params)
        self._updated = True

    def _set_params(self, params):
        if isinstance(params, dict):
            # dict specs support wildcard updates against declared params
            self._param_updates.append(dict(params))
        else:
            self._params = ParameterCollection(params)

    @property
    def params(self):
        if self._params is None:
            self._params = ParameterCollection()
        return self._params

    @params.setter
    def params(self, params):
        self._params = None
        self._param_updates = []
        self._set_params(params)
        self._updated = True
        self._calculator.runtime_info.initialized = False

    def update(self, *args, **kwargs):
        super().update(*args, **kwargs)
        self._updated = True
        self._calculator.runtime_info.initialized = False

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._updated = True
        self._calculator.runtime_info.initialized = False

    def setdefault(self, key, value, if_none=False):
        """Set ``key`` to ``value`` if it is missing (or None, with
        ``if_none``), which marks the calculator for re-initialization."""
        if key not in self or (if_none and self[key] is None):
            self[key] = value


class RuntimeInfo(object):
    """Bookkeeping attached to each calculator."""

    def __init__(self, calculator, device=None):
        self.calculator = calculator
        self.initialized = False
        self.requires = None      # list of Calculator, discovered or explicit
        self.params = ParameterCollection()
        self.namespace = ''
        self.name = calculator.__class__.__name__
        self.device = device      # explicit device request, or None

    def initialize(self):
        if self.initialized:
            return self.calculator
        calc = self.calculator
        cls_params = getattr(calc, '_params', None)
        if callable(cls_params):
            params = ParameterCollection(cls_params(dict(calc.init)))
        else:
            params = ParameterCollection(dict(cls_params) if cls_params else {})
        if calc.init._params is not None:
            params.update(calc.init._params, basename=True)
            for param in calc.init._params:
                if param.name not in [p.name for p in params] and param.basename not in params.basenames():
                    params.set(param)
        for updates in calc.init._param_updates:
            params.update(updates, basename=True)
        if calc.init._namespace:
            self.namespace = calc.init._namespace
            for param in params:
                if not param.namespace:
                    param.update(namespace=self.namespace)
            params = ParameterCollection(list(params))  # re-key after rename
        self.params = params
        calc.params = params  # let initialize() inspect/modify
        self.requires = None  # re-discover on each (re-)initialization
        calc.__dict__.pop('_const_cache', None)
        calc.initialize(**{k: v for k, v in calc.init.items()})
        self.params = calc.params
        # implicit dependency discovery: Calculator instances set during
        # initialize, including one level inside lists/tuples/dicts
        requires = []

        def scan(value):
            if isinstance(value, Calculator) and value is not calc and value not in requires:
                requires.append(value)
            elif isinstance(value, (list, tuple)):
                for v in value:
                    scan(v)
            elif isinstance(value, dict):
                for v in value.values():
                    scan(v)

        for name, value in calc.__dict__.items():
            if name.startswith('_') or name in ('init', 'runtime_info', 'params'):
                continue
            scan(value)
        explicit = calc.__dict__.get('requires', None)
        if explicit is not None:
            requires = list(explicit)
        self.requires = requires
        for req in self.requires:
            # the namespace passes to sub-calculators created implicitly
            # (template -> apeffect); nodes meant to be shared across
            # namespaces opt out
            if self.namespace and not req.init._namespace and getattr(req, '_propagate_namespace', True):
                req.init._namespace = self.namespace
                req.runtime_info.initialized = False
            req.runtime_info.initialize()
        self.initialized = True
        calc.init._updated = False
        return calc


class Calculator(BaseClass):
    """Base calculator. Subclasses override ``initialize`` and ``calculate``.

    ``__init__(device=None, **kwargs)`` only captures config; nothing runs
    until the node is part of an evaluated pipeline (or
    ``runtime_info.initialize()``). ``device`` is an explicit request
    ('cpu', 'cuda', 'cuda:1'); it raises at once if the device is not
    available. A pipeline evaluates on the one device its nodes request,
    and on the card if none does: the CPU only when asked for by name.
    """

    _params = None

    def __init__(self, device=None, **kwargs):
        self.init = InitConfig(self, kwargs)
        self.runtime_info = RuntimeInfo(self, device=None if device is None else config.device(device))
        # evaluation context, set by the pipeline before each calculate()
        self.dtype, self.device = config.HOST_DTYPE, torch.device('cpu')

    def initialize(self, **kwargs):
        pass

    def calculate(self):
        pass

    def get(self):
        return self

    def __getstate__(self):
        """Snapshot of the per-evaluation outputs listed in ``_state_attrs``
        (the emulators and ``Differentiation``'s default getter read it).

        An entry that depends on the evaluation's parameters keeps their
        leading chain axis, ``(B, ...)``; a constant one (a fiducial table,
        a float) has no batch axis. Entries are the attributes themselves
        (tensors, floats, or dicts of tensors such as ``pktable``), not
        copies.
        """
        return {name: getattr(self, name) for name in getattr(self, '_state_attrs', []) if hasattr(self, name)}

    def __setstate__(self, state):
        self.__dict__.update(state)

    def state_tensors(self, batch, nested=True):
        """The state snapshot as ``{name: (batch, ...) tensor}`` in the
        evaluation's dtype and device: a constant entry (a number, a numpy
        array or a tensor of :meth:`const`) broadcast to the batch, a dict
        entry flattened to ``'name.key'`` (dropped when ``nested`` is
        False), an entry that is not a number dropped."""
        cache = self.__dict__.get('_const_cache', {})
        constants = {id(t) for _, tensors in cache.values() for t in tensors.values()}
        out = {}

        def add(name, value):
            if isinstance(value, dict):
                if nested:
                    for key, item in value.items():
                        add('{}.{}'.format(name, key), item)
                return
            if isinstance(value, torch.Tensor):
                if id(value) in constants:
                    value = value.expand(batch, *value.shape)
                out[name] = value
            elif isinstance(value, (int, float, np.number, np.ndarray)) and np.issubdtype(np.asarray(value).dtype, np.number):
                value = torch.as_tensor(np.asarray(value), dtype=self.dtype, device=self.device)
                out[name] = value.expand(batch, *value.shape)

        for name, value in self.__getstate__().items():
            add(name, value)
        return out

    def const(self, name, dtype=None, device=None):
        """Host attribute ``name`` (numpy) as a tensor of the current
        evaluation's dtype and device (or ``dtype``, ``device``); cached
        until the attribute is reassigned."""
        value = getattr(self, name)
        cache = self.__dict__.setdefault('_const_cache', {})
        entry = cache.get(name)
        if entry is None or entry[0] is not value:
            entry = cache[name] = (value, {})
        key = (dtype or self.dtype, device or self.device)
        if key not in entry[1]:
            entry[1][key] = torch.as_tensor(np.asarray(value), dtype=key[0], device=key[1])
        return entry[1][key]

    @property
    def params(self):
        """This calculator's own parameters: initializes the node on first
        access; assigned directly during initialization."""
        if '_instance_params' not in self.__dict__:
            self.runtime_info.initialize()
        return self.__dict__.get('_instance_params', ParameterCollection())

    @params.setter
    def params(self, params):
        self.__dict__['_instance_params'] = params

    @property
    def all_params(self):
        """All parameters of this calculator's pipeline."""
        return self.pipeline.params

    @property
    def varied_params(self):
        return self.pipeline.varied_params

    @property
    def pipeline(self):
        from .pipeline import Pipeline
        info = self.runtime_info
        pipe = getattr(info, '_pipeline', None)
        if pipe is None or pipe._stale():
            pipe = Pipeline(self)
            info._pipeline = pipe
        return pipe

    def __repr__(self):
        return '{}()'.format(self.__class__.__name__)
