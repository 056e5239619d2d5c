"""Parameter metadata objects and collections.

Counterpart of ``desilike_tpu/parameters/parameter.py``. Parameters are
host-side metadata only; the evaluated quantities are plain dicts
``{name: (B,) tensor}``. ``Deriv`` keys the derivatives that
``Differentiation`` returns.

Solved statuses:
  '.best'  — plug in the analytic best-fit,
  '.marg'  — analytically marginalize (adds -1/2 logdet term),
  '.auto'  — sampler/profiler decides,
  '.prec'  — fold into the data precision matrix once at initialization.
"""

import re

import numpy as np
import torch

from ..utils import BaseClass, evaluate, find_names
from .prior import Prior
from .. import config


_ALLOWED_SOLVED = ('.best', '.marg', '.auto', '.prec')


def eval_expression(expression, values):
    """Evaluate a derived expression '{a} + {b}' with each ``{name}`` bound to
    ``values[name]`` through a placeholder (``__dep<i>__``), so that full
    names with dots need no quoting."""
    locs = {}
    for i, (dep, value) in enumerate(values.items()):
        var = '__dep{}__'.format(i)
        expression = expression.replace('{' + dep + '}', var)
        locs[var] = value
    return evaluate(expression, locals=locs)


class Deriv(dict):
    """Multiset of derivative orders, e.g. Deriv({'a': 1, 'b': 1}) ~ d^2/dadb.
    Hashable, order-insensitive."""

    def __init__(self, names=None):
        super().__init__()
        if names is None:
            names = ()
        if isinstance(names, dict):
            items = names.items()
        elif isinstance(names, str):
            items = [(names, 1)]
        else:
            items = [(name, 1) for name in names]
        for name, order in items:
            if order > 0:
                self[name] = self.get(name, 0) + order

    def __hash__(self):
        return hash(tuple(sorted(self.items())))

    @property
    def total(self):
        return sum(self.values())

    def __repr__(self):
        return 'Deriv({})'.format(dict(self))


def _decode_name(name):
    """Split full name into (namespace, basename)."""
    name = str(name)
    if '.' in name:
        namespace, basename = name.rsplit('.', 1)
        return namespace, basename
    return '', name


class Parameter(BaseClass):
    """Parameter metadata: name, prior, reference distribution, status.

    Parameters
    ----------
    basename : str
        Name without namespace. ``name='ns.base'`` can also be given directly.
    value : float
        Default / fiducial value.
    fixed : bool, default=None
        Whether fixed. Defaults to True if ``derived`` or no prior/ref given.
    derived : bool, str, default=False
        True for output (derived) quantities; an expression '{a}+{b}' for
        parameters derived from others; a solved status '.marg'/'.best'/
        '.auto'/'.prec' for analytically-solved linear parameters.
    prior, ref : Prior or config
        Prior and reference (start-point) distributions.
    proposal : float
        Proposal scale for MCMC. Defaults to ref.std or prior.std.
    delta : float or (float, float)
        Finite-difference step (for emulators/derivatives).
    latex : str
        LaTeX label.
    shape : tuple
        Shape (default scalar).
    drop : bool
        If True, parameter is consumed by derived expressions only and not
        passed to calculators.
    """

    _attrs = ('basename', 'namespace', 'value', 'fixed', 'derived', 'prior', 'ref',
              'proposal', 'delta', 'latex', 'shape', 'drop')

    def __init__(self, basename=None, namespace='', value=None, fixed=None, derived=False,
                 prior=None, ref=None, proposal=None, delta=None, latex=None, shape=(),
                 drop=False, name=None):
        if isinstance(basename, Parameter):
            self.__dict__.update(basename.__dict__)
            return
        if name is not None and basename is None:
            namespace, basename = _decode_name(name)
        elif basename is not None and '.' in str(basename):
            namespace2, basename = _decode_name(basename)
            namespace = namespace or namespace2
        if basename is None:
            raise ValueError('Parameter requires a basename')
        self.basename = str(basename)
        self.namespace = str(namespace or '')
        self.derived = derived
        if isinstance(derived, str) and derived.startswith('.'):
            solved = derived.split('_not_derived')[0]
            if solved not in _ALLOWED_SOLVED:
                raise ValueError('unknown solved status {}; allowed: {}'.format(derived, _ALLOWED_SOLVED))
        self.prior = Prior.from_config(prior) if prior is not None else None
        self.ref = Prior.from_config(ref) if ref is not None else None
        self.value = value
        if self.value is None:
            if self.ref is not None:
                self.value = self.ref.center
            elif self.prior is not None:
                self.value = self.prior.center
            else:
                self.value = 0.
        self.value = float(np.asarray(self.value).reshape(()).item()) if shape == () else np.asarray(self.value)
        if fixed is None:
            # solved params ('.marg' etc.) are varied-but-solved, not fixed
            nonsolved_derived = self.derived is True or (isinstance(self.derived, str) and not self.solved)
            fixed = nonsolved_derived or (not self.solved and prior is None and ref is None)
        self.fixed = bool(fixed)
        self.proposal = proposal
        if self.proposal is None and not self.fixed:
            for dist in (self.ref, self.prior):
                if dist is not None and np.isfinite(dist.std):
                    self.proposal = float(dist.std)
                    break
        self.delta = delta
        self.latex = latex if latex is not None else self.basename
        self.shape = tuple(shape)
        self.drop = bool(drop)

    @property
    def name(self):
        if self.namespace:
            return '{}.{}'.format(self.namespace, self.basename)
        return self.basename

    @property
    def varied(self):
        return not (self.fixed or self.derived is True)

    @property
    def solved(self):
        """Whether this parameter is analytically solved ('.marg', etc.)."""
        return isinstance(self.derived, str) and self.derived.startswith('.')

    @property
    def depends(self):
        """Names referenced by a derived expression '{a}+{b}' -> ['a', 'b']."""
        if isinstance(self.derived, str) and not self.solved:
            return re.findall(r'\{([^\}]+)\}', self.derived)
        return []

    @property
    def input(self):
        """Whether the parameter is an input to the pipeline (sampled or fixed-in)."""
        return not (self.derived is True or (isinstance(self.derived, str) and self.depends))

    def clone(self, **kwargs):
        state = self.__getstate__()
        state.update(kwargs)
        return Parameter(**state)

    def update(self, **kwargs):
        """In-place update (host-side metadata only)."""
        state = self.__getstate__()
        state.update(kwargs)
        new = Parameter(**state)
        self.__dict__.update(new.__dict__)
        return self

    def __getstate__(self):
        state = {}
        for attr in self._attrs:
            value = getattr(self, attr)
            if attr in ('prior', 'ref') and value is not None:
                value = value.__getstate__()
            state[attr] = value
        return state

    def __setstate__(self, state):
        self.__init__(**state)

    def __repr__(self):
        status = 'derived' if self.derived is True else (self.derived if isinstance(self.derived, str) else ('fixed' if self.fixed else 'varied'))
        return "Parameter('{}', value={}, {})".format(self.name, self.value, status)

    def sample_ref(self, generator, shape=(), device=None):
        """Draws from the reference distribution, else the prior, else the
        value repeated (see :meth:`Prior.sample`)."""
        dist = self.ref if self.ref is not None else self.prior
        if dist is None:
            device = generator.device if device is None else device
            return torch.full(tuple(shape), self.value, dtype=config.get_dtype(), device=device)
        return dist.sample(generator, shape, device=device)

    @property
    def limits(self):
        """The prior's limits, (-inf, inf) without a prior."""
        if self.prior is not None:
            return tuple(self.prior.limits)
        return (-np.inf, np.inf)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape, dtype='i8')) if self.shape else 1

    def eval(self, **values):
        """The value of a derived expression '{a}+{b}' given its inputs in
        ``values`` (tensors stay tensors); any other parameter returns its
        own entry of ``values``."""
        if isinstance(self.derived, str) and not self.solved:
            missing = [dep for dep in self.depends if dep not in values]
            if missing:
                raise ValueError('parameter {} derives from {}, not provided'.format(self.name, missing[0]))
            return eval_expression(self.derived, {dep: values[dep] for dep in self.depends})
        return values[self.name]

    def logprior(self, x):
        """The prior's log density at x, zeros like x without a prior."""
        if self.prior is None:
            return torch.zeros_like(torch.as_tensor(x))
        return self.prior.logpdf(x)

    def __eq__(self, other):
        if isinstance(other, str):
            return self.name == other
        return isinstance(other, Parameter) and self.name == other.name

    def __hash__(self):
        return hash(self.name)


class ParameterCollection(BaseClass):
    """Ordered collection of Parameters, indexed by full name, with wildcard
    updates."""

    def __init__(self, params=None):
        self._params = {}
        if params is None:
            params = []
        if isinstance(params, ParameterCollection):
            params = list(params)
        if isinstance(params, dict):
            params = [Parameter(basename=name, **(cfg if isinstance(cfg, dict) else {'value': cfg}))
                      for name, cfg in params.items()]
        for param in params:
            if isinstance(param, dict):
                param = Parameter(**param)
            elif not isinstance(param, Parameter):
                param = Parameter(param)
            self.set(param)

    def set(self, param):
        if not isinstance(param, Parameter):
            param = Parameter(param)
        self._params[param.name] = param
        return param

    def get(self, name, default=None):
        name = getattr(name, 'name', name)
        return self._params.get(name, default)

    def __getitem__(self, name):
        if isinstance(name, int):
            return list(self._params.values())[name]
        name = getattr(name, 'name', name)
        return self._params[name]

    def __delitem__(self, name):
        name = getattr(name, 'name', name)
        del self._params[name]

    def __contains__(self, name):
        name = getattr(name, 'name', name)
        return name in self._params

    def __iter__(self):
        return iter(self._params.values())

    def __len__(self):
        return len(self._params)

    def names(self, **kwargs):
        if kwargs:
            return [p.name for p in self.select(**kwargs)]
        return list(self._params.keys())

    def basenames(self, **kwargs):
        if kwargs:
            return [p.basename for p in self.select(**kwargs)]
        return [p.basename for p in self]

    def index(self, name):
        return list(self._params).index(getattr(name, 'name', name))

    def copy(self):
        return ParameterCollection(self)

    def clone(self):
        return ParameterCollection([p.clone() for p in self])

    def eval(self, **values):
        """{name: value} of every parameter (derived expressions included)
        whose inputs are in ``values``."""
        out = {}
        for param in self:
            try:
                out[param.name] = param.eval(**values)
            except (KeyError, ValueError):
                pass
        return out

    def prior(self, **values):
        """Sum of the log-priors of the varied, non-solved parameters at the
        given values (tensors: on their device, batched as they are)."""
        logp = None
        for param in self:
            if param.varied and not param.solved and param.prior is not None and param.name in values:
                term = param.prior.logpdf(values[param.name])
                logp = term if logp is None else logp + term
        return torch.zeros((), dtype=config.get_dtype()) if logp is None else logp

    def params(self, **kwargs):
        """Selected parameters as a collection (the reference's name for :meth:`select`)."""
        return self.select(**kwargs)

    def select(self, name=None, basename=None, varied=None, fixed=None, derived=None,
               solved=None, input=None, depends=None):
        """Sub-collection matching the given criteria (wildcards allowed)."""
        params = list(self)
        if name is not None:
            names = find_names([p.name for p in params], name)
            params = [p for p in params if p.name in names]
        if basename is not None:
            names = find_names([p.basename for p in params], basename)
            params = [p for p in params if p.basename in names]
        if varied is not None:
            params = ([p for p in params if p.varied and not p.solved] if varied
                      else [p for p in params if not p.varied or p.solved])
        if fixed is not None:
            params = [p for p in params if p.fixed == bool(fixed)]
        if derived is not None:
            if isinstance(derived, bool):
                params = [p for p in params if (p.derived is True) == derived]
            else:
                params = [p for p in params if p.derived == derived]
        if solved is not None:
            params = [p for p in params if p.solved == bool(solved)]
        if input is not None:
            params = [p for p in params if p.input == bool(input)]
        if depends is not None:
            params = [p for p in params if bool(p.depends) == bool(depends)]
        return ParameterCollection(params)

    def __eq__(self, other):
        return isinstance(other, ParameterCollection) and self.names() == other.names()

    def __getstate__(self):
        return {'params': [p.__getstate__() for p in self]}

    def __setstate__(self, state):
        self.__init__([Parameter(**s) for s in state['params']])

    def update(self, other=None, basename=False, **kwargs):
        """Merge another collection (or name->config dict with wildcards)."""
        if other is None:
            other = kwargs
        if isinstance(other, (ParameterCollection, list)):
            for param in other:
                if basename:
                    matches = [p for p in self if p.basename == param.basename]
                    if matches:
                        for p in matches:
                            self._params[p.name] = param.clone(namespace=p.namespace)
                        continue
                self.set(param)
        else:
            for template, cfg in dict(other).items():
                cfg = cfg if isinstance(cfg, dict) else {'value': cfg}
                target = self.basenames() if basename else self.names()
                matched = find_names(target, template)
                if matched:
                    for p in list(self):
                        key = p.basename if basename else p.name
                        if key in matched:
                            p.update(**cfg)
                elif not any(c in str(template) for c in '*?['):
                    # non-wildcard unmatched key: add a new parameter
                    self.set(Parameter(basename=template, **cfg))
        return self

    def __repr__(self):
        return 'ParameterCollection({})'.format(self.names())
