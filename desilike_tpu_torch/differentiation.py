"""Derivatives of pipeline quantities: forward mode first, finite
differences on request.

Counterpart of ``desilike_tpu/differentiation.py``. ``method='auto'`` nests
``torch.func.jacfwd`` once an order, through the card's kernels where the
pipeline reaches them; ``method='finite'`` takes the accuracy-2 or -4
central stencils with steps shrunk to stay inside the prior limits, every
stencil point of the grid evaluated in one batched pipeline call. Both run
at one point, on the pipeline's device: the card unless the calculators
were built with ``device='cpu'``.
"""

import itertools

import numpy as np
import torch
from torch.func import jacfwd

from .parameters import Deriv, DerivArray
from .utils import BaseClass
from . import config


def evaluator(pipeline, names, getter):
    """theta (B, len(names)), on the host or the device -> ``getter()`` after
    the pipeline's evaluation at the rows of theta, in the compute dtype on
    the pipeline's device."""
    device, dtype = pipeline.device, config.get_dtype()

    def fn(theta):
        theta = torch.as_tensor(theta, device=device)  # host points (finite differences) go to the device
        full = pipeline._resolve_values(dict(zip(names, theta.unbind(-1))), device=device, dtype=dtype)
        pipeline.run_once(full)
        return getter()
    return fn


def clamped_deltas(varied_params, theta0, reach, delta_scale=1.):
    """Finite-difference steps: each parameter's ``delta`` (or its proposal /
    10) times ``delta_scale``, shrunk so that every stencil point (up to
    ``reach`` steps away) stays inside the prior limits."""
    deltas = np.empty(len(varied_params))
    for i, p in enumerate(varied_params):
        delta = p.delta if np.ndim(p.delta) == 0 and p.delta else (p.proposal or 0.01) / 10.
        delta = float(delta) * delta_scale
        lims = p.prior.limits if p.prior is not None else (-np.inf, np.inf)
        center = float(theta0[i])
        room = min(center - lims[0] if np.isfinite(lims[0]) else np.inf,
                   lims[1] - center if np.isfinite(lims[1]) else np.inf)
        if room <= 0:
            raise ValueError('parameter {} sits on its prior boundary; cannot place a '
                             'central finite-difference stencil'.format(p.name))
        deltas[i] = min(delta, room / reach * (1. - 1e-9))
    return deltas


def at_offsets(fn, theta0, deltas, keys):
    """Evaluate ``fn`` (batched over rows) once at theta0 shifted by each key
    of ``keys`` (tuples of (parameter index, multiple of its step)): returns
    {key: output at that point}, as float64 numpy."""
    keys = list(dict.fromkeys(keys))
    thetas = np.repeat(np.asarray(theta0, dtype='f8')[None], len(keys), axis=0)
    for row, key in enumerate(keys):
        for i, mult in key:
            thetas[row, i] += mult * deltas[i]
    out = fn(torch.as_tensor(thetas))
    if isinstance(out, dict):
        out = {name: value.detach().cpu().double().numpy() for name, value in out.items()}
        return {key: {name: value[row] for name, value in out.items()} for row, key in enumerate(keys)}
    out = out.detach().cpu().double().numpy()
    return {key: out[row] for row, key in enumerate(keys)}


# central-difference stencils in units of 1/h (first derivative) and
# 1/h^2 (second derivative); offsets are multiples of the step
_STENCIL_D1 = {2: {-1: -0.5, 1: 0.5},
               4: {-2: 1. / 12., -1: -8. / 12., 1: 8. / 12., 2: -1. / 12.}}
_STENCIL_D2 = {2: {-1: 1., 0: -2., 1: 1.},
               4: {-2: -1. / 12., -1: 16. / 12., 0: -30. / 12., 1: 16. / 12., 2: -1. / 12.}}


def finite_derivatives(fn, varied_params, theta0, order, accuracy=2, delta_scale=1.):
    """Derivatives of the batched ``fn`` at theta0 over ``varied_params`` by
    the accuracy-2 or -4 central stencils, mixed second partials by the
    product of first-derivative stencils, prior-limit-clamped steps, every
    stencil point in one call of ``fn``; ``order`` maps each name to its
    maximum order, total order <= 2. Returns [(Deriv, value)], each value a
    float64 numpy array or a dict of them: the first derivatives and the
    second ones of each parameter in turn, then the mixed ones."""
    if accuracy not in _STENCIL_D1:
        raise ValueError('accuracy must be one of {}'.format(tuple(_STENCIL_D1)))
    if max(order.values()) > 2:
        raise ValueError("method='finite' supports order <= 2; use method='auto' for higher orders")
    names = varied_params.names()
    reach = max(abs(o) for o in _STENCIL_D1[accuracy])
    deltas = clamped_deltas(varied_params, theta0, reach, delta_scale)
    d1, d2 = _STENCIL_D1[accuracy], _STENCIL_D2[accuracy]

    def key(offsets):
        return tuple(sorted(o for o in offsets if o[1]))

    entries = []  # (Deriv, [(coefficient, key)])
    for i, name in enumerate(names):
        if order[name] >= 1:
            entries.append((Deriv((name,)), [(c / deltas[i], key(((i, o),))) for o, c in d1.items()]))
        if order[name] >= 2:
            entries.append((Deriv({name: 2}), [(c / deltas[i] ** 2, key(((i, o),))) for o, c in d2.items()]))
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            if min(order[names[i]], order[names[j]]) >= 2:
                entries.append((Deriv((names[i], names[j])),
                                [(ci * cj / (deltas[i] * deltas[j]), key(((i, oi), (j, oj))))
                                 for oi, ci in d1.items() for oj, cj in d1.items()]))
    values = at_offsets(fn, theta0, deltas, [k for _, combos in entries for _, k in combos])

    first = next(iter(values.values()))
    out = []
    for deriv, combos in entries:
        if isinstance(first, dict):
            value = {name: np.asarray(sum(c * values[k][name] for c, k in combos)) for name in first}
        else:
            value = np.asarray(sum(c * values[k] for c, k in combos))
        out.append((deriv, value))
    return out


class Differentiation(BaseClass):
    """Derivatives of ``getter()`` outputs with respect to the varied
    parameters.

    Parameters
    ----------
    calculator : Calculator
        Pipeline root.
    getter : callable or None
        Called after the pipeline's evaluation; returns the quantity (a
        tensor with a leading batch dimension, or a dict of them) to
        differentiate. Defaults to the root calculator's state snapshot
        (:meth:`Calculator.state_tensors`: a dict entry flattened to
        ``'name.key'``, a constant one broadcast to the batch).
    order : int or dict name -> int
        Maximum derivative order (total, mixed partials included).
    method : 'auto' (forward mode) or 'finite'
    accuracy : 2 or 4, the finite-difference stencil's
    delta_scale : float
        Multiplier on the per-parameter finite-difference steps.
    """

    def __init__(self, calculator, getter=None, order=1, method='auto', accuracy=2, delta_scale=1.):
        self.calculator = calculator
        self.pipeline = calculator.pipeline
        if getter is None:
            def getter():
                return calculator.state_tensors(self.pipeline.batch)
        self.varied_params = self.pipeline.varied_params
        self.names = self.varied_params.names()
        self.getter = getter
        if np.ndim(order) == 0:
            order = {name: int(order) for name in self.names}
        self.order = order
        self.method = method
        self.accuracy = int(accuracy)
        self.delta_scale = float(delta_scale)

    def __call__(self, **params):
        """Evaluate derivatives at the given parameter values (default: the
        parameters' values); returns a dict of quantity name -> DerivArray
        (``'value'`` when the getter returns one tensor)."""
        center = {p.name: p.value for p in self.varied_params}
        for name, v in params.items():
            matches = [p.name for p in self.varied_params if p.name == name or p.basename == name]
            if matches:
                center[matches[0]] = v
        theta0 = np.array([center[n] for n in self.names], dtype='f8')
        fn = evaluator(self.pipeline, self.names, self.getter)

        def point(theta):  # one point (ndim,) -> {name: output without its batch dimension}
            out = fn(theta[None])
            return {name: value[0] for name, value in out.items()} if isinstance(out, dict) else {'value': out[0]}

        theta = torch.as_tensor(theta0, dtype=config.get_dtype(), device=self.pipeline.device)
        value = {name: v.detach().cpu().double().numpy() for name, v in point(theta).items()}
        derivs_list = [Deriv()]
        arrays = {k: [v[None]] for k, v in value.items()}
        if self.method == 'auto':
            dfn = point
            for order in range(1, max(self.order.values()) + 1):
                dfn = jacfwd(dfn)
                jac = {k: v.detach().cpu().double().numpy() for k, v in dfn(theta).items()}  # (..., ndim^order)
                for combo in itertools.combinations_with_replacement(range(len(self.names)), order):
                    names = tuple(self.names[i] for i in combo)
                    if order > min(self.order[n] for n in names):
                        continue
                    d = Deriv(names)
                    if d in derivs_list:
                        continue
                    derivs_list.append(d)
                    for k, v in jac.items():
                        for i in combo[::-1]:
                            v = v[..., i]
                        arrays[k].append(v[None])
        elif self.method == 'finite':
            for deriv, value in finite_derivatives(fn, self.varied_params, theta0, self.order, self.accuracy,
                                                   self.delta_scale):
                derivs_list.append(deriv)
                for k in arrays:
                    arrays[k].append((value[k] if isinstance(value, dict) else value)[None])
        else:
            raise ValueError('unknown method {}'.format(self.method))
        return {k: DerivArray(np.concatenate(v, axis=0), derivs=list(derivs_list)) for k, v in arrays.items()}
