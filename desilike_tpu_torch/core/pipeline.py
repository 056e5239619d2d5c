"""Pipeline: topologically-ordered calculator graph, evaluated eagerly over a
batch of parameter vectors.

Counterpart of ``desilike_tpu/core/pipeline.py``. Where the JAX package
traces the walk once and lets ``vmap`` add the chain dimension, here every
parameter is a ``(B,)`` tensor and each calculator broadcasts over the
leading batch dimension itself. Host-evaluated nodes, injected external
state and the per-calculator profiler wait for ROADMAP A15 and A17.
"""

import torch

from ..utils import BaseClass, evaluate as safe_evaluate
from ..parameters import ParameterCollection
from .. import config


class Pipeline(BaseClass):
    """Builds and evaluates the calculator graph rooted at ``root``."""

    def __init__(self, root):
        self.root = root
        self.calculators = []

        def callback(calc):
            calc.runtime_info.initialize()
            if calc in self.calculators:
                # move to front (dependencies of multiple nodes)
                self.calculators.remove(calc)
            self.calculators.append(calc)
            for req in calc.runtime_info.requires:
                callback(req)

        callback(root)
        self.calculators = self.calculators[::-1]  # dependencies first
        self._set_params()
        devices = {c.runtime_info.device for c in self.calculators if c.runtime_info.device is not None}
        if len(devices) > 1:
            raise ValueError('calculators of one pipeline request different devices: {}'.format(
                sorted(str(d) for d in devices)))
        self._device = devices.pop() if devices else None

    @property
    def device(self):
        """The evaluation device: the one the calculators request, else the
        card (``config.device('cuda')``, which raises where there is none).
        Resolved at first use, so that host-side initialization, which
        evaluates on the CPU by name, needs no card."""
        if self._device is None:
            self._device = config.device('cuda')
        return self._device

    def _stale(self):
        return any((not c.runtime_info.initialized) or c.init._updated
                   for c in self.calculators)

    def _set_params(self):
        params = ParameterCollection()
        self._param_owners = {}
        for calc in self.calculators:
            for param in calc.runtime_info.params:
                if param.name in params:
                    existing = params[param.name]
                    # merge: prefer the declaration with an explicit prior,
                    # and a varied declaration over a fixed one (shared nodes)
                    if (existing.prior is None and param.prior is not None) or \
                            (existing.fixed and not param.fixed):
                        params.set(param)
                else:
                    params.set(param)
                self._param_owners.setdefault(param.name, []).append(calc)
        self.params = params

    @property
    def varied_params(self):
        """Sampled parameters: varied, not solved, not derived-by-expression."""
        return ParameterCollection([p for p in self.params
                                    if p.varied and not p.solved and not p.depends])

    @property
    def solved_params(self):
        return ParameterCollection([p for p in self.params if p.solved])

    def input_defaults(self):
        """Default values for every input parameter (fixed + varied + solved)."""
        return {p.name: p.value for p in self.params if p.derived is not True}

    def _resolve_values(self, values, device, dtype):
        """Overlay user values on defaults as ``(B,)`` tensors of ``dtype`` on
        ``device``; evaluate derived expressions.

        Each value is a scalar or a ``(B,)`` tensor/array; scalars broadcast
        to the batch size. A tensor on another device is an error, never
        silently copied.
        """
        full = self.input_defaults()
        for name, value in values.items():
            if name in full:
                full[name] = value
            else:
                # allow basename shortcut if unique
                matches = [p.name for p in self.params if p.basename == name]
                if len(matches) == 1:
                    full[matches[0]] = value
                elif len(matches) > 1:
                    raise ValueError('ambiguous parameter {}: {}'.format(name, matches))
                else:
                    raise ValueError('unknown parameter {}'.format(name))
        tensors = {}
        for name, value in full.items():
            if isinstance(value, torch.Tensor) and value.device != device:
                raise ValueError('parameter {} is on {}, but the pipeline evaluates on {}'.format(
                    name, value.device, device))
            tensor = torch.as_tensor(value, dtype=dtype, device=device)
            if tensor.ndim > 1:
                raise ValueError('parameter {} must be a scalar or a (B,) vector, got shape {}'.format(
                    name, tuple(tensor.shape)))
            tensors[name] = tensor
        sizes = {t.numel() for t in tensors.values() if t.numel() != 1}
        if len(sizes) > 1:
            raise ValueError('parameters have different batch sizes: {}'.format(sorted(sizes)))
        batch = sizes.pop() if sizes else 1
        full = {name: t.reshape(-1).expand(batch) for name, t in tensors.items()}
        # derived expressions '{a}+{b}'
        pending = [p for p in self.params if p.depends]
        for _ in range(len(pending) + 1):
            progress = False
            for p in list(pending):
                deps = {}
                ok = True
                for dep in p.depends:
                    key = dep if dep in full else None
                    if key is None:
                        matches = [q.name for q in self.params if q.basename == dep and q.name in full]
                        key = matches[0] if len(matches) == 1 else None
                    if key is None or any(q.name == key and q.depends for q in pending):
                        ok = False
                        break
                    deps[dep] = full[key]
                if ok:
                    expr = p.derived
                    locs = {}
                    for i, (dep, val) in enumerate(deps.items()):
                        var = '__dep{}__'.format(i)
                        expr = expr.replace('{' + dep + '}', var)
                        locs[var] = val
                    value = torch.as_tensor(safe_evaluate(expr, locals=locs), dtype=dtype, device=device)
                    full[p.name] = value.reshape(-1).expand(batch)
                    pending.remove(p)
                    progress = True
            if not pending:
                break
            if not progress:
                raise ValueError('circular derived-parameter dependencies: {}'.format(
                    [p.name for p in pending]))
        return full

    def run_once(self, full_values):
        """Per-evaluation walk. ``full_values``: every input param as a
        ``(B,)`` tensor; their dtype and device set the evaluation context.

        Returns (root_get, derived dict of full-name -> value).
        """
        ref = next(iter(full_values.values()), None)
        dtype, device = (ref.dtype, ref.device) if ref is not None else (config.get_dtype(), self.device)
        self.batch = ref.numel() if ref is not None else 1  # the batch of the last walk (state snapshots)
        for calc in self.calculators:
            cvals = {p.basename: full_values[p.name] for p in calc.runtime_info.params
                     if p.derived is not True and not p.drop}
            calc.dtype, calc.device = dtype, device
            calc.calculate(**cvals)
        derived = {}
        for calc in self.calculators:
            for p in calc.runtime_info.params:
                if p.derived is True and hasattr(calc, p.basename):
                    derived[p.name] = getattr(calc, p.basename)
        return self.root.get(), derived

    def evaluate(self, values=None, device=None, dtype=None):
        """Eager evaluation; attributes on the calculators are left as tensors
        with a leading batch dimension. Defaults: the pipeline's device and
        the compute dtype (``config.get_dtype()``)."""
        device = self.device if device is None else config.device(device)
        dtype = config.get_dtype() if dtype is None else dtype
        full = self._resolve_values(values or {}, device=device, dtype=dtype)
        result, self.derived = self.run_once(full)
        return result

    def host_evaluate(self, values=None):
        """Initialization-time evaluation: float64 on the CPU."""
        return self.evaluate(values, device='cpu', dtype=config.HOST_DTYPE)

    def logprior(self, values):
        """Sum of log priors of varied params at given (resolved) values -> (B,)."""
        logp = torch.zeros_like(next(iter(values.values())))
        for p in self.varied_params:
            if p.prior is not None:
                logp = logp + p.prior.logpdf(values[p.name])
        return logp
