"""Pipeline: topologically-ordered calculator graph, evaluated eagerly over a
batch of parameter vectors.

Counterpart of ``desilike_tpu/core/pipeline.py``. Where the JAX package
traces the walk once and lets ``vmap`` add the chain dimension, here every
parameter is a ``(B,)`` tensor and each calculator broadcasts over the
leading batch dimension itself. A calculator flagged ``_host_eval`` (a host
code that cannot run on the card) is memoized on its parameter footprint,
so that moves of the other parameters skip it: ``block_params`` splits the
varied parameters on that footprint for the blocked sampler. Injected
external state and the per-calculator profiler wait for ROADMAP A17.
"""

import numpy as np
import torch

from ..utils import BaseClass, evaluate as safe_evaluate
from ..parameters import ParameterCollection
from .. import config


class Pipeline(BaseClass):
    """Builds and evaluates the calculator graph rooted at ``root``."""

    def __init__(self, root):
        self.root = root
        self.calculators = []
        self.host_reads = 0  # footprint reads of host-evaluated nodes (one a call)

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

    def param_footprint(self, calc):
        """Input parameter names influencing ``calc`` directly or through its
        transitive dependencies (the reference's footprint, base.py:737)."""
        names = {p.name for p in calc.runtime_info.params if p.derived is not True and not p.drop}
        for req in calc.runtime_info.requires:
            names |= self.param_footprint(req)
        return names

    def host_calculators(self):
        """Calculators flagged ``_host_eval`` (host codes that cannot run on
        the card): ``run_once`` memoizes them on their parameter footprint."""
        return [c for c in self.calculators if getattr(c, '_host_eval', False)]

    def block_params(self, oversample_power=0.4):
        """Split the varied parameters into (slow, fast) blocks by whether
        their footprint touches a host-evaluated calculator, the fast block
        oversampled Cobaya-style (reference base.py:737-857): [(names,
        repeat), ...], one block when there is nothing to split."""
        hosts = self.host_calculators()
        slow_names = set()
        for host in hosts:
            slow_names |= self.param_footprint(host)
        fast, slow = [], []
        for p in self.varied_params:
            (slow if p.name in slow_names else fast).append(p.name)
        if not hosts or not fast or not slow:
            return [(self.varied_params.names(), 1)]
        # the host call dominates a slow move: without timings, take it as >= 10x a fast one
        factor = max(2, int(round(10 ** oversample_power * 2)))
        return [(slow, 1), (fast, factor)]

    _HOST_CACHE_SIZE = 4

    def _host_inputs(self, calc, full_values):
        """The batch's values of the footprint of a host node, copied to the
        host: (nfootprint, B) float64, one read a call."""
        names = sorted(self.param_footprint(calc))
        self.host_reads += 1
        if not names:
            return np.zeros((0, self.batch))
        return torch.stack([full_values[n] for n in names]).detach().cpu().numpy().astype('f8')

    def _host_lookup(self, calc, inputs):
        """Restore the cached ``_state_attrs`` for these inputs; True on a
        hit. A small LRU (not a last-call memo) keeps a Metropolis
        accept/reject ping-pong from re-running the host code. Chains are
        matched one by one: when each chain's footprint values are in some
        cached call (a batch in which some chains took a move and others did
        not), its rows are gathered from there (attributes with a leading
        batch dimension; the others come from the most recent such call)."""
        cache = calc.__dict__.setdefault('_host_cache', [])
        for i, (key, state) in enumerate(cache):
            if key.shape == inputs.shape and np.array_equal(key, inputs):
                for attr, value in state.items():
                    setattr(calc, attr, value)
                cache.insert(0, cache.pop(i))
                return True
        batch = inputs.shape[1]
        source = np.full(batch, -1)
        row = np.zeros(batch, dtype=int)
        for i, (key, _) in enumerate(cache):
            if key.shape[0] != inputs.shape[0]:
                continue
            match = (key[:, None, :] == inputs[:, :, None]).all(0)  # (batch, cached batch)
            new = (source < 0) & match.any(1)
            source[new], row[new] = i, match.argmax(1)[new]
        if (source < 0).any():
            return False
        state = {}
        for attr, value in cache[source[0]][1].items():
            batched = [isinstance(cache[i][1].get(attr), torch.Tensor) and cache[i][1][attr].ndim
                       and cache[i][1][attr].shape[0] == cache[i][0].shape[1] for i in set(source)]
            if not all(batched):
                state[attr] = value
                continue
            out = value.new_empty((batch,) + tuple(value.shape[1:]))
            for i in set(source):
                mask = source == i
                out[torch.as_tensor(np.flatnonzero(mask), device=out.device)] = \
                    cache[i][1][attr][torch.as_tensor(row[mask], device=out.device)]
            state[attr] = out
        for attr, value in state.items():
            setattr(calc, attr, value)
        cache.insert(0, (inputs, state))
        del cache[self._HOST_CACHE_SIZE:]
        return True

    def _host_store(self, calc, inputs):
        state = {attr: getattr(calc, attr) for attr in getattr(calc, '_state_attrs', ()) if hasattr(calc, attr)}
        cache = calc.__dict__.setdefault('_host_cache', [])
        cache.insert(0, (inputs, state))
        del cache[self._HOST_CACHE_SIZE:]

    def run_once(self, full_values):
        """Per-evaluation walk. ``full_values``: every input param as a
        ``(B,)`` tensor; their dtype and device set the evaluation context.
        A host-evaluated node runs only when its footprint's values are not
        among those of its last few calls.

        Returns (root_get, derived dict of full-name -> value).
        """
        ref = next(iter(full_values.values()), None)
        dtype, device = (ref.dtype, ref.device) if ref is not None else (config.get_dtype(), self.device)
        self.batch = ref.numel() if ref is not None else 1  # the batch of the last walk (state snapshots)
        for calc in self.calculators:
            cvals = {p.basename: full_values[p.name] for p in calc.runtime_info.params
                     if p.derived is not True and not p.drop}
            calc.dtype, calc.device = dtype, device
            if getattr(calc, '_host_eval', False):
                inputs = self._host_inputs(calc, full_values)
                if self._host_lookup(calc, inputs):
                    continue
                calc.calculate(**cvals)
                self._host_store(calc, inputs)
                continue
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
