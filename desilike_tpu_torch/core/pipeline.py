"""Pipeline: topologically-ordered calculator graph, evaluated eagerly over a
batch of parameter vectors.

Counterpart of ``desilike_tpu/core/pipeline.py``. Where the JAX package
traces the walk once and lets ``vmap`` add the chain dimension, here every
parameter is a ``(B,)`` tensor and each calculator broadcasts over the
leading batch dimension itself. A calculator flagged ``_host_eval`` (a host
code that cannot run on the card) is memoized on its parameter footprint,
so that moves of the other parameters skip it: ``block_params`` splits the
varied parameters on that footprint for the blocked sampler.
``profile_speed`` times each calculator and the batched call. Nodes with
injectable external state (``Cosmology(engine='external')``, fed by a host
code through the bindings) take their tables from the values dict under
``'external:<index>:<attr>'`` keys (:meth:`Pipeline.external_values`) for
one call: each table has the node's grid shape and serves every chain.
"""

import numpy as np
import torch

from ..utils import BaseClass
from ..parameters import ParameterCollection
from ..parameters.parameter import eval_expression
from .. import config


def _same_values(a, b):
    """Whether the dicts of parameter values ``a`` and ``b`` hold the same values."""
    return a.keys() == b.keys() and all(
        x is b[k] or (np.array_equal(x, b[k]) if isinstance(x, np.ndarray) else x == b[k]) for k, x in a.items())


def _only_tensors(value):
    """Whether ``value`` is a tensor, or a non-empty dict, list or tuple of only tensors (nested)."""
    if isinstance(value, torch.Tensor):
        return True
    if isinstance(value, dict):
        value = list(value.values())
    return isinstance(value, (list, tuple)) and bool(value) and all(_only_tensors(item) for item in value)


class Pipeline(BaseClass):
    """Builds and evaluates the calculator graph rooted at ``root``."""

    def __init__(self, root):
        self.root = root
        self.calculators = []
        self.host_reads = 0  # footprint reads of host-evaluated nodes (one a call)
        self._fns = {}  # get_fn, states_fn

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

    @property
    def derived_params(self):
        return ParameterCollection([p for p in self.params if p.derived is True])

    def input_defaults(self):
        """Default values for every input parameter (fixed + varied + solved)."""
        return {p.name: p.value for p in self.params if p.derived is not True}

    def _default_tensors(self, device, dtype):
        """The defaults (:meth:`input_defaults`) as 0-dim tensors of ``dtype``
        on ``device``, made once and kept until a default changes: after the
        first call, a call copies no default from the host (a capturable
        call). ``self._defaults_version`` counts the changes."""
        defaults = self.input_defaults()
        cached = self.__dict__.get('_defaults_cache')
        if cached is None or not _same_values(cached[0], defaults):
            cached = self._defaults_cache = (defaults, {})
            self._defaults_version = self.__dict__.get('_defaults_version', 0) + 1
        key = (torch.device(device), dtype)
        if key not in cached[1]:
            tensors = {}
            for name, value in defaults.items():
                tensor = torch.as_tensor(value, dtype=dtype, device=device)
                if tensor.ndim > 1:
                    raise ValueError('parameter {} must be a scalar or a (B,) vector, got shape {}'.format(
                        name, tuple(tensor.shape)))
                tensors[name] = tensor
            cached[1][key] = tensors
        return cached[1][key]

    def _resolve_values(self, values, device, dtype):
        """Overlay user values on defaults as ``(B,)`` tensors of ``dtype`` on
        ``device``; evaluate derived expressions.

        Each value is a scalar or a ``(B,)`` tensor/array; scalars broadcast
        to the batch size. A tensor on another device is an error, never
        silently copied. An ``'external:<index>:<attr>'`` entry (an injected
        table, :meth:`external_values`) is kept as it is, a host array copied
        to ``device`` in ``dtype``; it comes after the parameters.
        """
        defaults = self._default_tensors(device, dtype)
        full = {}
        external = {}
        for name, value in values.items():
            if name.startswith('external:'):
                if isinstance(value, torch.Tensor):
                    if value.device != device:
                        raise ValueError('external table {} is on {}, but the pipeline evaluates on {}'.format(
                            name, value.device, device))
                    external[name] = value
                else:
                    external[name] = torch.as_tensor(np.asarray(value), dtype=dtype, device=device)
            elif name in defaults:
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
        tensors = dict(defaults)
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
                    value = torch.as_tensor(eval_expression(p.derived, deps), dtype=dtype, device=device)
                    full[p.name] = value.reshape(-1).expand(batch)
                    pending.remove(p)
                    progress = True
            if not pending:
                break
            if not progress:
                raise ValueError('circular derived-parameter dependencies: {}'.format(
                    [p.name for p in pending]))
        full.update(external)
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
        ref = next((value for name, value in full_values.items() if not name.startswith('external:')), None)
        dtype, device = (ref.dtype, ref.device) if ref is not None else (config.get_dtype(), self.device)
        self.batch = ref.numel() if ref is not None else 1  # the batch of the last walk (state snapshots)
        restore = []
        try:
            for key, value in full_values.items():
                if key.startswith('external:'):
                    _, index, attr = key.split(':', 2)
                    calc = self.calculators[int(index)]
                    original = getattr(calc, attr)
                    if tuple(value.shape) != np.shape(original):
                        raise ValueError('external table {} has shape {}, the node\'s grid {}'.format(
                            key, tuple(value.shape), np.shape(original)))
                    restore.append((calc, attr, original))
                    setattr(calc, attr, value)
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
        finally:
            # the injected tables stay the node's between calls: a passed-in one serves its call only
            for calc, attr, original in restore:
                setattr(calc, attr, original)

    def evaluate(self, values=None, device=None, dtype=None):
        """Eager evaluation; attributes on the calculators are left as tensors
        with a leading batch dimension. Defaults: the pipeline's device and
        the compute dtype (``config.get_dtype()``)."""
        device = self.device if device is None else config.device(device)
        dtype = config.get_dtype() if dtype is None else dtype
        full = self._resolve_values(values or {}, device=device, dtype=dtype)
        result, self.derived = self.run_once(full)
        return result

    def _defaults_version_at(self, device, dtype):
        """The version of the defaults (:meth:`_default_tensors`) as they stand."""
        self._default_tensors(device, dtype)
        return self._defaults_version

    def _graph_constants(self):
        """Every tensor reachable from the calculators (their attributes and
        caches, through dicts, lists and tuples) and the defaults' tensors:
        what a graph captured from this pipeline's calls may read besides its
        inputs. It keeps alive those there before and after its capture (the
        constants), so that an attribute or a default set later frees none
        that it reads."""
        found, seen = [], set()

        def walk(value):
            if isinstance(value, torch.Tensor):
                found.append(value)
            elif isinstance(value, (dict, list, tuple)) and id(value) not in seen:
                seen.add(id(value))
                for item in (value.values() if isinstance(value, dict) else value):
                    walk(item)

        walk(self.__dict__.get('_defaults_cache'))
        for calc in self.calculators:
            walk(calc.__dict__)
        return found

    def _warmup_state(self):
        """Marks the calculators' attributes before a capture's warm-up, and
        returns the function that, called after it, deletes the public ones
        that the warm-up set and that hold only tensors: the state of that
        call, which the capture sets again. With them go the autograd graphs
        that hang from those the log-density does not read (config 3d's
        sigma8 and fsigma8: 65 GiB at 32768 chains with the gradient), whose
        memory the capture's pool then takes. Private attributes are the
        calculators' own caches, which a calculator may keep only where it
        finds them (``EmulatedCalculator``'s ``_cheb_cache``): they stay."""
        marks = [{name: id(value) for name, value in calc.__dict__.items()} for calc in self.calculators]

        def forget():
            for calc, before in zip(self.calculators, marks):
                for name, value in list(calc.__dict__.items()):
                    if not name.startswith('_') and before.get(name) != id(value) and _only_tensors(value):
                        del calc.__dict__[name]
        return forget

    def capture(self, fn, name=None):
        """``fn`` (a function of the values dict) as a
        :class:`~desilike_tpu_torch.core._capture.CapturedFunction` on the
        pipeline's device in the compute dtype: captured as a CUDA graph a
        signature and replayed on the card, eager on the CPU (the port's
        ``jax.jit``). A graph is never replayed on defaults that changed
        since its capture."""
        from ._capture import CapturedFunction
        device, dtype = self.device, config.get_dtype()
        return CapturedFunction(fn, device, version=lambda: self._defaults_version_at(device, dtype),
                                retain=self._graph_constants, release=self._warmup_state, name=name)

    def get_fn(self):
        """{name: value} -> root.get(): :meth:`evaluate` as a function of the
        values, on the pipeline's device in the compute dtype, compiled as
        the JAX package compiles it: on the card each signature (batch size,
        dtypes, scalars or (B,) values) is captured once as a CUDA graph and
        replayed (:meth:`capture`); on the CPU it runs eagerly. Its outputs
        are fresh tensors; the calculators' attributes after a replayed call
        are not its values. Made once a pipeline."""
        if 'get' not in self._fns:
            def fn(values):
                return self.evaluate(values)
            self._fns['get'] = self.capture(fn, name='Pipeline.get_fn')
        return self._fns['get']

    def states_fn(self):
        """values -> (root.get(), derived {name: value}, {'<name>:<index>':
        calculator.__getstate__()}) of one :meth:`evaluate`, compiled as
        :meth:`get_fn` is. Made once a pipeline."""
        if 'states' not in self._fns:
            def fn(values):
                result = self.evaluate(values)
                states = {c.runtime_info.name + ':' + str(i): c.__getstate__()
                          for i, c in enumerate(self.calculators)}
                return result, self.derived, states
            self._fns['states'] = self.capture(fn, name='Pipeline.states_fn')
        return self._fns['states']

    def host_evaluate(self, values=None):
        """Initialization-time evaluation: float64 on the CPU."""
        return self.evaluate(values, device='cpu', dtype=config.HOST_DTYPE)

    def profile_speed(self, niterations=10, batch=1):
        """Per-calculator wall time and batched-call throughput (the
        reference's Monitor/_set_speed analog, base.py:695-735; the JAX
        package's ``profile_speed``). Every parameter at its default, ``batch``
        chains, on the pipeline's device; on the card each
        calculator's ``calculate`` and each whole call is bracketed by
        ``torch.cuda.synchronize``. Returns {'eager_per_calculator': {name:
        seconds a call}, 'compiled_per_eval': seconds an evaluation of the
        whole batched call through :meth:`get_fn` (compiled: replayed as a
        CUDA graph on the card, eager on the CPU), 'compiled_evals_per_sec',
        'per_call', 'batch'}, the JAX package's keys."""
        import time
        device, dtype = self.device, config.get_dtype()
        sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
        names = [c.runtime_info.name for c in self.calculators]
        counts = {n: names.count(n) for n in names}
        ordinal, keys = {}, []
        for n in names:  # unique per-instance keys (multi-tracer graphs repeat class names)
            ordinal[n] = ordinal.get(n, 0) + 1
            keys.append('{}#{}'.format(n, ordinal[n]) if counts[n] > 1 else n)
        values = {p.name: torch.full((batch,), float(p.value), dtype=dtype, device=device)
                  for p in self.varied_params}
        full = self._resolve_values(values, device=device, dtype=dtype)
        timings = dict.fromkeys(keys, 0.)
        niterations = max(1, int(niterations))
        with torch.no_grad():
            self.run_once(full)  # first use (kernel builds, caches) outside the timings
            for _ in range(niterations):
                for key, calc in zip(keys, self.calculators):
                    cvals = {p.basename: full[p.name] for p in calc.runtime_info.params
                             if p.derived is not True and not p.drop}
                    calc.dtype, calc.device = dtype, device
                    sync()
                    t0 = time.perf_counter()
                    calc.calculate(**cvals)
                    sync()
                    timings[key] += time.perf_counter() - t0
            nrep = max(3, niterations)
            fn = self.get_fn()
            fn(values)  # its capture, on the card, outside the timing
            sync()
            t0 = time.perf_counter()
            for _ in range(nrep):
                fn(values)
            sync()
            per_call = (time.perf_counter() - t0) / nrep
        per_eval = per_call / batch
        return {'eager_per_calculator': {key: t / niterations for key, t in timings.items()},
                'compiled_per_eval': per_eval,
                'compiled_evals_per_sec': 1. / per_eval if per_eval > 0 else float('inf'),
                'per_call': per_call, 'batch': int(batch)}

    # --- external (host-cosmology) state ---

    def external_nodes(self):
        """(index, calculator) of the calculators with injectable external
        state (the host-code products of ``Cosmology(engine='external')``)."""
        return [(i, c) for i, c in enumerate(self.calculators) if getattr(c, '_external_attrs', None)]

    def external_values(self):
        """The current external tables, keyed ``'external:<index>:<attr>'``
        for the values dict of a call, as tensors of the compute dtype on the
        pipeline's device: the copies the nodes made at injection (or now,
        once for each injected table)."""
        dtype, device = config.get_dtype(), self.device
        return {'external:{}:{}'.format(i, attr): calc.external_tensor(attr, dtype, device)
                for i, calc in self.external_nodes() for attr in calc._external_attrs}

    def get_cosmo_requires(self):
        """The host-cosmology requirements the calculators declare, merged
        (section -> quantity -> arguments; the grids are the nodes', the last
        one wins)."""
        merged = {}
        for calc in self.calculators:
            for section, quantities in getattr(calc, 'cosmo_requires', {}).items():
                merged.setdefault(section, {}).update(quantities)
        return merged

    def set_cosmo_requires(self, **products):
        """Inject host-cosmology products into every external node; follow
        with :meth:`external_values` for the values dict of a call."""
        for _, calc in self.external_nodes():
            calc.inject(**products)

    def logprior(self, values):
        """Sum of log priors of varied params at given (resolved) values -> (B,)."""
        logp = torch.zeros_like(next(iter(values.values())))
        for p in self.varied_params:
            if p.prior is not None:
                logp = logp + p.prior.logpdf(values[p.name])
        return logp
