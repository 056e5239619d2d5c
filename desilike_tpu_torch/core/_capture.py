"""The port's ``jax.jit``: a function captured as a CUDA graph, once a
signature, and replayed.

Where the JAX package compiles its entry points (``logpost_fn(jit=True)``,
``Pipeline.get_fn`` and ``states_fn``, the samplers' log-density and
gradient) with ``jax.jit``, the port captures them on the card. The first
call with a given signature runs the function once on the caller's stream
(the warm-up: kernel builds, lazily made constants, library handles; its
outputs are that call's, as a first ``jax.jit`` call runs what it
compiled) and captures it into a ``torch.cuda.CUDAGraph`` on a side
stream. Every later call with that signature copies its inputs into the
graph's input buffers, replays the graph and copies its outputs out. The
signature is the structure of the arguments and, for each argument, its
shape and dtype: a tensor, a numpy array, or a Python number (a 0-dim
float64, int64 or bool buffer, filled at each call, an input like any
other). What the function reads besides its arguments is fixed at capture,
as ``jax.jit`` fixes the constants a function closes over.

Memory: the warm-up runs where an eager call would (on the caller's
stream, whose cached blocks it reuses); the state that it left on the
pipeline's calculators (``release``), with the autograd graphs that hang
from it, and what only a cycle holds of it go before the capture; the
capture then holds about an eager call's peak where the allocator maps its
memory in expandable segments, the port's default (``config.py``).

A replay's outputs are copies, so that no caller holds a buffer that the
next replay overwrites. No output carries autograd history: the function
runs under ``torch.no_grad``, unless it enables it itself, as the samplers'
log-density-and-gradient does around ``torch.autograd.grad``.

A call runs the function eagerly instead where it cannot be captured or
would change meaning, as ``jax.jit`` inlines under an outer transform: on
the CPU (the tests' path), inside another capture, under a ``torch.func``
transform, or with an argument that requires a gradient while autograd is
on. A capture that fails raises; no call falls back to the eager function.

The Clenshaw kernels' launch counters (``ops/cuda_kernels.py``) are Python
counters that a replay would not move: each graph keeps the launches it
captured, which are taken back from the counters after the capture, and
adds them at every replay. The warm-up's launches are real ones and count,
so that every call counts each launch once.

Each captured function keeps its graphs in one memory pool and at most
``MAX_SIGNATURES`` of them, the least recently used dropped first;
:meth:`CapturedFunction.clear` drops them all and returns the pool's
memory to the card.
"""

import collections
import gc
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..ops import cuda_kernels
from .. import config

MAX_SIGNATURES = 4
"""The graphs a captured function keeps: each holds its intermediates in the pool."""


def _under_transform(leaves):
    """Whether a ``torch.func`` transform is active or wraps one of the tensors."""
    functorch = torch._C._functorch
    return functorch.peek_interpreter_stack() is not None or any(
        functorch.is_functorch_wrapped_tensor(leaf) for leaf in leaves if isinstance(leaf, torch.Tensor))


def signature(args):
    """The key a call's graph is kept under: the structure of ``args`` and,
    for each leaf, ('tensor', shape, dtype, device), ('host', shape, dtype)
    for a number or a numpy array (a Python float is float64, an int int64),
    or ('constant', value) for anything else (fixed in the graph). Returns
    (key, leaves)."""
    leaves, spec = pytree.tree_flatten(args)
    kinds = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            kinds.append(('tensor', tuple(leaf.shape), leaf.dtype, leaf.device))
        elif isinstance(leaf, (bool, int, float, np.generic, np.ndarray)) and np.asarray(leaf).dtype.kind in 'biuf':
            array = np.asarray(leaf)
            kinds.append(('host', array.shape, torch.from_numpy(array.reshape(-1)[:0]).dtype))
        else:
            kinds.append(('constant', leaf))
    return (spec, tuple(kinds)), leaves


def _input_buffers(kinds, device):
    """One buffer on ``device`` for each leaf that is not a constant (None for those)."""
    return [torch.empty(kind[1], dtype=kind[2], device=device) if kind[0] != 'constant' else None for kind in kinds]


def _load(buffers, leaves):
    """Copy the call's leaves into the input buffers: a tensor by a copy on
    the card, a Python number by a fill (no copy from the host)."""
    for buffer, leaf in zip(buffers, leaves):
        if buffer is None:
            continue
        if isinstance(leaf, torch.Tensor):
            buffer.copy_(leaf.detach())
        elif isinstance(leaf, (bool, int, float)):
            buffer.fill_(leaf)
        else:
            buffer.copy_(torch.as_tensor(np.asarray(leaf)))


class _Graph(object):
    """One captured signature: the graph, its input buffers, its outputs
    (the tensors it writes at each replay, in the function's structure) and
    the kernel launches it holds."""

    def __init__(self, graph, inputs, outputs, launches, retained):
        self.graph, self.inputs, self.launches, self.retained = graph, inputs, launches, retained
        self.leaves, self.spec = pytree.tree_flatten(outputs)

    def outputs(self):
        """Copies of the outputs of the last replay, in the function's structure."""
        return pytree.tree_unflatten([leaf.detach().clone() if isinstance(leaf, torch.Tensor) else leaf
                                      for leaf in self.leaves], self.spec)


class CapturedFunction(object):
    """``fn`` (a function of tensors, Python numbers and nested dicts,
    lists and tuples of them) captured and replayed on ``device`` (see the
    module's docstring); eager on a CPU device.

    version: a function of no argument whose value joins the signature
    (e.g. the pipeline's defaults version: a graph never replays on
    constants that changed since its capture). retain: a function of no
    argument returning the tensors the function may read besides its
    arguments and closure (e.g. every tensor reachable from the pipeline's
    calculators); each graph keeps alive those that are there both before
    and after its capture: the constants, not the state that the capture
    sets anew. release: a function of no argument called just before the
    warm-up, returning a function of no argument that is called just after
    it to let go of what the warm-up left behind (the calculators' state)."""

    def __init__(self, fn, device, version=None, retain=None, release=None, name=None):
        self.fn = fn
        self.device = config.device(device)
        self.version = version
        self.retain = retain
        self.release = release
        self.name = name or getattr(fn, '__qualname__', 'function')
        self.captures = self.replays = 0
        self.capture_seconds = 0.
        self._graphs = collections.OrderedDict()
        self._pool = self._stream = None

    def capturable(self, leaves):
        """Whether a call with these argument leaves is captured or replayed
        (else it runs the function eagerly)."""
        if self.device.type != 'cuda':
            return False
        tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
        if torch.is_grad_enabled() and any(leaf.requires_grad for leaf in tensors):
            return False
        if _under_transform(leaves) or any(leaf.device != self.device for leaf in tensors):
            return False
        return not torch.cuda.is_current_stream_capturing()

    def __call__(self, *args):
        if self.device.type != 'cuda':
            return self.fn(*args)
        key, leaves = signature(args)
        if not self.capturable(leaves):
            return self.fn(*args)
        if self.version is not None:
            key = key + (self.version(),)
        graph = self._graphs.get(key)
        if graph is None:
            return self._capture(key, leaves)
        self._graphs.move_to_end(key)
        _load(graph.inputs, leaves)
        graph.graph.replay()
        self.replays += 1
        cuda_kernels.CLENSHAW_LAUNCHES += graph.launches[0]
        cuda_kernels.COEFF_GRAD_LAUNCHES += graph.launches[1]
        return graph.outputs()

    def _capture(self, key, leaves):
        """The first call of a signature: the warm-up, whose outputs are the
        call's, then the capture, kept under ``key``."""
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            inputs = _input_buffers(key[1], self.device)
            _load(inputs, leaves)
            static = pytree.tree_unflatten([leaf if buffer is None else buffer for leaf, buffer in zip(leaves, inputs)],
                                           key[0])
            forget = self.release() if self.release is not None else None
            with torch.no_grad():
                result = self.fn(*static)  # the warm-up, on the caller's stream as an eager call
            if forget is not None:
                forget()
            gc.collect()  # what only a cycle still holds of the warm-up goes too
            marks = {id(tensor) for tensor in self.retain()} if self.retain is not None else set()
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            cuda_graph = torch.cuda.CUDAGraph()
            counters = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
            try:
                # torch.cuda.graph empties the cache first: what the warm-up let go goes to the pool
                with torch.cuda.graph(cuda_graph, pool=self._pool, stream=self._stream), torch.no_grad():
                    outputs = self.fn(*static)
            except Exception as exc:
                _end_failed_capture(self.device, self._pool)
                self._stream = self._pool = None  # the next capture takes a new stream and pool
                cause = exc.__context__ or exc  # what failed inside the capture, where ending it failed too
                message = 'capturing {} as a CUDA graph failed (signature {}): {}: {}'.format(
                    self.name, _describe(key), type(cause).__name__, cause)
                del cause  # no cycle through this frame: the capture's tensors go with the exception
                raise RuntimeError(message) from exc
            finally:
                launches = (cuda_kernels.CLENSHAW_LAUNCHES - counters[0], cuda_kernels.COEFF_GRAD_LAUNCHES - counters[1])
                cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES = counters
        retained = [tensor for tensor in self.retain() if id(tensor) in marks] if self.retain is not None else None
        graph = _Graph(cuda_graph, inputs, outputs, launches, retained)
        self._graphs[key] = graph
        while len(self._graphs) > MAX_SIGNATURES:
            self._graphs.popitem(last=False)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return result

    @property
    def signatures(self):
        """The number of signatures held (captured graphs)."""
        return len(self._graphs)

    def clear(self):
        """Drop every graph and its buffers, and return the pool's memory to the card."""
        self._graphs.clear()
        self._pool = None
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def _end_failed_capture(device, pool):
    """Undo what a capture that raised leaves behind where ending it failed
    half way (a CUDA error inside the capture; an out-of-memory error ends
    it cleanly, and its graph releases ``pool``): the allocator still
    routes the capture stream's allocations into ``pool`` (a later stream
    that reuses its handle would allocate there), the pool is never
    released (its memory out of ``empty_cache``'s reach), and the CUDA
    generators still count their offsets as inside a capture (every later
    draw on the card would raise). The routing is ended and the pool
    released, and one capture of a trivial op, begun and ended, returns the
    generators to eager draws."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, tuple(pool))
    except RuntimeError:  # the capture ended the routing itself: its graph releases the pool
        pass
    else:
        torch._C._cuda_releasePool(device.index, tuple(pool))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
        torch.zeros(1, device=device)
    del graph


def _describe(key):
    """A short text of a signature: the dtypes and shapes of its inputs."""
    parts = []
    for kind in key[1]:
        if kind[0] != 'constant':
            parts.append('{}{}'.format(str(kind[2]).replace('torch.', ''), list(kind[1])))
    counts = collections.Counter(parts)
    return ', '.join('{} x{}'.format(part, n) if n > 1 else part for part, n in counts.items())
