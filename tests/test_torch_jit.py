"""The port's compiled entry points (``jit``) on the CPU.

On the card, ``logpost_fn(jit=True)``, ``Pipeline.get_fn`` / ``states_fn``
and the samplers' log-density and gradient are captured as CUDA graphs and
replayed (``desilike_tpu_torch/core/_capture.py``; ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phase A19 hold the replays against the eager calls
there). On the CPU the same entry points run the eager function: here they
are held bit-identical to it, and to the JAX package's frozen values of
configs 1 and 4 (``tests/data/torch_port_bao_reference.npz`` and
``torch_port_joint_reference.npz``, ``scripts/make_torch_port_reference.py
bao`` and ``joint``) at the tolerances of ``chip_smoke.py``. What capture
needs of a call is checked here too: the signature a graph is kept under,
the outputs that a replay copies out, the calculators' state let go after
a warm-up and the constants a graph keeps, and that after its first call a
call makes no tensor from host data but its values (config 4).
"""

import os

import numpy as np
import pytest
import torch
from torch.func import vmap

from desilike_tpu_torch.core import _capture
from desilike_tpu_torch.core._capture import CapturedFunction, signature
from desilike_tpu_torch.ops.linalg import cholesky_solve
from desilike_tpu_torch.samplers import BlockedMCMCSampler
import chip_smoke
from chip_smoke import build_likelihood, build_joint_likelihood

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), 'data')
CONFIGS = {'1': (build_likelihood, 'torch_port_bao_reference.npz', (5e-2, 1e-2), (2e-3, 5e-4)),
           '4': (build_joint_likelihood, 'torch_port_joint_reference.npz',
                 (chip_smoke.JOINT_F32_ATOL, chip_smoke.JOINT_F32_GRAD_RTOL),
                 (chip_smoke.JOINT_X64_ATOL, chip_smoke.JOINT_X64_GRAD_RTOL))}


@pytest.fixture(scope='module')
def likelihoods():
    return {config: make('cpu') for config, (make, _, _, _) in CONFIGS.items()}


def logpost_and_grad(fn, names, points):
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, aux = fn(values)
    logpost.sum().backward()
    return logpost.detach(), torch.stack([values[n].grad for n in names], dim=-1), aux


@pytest.mark.parametrize('config', list(CONFIGS))
def test_logpost_jit_matches_eager_and_jax(likelihoods, config):
    """``logpost_fn(jit=True)`` (the default) on the CPU: the eager function,
    bit-identical to ``jit=False`` (log-posterior, gradient, every aux
    tensor), within the frozen JAX float32 and x64 values' tolerances."""
    _, filename, (f32_atol, f32_grad), (x64_atol, x64_grad) = CONFIGS[config]
    reference = np.load(os.path.join(DATA, filename))
    like, names = likelihoods[config], list(reference['names'])
    jitted = like.logpost_fn()
    assert isinstance(jitted, CapturedFunction) and jitted.device.type == 'cpu'
    got = logpost_and_grad(jitted, names, reference['points'])
    expected = logpost_and_grad(like.logpost_fn(jit=False), names, reference['points'])
    error, identical = chip_smoke.outputs_error(got, expected)
    assert identical and error == 0.
    assert jitted.captures == jitted.replays == 0
    lp, grad = got[0].numpy(), got[1].numpy()
    for (atol, grad_rtol), suffix in (((f32_atol, f32_grad), ''), ((x64_atol, x64_grad), '_x64')):
        assert np.abs(lp - reference['logpost' + suffix]).max() <= atol
        expected_grad = reference['grad' + suffix]
        assert (np.linalg.norm(grad - expected_grad, axis=-1) / np.linalg.norm(expected_grad, axis=-1)).max() <= grad_rtol


def test_get_fn_and_states_fn_match_evaluate(likelihoods):
    """``get_fn`` / ``states_fn``, the same capture helper always on, are
    bit-identical to ``evaluate`` on the CPU, with a scalar among the values."""
    pipe = likelihoods['1'].pipeline
    names = pipe.varied_params.names()
    values = {n: v.detach() for n, v in chip_smoke.chains(names, 8, seed=3, device='cpu').items()}
    values[names[0]] = 1.01  # a scalar, broadcast to the batch
    assert isinstance(pipe.get_fn(), CapturedFunction) and pipe.get_fn() is pipe.get_fn()
    with torch.no_grad():
        expected = pipe.evaluate(values)
        derived = dict(pipe.derived)
        got = pipe.get_fn()(values)
        result, states_derived, states = pipe.states_fn()(values)
    assert torch.equal(got, expected) and torch.equal(result, expected)
    assert list(states_derived) == list(derived) and all(torch.equal(states_derived[n], derived[n]) for n in derived)
    assert len(states) == len(pipe.calculators)


def test_signature():
    """The key a graph is kept under: the batch size, the dtypes, which
    values are scalars and which (B,) tensors, the external tables' shapes;
    not the values themselves."""
    def key(values):
        return signature((values,))[0]

    base = {'a': torch.zeros(4), 'b': 1., 'external:0:table': torch.zeros((3, 5))}
    assert key(base) == key({'a': torch.ones(4), 'b': 2., 'external:0:table': torch.ones((3, 5))})
    for other in ({'a': torch.zeros(8), 'b': 1., 'external:0:table': torch.zeros((3, 5))},
                  {'a': torch.zeros(4, dtype=torch.float64), 'b': 1., 'external:0:table': torch.zeros((3, 5))},
                  {'a': torch.zeros(4), 'b': torch.ones(4), 'external:0:table': torch.zeros((3, 5))},
                  {'a': torch.zeros(4), 'b': 1, 'external:0:table': torch.zeros((3, 5))},
                  {'a': torch.zeros(4), 'b': 1., 'external:0:table': torch.zeros((3, 6))},
                  {'a': torch.zeros(4), 'b': 1.}):
        assert key(other) != key(base)
    kinds = signature(({'a': torch.zeros(4), 'b': 1., 'c': np.float32(2.), 'd': np.zeros(3), 'e': 'text'},))[0][1]
    assert kinds == (('tensor', (4,), torch.float32, torch.device('cpu')), ('host', (), torch.float64),
                     ('host', (), torch.float32), ('host', (3,), torch.float64), ('constant', 'text'))
    assert _capture._describe(key(base)) == 'float32[4], float64[], float32[3, 5]'


def test_replay_outputs_are_copies():
    """A replay's outputs are copied out of the graph's output tensors: the
    same structure and values, fresh tensors (not the graph's, not each
    other's), constants passed through; inputs load by a copy or a fill."""
    outputs = ({'lp': torch.arange(4.), 'info': torch.arange(4, dtype=torch.int32),
                'solved': {'x': torch.ones(4), 'y': torch.full((4,), 2.)}, 'hessian': torch.eye(3).expand(4, 3, 3)},
               'text', 7)
    graph = _capture._Graph(None, [], outputs, (0, 0), None)
    first, second = graph.outputs(), graph.outputs()
    assert chip_smoke.outputs_error(first, outputs) == (0., True)
    assert first[0]['lp'].data_ptr() != second[0]['lp'].data_ptr() != outputs[0]['lp'].data_ptr()
    assert first[0]['hessian'].untyped_storage().data_ptr() != outputs[0]['hessian'].untyped_storage().data_ptr()
    buffers = _capture._input_buffers(signature(({'a': torch.zeros(3), 'b': 1.5, 'c': 'x'},))[0][1], 'cpu')
    _capture._load(buffers, [torch.arange(3.), 1.5, 'x'])
    assert torch.equal(buffers[0], torch.arange(3.)) and buffers[1].item() == 1.5 and buffers[2] is None


def test_warmup_state_and_graph_constants(likelihoods):
    """What a capture does around its warm-up, on config 1's pipeline: the
    public attributes that a call set and that hold only tensors (the
    calculators' state) are let go after it, the caches kept, and the next
    call is bit-identical; a graph may read every tensor reachable from the
    calculators (their cached constants, their attributes) and the
    defaults' tensors, with no module's cache named."""
    pipe = likelihoods['1'].pipeline
    names = pipe.varied_params.names()
    values = {n: v.detach() for n, v in chip_smoke.chains(names, 8, seed=5, device='cpu').items()}
    with torch.no_grad():
        expected = pipe.evaluate(values)
        constants = {id(t) for t in pipe._graph_constants()}
        attributes = [v for calc in pipe.calculators for v in calc.__dict__.values() if isinstance(v, torch.Tensor)]
        assert attributes and all(id(t) in constants for t in attributes)
        cached = [t for calc in pipe.calculators for _, tensors in calc.__dict__.get('_const_cache', {}).values()
                  for t in tensors.values()]
        assert cached and all(id(t) in constants for t in cached)
        assert all(id(t) in constants for tensors in pipe._defaults_cache[1].values() for t in tensors.values())
        forget = pipe._warmup_state()
        pipe.evaluate(values)
        state = [{n for n, v in calc.__dict__.items() if isinstance(v, torch.Tensor)} for calc in pipe.calculators]
        forget()
        left = [{n for n, v in calc.__dict__.items() if isinstance(v, torch.Tensor)} for calc in pipe.calculators]
        assert all(b <= a for a, b in zip(state, left)) and sum(map(len, left)) < sum(map(len, state))
        assert all(not n.startswith('_') for a, b in zip(state, left) for n in a - b)
        assert any('_const_cache' in calc.__dict__ for calc in pipe.calculators)
        assert torch.equal(pipe.evaluate(values), expected)


def test_second_call_makes_no_host_tensor(likelihoods, monkeypatch):
    """Config 4: after the first call (which makes the defaults' tensors), a
    forward call makes no tensor from host data (``torch.as_tensor``,
    ``torch.tensor``, ``torch.from_numpy`` of anything but a tensor): on the
    card it copies nothing from the host, so that it can be captured; the
    defaults are made again only after a default changes."""
    like = likelihoods['4']
    pipe = like.pipeline
    names = pipe.varied_params.names()
    values = {n: v.detach() for n, v in chip_smoke.chains(names, 8, seed=4, device='cpu').items()}
    fn = like.logpost_fn()
    with torch.no_grad():
        first = fn(values)[0]
    made = []
    for name in ('as_tensor', 'tensor', 'from_numpy'):
        original = getattr(torch, name)

        def counting(data, *args, _original=original, _name=name, **kwargs):
            if not isinstance(data, torch.Tensor):
                made.append(_name)
            return _original(data, *args, **kwargs)
        monkeypatch.setattr(torch, name, counting)
    version = pipe._defaults_version
    with torch.no_grad():
        second = fn(values)[0]
    assert made == [] and torch.equal(first, second) and pipe._defaults_version == version
    fixed = next(p for p in pipe.params if p.fixed and p.derived is not True)
    fixed.update(value=fixed.value + 0.)  # the same value: nothing made again
    with torch.no_grad():
        fn(values)
    assert made == [] and pipe._defaults_version == version
    saved = fixed.value
    try:
        fixed.update(value=saved + 1e-3)
        with torch.no_grad():
            fn(values)
        assert made and pipe._defaults_version == version + 1
        assert float(pipe._default_tensors(torch.device('cpu'), torch.float32)[fixed.name]) == np.float32(saved + 1e-3)
    finally:
        fixed.update(value=saved)


def test_host_calculators_refuse_jit():
    """``logpost_fn(jit=True)`` on a pipeline with a host-evaluated calculator
    raises, as the JAX package's trace does; ``jit=False`` is the eager
    function, and the blocked sampler runs on it (``desilike_tpu/samplers/mcmc.py:211``)."""
    _, host_like, _ = chip_smoke.gaussian_likelihoods('cpu')
    assert host_like.pipeline.host_calculators()
    with pytest.raises(ValueError, match='host-evaluated'):
        host_like.logpost_fn()
    with pytest.raises(ValueError, match='host-evaluated'):
        host_like.logpost_fn(jit=True)
    assert not isinstance(host_like.logpost_fn(jit=False), CapturedFunction)
    sampler = BlockedMCMCSampler(host_like, nchains=2, seed=1)
    chain = sampler.run(nsteps=6)
    assert chain.shape == (6, 2) and np.isfinite(chain['logposterior']).all()
    assert not isinstance(sampler._logpost_aux, CapturedFunction)


def test_eager_where_jax_inlines():
    """The calls that run eagerly whatever the device (an outer ``torch.func``
    transform, an argument that requires a gradient with autograd on), and
    the CPU: a CPU captured function never captures."""
    calls = []

    def fn(values):
        calls.append(1)
        return values['a'] * 2.

    captured = CapturedFunction(fn, 'cpu')
    assert captured({'a': torch.ones(3)}).tolist() == [2.] * 3 and captured.signatures == 0
    inside = []
    vmap(lambda a: inside.append(_capture._under_transform([a])) or a)(torch.ones(2, 3))
    assert inside == [True] and not _capture._under_transform([torch.ones(3)])
    cuda = CapturedFunction.__new__(CapturedFunction)
    cuda.device = torch.device('cuda', 0)  # the decisions taken before the card is asked
    assert not cuda.capturable([torch.ones(3, requires_grad=True)])
    assert vmap(lambda a: torch.tensor(float(not cuda.capturable([a]))))(torch.ones(2, 3)).tolist() == [1., 1.]
    assert not cuda.capturable([torch.ones(3)])  # a tensor on another device: the eager call raises


def test_cholesky_solve_by_triangular_solves():
    """The solve the likelihoods use in place of ``torch.cholesky_solve``
    (which synchronises with the host on the card): two triangular solves,
    batched factors and one factor for a batch of right-hand sides."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 5, 5))
    matrices = torch.tensor(a @ np.swapaxes(a, -1, -2) + 5. * np.eye(5))
    factors = torch.linalg.cholesky(matrices)
    rhs = torch.tensor(rng.normal(size=(6, 5, 3)))
    assert torch.allclose(cholesky_solve(rhs, factors), torch.cholesky_solve(rhs, factors), rtol=1e-12, atol=1e-12)
    assert torch.allclose(cholesky_solve(rhs, factors[0]), torch.cholesky_solve(rhs, factors[0]), rtol=1e-12,
                          atol=1e-12)
    assert torch.allclose(cholesky_solve(rhs[0], factors[0]), torch.cholesky_solve(rhs[0], factors[0]), rtol=1e-12,
                          atol=1e-12)
