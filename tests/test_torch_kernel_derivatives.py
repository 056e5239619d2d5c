"""The derivatives of the port's Chebyshev Functions, on the CPU.

``_Clenshaw`` (the series) and ``_ClenshawCoeffGrad`` (its gradient in the
coefficients) in ``desilike_tpu_torch/ops/cuda_kernels.py`` launch the CUDA
kernels on a CUDA tensor and run the plain versions on a CPU one, and build
every derivative from each other. Called on CPU tensors, their formulas are
held here against autograd through the plain recurrence
(``clenshaw_reference``): ``torch.func.jvp``, ``jacfwd``, ``jacrev``,
``hessian`` and ``vmap``, and double backward, within 1e-5 of the
magnitude in float32 (measured on the CPU: below 1e-6; the two sides round the same
recurrence in another order). ``tests/test_torch_gpu.py`` holds the same on
the card.
"""

import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, jacrev, jvp, vmap

from desilike_tpu_torch.ops.cuda_kernels import (_Clenshaw, _ClenshawCoeffGrad, clenshaw, clenshaw_coeff_grad_reference,
                                                 clenshaw_reference)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The per-step ops here are tiny: one thread each (more only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5
B, Q, ORDER = 4, 16, 24


def inputs(per_row, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1., 1., (B, Q)), dtype=torch.float32)
    decay = 1. / (1. + np.arange(ORDER)) ** 2
    c = rng.normal(size=(B, ORDER) if per_row else ORDER) * decay
    c[..., 0] += 1.
    return x, torch.tensor(c, dtype=torch.float32)


def close(got, expected):
    err = float((got - expected).abs().max() / expected.abs().max())
    assert err <= RTOL, err


def kernel(log_values):
    return lambda x, c: _Clenshaw.apply(x, c, log_values)


def plain(log_values):
    return lambda x, c: clenshaw_reference(x, c, log_values)


CASES = [(per_row, log_values) for per_row in (False, True) for log_values in (True, False)]
IDS = ['{}-{}'.format('per_row' if p else 'shared', 'exp' if lv else 'series') for p, lv in CASES]


@pytest.mark.parametrize('per_row,log_values', CASES, ids=IDS)
def test_jvp(per_row, log_values):
    x, c = inputs(per_row)
    dx, dc = torch.randn_like(x), torch.randn_like(c)
    for tangents in ((dx, torch.zeros_like(c)), (torch.zeros_like(x), dc), (dx, dc)):
        close(jvp(kernel(log_values), (x, c), tangents)[1], jvp(plain(log_values), (x, c), tangents)[1])


@pytest.mark.parametrize('per_row,log_values', CASES, ids=IDS)
def test_jacfwd_jacrev(per_row, log_values):
    x, c = inputs(per_row)
    for transform in (jacfwd, jacrev):
        for argnums in (0, 1):
            close(transform(kernel(log_values), argnums=argnums)(x, c),
                  transform(plain(log_values), argnums=argnums)(x, c))


@pytest.mark.parametrize('per_row,log_values', CASES, ids=IDS)
def test_vmap(per_row, log_values):
    """A leading batch of 3 over x, over the coefficients, and over both."""
    x, c = inputs(per_row)
    xs = x + 0.01 * torch.randn((3,) + x.shape)
    cs = c + 0.01 * torch.randn((3,) + c.shape)
    for in_dims, args in (((0, None), (xs, c)), ((None, 0), (x, cs)), ((0, 0), (xs, cs)),
                          ((1, 0), (xs.movedim(0, 1), cs))):
        close(vmap(kernel(log_values), in_dims=in_dims)(*args), vmap(plain(log_values), in_dims=in_dims)(*args))


@pytest.mark.parametrize('per_row,log_values', CASES, ids=IDS)
def test_double_backward(per_row, log_values):
    """d2/dx2 and d2/(dx dc) by double backward: the first backward with
    create_graph, then the gradient of a weighted sum of its results."""
    x, c = inputs(per_row)
    weight = torch.linspace(-1., 1., B * Q).reshape(B, Q)
    results = []
    for function in (kernel(log_values), plain(log_values)):
        xg, cg = x.clone().requires_grad_(True), c.clone().requires_grad_(True)
        gx, gc = torch.autograd.grad((function(xg, cg) * weight).sum(), (xg, cg), create_graph=True)
        results.append(torch.autograd.grad((gx * weight).sum() + (gc * gc).sum(), (xg, cg)))
    for got, expected in zip(*results):
        close(got, expected)


@pytest.mark.parametrize('per_row,log_values', CASES, ids=IDS)
def test_hessian(per_row, log_values):
    x, c = inputs(per_row)

    def scalar(function):
        return lambda v: (function(v[:B * Q].reshape(B, Q), v[B * Q:].reshape(c.shape)) ** 2).sum()

    v = torch.cat([x.reshape(-1), c.reshape(-1)])
    close(hessian(scalar(kernel(log_values)))(v), hessian(scalar(plain(log_values)))(v))


@pytest.mark.parametrize('per_row', [False, True], ids=['shared', 'per_row'])
def test_coeff_grad_function(per_row):
    """_ClenshawCoeffGrad on its own: value, backward in x, w and y, jvp, and
    a vmap over w, against the plain version and autograd through it."""
    x, _ = inputs(per_row)
    rng = np.random.default_rng(1)
    w, y = (torch.tensor(rng.normal(size=(B, Q)), dtype=torch.float32) for _ in range(2))

    def function(x, w, y):
        return _ClenshawCoeffGrad.apply(x, w, y, ORDER, per_row)

    def reference(x, w, y):
        return clenshaw_coeff_grad_reference(x, w * y, ORDER, per_row)

    close(function(x, w, y), reference(x, w, y))
    for transform in (jacrev, jacfwd):
        for got, expected in zip(transform(function, argnums=(0, 1, 2))(x, w, y),
                                 transform(reference, argnums=(0, 1, 2))(x, w, y)):
            close(got, expected)
    ws = w + torch.randn((3,) + w.shape)
    close(vmap(function, in_dims=(None, 0, None))(x, ws, y), vmap(reference, in_dims=(None, 0, None))(x, ws, y))


def test_device_rule_on_the_cpu():
    """On CPU tensors the public wrapper goes through the Functions, which
    reach the plain recurrence (no launch), with its values."""
    for per_row in (False, True):
        x, c = inputs(per_row)
        expected = clenshaw_reference(x, c)
        assert torch.equal(clenshaw(x, c), expected)
        assert torch.equal(_Clenshaw.apply(x, c, True), expected)
    for function in (_Clenshaw, _ClenshawCoeffGrad):
        for name in ('setup_context', 'jvp', 'vmap'):
            assert name in vars(function), (function, name)
