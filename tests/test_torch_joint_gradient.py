"""Gradient of the joint two-tracer likelihood in the PyTorch port against the
live JAX package, on the reduced build of ``tests/test_torch_joint_likelihood.py``
(k bins of 0.02, 4 points).

The JAX side is one compiled forward-mode derivative (``jax.jvp``) whose
direction is an argument, so that several directions cost one compile:
reverse mode over this graph (eight unrolled order-202 recurrences) takes
minutes to compile on a CPU, forward mode most of a minute. The port's
gradient comes from one backward pass and is projected on the same
directions; on the CPU it runs through the plain versions of the kernels
and autograd, the coefficients of the ShapeFit tables included.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_joint_likelihood import NAMES, REFERENCE, build_reduced, evaluate

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def directions():
    """Unit directions in the space of the 18 varied parameters: along dm
    and df of each tracer (the ShapeFit table and the growth rate), and three
    seeded random ones."""
    rows = [np.eye(len(NAMES))[NAMES.index(name)] for name in ('LRG.dm', 'ELG.dm', 'LRG.df', 'ELG.df')]
    rng = np.random.default_rng(11)
    rows += [v / np.linalg.norm(v) for v in rng.normal(size=(3, len(NAMES)))]
    return np.array(rows, dtype='f4')


def test_reduced_gradient_matches_jax(directions):
    """Directional derivatives of the log-posterior, float32 in both
    packages: within 1e-2 of the gradient's norm (the JAX package's float32
    gradient is 2.0e-3 from its own x64 value at full width; the port's 6e-5)."""
    ref = build_reduced('desilike_tpu')
    logpost = ref.logpost_fn(jit=False)
    assert ref.pipeline.varied_params.names() == NAMES

    def derivative(theta, direction):
        return jax.jvp(lambda t: logpost(dict(zip(NAMES, t)))[0], (theta,), (direction,))[1]

    points = REFERENCE['points'][:4].astype('f4')
    compiled = jax.jit(jax.vmap(derivative, in_axes=(0, None)))
    expected = np.stack([np.asarray(compiled(jnp.asarray(points), jnp.asarray(d))) for d in directions], axis=-1)

    port = build_reduced('desilike_tpu_torch', device='cpu')
    _, grad, _ = evaluate(port, points)
    assert grad.shape == (4, len(NAMES)) and np.isfinite(grad).all()
    norm = np.linalg.norm(grad, axis=-1, keepdims=True)
    got = grad @ directions.T.astype('f8')
    err = np.abs(got - expected) / norm
    print('directional derivatives: error over the gradient\'s norm\n', err, '\nport\n', got, '\nJAX\n', expected)
    assert err.max() < 1e-2, err
    # the ShapeFit parameters do move the posterior, through the coefficients of the per-chain
    # tables: their own partial derivatives agree with the JAX package's, not only within the norm
    single = slice(0, 4)
    assert (got[:, single] != 0.).all()
    np.testing.assert_allclose(got[:, single], expected[:, single], rtol=5e-2, atol=1e-3 * norm.max())
