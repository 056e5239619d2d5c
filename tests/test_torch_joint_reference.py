"""``tests/data/torch_port_joint_reference.npz`` against the live JAX package:
the frozen config-4 state and two of its 16 points are recomputed at full
width with ``bench.build_likelihood()``, so that the file, which the tests
of the PyTorch port and ``chip_smoke.py`` rely on, cannot go stale.

At reduced cost: the log-posterior and the solved parameters of two points,
forward only (the JAX package's gradient at full width takes minutes to
compile on a CPU; ``tests/test_torch_joint_gradient.py`` holds the port's
gradient against the live package on a reduced build).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import bench

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_joint_reference.npz'))


@pytest.fixture(scope='module')
def likelihood():
    like = bench.build_likelihood()
    like.pipeline
    return like


def test_frozen_state_matches_live_jax(likelihood):
    pipe = likelihood.pipeline
    assert pipe.varied_params.names() == list(REFERENCE['names'])
    assert pipe.solved_params.names() == list(REFERENCE['solved_names'])
    assert len(likelihood.observables) == 4
    for i, observable in enumerate(likelihood.observables):
        template = observable.wmatrix.theory.template
        np.testing.assert_allclose(template.pk_dd_fid, REFERENCE['pk_dd_fid.{:d}'.format(i)], rtol=1e-6)
        np.testing.assert_allclose(template.pknow_dd_fid, REFERENCE['pknow_dd_fid.{:d}'.format(i)], rtol=1e-6)
        np.testing.assert_allclose(observable.wmatrix.wmatrix, REFERENCE['wmatrix.{:d}'.format(i)], rtol=1e-12,
                                   atol=1e-15)
    np.testing.assert_allclose(likelihood.flatdata, REFERENCE['flatdata'], rtol=1e-6)
    np.testing.assert_allclose(likelihood._whiten, REFERENCE['whiten'], rtol=1e-6, atol=1e-12)
    assert REFERENCE['static_J'].shape == (26, 368) and REFERENCE['points'].shape == (16, 18)
    np.testing.assert_array_equal(REFERENCE['points'].astype('f4').astype('f8'), REFERENCE['points'])


def test_frozen_points_match_live_jax(likelihood):
    """Same package and dtype: only another XLA build or batch size could move
    the float32 rounding, which the frozen values bound themselves: they are
    5.5e-2 from their own x64 values."""
    names = list(REFERENCE['names'])
    solved_names = list(REFERENCE['solved_names'])
    logpost = likelihood.logpost_fn(jit=False)

    def scalar(theta):
        value, aux = logpost(dict(zip(names, theta)))
        return value, jnp.stack([aux['solved'][name] for name in solved_names])

    theta = jnp.asarray(REFERENCE['points'][:2], dtype=jnp.float32)
    values, solved = jax.jit(jax.vmap(scalar))(theta)
    np.testing.assert_allclose(np.asarray(values), REFERENCE['logpost'][:2], rtol=0., atol=0.15)
    np.testing.assert_allclose(np.asarray(values), REFERENCE['logpost_x64'][:2], rtol=0., atol=0.15)
    # the stochastic and counter terms are well determined; the broadband powers are nearly
    # degenerate among themselves and carry the float32 error of the solve
    for i, name in enumerate(solved_names):
        scale = np.abs(REFERENCE['solved_x64'][:, i]).max()
        np.testing.assert_allclose(np.asarray(solved)[:, i], REFERENCE['solved_x64'][:2, i], rtol=0.,
                                   atol=(0.5 if '.al' in name else 2e-2) * scale, err_msg=name)
