"""``tests/data/torch_port_joint_reference.npz`` against a second computation
by the JAX package: the frozen config-4 state and two of its 16 points,
recomputed at full width with ``bench.build_likelihood()`` and one
``jax.jit(jax.vmap)`` of the log-posterior and solved parameters, so that the
file, which the tests of the PyTorch port and ``chip_smoke.py`` rely on,
agrees with what the JAX package computes. That second computation is
frozen in ``tests/data/torch_port_tier1b_reference.npz``
(``scripts/make_torch_port_reference.py tier1b``) for the tier-1 clock, so
these tests run neither package: they hold two files written by the same
script against each other. The JAX package is the fixed reference of the
port; after a change to it, regenerating both files (``joint``, then
``tier1b``) is what keeps them from going stale.

At reduced cost: the log-posterior and the solved parameters of two points,
forward only (the JAX package's gradient at full width takes minutes to
compile on a CPU; ``tests/test_torch_joint_gradient.py`` holds the port's
gradient against the live package on a reduced build).
"""

import os

import numpy as np

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_joint_reference.npz'))
TIER1B = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tier1b_reference.npz'))


def test_frozen_state_matches_live_jax():
    assert list(TIER1B['joint_names']) == list(REFERENCE['names'])
    assert list(TIER1B['joint_solved_names']) == list(REFERENCE['solved_names'])
    assert int(TIER1B['joint_nobservables']) == 4
    for i in range(4):
        np.testing.assert_allclose(TIER1B['joint_pk_dd_fid.{:d}'.format(i)], REFERENCE['pk_dd_fid.{:d}'.format(i)],
                                   rtol=1e-6)
        np.testing.assert_allclose(TIER1B['joint_pknow_dd_fid.{:d}'.format(i)],
                                   REFERENCE['pknow_dd_fid.{:d}'.format(i)], rtol=1e-6)
        np.testing.assert_allclose(TIER1B['joint_wmatrix.{:d}'.format(i)], REFERENCE['wmatrix.{:d}'.format(i)],
                                   rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(TIER1B['joint_flatdata'], REFERENCE['flatdata'], rtol=1e-6)
    np.testing.assert_allclose(TIER1B['joint_whiten'], REFERENCE['whiten'], rtol=1e-6, atol=1e-12)
    assert REFERENCE['static_J'].shape == (26, 368) and REFERENCE['points'].shape == (16, 18)
    np.testing.assert_array_equal(REFERENCE['points'].astype('f4').astype('f8'), REFERENCE['points'])


def test_frozen_points_match_live_jax():
    """Same package and dtype: only another XLA build or batch size could move
    the float32 rounding, which the frozen values bound themselves: they are
    5.5e-2 from their own x64 values."""
    solved_names = list(REFERENCE['solved_names'])
    values, solved = TIER1B['joint_logpost'], TIER1B['joint_solved']
    np.testing.assert_allclose(values, REFERENCE['logpost'][:2], rtol=0., atol=0.15)
    np.testing.assert_allclose(values, REFERENCE['logpost_x64'][:2], rtol=0., atol=0.15)
    # the stochastic and counter terms are well determined; the broadband powers are nearly
    # degenerate among themselves and carry the float32 error of the solve
    for i, name in enumerate(solved_names):
        scale = np.abs(REFERENCE['solved_x64'][:, i]).max()
        np.testing.assert_allclose(solved[:, i], REFERENCE['solved_x64'][:2, i], rtol=0.,
                                   atol=(0.5 if '.al' in name else 2e-2) * scale, err_msg=name)
