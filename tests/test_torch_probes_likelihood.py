"""Config 3j in the port (config 3d + the CMB distance prior + DES-Y5
supernovae + BBN on one ``Cosmology`` node,
``chip_smoke.build_probes_likelihood``) at its small width (64 supernovae)
against the JAX package's x64 values frozen in
``tests/data/torch_port_probes_reference.npz``: the slice test and its
gradient test.

Limits, config 3d's: at 16 points in float32 the log-posterior within 2e-2,
the gradient within 5e-4 of its norm, the 7 solved parameters (``ct*``,
``sn*``, ``Mb``) within 1e-3 of their prior width or value (measured on the
CPU: 9.7e-4, 3.1e-6 and 4.8e-4).
"""

import numpy as np
import pytest

from chip_smoke import (write_probe_files, build_probes_likelihood, at_points, solved_at_points, direct_template,
                        EPT_X64_ATOL, EPT_X64_GRAD_RTOL, SOLVED_RTOL)
from test_torch_external import REFERENCE


@pytest.fixture(scope='module')
def probes(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp('probes'))
    assert write_probe_files(directory, small=True) == int(REFERENCE['probes_small_nsn']) == 64
    return build_probes_likelihood('cpu', directory, small=True)


def test_probes_layout(probes):
    """One Cosmology node under the four likelihoods; 9 varied, 7 solved, 108 + 3 + 64 + 2 data."""
    pipe = probes.pipeline
    cosmo = direct_template(probes.likelihoods[0]).cosmo
    assert all(like.cosmo is cosmo for like in probes.likelihoods[1:])
    assert pipe.varied_params.names() == list(REFERENCE['probes_small_names'])
    assert pipe.solved_params.names() == list(REFERENCE['probes_small_solved_names'])
    assert [like.size for like in probes.likelihoods] == [108, 3, 64, 2]


def test_probes_against_x64(probes):
    """Log-posterior, gradient and solved parameters at the 16 frozen points."""
    names, points = list(REFERENCE['probes_small_names']), REFERENCE['probes_small_points']
    logpost, grad = at_points(probes, names, points)
    np.testing.assert_allclose(logpost, REFERENCE['probes_small_logpost_x64'], rtol=0., atol=EPT_X64_ATOL)
    expected = REFERENCE['probes_small_grad_x64']
    assert (np.linalg.norm(grad - expected, axis=-1) / np.linalg.norm(expected, axis=-1)).max() < EPT_X64_GRAD_RTOL
    solved, expected = solved_at_points(probes, names, points), REFERENCE['probes_small_solved_x64']
    width = np.array([p.prior.scale if p.prior is not None and p.prior.dist == 'norm' else 1.
                      for p in probes.pipeline.solved_params])
    assert (np.abs(solved - expected) / np.maximum(width, np.abs(expected))).max() < SOLVED_RTOL
