"""The supernova likelihoods of the port against the JAX package's x64
values frozen in ``tests/data/torch_port_probes_reference.npz``
(``scripts/make_torch_port_reference.py probes``), each dataset class read
from files in its real layout; the readers and the writer against the JAX
package's in both directions; the shared quadrature of the distances
against the per-redshift rule.

Tolerances, each with what was measured on the CPU: the dataset classes at
4 points in float32, the log-posterior within 2e-3 and the gradient within
5e-4 of its norm (config 1's limits; at most 3.1e-4 and 8.1e-5); the
shared quadrature in float64 within 1e-12 of the per-redshift 64-node rule
(2e-15); the files' arrays exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

from desilike_tpu.likelihoods import supernovae as jsn
from desilike_tpu_torch import likelihoods as L
from desilike_tpu_torch.cosmology import background as bg
from desilike_tpu_torch.likelihoods import supernovae as tsn
from chip_smoke import at_points, write_probe_files
from test_torch_external import varied_cosmology, REFERENCE

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), 'scripts'))
from make_torch_port_reference import SN_CASES  # noqa: E402


def fixture(case):
    columns = SN_CASES[case][1]
    return ({name: REFERENCE['sn_{}_{}'.format(case, name)] for name in columns},
            REFERENCE['sn_{}_covariance'.format(case)])


@pytest.mark.parametrize('case', list(SN_CASES))
def test_sn_datasets(case, tmp_path):
    """Each dataset class from files the port's writer wrote in its layout
    (Pantheon+'s z > 0.01 cut, the SH0ES calibrators, Union3's dM, DES-Y5's
    CSV and MUERR_FINAL): the log-posterior and gradient at 4 points."""
    cls, _, kwargs = SN_CASES[case]
    columns, covariance = fixture(case)
    tsn.write_sn_dataset(str(tmp_path), columns, covariance, **kwargs)
    like = getattr(L, cls)(data_dir=str(tmp_path), cosmo=varied_cosmology(('h', 'omega_cdm')))
    names = list(REFERENCE['sn_{}_names'.format(case)])
    assert like.pipeline.varied_params.names() == names
    logpost, grad = at_points(like, names, REFERENCE['sn_{}_points'.format(case)])
    np.testing.assert_allclose(logpost, REFERENCE['sn_{}_logpost_x64'.format(case)], rtol=0., atol=2e-3)
    expected = REFERENCE['sn_{}_grad_x64'.format(case)]
    assert (np.linalg.norm(grad - expected, axis=-1) / np.linalg.norm(expected, axis=-1)).max() < 5e-4


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_sn_files_both_ways(writer, tmp_path):
    """Files the port writes read by the JAX package's readers, and files the
    JAX package writes read by the port's: the same arrays, for every
    dataset layout and for config 3j's DES-Y5 sample with its comment line."""
    write, read = (tsn, jsn) if writer == 'port' else (jsn, tsn)
    for case, (cls, _, kwargs) in SN_CASES.items():
        columns, covariance = fixture(case)
        directory = str(tmp_path / case)
        write.write_sn_dataset(directory, columns, covariance, **kwargs)
        config = read.read_sn_config(os.path.join(directory, kwargs.get('config_fn', 'config.dataset')))
        owner = getattr(L, cls)
        table = read.read_light_curve_params(os.path.join(directory, config['data_file']), header=owner.lc_header,
                                             sep=owner.lc_sep, skip=owner.lc_skip)
        assert sorted(table) == sorted(columns)
        for name, value in columns.items():
            np.testing.assert_array_equal(table[name], value)
        np.testing.assert_array_equal(read.read_sn_covariance(os.path.join(directory, config['mag_covmat_file'])),
                                      covariance)
    if writer == 'port':
        directory = str(tmp_path / 'probes')
        n = write_probe_files(directory, small=True)
        ours = L.DESY5SNLikelihood(data_dir=directory, device='cpu')
        theirs = jsn.DESY5SNLikelihood(data_dir=directory)
        ours.runtime_info.initialize()
        theirs.runtime_info.initialize()
        assert ours.size == n == 64
        for name in ('z', '_mu_static', 'flatdata', 'covariance'):
            np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(theirs, name)))


def test_shared_quadrature():
    """D_M at 1829 redshifts from one shared node set (16 panels of 8 nodes)
    against the 64-node rule at each redshift, in float64; and per chain in a
    batch, with curvature."""
    z = np.linspace(0.01, 2.3, 1829)
    rule = bg.SharedQuadrature(z)
    assert rule.u.shape == (128,) and rule.weights_t.shape == (128, 1829)
    p = bg.resolve({})
    np.testing.assert_allclose(bg.comoving_angular_distances(p, rule), bg.comoving_angular_distance(p, z), rtol=1e-12)
    p = bg.resolve({'h': torch.tensor([0.66, 0.7], dtype=torch.float64),
                    'Omega_k': torch.tensor([0.02, -0.02], dtype=torch.float64)})
    p['_massless_ncdm'] = False
    got = bg.comoving_angular_distances(p, rule)
    assert got.shape == (2, 1829)
    np.testing.assert_allclose(got.numpy(), bg.comoving_angular_distance(p, z).numpy(), rtol=1e-12)
