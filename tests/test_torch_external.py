"""The recombination-era quantities, ``Cosmology(theta=True)`` and the
external likelihoods of the port against the JAX package's x64 values
frozen in ``tests/data/torch_port_probes_reference.npz``
(``scripts/make_torch_port_reference.py probes``).

Tolerances, each with what was measured on the CPU: z_*, r_s(z_*), D_M(z_*)
and 100 theta_* on the host in float64 within 1e-12 (relative; 1.3e-14) and
within the published values of ``tests/test_cmb.py:800-805``; per chain in
float32 within 2e-6 (4.4e-7). theta=True, solved in float32: h within 5e-6
(6.0e-7; the float32 rounding of theta_*, ~3.5e-7 of it, is ~1.2e-6 of h
through d h / d theta_* ~ 3.4), its gradient within 1e-5 of its norm
(1.0e-6). The external likelihoods at 4 points in
float32: the log-posterior within 2e-3, the gradient within 5e-4 of its norm
(config 1's limits; at most 1.7e-4 and 3e-5).
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import Cosmology, Pipeline
from desilike_tpu_torch import likelihoods as L
from desilike_tpu_torch.cosmology import background as bg
from chip_smoke import at_points

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_probes_reference.npz'))


def varied_cosmology(names, **kwargs):
    cosmo = Cosmology(device='cpu', **kwargs)
    cosmo.init.params = {name: dict(fixed=False) for name in names}
    return cosmo


def recombination(p):
    zs = bg.z_star(p)
    return [zs, bg.sound_horizon(p, zs), bg.comoving_angular_distance(p, zs), bg.theta_star_100(p)]


def test_recombination_quantities():
    """z_*, r_s(z_*), D_M(z_*) and 100 theta_* at the fiducial on the host and
    at 16 cosmologies per chain, each at its own z_*."""
    p = bg.resolve({})
    host = np.array([float(v) for v in recombination(p)])
    np.testing.assert_allclose(host, REFERENCE['recombination_x64'][0], rtol=1e-12)
    assert host[0] == pytest.approx(1091.9, abs=1.)
    assert host[1] / p['h'] == pytest.approx(144.13, abs=0.05)
    assert host[3] == pytest.approx(1.0389, abs=0.002)
    points = torch.tensor(REFERENCE['theta_points'], dtype=torch.float32)
    p = bg.resolve({'h': torch.full((len(points),), 0.6736), 'omega_cdm': points[:, 1], 'omega_b': points[:, 2]})
    p['_massless_ncdm'] = False
    got = torch.stack(recombination(p), dim=-1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), REFERENCE['recombination_x64'][1:], rtol=2e-6)


def test_theta_true():
    """h solved from 100 theta_* per chain (theta_MC_100, omega_cdm, omega_b
    varied), and its gradient, at 16 points in one float32 batch."""
    names = list(REFERENCE['theta_names'])
    cosmo = varied_cosmology(names, theta=True)
    pipe = Pipeline(cosmo)
    assert 'h' not in pipe.varied_params.names() and pipe.params['h'].derived is True
    values = {name: torch.tensor(REFERENCE['theta_points'][:, i], dtype=torch.float32, requires_grad=True)
              for i, name in enumerate(names)}
    pipe.evaluate(values, device='cpu', dtype=torch.float32)
    assert cosmo.h.dtype == torch.float32 and pipe.derived['h'] is cosmo.h
    grad = torch.stack(torch.autograd.grad(cosmo.h.sum(), list(values.values())), dim=-1).numpy()
    np.testing.assert_allclose(cosmo.h.detach().numpy(), REFERENCE['theta_h_x64'], rtol=0., atol=5e-6)
    expected = REFERENCE['theta_grad_x64']
    assert (np.linalg.norm(grad - expected, axis=-1) / np.linalg.norm(expected, axis=-1)).max() < 1e-5
    # a target no h in [0.05, 1.5] reaches: NaN, not a wrong h
    values = {name: torch.tensor([1.04109, 3.], dtype=torch.float32) if name == 'theta_MC_100' else 0.12
              if name == 'omega_cdm' else 0.02237 for name in names}
    pipe.evaluate(values, device='cpu', dtype=torch.float32)
    assert bool(torch.isfinite(cosmo.h[0])) and bool(torch.isnan(cosmo.h[1]))


def external_likelihood(case):
    if case == 'bbn':
        return L.Schoneberg2024BBNLikelihood(cosmo=varied_cosmology(('omega_b', 'N_ur')))
    if case == 'h0':
        return L.Riess2020H0Likelihood(cosmo=varied_cosmology(('h',)))
    if case == 'mb':
        return L.Riess2020MbLikelihood(device='cpu')
    return L.CMBDistancePriorLikelihood(cosmo=varied_cosmology(('h', 'omega_cdm', 'omega_b')))


@pytest.mark.parametrize('case', ['bbn', 'h0', 'mb', 'cmb_prior'])
def test_external_likelihoods(case):
    """Each external likelihood's log-posterior and gradient at 4 points."""
    like = external_likelihood(case)
    names = list(REFERENCE[case + '_names'])
    assert like.pipeline.varied_params.names() == names
    logpost, grad = at_points(like, names, REFERENCE[case + '_points'])
    np.testing.assert_allclose(logpost, REFERENCE[case + '_logpost_x64'], rtol=0., atol=2e-3)
    expected = REFERENCE[case + '_grad_x64']
    assert (np.linalg.norm(grad - expected, axis=-1) / np.linalg.norm(expected, axis=-1)).max() < 5e-4
