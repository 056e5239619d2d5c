"""The CMB likelihoods of the port against the JAX package's x64 values
frozen in ``tests/data/torch_port_probes_reference.npz``
(``scripts/make_torch_port_reference.py probes``): each case of
``make_torch_port_reference.cmb_cases`` (plik-lite TTTEEE and TT,
commander, simall, lollipop EE, BB and EB, ACT DR6 lensing, Planck 2018
lensing and its CMB-marginalized variant, CamSpec TTTEEE and TT, hillipop
TTTEEE, TT, EE and TE) on the fixtures of ``tests/test_cmb.py``, on a
``ClTheory`` whose tables respond to (amp, tilt) to second order; the
compressed Gaussian likelihoods on the ``Cosmology`` node and the S/N
weighted P(k) likelihood.

Limits: at 4 points in float32 the log-posterior within 2e-2 and the
gradient within 5e-4 of its norm (config 3d's limits; measured on the CPU at
most 6.7e-4 (CamSpec, log-posterior ~ -3860) and 1.1e-4 (ACT)). Hillipop,
whose fixture's errors are 0.01% of the signal, runs its stage and the
theory's spectra in float64 (its points within 1e-3 of the other cases'
widths of the data).
"""

import os
import sys

import numpy as np
import pytest

from desilike_tpu_torch.likelihoods import cmb, SNWeightedPowerSpectrumLikelihood
from desilike_tpu_torch import KaiserTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate, BoxFootprint
from chip_smoke import at_points, EPT_X64_ATOL, EPT_X64_GRAD_RTOL
from test_torch_external import REFERENCE, varied_cosmology

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), 'scripts'))
import make_torch_port_reference as M  # noqa: E402

GROUPS = {'planck2018': ('plik_ttteee', 'plik_tt', 'commander', 'simall'),
          'lollipop': ('lollipop_ee', 'lollipop_bb', 'lollipop_eb'),
          'lensing': ('act', 'lensing', 'lensing_marged'),
          'foregrounds': ('camspec_ttteee', 'camspec_tt', 'hillipop_ttteee', 'hillipop_tt', 'hillipop_ee',
                          'hillipop_te')}


@pytest.fixture(scope='module')
def fixtures():
    return M.cmb_fixtures()


def check(like, case):
    key = 'cmb_' + case
    names = list(REFERENCE[key + '_names'])
    assert like.pipeline.varied_params.names() == names
    logpost, grad = at_points(like, names, REFERENCE[key + '_points'])
    np.testing.assert_allclose(logpost, REFERENCE[key + '_logpost_x64'], rtol=0., atol=EPT_X64_ATOL)
    expected = REFERENCE[key + '_grad_x64']
    assert (np.linalg.norm(grad - expected, axis=-1) / np.linalg.norm(expected, axis=-1)).max() < EPT_X64_GRAD_RTOL


@pytest.mark.parametrize('group', ['planck2018', 'lollipop', 'lensing', 'foregrounds'])
def test_cmb_likelihoods(group, fixtures):
    """Each case of the group at its 4 frozen points."""
    cases = M.cmb_cases(cmb, fixtures, device='cpu')
    for case in GROUPS[group]:
        check(cases[case], case)


def test_gaussian_likelihoods():
    """``Planck2018GaussianLikelihood`` and a ``BasePlanck2018GaussianLikelihood``
    on derived quantities (H0, Omega_m, rs_drag, 100 theta_*, z_*, sigma8,
    N_eff, logA), per chain on a Cosmology node with h, omega_cdm, omega_b varied."""
    check(cmb.Planck2018GaussianLikelihood(cosmo=varied_cosmology(('h', 'omega_cdm', 'omega_b'))), 'gaussian')
    check(cmb.BasePlanck2018GaussianLikelihood(cosmo=varied_cosmology(('h', 'omega_cdm', 'omega_b')),
                                               quantities=M.GAUSSIAN_QUANTITIES, mean=M.GAUSSIAN_MEAN,
                                               covariance=np.diag(M.GAUSSIAN_STD) ** 2), 'gaussian_derived')


def test_sn_weighted_likelihood():
    """``SNWeightedPowerSpectrumLikelihood`` (the Fisher-forecast likelihood
    of ``tests/test_inference.py:186-201``) on a Kaiser theory over a
    ShapeFit template, at its points: b1 within 0.1 of its data's value,
    the template's parameters at their defaults (the gradient in all six)."""
    theory = KaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=ShapeFitPowerSpectrumTemplate(z=1.), mu=6)
    like = SNWeightedPowerSpectrumLikelihood(theories=[theory], data={'b1': 2.0}, klim=(0.02, 0.2), mu=10,
                                             footprints=BoxFootprint(volume=1e9, nbar=1e-3), device='cpu')
    check(like, 'sn_weighted')
