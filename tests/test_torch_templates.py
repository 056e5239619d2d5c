"""The port's remaining power spectrum templates (Fixed, BAOPhaseShift,
Standard, WiggleSplit, BandVelocity, TurnOver, DirectWiggleSplit,
ExtractedBandVelocity through ``BandVelocityPowerSpectrumCalculator``) and
extractors (BAO, Standard, ShapeFit, WiggleSplit, BandVelocity, TurnOver,
BAOPhaseShift), at the settings of ``tests/test_templates_extra.py``,
against the JAX package's x64 values frozen in
``tests/data/torch_port_templates_reference.npz``
(``scripts/make_torch_port_reference.py templates``). The port evaluates
each case's points as one batch of chains, in float64 (the same arithmetic:
1e-10 of the largest value of each quantity, measured 1.4e-11) and in
float32 (2e-4: a float32 series of order ~200 evaluated at moved k, and
float32 sums of ~500 terms; measured 3.8e-5).
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import Cosmology, KaiserTracerPowerSpectrumMultipoles, Pipeline
from desilike_tpu_torch import theories

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_templates_reference.npz'))

# the cases of scripts/make_torch_port_reference.py (TEMPLATE_CASES, EXTRACTOR_CASES, EXTRACTOR_POINTS, BAND_KP)
TEMPLATE_CASES = {
    'fixed': ('FixedPowerSpectrumTemplate', dict(z=1., k=np.geomspace(1e-3, 0.6, 300)), [{}],
              ('pk_dd', 'pknow_dd', 'f', 'fsigma8', 'qpar', 'qper')),
    'standard': ('StandardPowerSpectrumTemplate', dict(z=1., k=np.geomspace(1e-3, 0.6, 300)),
                 [{'df': 1.1, 'qpar': 1.02, 'qper': 0.99}, {'df': 0.95, 'qpar': 0.98, 'qper': 1.01}],
                 ('pk_dd', 'f', 'fsigma8', 'qpar', 'qper')),
    'bao_phaseshift': ('BAOPhaseShiftPowerSpectrumTemplate',
                       dict(z=0.8, k=np.geomspace(1e-3, 0.6, 400), apmode='qiso'),
                       [{'baoshift': 1.}, {'baoshift': 2., 'qiso': 1.02}], ('pk_dd', 'pknow_dd', 'f', 'DV_over_rd')),
    'wigglesplit': ('WiggleSplitPowerSpectrumTemplate', dict(z=1., k=np.geomspace(1e-3, 0.6, 300)),
                    [{'qbao': 1., 'dm': 0., 'df': 1.}, {'qbao': 1.05, 'dm': 0.02, 'df': 1.1, 'qap': 1.01}],
                    ('pk_dd', 'pknow_dd', 'f', 'qpar', 'qper')),
    'wigglesplit_tophat': ('WiggleSplitPowerSpectrumTemplate',
                           dict(z=1., k=np.geomspace(1e-3, 0.6, 300), kernel='tophat'),
                           [{'qbao': 1.05, 'dm': 0.02, 'df': 1.1}], ('pk_dd', 'pknow_dd')),
    'bandvelocity': ('BandVelocityPowerSpectrumTemplate',
                     dict(z=1., kp=[0.02, 0.05, 0.1, 0.2], k=np.geomspace(5e-3, 0.4, 200)),
                     [{'dptt1': 1.2}, {'dptt0': 0.9, 'dptt3': 1.1, 'df': 1.05, 'qap': 0.99}],
                     ('pk_dd', 'pknow_dd', 'pk_tt', 'f', 'qpar')),
    'turnover': ('TurnOverPowerSpectrumTemplate', dict(z=0.5, k=np.geomspace(3e-3, 0.3, 300)),
                 [{}, {'qto': 1.1, 'dpto': 1.05, 'm': 0.6, 'n': 0.9, 'qap': 1.02}],
                 ('pk_dd', 'DV_times_kTO', 'DH_over_DM', 'kto')),
    'direct_wigglesplit': ('DirectWiggleSplitPowerSpectrumTemplate', dict(z=1., k=np.logspace(-2.2, -0.3, 200)),
                           [{'qbao': 1.05}, {'sigmabao': 50.}, {'omega_cdm': 0.13, 'qbao': 0.97, 'sigmabao': 3.}],
                           ('pk_dd', 'pknow_dd', 'f', 'qpar', 'qper'))}
EXTRACTOR_CASES = {
    'bao': ('BAOExtractor', dict(z=0.8), ('DH_over_rd', 'DM_over_rd', 'DV_over_rd', 'DH_over_DM', 'qpar', 'qper',
                                          'qiso', 'qap')),
    'standard': ('StandardPowerSpectrumExtractor', dict(z=0.8), ('df', 'fsigmar')),
    'shapefit': ('ShapeFitPowerSpectrumExtractor', dict(z=0.8), ('dm', 'dn', 'df', 'm', 'f_sqrt_Ap')),
    'shapefit_n': ('ShapeFitPowerSpectrumExtractor', dict(z=0.8, n_varied=True), ('dm', 'df', 'm')),
    'wigglesplit': ('WiggleSplitPowerSpectrumExtractor', dict(z=0.8), ('qbao', 'df', 'dm', 'm', 'fsigmar')),
    'wigglesplit_tophat': ('WiggleSplitPowerSpectrumExtractor', dict(z=0.8, kernel='tophat'), ('df', 'dm', 'm')),
    'bandvelocity': ('BandVelocityPowerSpectrumExtractor', dict(z=0.8, kp=[0.02, 0.05, 0.1, 0.2]),
                     ('dptt', 'df', 'fsigmar', 'qap')),
    'turnover': ('TurnOverPowerSpectrumExtractor', dict(z=0.8), ('kTO', 'DV_times_kTO', 'DM_over_DH', 'qto')),
    'baophaseshift': ('BAOPhaseShiftExtractor', dict(z=0.8), ('baoshift', 'qiso'))}
EXTRACTOR_POINTS = [{'h': 0.7, 'omega_cdm': 0.125, 'omega_b': 0.023, 'logA': 3.1, 'n_s': 0.95, 'N_ur': 2.3},
                    {'h': 0.65, 'omega_cdm': 0.115, 'omega_b': 0.021, 'logA': 3.0, 'n_s': 0.98, 'N_ur': 1.9}]
BAND_KP = [0.02, 0.05, 0.1, 0.2]
TOLERANCES = {torch.float64: 1e-10, torch.float32: 2e-4}


def batch(pipe, points, dtype):
    """The points as one batch of (npoints,) tensors: each parameter named
    by a point, at its default value in the others."""
    names = sorted(set().union(*points))
    defaults = {p.basename: p.value for p in pipe.params}
    return {name: torch.tensor([point.get(name, defaults[name]) for point in points], dtype=dtype) for name in names}


def assert_rows(got, expected, dtype, label):
    """``got`` (a batch, or a constant without one) against the frozen rows,
    within TOLERANCES[dtype] of the largest value of the quantity."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, dtype='f8')
    got = np.broadcast_to(got, expected.shape) if got.ndim < expected.ndim else got
    assert got.shape == expected.shape, label
    np.testing.assert_allclose(got, expected, rtol=0., atol=TOLERANCES[dtype] * np.abs(expected).max(), err_msg=label)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['float64', 'float32'])
@pytest.mark.parametrize('case', list(TEMPLATE_CASES))
def test_template_matches_jax_x64(case, dtype):
    cls, kwargs, points, attrs = TEMPLATE_CASES[case]
    node = getattr(theories, cls)(device='cpu', **kwargs)
    pipe = Pipeline(node)
    pipe.evaluate(batch(pipe, points, dtype) if points != [{}] else {}, dtype=dtype)
    for attr in attrs:
        assert_rows(getattr(node, attr), REFERENCE['{}_{}'.format(case, attr)], dtype, attr)
    if case == 'turnover':
        np.testing.assert_allclose([node.kto_fid, node.pkto_fid],
                                   [REFERENCE['turnover_kto_fid'], REFERENCE['turnover_pkto_fid']], rtol=1e-10)


def cosmology():
    cosmo = Cosmology(device='cpu')
    cosmo.init.params = {name: dict(fixed=False) for name in EXTRACTOR_POINTS[0]}
    return cosmo


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['float64', 'float32'])
@pytest.mark.parametrize('case', list(EXTRACTOR_CASES))
def test_extractor_matches_jax_x64(case, dtype):
    """Each extractor on a Cosmology node varying h, omega_cdm, omega_b, logA,
    n_s and N_ur, at two cosmologies as one batch."""
    cls, kwargs, attrs = EXTRACTOR_CASES[case]
    node = getattr(theories, cls)(cosmo=cosmology(), **kwargs)
    pipe = Pipeline(node)
    pipe.evaluate(batch(pipe, EXTRACTOR_POINTS, dtype), dtype=dtype)
    for attr in attrs:
        assert_rows(getattr(node, attr), REFERENCE['extractor_{}_{}'.format(case, attr)], dtype, attr)


def test_band_velocity_calculator_matches_jax_x64():
    """A Kaiser theory on the band-power template, rewired by
    ``BandVelocityPowerSpectrumCalculator`` so that an extractor on a direct
    cosmology computes its band amplitudes, growth and AP distortion: its
    multipoles in float64 at two cosmologies."""
    theory = KaiserTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=np.linspace(0.02, 0.2, 19), device='cpu',
        template=theories.BandVelocityPowerSpectrumTemplate(z=0.8, kp=BAND_KP))
    assert theories.BandVelocityPowerSpectrumCalculator(theory, cosmo=cosmology()) is theory
    pipe = Pipeline(theory)
    assert 'dptt0' not in pipe.varied_params.basenames() and 'h' in pipe.varied_params.names()
    pipe.evaluate(batch(pipe, [dict(point, b1=2.) for point in EXTRACTOR_POINTS], torch.float64), dtype=torch.float64)
    assert_rows(theory.power, REFERENCE['calculator_power'], torch.float64, 'power')
