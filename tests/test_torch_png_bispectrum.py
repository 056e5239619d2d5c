"""PNG, the tree-level bispectrum and its observable, and the Lyman-alpha
extractor of the PyTorch port on the CPU, against the JAX package's x64
values frozen in ``tests/data/torch_port_theories_reference.npz``
(``scripts/make_torch_port_reference.py theories``).

Tolerances: the theory vectors (float32) within 2e-5 of their largest
value (the goldens'; measured 1.1e-7 to 1.2e-7 for PNG's density
multipoles, 1.0e-6 to 1.1e-6 for its velocity multipoles, 1.6e-6 for the
1-loop bispectrum); the bispectrum observable's likelihood (float32) at 4
points within 2e-2 on the log-posterior and 5e-4 of the gradient's norm
(configs 3 and 4's limits against x64; measured 2.7e-3, 1e-5 of the
log-posterior, which sums residuals of 1e9-sized bispectra in float32), and
the same with a covariance from 40 mocks (its Hartlap factor 1e-12, its
whitening with the Percival factor 1e-10, frozen in
``tests/data/torch_port_observables_reference.npz``); the Lyman-alpha extractor in float64
within 1e-10 (relative).
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import (Pipeline, theories, TracerBispectrumMultipolesObservable,
                                ObservablesGaussianLikelihood)
from test_torch_bao_models import BAO_K, VALUES, REFERENCE, evaluate, assert_close

torch.set_num_threads(2)

TRIANGLES = [(0.05, 0.05, 0.05), (0.05, 0.08, 0.1), (0.08, 0.08, 0.1), (0.1, 0.1, 0.12), (0.04, 0.07, 0.09)]


@pytest.mark.parametrize('mode', ['b-p', 'bphi', 'bfnl'])
def test_png_modes(mode):
    """The density multipoles (0, 2) and the velocity multipoles (1, 3) in each of the three modes."""
    reference = np.load(REFERENCE)
    got, pipe = evaluate(theories.PNGTracerPowerSpectrumMultipoles(ells=(0, 2), k=BAO_K, mode=mode, device='cpu'),
                         VALUES, 'power')
    assert_close(got, reference['vector:png_' + mode])
    dropped = {'b-p': ('bphi', 'bfnl_loc'), 'bphi': ('p', 'bfnl_loc'), 'bfnl': ('fnl_loc', 'bphi', 'p')}[mode]
    assert not set(dropped) & set(pipe.params.basenames())
    got, _ = evaluate(theories.PNGTracerVelocityPowerSpectrumMultipoles(k=BAO_K, mode=mode, device='cpu'), VALUES,
                      'power')
    assert_close(got, reference['vector:png_velocity_' + mode])


def test_bispectrum_one_loop():
    """pt='1loop' (the 1-loop SPT matter pk from the FFTLog engine as the
    input), with a (0, 2, 0) multipole label beside (0,) and (2,)."""
    reference = np.load(REFERENCE)
    got, _ = evaluate(theories.TreeLevelBispectrumMultipoles(
        template=theories.ShapeFitPowerSpectrumTemplate(z=0.8), pt='1loop', ells=(0, 2, (0, 2, 0)), device='cpu'),
        VALUES, 'bispectrum')
    assert_close(got, reference['vector:bispectrum_1loop'])


def test_bispectrum_observable_likelihood():
    """The bispectrum observable (monopole and quadrupole on 5 triangles,
    data generated from the theory) in a Gaussian likelihood with its
    explicit diagonal covariance, at 4 points; then with a covariance from
    40 mocks."""
    reference = np.load(REFERENCE)
    data = {'b1': 2., 'b2': 0.3}
    flatdata = reference['bispectrum_like_flatdata']
    covariance = np.diag((0.05 * np.abs(flatdata)) ** 2 + 1e3)
    observable = TracerBispectrumMultipolesObservable(
        data=data, covariance=covariance, triangles=TRIANGLES, ells=(0, 2),
        theory=theories.TreeLevelBispectrumMultipoles(template=theories.ShapeFitPowerSpectrumTemplate(z=0.8)))
    like = ObservablesGaussianLikelihood(observables=[observable], device='cpu')
    names = list(reference['bispectrum_like_names'])
    assert like.pipeline.varied_params.names() == names
    np.testing.assert_allclose(like.flatdata, flatdata, rtol=1e-10)
    points = reference['bispectrum_like_points']
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, _ = like.logpost_fn()(values)
    logpost.sum().backward()
    np.testing.assert_allclose(logpost.detach().numpy(), reference['bispectrum_like_logpost_x64'], rtol=0., atol=2e-2)
    grad, ref = torch.stack([values[n].grad for n in names], dim=-1).numpy(), reference['bispectrum_like_grad_x64']
    assert np.max(np.linalg.norm(grad - ref, axis=-1) / np.linalg.norm(ref, axis=-1)) < 5e-4
    # a covariance from 40 mocks (which raised before the observables layer was ported): the Hartlap factor at
    # build, the Percival factor in logpost_fn, against the JAX package's (tests/data/torch_port_observables_reference.npz)
    mocks_reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_observables_reference.npz'))
    observable = TracerBispectrumMultipolesObservable(
        data=flatdata, covariance=list(mocks_reference['bispectrum_mocks']), triangles=TRIANGLES, ells=(0, 2),
        theory=theories.TreeLevelBispectrumMultipoles(template=theories.ShapeFitPowerSpectrumTemplate(z=0.8)))
    like = ObservablesGaussianLikelihood(observables=[observable], device='cpu')
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, _ = like.logpost_fn()(values)
    logpost.sum().backward()
    assert observable.nmocks == 40
    assert like.hartlap == pytest.approx(float(mocks_reference['bispectrum_mocks_hartlap']), rel=1e-12)
    np.testing.assert_allclose(like._whiten, mocks_reference['bispectrum_mocks_whiten'], rtol=1e-10,
                               atol=1e-10 * np.abs(mocks_reference['bispectrum_mocks_whiten']).max())
    np.testing.assert_allclose(logpost.detach().numpy(), mocks_reference['bispectrum_mocks_logpost_x64'], rtol=0.,
                               atol=2e-2)
    grad, ref = torch.stack([values[n].grad for n in names], dim=-1).numpy(), mocks_reference['bispectrum_mocks_grad_x64']
    assert np.max(np.linalg.norm(grad - ref, axis=-1) / np.linalg.norm(ref, axis=-1)) < 5e-4


def test_lya_extractor():
    """delta2_star and n_star, per chain, at 4 cosmologies in one batch (float64)."""
    reference = np.load(REFERENCE)
    points = reference['lya_points']
    extractor = theories.P1DPowerSpectrumExtractor(cosmo=theories.Cosmology(fixed=('h', 'omega_cdm', 'logA')),
                                                   device='cpu')
    pipe = Pipeline(extractor)
    pipe.evaluate({name: torch.tensor(points[:, i]) for i, name in enumerate(('h', 'omega_cdm', 'logA'))},
                  dtype=torch.float64)
    got = np.column_stack([pipe.derived['delta2_star'].numpy(), pipe.derived['n_star'].numpy()])
    np.testing.assert_allclose(got, reference['lya_x64'], rtol=1e-10)
