"""The compression observables and the cut-sky footprint of the port against
the JAX package's x64 values frozen in
``tests/data/torch_port_observables_reference.npz``
(``scripts/make_torch_port_reference.py observables``): each compression
observable's flat theory, per chain on the ``Cosmology`` node, at the two
cosmologies of ``tests/test_torch_templates.py``, in float32 within 2e-5 of
its largest value; the BAO compression likelihood at 16 points in float32
within 2e-3 of the log-posterior and 5e-4 of the gradient's norm (config
1's limits); a compression observable read from a chain; ``CutskyFootprint``
from the port's background in float64 within 1e-10.
"""

import os
import sys

import numpy as np
import pytest
import torch

from desilike_tpu_torch import Pipeline, Cosmology, CutskyFootprint, ObservablesGaussianLikelihood
from desilike_tpu_torch import observables
from desilike_tpu_torch.samples import Chain
from test_torch_templates import EXTRACTOR_POINTS, batch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), 'scripts'))
from make_torch_port_reference import (COMPRESSION_CASES, BAO_COMPRESSION, bao_compression_covariance,  # noqa: E402
                                       cutsky_cases)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_observables_reference.npz'))


def varied_cosmology(names):
    cosmo = Cosmology(device='cpu')
    cosmo.init.params = {name: dict(fixed=False) for name in names}
    return cosmo


@pytest.mark.parametrize('name', list(COMPRESSION_CASES))
def test_compression_observables(name):
    """The flat theory (B, nquantities) at two cosmologies in one batch."""
    kwargs = COMPRESSION_CASES[name]
    cls = getattr(observables, name)
    nquantities = len(cls._quantities_default(kwargs))
    observable = cls(data=np.ones(nquantities), covariance=np.eye(nquantities),
                     cosmo=varied_cosmology(EXTRACTOR_POINTS[0]), **kwargs)
    pipe = Pipeline(observable)
    pipe.evaluate(batch(pipe, EXTRACTOR_POINTS, torch.float32), device='cpu', dtype=torch.float32)
    got, expected = observable.flattheory.numpy().astype('f8'), REFERENCE['compression_' + name]
    assert observable.flattheory.dtype == torch.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0., atol=2e-5 * np.abs(expected).max())


def test_bao_compression_likelihood(tmp_path):
    """The BAO compression likelihood (DM/rd, DH/rd at z = 0.8; h, omega_cdm
    and omega_b varied) at 16 points; then the same observable built from a
    chain file (its best fit as the data, its covariance)."""
    cosmo = varied_cosmology(BAO_COMPRESSION['varied'])
    observable = observables.BAOCompressionObservable(data=BAO_COMPRESSION['data'], z=BAO_COMPRESSION['z'],
                                                      covariance=bao_compression_covariance(), cosmo=cosmo)
    like = ObservablesGaussianLikelihood(observables=[observable], device='cpu')
    names = like.pipeline.varied_params.names()
    assert names == list(REFERENCE['bao_compression_names'])
    points = REFERENCE['bao_compression_points']
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, _ = like.logpost_fn()(values)
    logpost.sum().backward()
    np.testing.assert_allclose(logpost.detach().numpy(), REFERENCE['bao_compression_logpost_x64'], rtol=0., atol=2e-3)
    grad, ref = torch.stack([values[n].grad for n in names], dim=-1).numpy(), REFERENCE['bao_compression_grad_x64']
    assert np.max(np.linalg.norm(grad - ref, axis=-1) / np.linalg.norm(ref, axis=-1)) < 5e-4
    rng = np.random.default_rng(2)
    samples = rng.multivariate_normal(BAO_COMPRESSION['data'], bao_compression_covariance(), size=2000)
    Chain({'DM_over_rd': samples[:, 0], 'DH_over_rd': samples[:, 1],
           'logposterior': -0.5 * ((samples - BAO_COMPRESSION['data']) ** 2).sum(-1)}).save(tmp_path / 'chain.npz')
    observable = observables.BAOCompressionObservable(data=str(tmp_path / 'chain.npz'), z=BAO_COMPRESSION['z'],
                                                      cosmo=varied_cosmology(BAO_COMPRESSION['varied']))
    observable.runtime_info.initialize()
    best = samples[np.argmax(-((samples - BAO_COMPRESSION['data']) ** 2).sum(-1))]
    np.testing.assert_allclose(observable.flatdata, best, rtol=1e-12)
    np.testing.assert_allclose(observable.covariance, np.cov(samples, rowvar=False), rtol=1e-10)


def test_cutsky_footprint():
    """CutskyFootprint's volume, size, zeff, density and shot noise, with a
    constant density and with an n(z) profile over three bins."""
    for case, kwargs in enumerate(cutsky_cases()):
        footprint = CutskyFootprint(**kwargs)
        got = [float(footprint.volume), float(footprint.size), footprint.zeff, float(np.mean(footprint.nbar)),
               float(footprint.shotnoise)]
        np.testing.assert_allclose(got, REFERENCE['cutsky_{:d}'.format(case)], rtol=1e-10)
