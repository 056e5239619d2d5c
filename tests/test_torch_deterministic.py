"""The port's grid, quasi-Monte-Carlo and importance samplers, on the CPU.

Config 1 (``chip_smoke.build_likelihood('cpu')``, the port's own host
initialization, float32) against the JAX package in x64 (frozen in
``tests/data/torch_port_samplers_reference.npz``,
``scripts/make_torch_port_reference.py samplers``): the grid of size 3 (its
axes and every log-posterior) and the importance reweighting of a 64-point
chain, within 2e-3 in the log-posterior (the port's float32 error against
x64 on this likelihood, as ``tests/test_torch_bao_likelihood.py`` allows).
Then the solved-parameter bookkeeping of the grid and QMC paths and the
engines (``tests/test_deterministic_samplers.py``), on config 1, whose
broadband terms are solved.
"""

import os

import numpy as np
import pytest

from chip_smoke import build_likelihood
from desilike_tpu_torch.samplers import GridSampler, QMCSampler, ImportanceSampler
from desilike_tpu_torch.samplers.deterministic import _rqrs
from desilike_tpu_torch.samples import Chain

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_samplers_reference.npz'))
ATOL = 2e-3


@pytest.fixture(scope='module')
def like():
    return build_likelihood('cpu')


def test_grid_matches_jax_x64(like):
    sampler = GridSampler(like, size=3)
    samples = sampler.run()
    names = sampler.varied_params.names()
    assert names == list(REFERENCE['grid_names'])
    assert samples.attrs['grid_shape'] == tuple(REFERENCE['grid_shape'])
    np.testing.assert_allclose(np.stack([samples[n] for n in names], axis=-1), REFERENCE['grid_points'], rtol=1e-12)
    np.testing.assert_allclose(samples['logposterior'], REFERENCE['grid_logpost_x64'], rtol=0., atol=ATOL)
    # the solved broadband terms: a column a point, the Hessian and the names in attrs
    solved = like.pipeline.solved_params.names()
    npts = len(samples['logposterior'])
    assert solved and samples.attrs['solved_names'] == solved
    for name in solved:
        assert np.asarray(samples[name]).shape == (npts,)
    assert samples.attrs['solved_hessian'].shape == (npts, len(solved), len(solved))


def test_importance_matches_jax_x64(like):
    names = list(REFERENCE['grid_names'])
    chain = Chain()
    for i, name in enumerate(names):
        chain[like.pipeline.varied_params[name]] = REFERENCE['importance_points'][..., i]
    weighted = ImportanceSampler(like, seed=6).run(chain, batch=24)  # batches that split the chain
    assert weighted.shape == chain.shape
    np.testing.assert_allclose(weighted['logposterior'], REFERENCE['importance_logpost_x64'], rtol=0., atol=ATOL)
    # the weights are exp(logposterior - max): their logs within twice the tolerance
    np.testing.assert_allclose(np.log(weighted['aweight']), np.log(REFERENCE['importance_aweight_x64']),
                               rtol=0., atol=2 * ATOL)
    # reweighting a chain that carries the same log-posterior leaves its weights as they were
    same = ImportanceSampler(like, seed=7).run(weighted)
    np.testing.assert_allclose(same['aweight'], weighted['aweight'], rtol=1e-6)


@pytest.mark.parametrize('engine', ['sobol', 'halton', 'lhs', 'rqrs'])
def test_qmc_engines(like, engine):
    """The engines of tests/test_deterministic_samplers.py; sobol evaluated
    with the solved bookkeeping; an unknown engine raises."""
    sampler = QMCSampler(like, engine=engine, seed=4)
    samples = sampler.run(niterations=16, evaluate=(engine == 'sobol'))
    for p in sampler.varied_params:
        x = np.asarray(samples[p.name])
        assert x.shape == (16,) and np.all(np.isfinite(x))
        dist = p.ref if p.ref is not None else p.prior
        assert np.all((x >= dist.limits[0]) & (x <= dist.limits[1]))
    if engine == 'sobol':
        assert np.all(np.isfinite(samples['logposterior']))
        assert set(like.pipeline.solved_params.names()) <= set(samples.names())
        assert 'solved_hessian' in samples.attrs
    if engine == 'rqrs':
        from desilike_tpu.samplers.deterministic import _rqrs as jax_rqrs
        np.testing.assert_array_equal(_rqrs(3, 512, seed=1), jax_rqrs(3, 512, seed=1))
        with pytest.raises(ValueError):
            QMCSampler(like, engine='dragon', seed=4).run(niterations=4)
