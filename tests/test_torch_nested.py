"""The port's nested sampler against the JAX package's, on the CPU.

The prior transform against the host ``ppf`` (as ``tests/test_nested.py``
holds the JAX package's); one batch step (delete the 16 worst of 64 live
points, 5 random-direction slice updates of each replacement) fed the draws
that the JAX package's batch step derives from its key (frozen in
``tests/data/torch_port_samplers_reference.npz``,
``scripts/make_torch_port_reference.py samplers``: the survivor picks, the
unit directions, one shrink uniform an iteration), held to its live and
dead points and calls within 1e-5 relative, both in float32, with the loop
reading ``done.all()`` and with 32 fixed masked iterations; and the
evidence and weighted posterior of ``tests/test_nested.py``.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch.parameters import Prior
from desilike_tpu_torch.samplers import NestedSampler
from test_torch_sampler_steps import GaussianModel, MEAN, analytic_cov, close, t

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_samplers_reference.npz'))
COV = analytic_cov()


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The per-step ops here are tiny: one thread each (more only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def analytic_logz(like):
    """logZ = loglike_max + log (2pi)^{d/2} sqrt(det C) - log(prior volume):
    the posterior mass lies well inside the flat prior box."""
    like.pipeline.evaluate({'a': 1.0, 'b': -0.5}, device='cpu')
    loglmax = float(like.loglikelihood[0])
    vol = np.prod([p.prior.limits[1] - p.prior.limits[0] for p in like.pipeline.varied_params])
    return loglmax + 0.5 * COV.shape[0] * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(COV)[1] - np.log(vol)


def test_prior_transform_matches_host_ppf():
    """``Prior.ppf_torch`` against the host ``ppf`` (tests/test_nested.py:28-36), in float32."""
    u = np.linspace(0.01, 0.99, 21)
    for prior in (Prior(limits=(-4, 4)), Prior(dist='norm', loc=0.3, scale=1.7),
                  Prior(dist='norm', loc=0.3, scale=1.7, limits=(-1, 2)),
                  Prior(dist='expon', loc=0., scale=2., limits=(0., 5.)), Prior(dist='loguniform', limits=(0.1, 10.))):
        np.testing.assert_allclose(prior.ppf_torch(t(u)).numpy(), prior.ppf(u.astype('f4')), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('read_done', [True, False], ids=['read-done', 'fixed-32'])
def test_batch_step_same_draws(read_done):
    sampler = NestedSampler(GaussianModel(device='cpu'), nlive=64, nbatch=16, seed=2)
    sampler.read_done = read_done
    assert sampler.num_slices == REFERENCE['nested_dirs'].shape[0]
    u0 = t(REFERENCE['nested_u0'])
    L0 = sampler._nsloglike(u0)
    close(L0, REFERENCE['nested_L0'])
    reads0 = sampler.host_reads
    u, L, u_dead, L_dead, ncall = sampler.batch_step(u0, t(REFERENCE['nested_L0']),
                                                     torch.as_tensor(REFERENCE['nested_pick']).long(),
                                                     t(REFERENCE['nested_dirs']), t(REFERENCE['nested_shrink']))
    close(u, REFERENCE['nested_u'])
    close(L, REFERENCE['nested_L'])
    close(u_dead, REFERENCE['nested_u_dead'])
    close(L_dead, REFERENCE['nested_L_dead'])
    assert int(ncall) == int(REFERENCE['nested_ncall'])
    assert (sampler.host_reads > reads0) == read_done


def test_nested_evidence_and_posterior():
    """tests/test_nested.py: the evidence within max(3 logzerr, 0.1) of the
    analytic value, the weighted moments of the analytic Gaussian."""
    like = GaussianModel(device='cpu')
    sampler = NestedSampler(like, seed=11, nlive=512, nbatch=128)
    chain = sampler.run(dlogz=0.05)
    logz, logzerr = chain.attrs['logz'], chain.attrs['logzerr']
    assert np.isfinite(logzerr) and logzerr < 0.5
    assert logz == pytest.approx(analytic_logz(like), abs=max(3 * logzerr, 0.1))
    for i, name in enumerate(('a', 'b')):
        assert chain.mean(name) == pytest.approx(MEAN[i], abs=0.4 * np.sqrt(COV[i, i]))
        assert chain.std(name) == pytest.approx(np.sqrt(COV[i, i]), rel=0.25)
    assert 'logweight' in chain and 'aweight' in chain
    assert chain.attrs['niterations'] > 0 and chain.attrs['ncall'] > sampler.nlive
    d = sampler.diagnostics
    assert d['host_reads_per_batch_step'] >= 1 and d['niterations'] == chain.attrs['niterations']
