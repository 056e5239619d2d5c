"""Statistical recovery of the port's gradient samplers on the CPU.

The recovery and mixing tests of ``tests/test_samplers.py:82-256``, at their
tolerances, on the port's twin of the 2-parameter linear Gaussian
(``tests/test_torch_sampler_steps.py``), with ``device='cpu'``. Each sampler
draws from a ``torch.Generator`` seeded by ``seed``; the JAX package's
threefry streams cannot be replayed, so whole runs are compared with the
posterior, not with the JAX package's chains. ``sample()``'s convergence
loop drives ChEES here: the JAX test drives the ensemble sampler, whose
port is held to it in ``tests/test_torch_ensemble.py``. Runs are shared through module fixtures:
one NUTS and one HMC run through ``sample()``'s batch loop serve both the
recovery and the resume tests, and one 1024-chain ChEES run through its
convergence loop serves the convergence and the many-chain mixing tests.
The check suite's drift and tail cases are in ``tests/test_torch_chains.py``.
"""

import numpy as np
import pytest
import torch

from desilike_tpu_torch.likelihoods.base import BaseLikelihood
from desilike_tpu_torch.samplers import ChEESSampler, HMCSampler, MCLMCSampler, NUTSSampler
from test_torch_sampler_steps import GaussianModel, MEAN, analytic_cov


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The per-step ops here are tiny: one thread each (more only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


COV = analytic_cov()


def assert_recovers(chain, mean_sigmas, std_rtol):
    for i, name in enumerate(('a', 'b')):
        assert chain.mean(name) == pytest.approx(MEAN[i], abs=mean_sigmas * np.sqrt(COV[i, i]))
        assert chain.std(name) == pytest.approx(np.sqrt(COV[i, i]), rel=std_rtol)


@pytest.fixture(scope='module')
def nuts_sampled():
    """One NUTS run through sample()'s batch loop, shared by the recovery and
    the resume tests: a warmup of 300, then two batches of 150 (the
    recovery test of tests/test_samplers.py runs 300 after 300)."""
    sampler = NUTSSampler(GaussianModel(device='cpu'), seed=5, nchains=4, max_depth=6)
    chain = sampler.sample(max_iterations=300, check_every=150, min_iterations=300, max_gr=1.5, min_ess=10,
                           nwarmup=300)
    return sampler, chain, 300


@pytest.fixture(scope='module')
def hmc_sampled():
    """One HMC run through sample()'s batch loop, shared by the recovery and
    the resume tests: a warmup of 300, then two batches of 200 (the recovery
    test of tests/test_samplers.py runs 400 after 300)."""
    sampler = HMCSampler(GaussianModel(device='cpu'), seed=9, nchains=4, nleapfrog=16)
    chain = sampler.sample(max_iterations=400, check_every=200, min_iterations=400, max_gr=1.5, min_ess=10,
                           nwarmup=300)
    return sampler, chain, 300


@pytest.fixture(scope='module')
def chees_sampled():
    """One ChEES run of 1024 chains through sample()'s convergence loop,
    shared by the convergence and the many-chain mixing tests: a warmup of
    200, then batches of 75 until the check suite passes, at 150 at the
    earliest (the mixing test of tests/test_samplers.py runs 150 after 200)."""
    sampler = ChEESSampler(GaussianModel(device='cpu'), seed=13, nchains=1024)
    chain = sampler.sample(max_iterations=3000, check_every=75, min_iterations=150, max_gr=1.05, min_ess=400,
                           nwarmup=200)
    return sampler, chain, dict(sampler.diagnostics)


def test_nuts_recovers_gaussian(nuts_sampled):
    sampler, chain, _ = nuts_sampled
    assert sampler.diagnostics['divergence_rate'] < 0.01
    assert_recovers(chain, 3. / 10, 0.25)
    # NUTS should decorrelate fast: high ESS per sample
    assert chain.effective_sample_size('a') > 300
    assert sampler.diagnostics['host_reads'] >= sampler.diagnostics['leaves'] > 0


def test_hmc_recovers_gaussian(hmc_sampled):
    _, chain, _ = hmc_sampled
    assert_recovers(chain, 4. / 10, 0.3)


def test_mclmc_runs():
    sampler = MCLMCSampler(GaussianModel(device='cpu'), seed=9, nchains=4)
    chain = sampler.run(nsteps=1500, nwarmup=500)
    # unadjusted method: looser tolerances
    assert_recovers(chain, 5. / 10, 0.5)


def test_batch_sample_with_convergence(chees_sampled):
    _, chain, diagnostics = chees_sampled
    assert diagnostics['converged']
    assert chain.shape[0] >= 150
    assert chain.remove_burnin(0.5).mean('a') == pytest.approx(1.0, abs=3 * np.sqrt(COV[0, 0]) / 5)


@pytest.mark.parametrize('sampler_name', ['NUTSSampler', 'HMCSampler'])
def test_batch_sample_resume(sampler_name, request):
    """sample()'s batch loop passes resume=True to run(): the samplers carry
    their adapted state over instead of redoing the warmup, which runs once."""
    sampler, chain, nwarmup = request.getfixturevalue('{}_sampled'.format(sampler_name[:-7].lower()))
    assert chain.shape[0] >= 200
    assert np.isfinite(chain.mean('a'))
    assert sampler.diagnostics['iterations'] == nwarmup + chain.shape[0]


def test_chees_manychain_mixing(chees_sampled):
    """Dense batch, GR ~ 1 at 1024 chains with a short warmup; resume continues
    without re-warmup and stays calibrated."""
    sampler, chain, diagnostics = chees_sampled
    chain = chain.remove_burnin(0.3)
    assert_recovers(chain, 3. / 30, 0.1)
    assert np.all(chain.gelman_rubin(('a', 'b')) < 1.05)
    assert 0.4 < diagnostics['acceptance_rate'] < 0.95
    more = sampler.run(nsteps=50, resume=True)
    assert more['a'].shape[0] == 50
    assert np.isfinite(np.asarray(more['logposterior'])).all()


def test_chees_phase_b_eps_retune_reaches_target():
    """Phase B's dual-averaged step size is kept: on a non-Gaussian target
    with an anisotropic Hessian-vs-variance mass mismatch, the acceptance
    lands near its target (the reference measured 0.96 without the re-tune)."""

    class QuarticModel(BaseLikelihood):
        _params = dict(BaseLikelihood._params)
        _params.update({
            'a': dict(value=0., prior=dict(limits=[-8, 8]), ref=dict(dist='norm', loc=0., scale=1.0)),
            'b': dict(value=0., prior=dict(limits=[-1, 1]), ref=dict(dist='norm', loc=0., scale=0.1)),
        })

        def calculate(self, a=0., b=0.):
            self.loglikelihood = -0.5 * a ** 2 - 0.5 * (b / 0.05) ** 4

    sampler = ChEESSampler(QuarticModel(device='cpu'), seed=17, nchains=256)
    chain = sampler.run(nsteps=150, nwarmup=200)
    assert 0.5 < sampler.diagnostics['acceptance_rate'] < 0.9
    assert np.isfinite(np.asarray(chain['logposterior'])).all()


def test_nuts_jitter_trajectory_mixing():
    """trajectory='jitter': NUTS warmup, then dense fixed-budget jittered HMC."""
    sampler = NUTSSampler(GaussianModel(device='cpu'), seed=29, nchains=256, trajectory='jitter')
    chain = sampler.run(nsteps=200, nwarmup=200).remove_burnin(0.3)
    assert sampler.diagnostics['jitter_path_length'] >= 1.
    assert chain.attrs['sampler'] == 'nuts-jitter'
    assert_recovers(chain, 3. / 30, 0.1)
    assert np.all(chain.gelman_rubin(('a', 'b')) < 1.05)
    assert sampler.diagnostics['divergence_rate'] < 0.01
    # default selection: many chains -> jitter, few -> tree NUTS
    assert NUTSSampler(GaussianModel(device='cpu'), nchains=2048).trajectory == 'jitter'
    assert NUTSSampler(GaussianModel(device='cpu'), nchains=8).trajectory == 'nuts'


def test_runs_reproduce_for_a_seed():
    chains = [ChEESSampler(GaussianModel(device='cpu'), seed=11, nchains=32).run(nsteps=5, nwarmup=10)
              for _ in range(2)]
    np.testing.assert_array_equal(chains[0]['a'], chains[1]['a'])
    other = ChEESSampler(GaussianModel(device='cpu'), seed=12, nchains=32).run(nsteps=5, nwarmup=10)
    assert not np.array_equal(chains[0]['a'], other['a'])
