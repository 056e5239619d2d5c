"""The port's Metropolis samplers against the JAX package's, on the CPU.

``MCMCSampler``'s steps are fed the draws that the JAX package's steps
derive from their keys (``tests/data/torch_port_samplers_reference.npz``,
``scripts/make_torch_port_reference.py samplers``: every carry of 6
adaptation and 2 frozen steps at 8 chains on the 2-parameter Gaussian of
``tests/test_samplers.py``), so the Robbins-Monro scale, the pooled Welford
mean and scatter, the regularised Cholesky and the chains' new state are
held to them within 1e-5 relative, both sides in float32. The blocked
sampler's run of one chain on the host-node likelihood of
``tests/test_samplers.py:365-424`` (with and without dragging) is held to
the JAX package's run from the same start and numpy seed. The recovery,
resume and host-cadence tests are those of ``tests/test_samplers.py``.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch.core import Calculator
from desilike_tpu_torch.likelihoods.base import BaseGaussianLikelihood
from desilike_tpu_torch.samplers import MCMCSampler, BlockedMCMCSampler
from test_torch_sampler_steps import GaussianModel, MEAN, analytic_cov, close, t

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_samplers_reference.npz'))
COV = analytic_cov()
XGRID = np.linspace(0., 1., 40)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The per-step ops here are tiny: one thread each (more only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SlowHost(Calculator):
    """A host code: omega is read to the host and the shape computed in numpy."""
    _host_eval = True
    _state_attrs = ['shape']
    _params = {'omega': dict(value=0.3, prior=dict(limits=[0.1, 0.5]),
                             ref=dict(dist='norm', loc=0.3, scale=0.01), proposal=0.01)}
    ncalls = 0

    def calculate(self, omega=0.3):
        SlowHost.ncalls += 1
        omega = omega.detach().cpu().numpy().astype('f8')
        self.shape = torch.as_tensor(np.exp(-omega[:, None] * XGRID), dtype=self.dtype, device=self.device)

    def get(self):
        return self.shape


class HostLike(BaseGaussianLikelihood):
    _params = dict(BaseGaussianLikelihood._params,
                   b=dict(value=2., prior=dict(limits=[0.5, 4.]), ref=dict(dist='norm', loc=2., scale=0.05),
                          proposal=0.02))

    def initialize(self):
        self.host = SlowHost()
        self.flatdata = 2. * np.exp(-0.3 * XGRID)
        self._set_whitening(np.eye(40) * 0.01 ** 2)

    def flattheory(self):
        return self._b[..., None] * self.host.shape

    def calculate(self, b=2.):
        self._b = b
        super().calculate()


def assert_recovers(chain):
    for i, name in enumerate(('a', 'b')):
        assert chain.mean(name) == pytest.approx(MEAN[i], abs=0.4 * np.sqrt(COV[i, i]))
        assert chain.std(name) == pytest.approx(np.sqrt(COV[i, i]), rel=0.25)
    assert np.all(chain.gelman_rubin(('a', 'b')) < 1.2)


def test_mcmc_steps_same_draws():
    """Six adaptation steps then two frozen ones
    (``desilike_tpu/samplers/mcmc.py:83-113``), each carry against the JAX package's."""
    sampler = MCMCSampler(GaussianModel(device='cpu'), nchains=8, seed=3)
    x0 = t(REFERENCE['mcmc_x0'])
    lp0, aux0 = sampler.logpost_batch(x0)
    close(lp0, REFERENCE['mcmc_lp0'])
    zero = torch.zeros(())
    state = (x0, lp0, aux0, zero, t(REFERENCE['mcmc_chol']), torch.zeros(2), torch.zeros((2, 2)), zero, zero)
    step = sampler._build_step(6)
    for i in range(8):
        state, record = step(state, t(REFERENCE['mcmc_z'][i]), t(REFERENCE['mcmc_u'][i]), i < 6)
        for j, name in enumerate(('x', 'lp', None, 'logscale', 'L', 'wmean', 'wm2', 'count', 'istep')):
            if name is not None and (i < 6 or j < 5):
                close(state[j], REFERENCE['mcmc_' + name][i])
        close(record['logposterior'], REFERENCE['mcmc_lp'][i])
    # the Cholesky factor was refreshed from the pooled scatter, after the first collections
    assert not np.allclose(REFERENCE['mcmc_L'][-1], REFERENCE['mcmc_chol'])


def test_mcmc_recovers_gaussian():
    """``test_sampler_recovers_gaussian`` of tests/test_samplers.py for the Metropolis sampler."""
    sampler = MCMCSampler(GaussianModel(device='cpu'), seed=7, nchains=8)
    chain = sampler.run(nsteps=800).remove_burnin(0.5)
    assert_recovers(chain)
    assert 0. < sampler.diagnostics['acceptance_rate'] < 1.


def test_mcmc_sample_resume():
    """sample()'s batch loop resumes the run: the second batch starts from
    the first's last state with the adapted proposal (tests/test_samplers.py:171-184)."""
    sampler = MCMCSampler(GaussianModel(device='cpu'), seed=21, nchains=4)
    chain = sampler.sample(max_iterations=400, check_every=200, min_iterations=200, max_gr=1.5, min_ess=10)
    assert chain.shape[0] >= 200
    assert np.isfinite(chain.mean('a'))
    x_last, _, _, logscale, L = sampler._state
    new = sampler.run(nsteps=1, resume=True)
    assert sampler.diagnostics['proposal_scale'] == pytest.approx(float(torch.exp(logscale)))
    assert torch.equal(sampler._state[4], L)  # no adaptation on resume
    assert new.shape == (1, 4)


@pytest.mark.parametrize('drag', [0, 2], ids=['blocks', 'dragging'])
def test_blocked_mcmc_one_chain_matches_jax(drag):
    """One chain of the blocked sampler from the JAX run's start and numpy
    seed: the same blocks, moves and accepted points, the adaptation and the
    learned block covariance included."""
    prefix = 'blocked{}_'.format(drag)
    sampler = BlockedMCMCSampler(HostLike(device='cpu'), nchains=1, seed=5, drag=drag)
    assert sampler.names == list(REFERENCE[prefix + 'names'])
    start = t(REFERENCE[prefix + 'start'])
    sampler.get_start = lambda nchains: (start, sampler.logpost_batch(start)[0])
    sampler._rng = lambda: np.random.default_rng(int(REFERENCE[prefix + 'seed']))
    chain = sampler.run(nsteps=60)
    close(np.stack([chain[n] for n in sampler.names], axis=-1), REFERENCE[prefix + 'x'])
    close(chain['logposterior'], REFERENCE[prefix + 'lp'])
    assert sampler.diagnostics['acceptance_rate'] == pytest.approx(float(REFERENCE[prefix + 'acceptance']))


@pytest.mark.parametrize('nchains,drag', [(1, 0), (4, 0), (1, 3)], ids=['one', 'lockstep', 'dragging'])
def test_blocked_mcmc_host_cadence(nchains, drag):
    """The host node runs once an iteration, for the slow proposal, however
    many fast moves and dragged steps (tests/test_samplers.py:365-480), and
    the chains land on the generating point; 4 chains move in lockstep."""
    sampler = BlockedMCMCSampler(HostLike(device='cpu'), seed=9, nchains=nchains, drag=drag)
    blocks = dict((tuple(b), r) for b, r in sampler.blocks)
    assert blocks[('omega',)] == 1 and blocks[('b',)] >= 2
    SlowHost.ncalls = 0
    nsteps = 40
    chain = sampler.run(nsteps=nsteps)
    assert SlowHost.ncalls <= nsteps + 2, SlowHost.ncalls
    assert chain.shape == (nsteps, nchains)
    burned = chain.remove_burnin(0.5)
    assert abs(burned.mean('b') - 2.) < 0.05
    assert abs(burned.mean('omega') - 0.3) < 0.05
    assert sampler.diagnostics['host_reads'] >= SlowHost.ncalls
