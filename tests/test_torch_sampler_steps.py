"""Single steps of the port's gradient samplers against the JAX package's,
on the CPU, given the same draws.

The 2-parameter linear Gaussian of ``tests/test_samplers.py`` is built twice
here: ``JaxGaussianModel`` with ``desilike_tpu`` and ``GaussianModel`` with
``desilike_tpu_torch`` (``device='cpu'``). The port's steps take their
random draws as arguments, so each is fed the very draws the JAX step
derives from its key (``kr, ka = jax.random.split(key)`` in a ChEES
iteration, ``jax.random.split(key, 3)`` in an HMC step, the key itself in
an MCLMC step). Both sides compute in float32; the new state agrees within
1e-5 relative (measured on the CPU: a few 1e-7, the two packages rounding the same
arithmetic in another order). The MCLMC step is the JAX package's own
closure, taken from ``MCLMCSampler.run`` by a stand-in ``lax.scan`` that
stops the run at its first scan. The dual-averaging and Welford updates are
held against a transcription of ``desilike_tpu/samplers/nuts.py:391-402``
over a fixed sequence.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from desilike_tpu.likelihoods import BaseGaussianLikelihood as JaxBaseGaussianLikelihood
from desilike_tpu.samplers import ChEESSampler as JaxChEESSampler, HMCSampler as JaxHMCSampler
from desilike_tpu.samplers import MCLMCSampler as JaxMCLMCSampler
from desilike_tpu.samplers import hmc as jax_hmc
from desilike_tpu.samplers import nuts as jax_nuts
from desilike_tpu_torch.likelihoods.base import BaseGaussianLikelihood
from desilike_tpu_torch.samplers import ChEESSampler, HMCSampler, MCLMCSampler
from desilike_tpu_torch.samplers import nuts
from desilike_tpu_torch.samplers.hmc import HMCKernel, mclmc_step


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The per-step ops here are tiny: one thread each (more only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5
MEAN = np.array([1.0, -0.5])
COV_DATA = 0.04
PARAMS = {'a': dict(value=1.0, prior=dict(limits=[-4, 4]), ref=dict(dist='norm', loc=1.0, scale=0.2)),
          'b': dict(value=-0.5, prior=dict(limits=[-4, 4]), ref=dict(dist='norm', loc=-0.5, scale=0.2))}
XGRID = np.linspace(-1, 1, 50)


class JaxGaussianModel(JaxBaseGaussianLikelihood):
    """The 2-parameter linear model of tests/test_samplers.py:10-31, in the JAX package."""
    _params = dict(JaxBaseGaussianLikelihood._params, **PARAMS)

    def initialize(self, **kwargs):
        super().initialize(data=MEAN[0] * XGRID + MEAN[1], covariance=np.eye(50) * COV_DATA)

    def flattheory(self):
        return self._a * jnp.asarray(XGRID) + self._b

    def calculate(self, a=1., b=0., **kwargs):
        self._a, self._b = a, b
        super().calculate()


class GaussianModel(BaseGaussianLikelihood):
    """The same model in the port: every parameter a (B,) tensor."""
    _params = dict(BaseGaussianLikelihood._params, **PARAMS)

    def initialize(self):
        self.x = XGRID
        self.flatdata = MEAN[0] * XGRID + MEAN[1]
        self._set_whitening(np.eye(50) * COV_DATA)

    def flattheory(self):
        return self._a[..., None] * self.const('x') + self._b[..., None]

    def calculate(self, a=1., b=0.):
        self._a, self._b = a, b
        super().calculate()


def analytic_cov():
    J = np.stack([XGRID, np.ones_like(XGRID)])
    return np.linalg.inv(J @ J.T / COV_DATA)


def close(got, expected, rtol=RTOL):
    got, expected = np.asarray(got, dtype='f8'), np.asarray(expected, dtype='f8')
    scale = max(float(np.abs(expected).max()), 1e-30)
    err = float(np.abs(got - expected).max()) / scale
    assert err <= rtol, err


def t(array):
    return torch.tensor(np.asarray(array), dtype=torch.float32)


def start(nchains, seed=0):
    """Unconstrained start points near the posterior mode, float32 exact."""
    rng = np.random.default_rng(seed)
    sampler = ChEESSampler(GaussianModel(device='cpu'), nchains=nchains)
    x = MEAN + np.sqrt(np.diag(analytic_cov())) * rng.normal(size=(nchains, 2))
    return sampler._unconstrain(x).astype('f4')


@pytest.fixture(scope='module')
def samplers():
    return JaxChEESSampler(JaxGaussianModel(), nchains=128), ChEESSampler(GaussianModel(device='cpu'), nchains=128)


@pytest.fixture(scope='module')
def jax_chees(samplers):
    """The JAX package's batched log-density and ChEES step, jitted once for the module."""
    lg = samplers[0]._logdens_grad()
    return jax.jit(jax.vmap(lg)), jax.jit(samplers[0]._build_step(lg))


def test_logit_transform(samplers):
    """The constrained point and the log-Jacobian of the logit transform,
    and its inverse."""
    jax_sampler, sampler = samplers
    u = start(128)
    x_jax, logjac_jax = jax.jit(jax.vmap(jax_sampler._constrain))(jnp.asarray(u))
    x, logjac = sampler._constrain(t(u))
    close(x, x_jax)
    close(logjac, logjac_jax)
    close(sampler._unconstrain(np.asarray(x_jax)), np.array([jax_sampler._unconstrain(xi) for xi in np.asarray(x_jax)]))


def test_logdens_grad(samplers, jax_chees):
    _, sampler = samplers
    u = start(128)
    lp_jax, grad_jax = jax_chees[0](jnp.asarray(u))
    lp, grad = sampler._logdens_grad()(t(u))
    close(lp, lp_jax)
    close(grad, grad_jax)


@pytest.mark.parametrize('adapting', [True, False], ids=['adapting', 'frozen'])
def test_chees_iteration(samplers, jax_chees, adapting):
    """One ChEES iteration at 128 chains (desilike_tpu/samplers/chees.py:46-129):
    the chains' new state, the shared log T, the Adam moments and the
    iteration's statistics."""
    _, sampler = samplers
    u = start(128, seed=1)
    inv_mass = (np.diag(analytic_cov()) / 1.875 ** 2 * np.array([1.3, 0.8])).astype('f4')
    eps = np.float32(0.02)
    log_T, adam = np.float32(np.log(eps * 16.)), (np.float32(0.3), np.float32(0.02), np.float32(4.))
    h = np.float32(nuts.halton(5))
    key = jax.random.key(3)
    logdens_grad_jax, step_jax = jax_chees
    lp_jax, grad_jax = logdens_grad_jax(jnp.asarray(u))
    state_jax = (jnp.asarray(u), lp_jax, grad_jax, jnp.asarray(eps), jnp.asarray(log_T), jnp.asarray(inv_mass),
                 tuple(jnp.asarray(a) for a in adam))
    new_jax, (record_jax, stats_jax) = step_jax(state_jax, (key, 0, jnp.asarray(h), jnp.asarray(adapting)))
    # the draws of chees.py:79-80
    kr, ka = jax.random.split(key)
    noise = jax.random.normal(kr, (128, 2))
    uniform = jax.random.uniform(ka, (128,))

    lg = sampler._logdens_grad()
    lp, grad = lg(t(u))
    state = (t(u), lp, grad, t(eps), t(log_T), t(inv_mass), tuple(t(a) for a in adam))
    new, record, stats = sampler._build_step(lg)(state, t(noise), t(uniform), t(h), adapting)
    assert stats['nsteps'] == int(stats_jax['nsteps']) > 1
    for got, expected in zip(new[:6], new_jax[:6]):
        close(got, expected)
    for got, expected in zip(new[6], new_jax[6]):
        close(got, expected)
    close(record['logposterior'], record_jax['logposterior'])
    close(stats['accept_prob'], stats_jax['accept_prob'])
    assert 0. < float(stats['accept_prob']) < 1.


def test_hmc_step():
    """One static-HMC transition of 8 chains (desilike_tpu/samplers/hmc.py:24-56),
    the per-chain draws of hmc.py:25-27."""
    nchains, nleap = 8, 16
    jax_sampler = JaxHMCSampler(JaxGaussianModel(), nchains=nchains, nleapfrog=nleap)
    sampler = HMCSampler(GaussianModel(device='cpu'), nchains=nchains, nleapfrog=nleap)
    u = start(nchains, seed=2)
    inv_mass = (np.diag(analytic_cov()) / 1.875 ** 2).astype('f4')
    eps = np.float32(0.012)
    lg_jax = jax_sampler._logdens_grad()
    lp_jax, grad_jax = jax.jit(jax.vmap(lg_jax))(jnp.asarray(u))
    keys = jax.random.split(jax.random.key(4), nchains)
    kernel_jax = jax_sampler._make_kernel(lg_jax)
    z_jax, lp1_jax, grad1_jax, stats_jax = jax.jit(jax.vmap(
        lambda k, z, lp, g: kernel_jax(k, z, lp, g, eps, jnp.asarray(inv_mass))))(keys, jnp.asarray(u), lp_jax, grad_jax)

    def draws(key):
        k_mom, k_jit, k_acc = jax.random.split(key, 3)
        return (jax.random.normal(k_mom, (2,)), jax.random.randint(k_jit, (), nleap // 2, nleap + 1),
                jax.random.uniform(k_acc))
    noise, nstep, accept_u = jax.vmap(draws)(keys)

    lg = sampler._logdens_grad()
    lp, grad = lg(t(u))
    z, lp1, grad1, stats = HMCKernel(lg, 2, nleap)(t(u), lp, grad, t(eps), t(inv_mass), t(noise),
                                                   torch.tensor(np.asarray(nstep)), t(accept_u))
    for got, expected in ((z, z_jax), (lp1, lp1_jax), (grad1, grad1_jax), (stats['accept_stat'], stats_jax['accept_stat'])):
        close(got, expected)
    np.testing.assert_array_equal(stats['n_leaves'].numpy(), np.asarray(stats_jax['n_leaves']))


class _Captured(Exception):
    pass


def test_mclmc_step(monkeypatch):
    """One MCLMC step of 8 chains: the JAX package's own step closure
    (desilike_tpu/samplers/hmc.py:80-95), vmapped, against the port's, the
    noise drawn from each chain's key as hmc.py:92 does."""
    captured = {}

    class StopAtScan(object):
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        @staticmethod
        def scan(f, *args, **kwargs):
            captured['step'] = f
            raise _Captured

    nchains = 8
    jax_sampler = JaxMCLMCSampler(JaxGaussianModel(), nchains=nchains)
    monkeypatch.setattr(jax_hmc, 'lax', StopAtScan())
    with pytest.raises(_Captured):
        jax_sampler.run(nsteps=1, nwarmup=2)
    monkeypatch.undo()
    step_jax = captured['step']
    u = start(nchains, seed=3)
    rng = np.random.default_rng(5)
    vel = rng.normal(size=(nchains, 2))
    vel = (vel / np.linalg.norm(vel, axis=-1, keepdims=True)).astype('f4')
    eps = np.float32(0.03) * np.ones(nchains, dtype='f4')
    L = np.float32(0.1) * np.ones(nchains, dtype='f4')
    lg_jax = jax_sampler._logdens_grad()
    lp_jax, grad_jax = jax.jit(jax.vmap(lg_jax))(jnp.asarray(u))
    keys = jax.random.split(jax.random.key(6), nchains)
    carry_jax, _ = jax.jit(jax.vmap(step_jax))((jnp.asarray(vel), jnp.asarray(u), lp_jax, grad_jax, jnp.asarray(eps),
                                       jnp.asarray(L)), keys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (2,)))(keys)

    lg = MCLMCSampler(GaussianModel(device='cpu'), nchains=nchains)._logdens_grad()
    lp, grad = lg(t(u))
    carry = mclmc_step(lg, (t(vel), t(u), lp, grad, t(eps), t(L)), t(noise), 2)
    for got, expected in zip(carry, carry_jax):
        close(got, expected)


def test_nuts_popcount_and_turning():
    """_popcount over 0..2^20 and _is_turning on seeded edges (nuts.py:36-47)."""
    x = np.arange(2 ** 20, dtype='i4')
    np.testing.assert_array_equal(nuts._popcount(torch.tensor(x)).numpy(), np.asarray(jax_nuts._popcount(jnp.asarray(x))))
    assert [nuts._popcount(i) for i in range(64)] == [bin(i).count('1') for i in range(64)]
    rng = np.random.default_rng(7)
    z_minus, r_minus, z_plus, r_plus = (rng.normal(size=(4096, 5)).astype('f4') for _ in range(4))
    inv_mass = rng.uniform(0.5, 2., 5).astype('f4')
    expected = jax.vmap(lambda a, b, c, d: jax_nuts._is_turning(a, b, c, d, jnp.asarray(inv_mass)))(
        z_minus, r_minus, z_plus, r_plus)
    got = nuts._is_turning(t(z_minus), t(r_minus), t(z_plus), t(r_plus), t(inv_mass))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    assert 0.2 < float(got.float().mean()) < 0.95


def test_dual_averaging_and_welford():
    """The warmup's dual averaging and Welford updates over a fixed sequence
    of 40 acceptance statistics and positions (4 chains), against a jnp
    transcription of desilike_tpu/samplers/nuts.py:391-402."""
    rng = np.random.default_rng(8)
    accepts = rng.uniform(0.3, 1., (40, 4)).astype('f4')
    positions = rng.normal(size=(40, 4, 3)).astype('f4')
    target, eps0, collect_from = 0.8, np.float32(0.1), 13
    mu = jnp.log(10. * jnp.float32(eps0))

    @jax.jit
    def update(da, welford, a, u, tt, in_window):
        h = (1. - 1. / (tt + 10.)) * da['h_bar'] + (target - a) / (tt + 10.)
        log_eps = mu - jnp.sqrt(tt) / 0.05 * h
        w = tt ** -0.75
        da = dict(log_eps=log_eps, log_eps_bar=w * log_eps + (1. - w) * da['log_eps_bar'], h_bar=h)
        cnt = welford['count'] + jnp.where(in_window, 1., 0.)
        delta = u - welford['mean']
        new_mean = welford['mean'] + jnp.where(in_window, delta / jnp.maximum(cnt, 1.)[:, None], 0.)
        return da, dict(mean=new_mean, m2=welford['m2'] + jnp.where(in_window, delta * (u - new_mean), 0.), count=cnt)

    da = dict(log_eps=jnp.full(4, jnp.log(eps0)), log_eps_bar=jnp.full(4, jnp.log(eps0)), h_bar=jnp.zeros(4))
    welford = dict(mean=jnp.zeros((4, 3)), m2=jnp.zeros((4, 3)), count=jnp.zeros(4))
    mu_t = torch.log(10. * torch.full((4,), eps0))
    log_eps_bar, h_bar = torch.log(torch.full((4,), eps0)), torch.zeros(4)
    mean, m2, count = torch.zeros(4, 3), torch.zeros(4, 3), torch.zeros(4)
    for i in range(40):
        da, welford = update(da, welford, jnp.asarray(accepts[i]), jnp.asarray(positions[i]), jnp.float32(i) + 1.,
                             i >= collect_from)
        log_eps_t, log_eps_bar, h_bar = nuts.dual_averaging_update(log_eps_bar, h_bar, t(accepts[i]), i + 1., mu_t,
                                                                   target)
        if i >= collect_from:
            mean, m2, count = nuts.welford_update(mean, m2, count, t(positions[i]))
        close(log_eps_t, da['log_eps'])
    close(log_eps_bar, da['log_eps_bar'])
    close(h_bar, da['h_bar'])
    close(mean, welford['mean'])
    close(m2, welford['m2'])
    close(count, welford['count'])


def test_jitter_record_makes_no_pipeline_call():
    """trajectory='jitter' records each iteration without evaluating the
    pipeline again when aux holds only loglikelihood and logprior
    (desilike_tpu/samplers/nuts.py:281-342): the pipeline runs once a
    leapfrog step, plus one single-chain call that reads aux's keys. The
    records equal a fresh evaluation at the recorded points."""
    sampler = nuts.NUTSSampler(GaussianModel(device='cpu'), seed=3, nchains=64, trajectory='jitter')
    lg = sampler._logdens_grad()
    u = t(start(64, seed=4))
    lp, grad = lg(u)
    calls, logpost_aux = [], sampler._logpost_aux

    def counted(values):
        calls.append(len(next(iter(values.values()))))
        return logpost_aux(values)

    sampler._logpost_aux_fn = counted
    eps, inv_mass = torch.full((64,), 0.5), t(np.diag(analytic_cov()) / 1.875 ** 2)
    _, records = sampler._jitter_sample(lg, u, lp, grad, eps, inv_mass, 3., 5)
    assert set(records) == {'x', 'logposterior', 'divergence', 'loglikelihood', 'logprior'}
    assert calls.count(1) == 1 and calls.count(64) == sampler.gradient_evaluations - 1 > 5
    lp_x, aux = sampler.logpost_batch(records['x'].reshape(-1, 2))
    close(records['logposterior'].reshape(-1), lp_x)
    for name in ('loglikelihood', 'logprior'):
        close(records[name].reshape(-1), aux[name])
