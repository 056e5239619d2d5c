"""The port's chain container, diagnostics and check suite against the JAX
package's, on seeded numpy arrays (1e-12, or exact).

``desilike_tpu_torch/samples`` keeps a numpy copy of
``desilike_tpu/samples/diagnostics.py`` and a port of ``samples/chain.py``;
the samplers' ``check()`` is the same host-side suite. A chain saved by the
JAX package loads in the port with equal arrays and parameters, and
``sample_solved(seed)`` draws the same solved parameters, bit for bit.
The drift and tail-growth cases of the check suite are those of
``tests/test_samplers.py:251-296``.
"""

import types

import numpy as np
import pytest

from desilike_tpu.samples import diagnostics as jax_diagnostics
from desilike_tpu.samples.chain import Chain as JaxChain
from desilike_tpu.samplers.base import BasePosteriorSampler as JaxBasePosteriorSampler, Diagnostics as JaxDiagnostics
from desilike_tpu.parameters import Deriv as JaxDeriv, DerivArray as JaxDerivArray
from desilike_tpu_torch.parameters import DerivArray
from desilike_tpu_torch.samples import Chain, diagnostics
from desilike_tpu_torch.samplers.base import BasePosteriorSampler, Diagnostics

RTOL = 1e-12


def close(got, expected):
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=0.)


def synthetic(cls, vals, extra=True):
    """vals (nsteps, nchains, 2) -> chain with params a, b (and weights)."""
    chain = cls()
    chain['a'] = vals[..., 0]
    chain['b'] = vals[..., 1]
    chain['logposterior'] = -0.5 * np.sum(vals ** 2, axis=-1)
    if extra:
        rng = np.random.default_rng(9)
        chain['aweight'] = rng.uniform(0.5, 1.5, vals.shape[:2])
    return chain


@pytest.fixture(scope='module')
def vals():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((600, 4, 2))
    return np.cumsum(0.3 * base, axis=0) * 0.1 + base


def test_diagnostics(vals):
    chains = np.moveaxis(vals, 0, 1)  # (nchains, nsteps, ndim)
    for method in ('diag', 'eigen'):
        close(diagnostics.gelman_rubin(chains, method=method), jax_diagnostics.gelman_rubin(chains, method=method))
    statistic = lambda c: np.quantile(c, 0.8, axis=0)  # noqa: E731
    close(diagnostics.gelman_rubin_statistic(chains, statistic),
          jax_diagnostics.gelman_rubin_statistic(chains, statistic))
    x = chains[..., 0]
    for kwargs in ({}, {'min_corr': 0.1}, {'c': 3}):
        close(diagnostics.integrated_autocorrelation_time(x, **kwargs),
              jax_diagnostics.integrated_autocorrelation_time(x, **kwargs))
    close(diagnostics.effective_sample_size(x), jax_diagnostics.effective_sample_size(x))
    close(diagnostics.autocorrelation(x), jax_diagnostics.autocorrelation(x))
    z = diagnostics.geweke(x, first=0.1, last=0.5)
    close(z, jax_diagnostics.geweke(x, first=0.1, last=0.5))
    zs = np.random.default_rng(3).normal(size=60)
    close(diagnostics.geweke_pvalue(zs), jax_diagnostics.geweke_pvalue(zs))


def test_chain_statistics(vals):
    ours, theirs = synthetic(Chain, vals), synthetic(JaxChain, vals)
    for name in ('mean', 'std', 'var', 'median', 'argmax'):
        close(getattr(ours, name)(['a', 'b']), getattr(theirs, name)(['a', 'b']))
    for method in ('covariance', 'corrcoef', 'precision'):
        close(getattr(ours, method)(['a', 'b']), getattr(theirs, method)(['a', 'b']))
    close(ours.quantile('a', q=(0.1, 0.5, 0.9)), theirs.quantile('a', q=(0.1, 0.5, 0.9)))
    close(ours.interval('b'), theirs.interval('b'))
    close(ours.gelman_rubin(('a', 'b')), theirs.gelman_rubin(('a', 'b')))
    close(ours.effective_sample_size('a'), theirs.effective_sample_size('a'))
    close(ours.geweke('b'), theirs.geweke('b'))
    assert ours.choice('argmax') == theirs.choice('argmax')
    assert ours.to_stats() == theirs.to_stats()
    burned, burned_jax = ours.remove_burnin(0.25), theirs.remove_burnin(0.25)
    assert burned.shape == burned_jax.shape == (450, 4)
    merged = Chain.concatenate([burned, ours.remove_burnin(500)])
    assert merged.shape == (550, 4)
    fisher, fisher_jax = ours.to_fisher(['a', 'b']), theirs.to_fisher(['a', 'b'])
    assert fisher.names() == fisher_jax.names() == ['a', 'b']
    close(fisher.center, fisher_jax.center)
    close(fisher.hessian, fisher_jax.hessian)
    with pytest.raises(NotImplementedError, match='A17'):
        ours.write_getdist('chain')


def test_saved_chain_loads_and_sample_solved(tmp_path):
    """A chain the JAX package saves (with solved parameters and their
    per-sample Hessian) loads in the port; sample_solved draws the same."""
    rng = np.random.default_rng(2)
    chain = synthetic(JaxChain, rng.normal(size=(30, 4, 2)), extra=False)
    chain['s0'] = rng.normal(size=(30, 4))
    chain['s1'] = rng.normal(size=(30, 4))
    A = rng.normal(size=(120, 2, 2))
    chain.attrs['solved_hessian'] = -(A @ np.swapaxes(A, -1, -2) + np.eye(2))
    chain.attrs['solved_names'] = ['s0', 's1']
    chain.attrs['sampler'] = 'nuts'
    chain.save(tmp_path / 'chain.npz')
    loaded = Chain.load(tmp_path / 'chain.npz')
    assert loaded.names() == chain.names() and loaded.params.names() == chain.params.names()
    for name in chain.names():
        np.testing.assert_array_equal(loaded[name], chain[name])
    assert loaded.attrs['sampler'] == 'nuts' and loaded.attrs['solved_names'] == ['s0', 's1']
    ours = Chain(data={n: chain[n] for n in chain.names()}, attrs=dict(chain.attrs))
    drawn, drawn_jax = ours.sample_solved(seed=11), chain.sample_solved(seed=11)
    for name in ('s0', 's1'):
        np.testing.assert_array_equal(drawn[name], drawn_jax[name])
    ours.attrs['solved_hessian'] = chain.attrs['solved_hessian'][0]
    chain.attrs['solved_hessian'] = chain.attrs['solved_hessian'][0]
    np.testing.assert_array_equal(ours.sample_solved(seed=3)['s0'], chain.sample_solved(seed=3)['s0'])


def test_derivative_columns_round_trip(tmp_path):
    """A ``DerivArray`` column (``deriv:`` / ``derivkeys:``) saved by the JAX
    package loads in the port with equal values and keys, and the port's
    save loads back in the JAX package (exact)."""
    rng = np.random.default_rng(4)
    derivs = [{}, {'a': 1}, {'b': 1}, {'a': 2}, {'a': 1, 'b': 1}]
    value = rng.normal(size=(len(derivs), 3))
    jax_chain = JaxChain()
    jax_chain['a'] = rng.normal(size=3)
    jax_chain['x'] = JaxDerivArray(value, derivs=[JaxDeriv(d) for d in derivs])
    jax_chain.save(tmp_path / 'jax.npz')
    value = np.asarray(jax_chain['x'].value)  # as the JAX package holds it (float32)
    loaded = Chain.load(tmp_path / 'jax.npz')
    assert isinstance(loaded['x'], DerivArray) and [dict(d) for d in loaded['x'].derivs] == derivs
    np.testing.assert_array_equal(loaded['x'].value, value)
    np.testing.assert_array_equal(loaded['x'][('a', 'b')], value[4])
    np.testing.assert_array_equal(loaded['a'], jax_chain['a'])
    loaded.save(tmp_path / 'port.npz')
    back = JaxChain.load(tmp_path / 'port.npz')
    assert [dict(d) for d in back['x'].derivs] == derivs
    np.testing.assert_array_equal(np.asarray(back['x'].value), value)


def run_checks(cls, diagnostics_cls, chains):
    """The check suite's verdicts, latest values and histories over a
    sequence of (chain, kwargs), as the reference's test drives it."""
    state = types.SimpleNamespace(names=['a', 'b'], diagnostics={}, diagnostics_history=diagnostics_cls())
    verdicts = [cls.check(state, chain, **kwargs) for chain, kwargs in chains]
    return verdicts, state.diagnostics, state.diagnostics_history


def test_check_suite_histories_and_verdicts():
    """Drift caught by Geweke, tail growth by the CL-interval GR, stable_over
    and the IAT stability window: the same verdicts, latest values and
    histories as the JAX package's check() (tests/test_samplers.py:251-296)."""
    rng = np.random.default_rng(2)
    nsteps, nchains = 4000, 4
    drift = rng.standard_normal((nsteps, nchains, 2)) + np.linspace(0., 1.0, nsteps)[:, None, None]
    tails = rng.standard_normal((nsteps, nchains, 2))
    tails[:, 2:] *= 1.3
    converged = rng.standard_normal((nsteps, nchains, 2))
    sequences = [
        [(drift, dict(max_gr=1.05, min_ess=200)), (drift, dict(max_gr=1.05, min_ess=200, max_geweke=3.))],
        [(tails, dict(max_gr=1.05, min_ess=200)), (tails, dict(max_gr=1.05, min_ess=200, max_cl_gr=1.01))],
        [(converged, dict(max_gr=1.05, min_ess=200, max_cl_gr=1.01, max_geweke=3., min_geweke_pvalue=1e-3,
                          max_eigen_gr=1.05))],
        [(converged, dict(max_gr=1.05, min_ess=200, stable_over=2))] * 2,
        [(converged, dict(max_dact=0.3))] * 2,
    ]
    expected_verdicts = [[True, False], [True, False], [True], [False, True], [False, True]]
    for sequence, expected in zip(sequences, expected_verdicts):
        runs = []
        for cls, diag_cls, chain_cls in ((BasePosteriorSampler, Diagnostics, Chain),
                                         (JaxBasePosteriorSampler, JaxDiagnostics, JaxChain)):
            runs.append(run_checks(cls, diag_cls, [(synthetic(chain_cls, v, extra=False), kw) for v, kw in sequence]))
        (verdicts, latest, history), (verdicts_jax, latest_jax, history_jax) = runs
        assert verdicts == verdicts_jax == expected
        assert latest.keys() == latest_jax.keys() and history.keys() == history_jax.keys()
        for key in latest:
            close(latest[key], latest_jax[key])
        for key in history:
            assert len(history[key]) == len(history_jax[key])
            for got, ref in zip(history[key], history_jax[key]):
                close(got, ref)


@pytest.mark.parametrize('config', [dict(limits=(-1., 3.)), dict(dist='norm', loc=0.5, scale=0.2),
                                    dict(dist='norm', loc=1., scale=0.5, limits=(0.8, 2.)),
                                    dict(dist='expon', loc=0.1, scale=2.), dict(dist='loguniform', limits=(0.1, 10.))],
                         ids=['uniform', 'norm', 'truncated_norm', 'expon', 'loguniform'])
def test_prior_sample(config):
    """Prior.sample draws from a torch.Generator: inside the limits, with the
    distribution's mean and standard deviation (scipy's, truncated where the
    limits cut it), and the same draws for the same seed."""
    import torch
    from scipy import stats
    from desilike_tpu_torch.parameters import Prior
    prior = Prior(**config)
    draws = prior.sample(torch.Generator().manual_seed(1), (200000,), dtype=torch.float64).numpy()
    lo, hi = prior.limits
    assert np.all((draws >= lo) & (draws <= hi))
    if prior.dist == 'uniform':
        ref = stats.uniform(lo, hi - lo)
    elif prior.dist == 'norm':
        ref = stats.truncnorm((lo - prior.loc) / prior.scale, (hi - prior.loc) / prior.scale, prior.loc, prior.scale)
    elif prior.dist == 'expon':
        ref = stats.expon(prior.loc, prior.scale)
    else:
        ref = stats.loguniform(lo, hi)
    assert draws.mean() == pytest.approx(ref.mean(), abs=5. * ref.std() / np.sqrt(draws.size))
    assert draws.std() == pytest.approx(ref.std(), rel=0.01)
    again = prior.sample(torch.Generator().manual_seed(1), (200000,), dtype=torch.float64).numpy()
    np.testing.assert_array_equal(again, draws)
