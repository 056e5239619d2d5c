"""The port's profile and covariance containers, contour extractor and plots
against the JAX package's (numpy on both sides), on the CPU.

Files written by either package load in the other (``Profiles``,
``ParameterCovariance``, ``ParameterPrecision``: the same ``.npz`` layout);
the containers' algebra and summaries agree with the JAX package's; the
plots' numbers (``_gaussian_kde_1d``, ``_contour_levels_2d``,
``_mean_std_of``) equal the JAX package's, and each plot is written to a
file under matplotlib's Agg backend.
"""

import numpy as np
import pytest

import desilike_tpu.samples.profiles as jax_profiles
import desilike_tpu.samples.plotting as jax_plotting
from desilike_tpu.parameters import Parameter as JaxParameter
from desilike_tpu.parameters.covariance import (ParameterCovariance as JaxCovariance,
                                                ParameterPrecision as JaxPrecision)
from desilike_tpu.samples.chain import Chain as JaxChain
from desilike_tpu.utils import marching_squares as jax_marching_squares
from desilike_tpu.interop import load_source as jax_load_source
from desilike_tpu_torch import plotting, interop
from desilike_tpu_torch.parameters import Parameter, ParameterCovariance, ParameterPrecision
from desilike_tpu_torch.samples import Chain, Profiles, plotting as samples_plotting
from desilike_tpu_torch.utils import marching_squares

NAMES = ('a', 'b', 'c')
COV = np.array([[0.04, 0.01, 0.], [0.01, 0.09, 0.02], [0., 0.02, 0.25]])
CENTER = np.array([1., -0.5, 2.])


@pytest.fixture(autouse=True, scope='module')
def agg():
    import matplotlib
    backend = matplotlib.get_backend()
    matplotlib.use('Agg')
    yield
    matplotlib.use(backend)


def fill(profiles):
    """The same results in either package's Profiles: two starts, errors,
    covariance, intervals, a 1D profile, a contour with two segments at one
    level and its grid, an nD grid."""
    profiles.bestfit['a'] = np.array([1.01, 0.99])
    profiles.bestfit['b'] = np.array([-0.5, -0.52])
    profiles.bestfit['c'] = np.array([2.1, 2.])
    profiles.bestfit['logposterior'] = np.array([-3.2, -3.1])
    profiles.error.update({'a': 0.2, 'b': 0.3, 'c': 0.5})
    profiles.covariance = COV
    profiles.interval.update({'a': (0.8, 1.2), 'b': (-0.8, -0.2)})
    profiles.profile['a'] = (np.linspace(0.5, 1.5, 5), np.array([6.5, 2.7, 0.1, 2.5, 6.1]))
    g = np.linspace(-1., 1., 4)
    profiles.contour[('a', 'b')] = {'grid': (g, g + 1., np.arange(16.).reshape(4, 4)),
                                    'paths': {1.: [(np.array([0., 1.]), np.array([1., 2.])),
                                                   (np.array([3., 4., 5.]), np.array([1., 0., 1.]))],
                                              2.: [(np.array([0., 2.]), np.array([1., 3.]))]}}
    profiles.grid[('a', 'b')] = (np.stack(np.meshgrid(g, g, indexing='ij'), axis=-1), np.arange(16.).reshape(4, 4))
    return profiles


def assert_same_profiles(got, expected):
    assert got.bestfit.names() == expected.bestfit.names()
    for name in expected.bestfit.names():
        np.testing.assert_array_equal(got.bestfit[name], expected.bestfit[name])
    assert got.error == expected.error
    assert {k: tuple(v) for k, v in got.interval.items()} == {k: tuple(v) for k, v in expected.interval.items()}
    np.testing.assert_array_equal(got.covariance, expected.covariance)
    np.testing.assert_array_equal(np.stack(got.profile['a']), np.stack(expected.profile['a']))
    for level, segs in expected.contour_paths(('a', 'b')).items():
        got_segs = got.contour_paths(('a', 'b'))[level]
        assert len(got_segs) == len(segs)
        for (x1, y1), (x2, y2) in zip(got_segs, segs):
            np.testing.assert_array_equal(x1, x2)
            np.testing.assert_array_equal(y1, y2)
    for part in range(3):
        np.testing.assert_array_equal(got.contour[('a', 'b')]['grid'][part], expected.contour[('a', 'b')]['grid'][part])
    np.testing.assert_array_equal(got.grid[('a', 'b')][1], expected.grid[('a', 'b')][1])
    assert got.params.names() == expected.params.names()


def test_profiles_files_both_ways(tmp_path):
    ours = fill(Profiles([Parameter(n, latex=n.upper()) for n in NAMES]))
    theirs = fill(jax_profiles.Profiles([JaxParameter(n, latex=n.upper()) for n in NAMES]))
    ours.save(tmp_path / 'port.npz')
    theirs.save(tmp_path / 'jax.npz')
    assert_same_profiles(Profiles.load(tmp_path / 'jax.npz'), theirs)
    assert_same_profiles(jax_profiles.Profiles.load(tmp_path / 'port.npz'), ours)
    assert_same_profiles(Profiles.load(tmp_path / 'port.npz'), ours)


def test_profiles_methods_match_jax():
    ours = fill(Profiles([Parameter(n, latex=n.upper()) for n in NAMES]))
    theirs = fill(jax_profiles.Profiles([JaxParameter(n, latex=n.upper()) for n in NAMES]))
    assert ours.choice() == theirs.choice() and ours.argmax() == theirs.argmax() == 1
    for fmt in ('plain', 'latex'):
        assert ours.to_stats(tablefmt=fmt) == theirs.to_stats(tablefmt=fmt)
    both = Profiles.concatenate(ours, ours)
    np.testing.assert_array_equal(both.bestfit['a'], jax_profiles.Profiles.concatenate(theirs, theirs).bestfit['a'])
    fisher, jax_fisher = ours.to_fisher(params=['a', 'b']), theirs.to_fisher(params=['a', 'b'])
    np.testing.assert_allclose(fisher.covariance(), np.asarray(jax_fisher.covariance()), rtol=1e-12)
    np.testing.assert_allclose(fisher.mean(), np.asarray(jax_fisher.mean()), rtol=1e-12)
    assert ours.profile.choice() == theirs.profile.choice()
    np.testing.assert_allclose(ours.profile.interpolate(9)['a'][1], theirs.profile.interpolate(9)['a'][1])
    assert np.array_equal(ours.grid.choice()[0], theirs.grid.choice()[0])
    with pytest.raises(NotImplementedError, match='A17'):
        ours.to_getdist()
    # the uniform loaders on a Profiles source: the best fit, the parabolic covariance
    assert interop.load_source(ours) == {'a': 0.99, 'b': -0.52, 'c': 2.}
    assert interop.load_source(ours) == jax_load_source(theirs, params=list(NAMES))
    names, cov = interop.load_source(ours, cov=True)
    assert names == list(NAMES) and np.array_equal(cov, COV)
    assert interop.get_params_in_source(ours) == list(NAMES)
    assert interop.get_params_in_source(ours, params=['b']) == ['b']


def covariances(package):
    cov_cls, prec_cls, param = ((ParameterCovariance, ParameterPrecision, Parameter) if package == 'port' else
                                (JaxCovariance, JaxPrecision, JaxParameter))
    params = [param(n, value=v) for n, v in zip(NAMES, CENTER)]
    return cov_cls(COV, params, attrs={'note': 'x'}), prec_cls(np.linalg.inv(COV[:2, :2]), params[:2]), cov_cls


def test_covariance_files_both_ways(tmp_path):
    (ours, ours_prec, _), (theirs, theirs_prec, _) = covariances('port'), covariances('jax')
    for obj, other_cls, name in ((ours, JaxCovariance, 'c1'), (theirs, ParameterCovariance, 'c2'),
                                 (ours_prec, JaxPrecision, 'p1'), (theirs_prec, ParameterPrecision, 'p2')):
        obj.save(tmp_path / (name + '.npz'))
        loaded = other_cls.load(tmp_path / (name + '.npz'))
        np.testing.assert_array_equal(loaded.view(), obj.view())
        np.testing.assert_array_equal(loaded.center, obj.center)
        assert loaded.names() == obj.names() and loaded.attrs == obj.attrs


def test_covariance_algebra_matches_jax():
    (ours, ours_prec, cov_cls), (theirs, theirs_prec, _) = covariances('port'), covariances('jax')
    pairs = [(ours.view(['b', 'a']), theirs.view(['b', 'a'])),
             (ours.marginalize(['c']).view(), theirs.marginalize(['c']).view()),
             (ours.fix(['c']).view(), theirs.fix(['c']).view()),
             (ours.std(), theirs.std()), (ours.corrcoef(), theirs.corrcoef()), (ours.fom(), theirs.fom()),
             (ours.var(['c']), theirs.var(['c'])),
             (ours.to_precision(['a', 'b']).view(), theirs.to_precision(['a', 'b']).view()),
             (ours_prec.to_covariance().view(), theirs_prec.to_covariance().view()),
             ((ours_prec + ours.to_precision()).view(), (theirs_prec + theirs.to_precision()).view()),
             ((ours_prec + ours.to_precision()).center, (theirs_prec + theirs.to_precision()).center),
             (ours.to_fisher().covariance(), np.asarray(theirs.to_fisher().covariance())),
             (ours_prec.fom(), theirs_prec.fom())]
    for got, expected in pairs:
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-15)
    assert ours.to_stats() == theirs.to_stats()
    rng = np.random.default_rng(3)
    draws = rng.multivariate_normal(CENTER, COV, size=(200, 2))
    chain, jax_chain = Chain(), JaxChain()
    for i, name in enumerate(NAMES):
        chain[Parameter(name)] = draws[..., i]
        jax_chain[JaxParameter(name)] = draws[..., i]
    np.testing.assert_allclose(cov_cls.from_chain(chain).view(), JaxCovariance.from_chain(jax_chain).view(), rtol=1e-12)
    np.testing.assert_allclose(cov_cls.from_fisher(ours.to_fisher()).view(), COV, rtol=1e-12, atol=1e-15)
    for call in (ours.to_getdist, lambda: ours.write_getdist('x.covmat'), lambda: cov_cls.read_getdist('x')):
        with pytest.raises(NotImplementedError, match='A17'):
            call()


def test_marching_squares_matches_jax():
    x, y = np.linspace(-2., 2., 21), np.linspace(-1.5, 2.5, 17)
    fields = [x[:, None] ** 2 + (y[None, :] - 0.5) ** 2,                                  # one closed loop
              np.sin(2. * x[:, None]) * np.cos(2. * y[None, :]),                          # many pieces, saddles
              (x[:, None] ** 2 - 1.) ** 2 + y[None, :] ** 2]                              # two loops
    for z in fields:
        for level in (0.1, 0.5, 0.9):
            got, expected = marching_squares(x, y, z, level), jax_marching_squares(x, y, z, level)
            assert len(got) == len(expected) and len(got) > 0
            for a, b in zip(got, expected):
                np.testing.assert_array_equal(a, b)


def test_plot_numbers_match_jax():
    rng = np.random.default_rng(5)
    x, w = rng.normal(size=500), rng.uniform(size=500)
    grid = np.linspace(-3., 3., 61)
    np.testing.assert_array_equal(samples_plotting._gaussian_kde_1d(x, w, grid), jax_plotting._gaussian_kde_1d(x, w, grid))
    H = rng.uniform(size=(40, 40))
    assert samples_plotting._contour_levels_2d(H) == jax_plotting._contour_levels_2d(H)
    chain, jax_chain = Chain(), JaxChain()
    for name, shift in (('a', 1.), ('b', -0.5)):
        chain[Parameter(name)] = x.reshape(100, 5) + shift
        jax_chain[JaxParameter(name)] = x.reshape(100, 5) + shift
    profiles = fill(Profiles([Parameter(n) for n in NAMES]))
    jax_prof = fill(jax_profiles.Profiles([JaxParameter(n) for n in NAMES]))
    for name in ('a', 'b'):
        assert samples_plotting._mean_std_of(chain, name) == jax_plotting._mean_std_of(jax_chain, name)
        assert samples_plotting._mean_std_of(profiles, name) == jax_plotting._mean_std_of(jax_prof, name)
    fisher, jax_fisher = covariances('port')[0].to_fisher(), covariances('jax')[0].to_fisher()
    np.testing.assert_allclose(samples_plotting._mean_std_of(fisher, 'c'), jax_plotting._mean_std_of(jax_fisher, 'c'),
                               rtol=1e-12)


def test_plots_write_files(tmp_path):
    from matplotlib import pyplot as plt
    rng = np.random.default_rng(6)
    chains = []
    for shift in (0., 0.1):
        chain = Chain()
        for name in ('a', 'b'):
            chain[Parameter(name, latex=name)] = rng.normal(size=(200, 4)) + shift
        chains.append(chain)
    profiles = fill(Profiles([Parameter(n) for n in NAMES]))
    grid_only = fill(Profiles([Parameter(n) for n in NAMES]))
    del grid_only.contour[('a', 'b')]['paths']
    grid_only.contour[('a', 'b')]['grid'] = (np.linspace(0., 1., 9), np.linspace(0., 1., 9),
                                            50. * np.add.outer((np.linspace(0., 1., 9) - 0.5) ** 2,
                                                               (np.linspace(0., 1., 9) - 0.5) ** 2))
    calls = {'triangle': lambda fn: samples_plotting.plot_triangle(chains, truths={'a': 0.}, fn=fn),
             'trace': lambda fn: samples_plotting.plot_trace(chains[0], fn=fn),
             'profile': lambda fn: samples_plotting.plot_profile(profiles, fn=fn),
             'contour': lambda fn: plotting.plot_contour([profiles, grid_only], ('a', 'b'), labels=['1', '2'],
                                                         truths={'a': 1.}, fn=fn),
             'comparison': lambda fn: plotting.plot_comparison([chains[0], profiles, covariances('port')[0].to_fisher()],
                                                               params=['a', 'b'], fn=fn),
             'covariance': lambda fn: plotting.plot_covariance_matrix(covariances('port')[0], fn=fn)}
    for name, call in calls.items():
        fn = tmp_path / (name + '.png')
        call(fn)
        assert fn.stat().st_size > 0, name
        plt.close('all')
    wrapped = plotting.plotter(lambda: plt.figure())
    wrapped(fn=tmp_path / 'sub' / 'plotter.png')
    assert (tmp_path / 'sub' / 'plotter.png').stat().st_size > 0
    plt.close('all')
    for call in (lambda: plotting.plot_triangle_getdist(chains), lambda: plotting.to_anesthetic(chains[0])):
        with pytest.raises(NotImplementedError, match='A17'):
            call()
