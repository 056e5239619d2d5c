"""The port's host-side observables layer against the JAX package, live (both
sides are numpy, so each comparison takes milliseconds): the
``ObservableArray`` / ``ObservableCovariance`` containers (selections,
rebinning, coordinate matching, mock estimation and its Hartlap and
Percival factors, marginalization, the npz files each package writes), the
readers of measured products in ``interop.py`` (pypower-style power
spectra, correlation functions and window matrices, glob patterns of mocks,
chains). Tolerances: exact for the containers and the files, 1e-12 for the
readers.
"""

import numpy as np
import pytest

from desilike_tpu import interop as jax_interop
from desilike_tpu.observables import types as jax_types
from desilike_tpu.samples.chain import Chain as JaxChain
from desilike_tpu_torch import interop
from desilike_tpu_torch.observables import types
from desilike_tpu_torch.samples import Chain
from test_interop import make_pypower_state, make_window_state


def arrays(module, seed=0):
    """Two projections on different grids, with weights, from one seed."""
    rng = np.random.default_rng(seed)
    x = [np.linspace(0.01, 0.2, 20), np.linspace(0.02, 0.2, 19)]
    value = [rng.normal(size=len(xx)) for xx in x]
    weights = [rng.uniform(0.5, 1.5, size=len(xx)) for xx in x]
    return module.ObservableArray(x=x, value=value, weights=weights, projs=[0, 2], name='power')


def assert_same_array(got, expected):
    assert got.projs == expected.projs and got.name == expected.name
    for key in ('x', 'value', 'edges', 'weights'):
        for a, b in zip(getattr(got, key), getattr(expected, key)):
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_observable_array_operations():
    """select (with rebinning and projections), slice, rebin, xmatch, view,
    flat_mask and slice_matrix, exactly as the JAX package does them."""
    port, ref = arrays(types), arrays(jax_types)
    assert_same_array(port.select(xlim=(0.03, 0.15), rebin=2, projs=[2]),
                      ref.select(xlim=(0.03, 0.15), rebin=2, projs=[2]))
    assert_same_array(port.select(projs=2, select_projs=True), ref.select(projs=2, select_projs=True))
    assert_same_array(port.slice(slice(1, None, 3)), ref.slice(slice(1, None, 3)))
    assert_same_array(port.rebin(2), ref.rebin(2))
    target = ref.rebin(2).xavg(projs=0)[2:6]
    assert_same_array(port.xmatch(target, projs=[0]), ref.xmatch(target, projs=[0]))
    np.testing.assert_array_equal(port.view(xlim=(0.05, 0.1)), ref.view(xlim=(0.05, 0.1)))
    np.testing.assert_array_equal(port.flat_mask(projs=[2], xlim=(0.05, 0.1)), ref.flat_mask(projs=[2], xlim=(0.05, 0.1)))
    np.testing.assert_array_equal(port.slice_matrix(slice(0, None, 2), projs=[0]),
                                  ref.slice_matrix(slice(0, None, 2), projs=[0]))
    assert port == types.ObservableArray(x=port.x, value=port.value, projs=port.projs)


def test_observable_covariance_operations():
    """from_observations over 30 seeded observations of two observables, then
    select, slice, xmatch, view, marginalize, clone and the statistics,
    exactly as the JAX package does them."""
    covs = {}
    for module in (types, jax_types):
        observations = [[arrays(module, seed=i), module.ObservableArray(
            x=[np.linspace(50., 150., 11)], value=[np.random.default_rng(100 + i).normal(size=11)], name='corr')]
            for i in range(30)]
        covs[module] = module.ObservableCovariance.from_observations(observations)
    port, ref = covs[types], covs[jax_types]
    assert port.nobs == ref.nobs == 30
    np.testing.assert_array_equal(port.value, ref.value)
    for a, b in zip(port.observables, ref.observables):
        assert_same_array(a, b)
    np.testing.assert_array_equal(port.select(xlim=(0.05, 120.), projs=[0], observables='power').value,
                                  ref.select(xlim=(0.05, 120.), projs=[0], observables='power').value)
    np.testing.assert_array_equal(port.slice(slice(0, None, 2), observables=0).value,
                                  ref.slice(slice(0, None, 2), observables=0).value)
    target = ref.observables[0].rebin(2).xavg(projs=0)[1:5]
    np.testing.assert_array_equal(port.xmatch(target, observables=0, projs=[0]).value,
                                  ref.xmatch(target, observables=0, projs=[0]).value)
    np.testing.assert_array_equal(port.view(observables='corr'), ref.view(observables='corr'))
    template = np.ones((2, 20))
    np.testing.assert_array_equal(port.marginalize(template, prior=[1., 4.], observables=0, projs=[0]).value,
                                  ref.marginalize(template, prior=[1., 4.], observables=0, projs=[0]).value)
    np.testing.assert_array_equal(port.clone(value=2. * port.value).value, 2. * ref.value)
    for name in ('corrcoef', 'inv', 'var'):
        np.testing.assert_array_equal(getattr(port, name)(), getattr(ref, name)())
    np.testing.assert_array_equal(port.std, ref.std)


@pytest.mark.parametrize('nobs', [200, 41, 43])
def test_mock_factors(nobs):
    """The Hartlap 2007 and Percival 2014 factors of a covariance of 39 bins
    from ``nobs`` mocks, against the JAX package's (1e-12), and their
    raises: the Hartlap factor is undefined at nobs <= nbins + 2, the
    Percival one at nobs <= nbins + 4."""
    nbins = 39
    port = types.ObservableCovariance(np.eye(nbins), [arrays(types)], nobs=nobs)
    ref = jax_types.ObservableCovariance(np.eye(nbins), [arrays(jax_types)], nobs=nobs)
    for method, args, limit in (('hartlap2007_factor', (), nbins + 2), ('percival2014_factor', (7,), nbins + 4)):
        if nobs <= limit:
            for cov in (port, ref):
                with pytest.raises(ValueError):
                    getattr(cov, method)(*args)
        else:
            got, expected = getattr(port, method)(*args), getattr(ref, method)(*args)
            assert got == pytest.approx(expected, rel=1e-12, abs=0.)
    assert types.ObservableCovariance(np.eye(nbins), [arrays(types)]).percival2014_factor(7) == 1.


def test_files_round_trip(tmp_path):
    """An ObservableArray and an ObservableCovariance written by the JAX
    package load here, and the port's files load there, unchanged."""
    ref_array, port_array = arrays(jax_types), arrays(types)
    ref_cov = jax_types.ObservableCovariance(np.diag(np.arange(1., 40.)), [ref_array], nobs=50, attrs={'a': 1})
    ref_array.save(tmp_path / 'jax_array.npz')
    ref_cov.save(tmp_path / 'jax_cov.npz')
    assert_same_array(types.ObservableArray.load(tmp_path / 'jax_array.npz'), ref_array)
    loaded = types.ObservableCovariance.load(tmp_path / 'jax_cov.npz')
    np.testing.assert_array_equal(loaded.value, ref_cov.value)
    assert loaded.nobs == 50 and loaded.attrs == {'a': 1}
    assert_same_array(loaded.observables[0], ref_array)
    port_array.save(tmp_path / 'port_array.npz')
    types.ObservableCovariance(ref_cov.value, [port_array], nobs=50).save(tmp_path / 'port_cov.npz')
    assert_same_array(jax_types.ObservableArray.load(tmp_path / 'port_array.npz'), ref_array)
    np.testing.assert_array_equal(jax_types.ObservableCovariance.load(tmp_path / 'port_cov.npz').value, ref_cov.value)


def test_power_spectrum_readers(tmp_path):
    """A pypower-style measurement and 6 mock files by glob pattern, through
    read_power_multipoles, select_multipoles (rebinned 2:1) and
    load_power_spectrum_data (the mock mean, the shot noise), against the
    JAX package's readers (1e-12)."""
    k = np.arange(0.005, 0.3, 0.005) + 0.0025
    for i in range(6):
        np.save(tmp_path / 'mock_{:d}.npy'.format(i), make_pypower_state(k, seed=i)[0])
    state = make_pypower_state(k, seed=99)[0]
    got, expected = interop.read_power_multipoles(state), jax_interop.read_power_multipoles(state)
    assert got['ells'] == expected['ells'] and got['shotnoise'] == expected['shotnoise']
    np.testing.assert_allclose(got['power'], expected['power'], rtol=1e-12, atol=0.)
    klim = {0: (0.02, 0.2, 0.01), 2: (0.02, 0.2, 0.01)}
    for got, expected in zip(interop.select_multipoles(got, klim), jax_interop.select_multipoles(expected, klim)):
        np.testing.assert_allclose(np.concatenate(got) if isinstance(got, list) else got,
                                   np.concatenate(expected) if isinstance(expected, list) else expected, rtol=1e-12)
    pattern = [str(tmp_path / 'mock_*.npy')]
    got, expected = interop.load_power_spectrum_data(pattern, klim), jax_interop.load_power_spectrum_data(pattern, klim)
    assert len(got['list_y']) == 6 and got['shotnoise'] == pytest.approx(expected['shotnoise'], rel=1e-12)
    np.testing.assert_allclose(got['flatdata'], expected['flatdata'], rtol=1e-12)
    np.testing.assert_allclose(np.array(got['list_y']), np.array(expected['list_y']), rtol=1e-12)
    corr = {'s': np.linspace(20., 150., 27), 'ells': np.array([0, 2]), 'corr': np.ones((2, 27))}
    for key in ('s', 'corr'):
        np.testing.assert_array_equal(interop.read_correlation_multipoles(corr)[key],
                                      jax_interop.read_correlation_multipoles(corr)[key])


@pytest.mark.parametrize('kwargs', [dict(klim={0: (0.02, 0.2), 2: (0.02, 0.2)}, kin=np.geomspace(2e-3, 0.4, 120)),
                                    dict(kout=[np.arange(0.02, 0.195, 0.01)] * 2, kinrebin=2,
                                         kinlim=(0.002, 0.3), ellsin=(0, 2)),
                                    dict(klim={0: (0.02, 0.2, 0.01), 2: (0.02, 0.2, 0.01)})],
                         ids=['regrid', 'factorout', 'klim_step'])
def test_window_matrix_reader(tmp_path, kwargs):
    """A pypower-style window file through read_window_matrix: output rows
    selected by klim or matched to a data grid by the factorout search,
    input projections selected, rebinned, limited and re-gridded, and the
    shot-noise response, against the JAX package's reader (1e-12)."""
    kin = np.geomspace(1e-3, 0.5, 300)
    kout = np.arange(0.005, 0.3, 0.005) + 0.0025
    np.save(tmp_path / 'wmatrix.npy', make_window_state(kin, kout))
    path = str(tmp_path / 'wmatrix.npy')
    got = interop.read_window_matrix(path, ells=(0, 2), **kwargs)
    expected = jax_interop.read_window_matrix(path, ells=(0, 2), **kwargs)
    assert got[3] == expected[3]
    for a, b in zip(got[:2] + (np.concatenate(got[2]), got[4]), expected[:2] + (np.concatenate(expected[2]), expected[4])):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.)


def test_load_source(tmp_path):
    """A chain, saved and loaded by path, as a compression source: its best
    fit, mean and covariance as the JAX package's load_source gives them
    from the same samples; a Profiles source gives its best fit as the JAX
    package's does; a source of another type raises."""
    rng = np.random.default_rng(3)
    data = {'DM_over_rd': 17.9 + 0.2 * rng.normal(size=500), 'DH_over_rd': 20.5 + 0.4 * rng.normal(size=500),
            'logposterior': -rng.uniform(size=500)}
    Chain(data).save(tmp_path / 'chain.npz')
    ref = JaxChain(data)
    names = ['DM_over_rd', 'DH_over_rd']
    got = interop.load_source(str(tmp_path / 'chain.npz'), choice={'index': 'argmax'}, params=names)
    assert got == jax_interop.load_source(ref, choice={'index': 'argmax'}, params=names)
    assert interop.load_source([str(tmp_path / 'chain.npz')], params=names) == pytest.approx(
        jax_interop.load_source(ref, params=names), rel=1e-12)
    np.testing.assert_allclose(interop.load_source(str(tmp_path / 'chain.npz'), cov=True, params=names)[1],
                               jax_interop.load_source(ref, cov=True, params=names)[1], rtol=1e-12)

    from desilike_tpu_torch.samples import Profiles
    from desilike_tpu.samples.profiles import Profiles as JaxProfiles
    profiles, jax_profiles = Profiles(names), JaxProfiles(names)
    for prof in (profiles, jax_profiles):
        for name in names + ['logposterior']:
            prof.bestfit[name] = data[name][:3]
    assert interop.load_source(profiles, params=names) == jax_interop.load_source(jax_profiles, params=names)

    class NotASource(object):
        bestfit = {}

    with pytest.raises(ValueError):
        interop.load_source(NotASource())
