"""Config 3f at a small width on the CPU: BASELINE's config 3 (EPT on direct
cosmology parameters) fed from files that ``chip_smoke.write_files`` writes
with numpy from a seed (pypower-style data, 100 mocks, a window file with
its shot-noise response), with top-hat fiber collisions folded into the
window and two systematic templates solved statically
(``chip_smoke.build_files_likelihood(..., small=True)``). The JAX side is
frozen in ``tests/data/torch_port_observables_reference.npz``
(``scripts/make_torch_port_reference.py observables``, x64, from files
written by the same writer). Then the Hartlap and Percival factors of
``tests/test_likelihood.py:166-225`` on the port, and the covariances of
several observables.

Tolerances: the readers 1e-12 (live against the JAX package's); the host
state (folded window, offset, templates, mock covariance) 1e-10 of its
largest value, the mock factors and the whitening 1e-12; the likelihood in
float32 against JAX x64 at 16 points within 2e-2 on the log-posterior and
5e-4 of the gradient's norm (the config 3 family's limits), the solved
parameters within 2e-3 of their prior width or value (measured 1.0e-3 for
``syst_b``, a constant template nearly degenerate with the monopole's
``sn0``; the others within 4e-4).
"""

import functools
import logging
import os

import numpy as np
import pytest
import torch

import chip_smoke
from desilike_tpu import interop as jax_interop
from desilike_tpu_torch import (interop, DampedBAOWigglesTracerPowerSpectrumMultipoles,
                                TracerPowerSpectrumMultipolesObservable, ObservablesGaussianLikelihood,
                                ObservableArray, ObservableCovariance)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_observables_reference.npz'))


def small(key):
    return REFERENCE['small_' + key]


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp('files'))
    chip_smoke.write_files(directory, small=True)
    return directory


@pytest.fixture(scope='module')
def like(files):
    like = chip_smoke.build_files_likelihood('cpu', files, small=True)
    like.logpost_fn()
    return like


def assert_close(got, expected, rtol, label):
    np.testing.assert_allclose(np.asarray(got, dtype='f8'), expected, rtol=0., atol=rtol * np.abs(expected).max(),
                               err_msg=label)


def check_x64(like, label):
    """float32 log-posterior, gradient and solved parameters at the 16
    frozen points against the JAX package's x64 values."""
    names = list(small('names'))
    assert like.pipeline.varied_params.names() == names, label
    points = small('points')
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, aux = like.logpost_fn()(values)
    logpost.sum().backward()
    np.testing.assert_allclose(logpost.detach().numpy(), small('logpost_x64'), rtol=0., atol=2e-2, err_msg=label)
    grad, ref = torch.stack([values[n].grad for n in names], dim=-1).numpy(), small('grad_x64')
    assert np.max(np.linalg.norm(grad - ref, axis=-1) / np.linalg.norm(ref, axis=-1)) < 5e-4, label
    solved = like.pipeline.solved_params
    assert solved.names() == list(small('solved_names'))
    got = torch.stack([aux['solved'][n] for n in solved.names()], dim=-1).detach().numpy()
    width, ref = np.array([p.prior.scale for p in solved]), small('solved_x64')
    assert np.all(np.abs(got - ref) <= 2e-3 * np.maximum(width, np.abs(ref))), label


def test_files_readers(files, like):
    """The data, mock and window files through the port's readers and the
    JAX package's (1e-12): the shot noise, the 5:1 factorout rebinning of the
    window rows onto the data's bins, the shot-noise response; the
    observable's data, k grid and mock covariance against the frozen JAX
    ones."""
    path = os.path.join(files, 'data.npy')
    got, expected = interop.read_power_multipoles(path), jax_interop.read_power_multipoles(path)
    assert got['shotnoise'] == expected['shotnoise'] == pytest.approx(1. / chip_smoke.FILES_NBAR, rel=1e-12)
    np.testing.assert_allclose(got['power'], expected['power'], rtol=1e-12)
    observable = like.observables[0]
    kwargs = dict(ells=chip_smoke.FILES_ELLS, kout=observable.k, kinlim=chip_smoke.FILES_KINLIM)
    path = os.path.join(files, 'wmatrix.npy')
    got, expected = interop.read_window_matrix(path, **kwargs), jax_interop.read_window_matrix(path, **kwargs)
    for a, b in zip(got[:2] + (got[4],), expected[:2] + (expected[4],)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.)
    assert got[1].shape == (54, 210)
    assert observable.nmocks == 100 and observable.wmatrix.shotnoise == pytest.approx(1. / chip_smoke.FILES_NBAR, rel=1e-12)
    np.testing.assert_allclose(np.array(observable.k), small('k'), rtol=1e-12)
    assert_close(observable.flatdata, small('flatdata'), 1e-12, 'flatdata')
    assert_close(observable.covariance, small('covariance'), 1e-12, 'mock covariance')


def test_files_host_state(like):
    """The folded window (fiber collisions in it), its constant offset (their
    uncorrelated term, the shot-noise response), the templates, the input
    grid, the mock factors (Hartlap (100 - 54 - 2) / 99; Percival with 7
    varied and 8 solved parameters), the whitening and the static design
    rows (sn*, syst_*) against the JAX package's."""
    window = like.observables[0].wmatrix
    assert_close(window.wmatrix, small('wmatrix'), 1e-10, 'wmatrix')
    assert_close(window.offset, small('offset'), 1e-10, 'offset')
    assert_close(window.templates, small('templates'), 1e-10, 'templates')
    np.testing.assert_allclose(window.kin, small('kin'), rtol=1e-12)
    assert like._nmocks == int(small('nmocks')) == 100
    assert like.hartlap == pytest.approx(float(small('hartlap')), rel=1e-12) == pytest.approx(44. / 99., rel=1e-12)
    assert like._mock_factor == pytest.approx(float(small('percival')), rel=1e-12)
    assert_close(like._whiten, small('whiten'), 1e-12, 'whiten')
    assert_close(like._whiten_base, small('whiten_base'), 1e-12, 'whiten_base')
    names = tuple(small('static_names'))
    assert tuple(like._static_J) == (names,)
    assert_close(like._static_J[names], small('static_J'), 1e-10, 'static_J')


def test_files_likelihood(like):
    """The small config 3f in float32 against JAX x64 at 16 points."""
    check_x64(like, 'config 3f (small), own host state')


def test_files_state_from_numpy(like):
    """The JAX likelihood's host state (template tables, folded window,
    offset, data, whitening with both mock factors, static rows with
    syst_*) loaded into the port's build (the last test of the module's
    build: it replaces the build's own state): its logpost_fn keeps that
    whitening (the Percival factor is not applied twice) and gives the JAX
    x64 values within the same limits."""
    state = {key: small(key) for key in ('pk_dd_fid', 'pknow_dd_fid', 'flatdata', 'wmatrix', 'whiten', 'static_J',
                                         'offset')}
    assert set(interop.state_keys(1)) | {'offset'} == set(state)
    interop.state_from_numpy(like, state)
    check_x64(like, 'config 3f (small), JAX host state')
    np.testing.assert_array_equal(like._whiten, small('whiten'))
    np.testing.assert_array_equal(like.observables[0].wmatrix.offset, small('offset'))


@functools.lru_cache()
def bao_data(klim):
    """The data the BAO monopole of ``tests/test_likelihood.py`` generates
    from its theory over ``klim``."""
    observable = TracerPowerSpectrumMultipolesObservable(data={}, klim={0: klim},
                                                         theory=DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,)))
    observable.runtime_info.initialize()
    return observable.flatdata


def bao_observable(rng, nmocks=None, klim=(0.05, 0.15, 0.01)):
    """The BAO monopole of ``tests/test_likelihood.py`` on its generated
    data; with ``nmocks``, that many mock vectors (5% scatter) as its
    covariance."""
    data = bao_data(klim)
    mocks = None if nmocks is None else list(data + rng.normal(0, 0.05 * np.abs(data), (nmocks, data.size)))
    return TracerPowerSpectrumMultipolesObservable(data=data, klim={0: klim}, covariance=mocks,
                                                   theory=DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,)))


def test_percival_factor_applied():
    """``tests/test_likelihood.py::test_percival_factor_applied`` on the
    port: with 200 mocks the precision is the Hartlap-scaled one over
    exactly the Percival 2014 m, and rebuilding logpost_fn does not stack
    it."""
    like = ObservablesGaussianLikelihood(observables=[bao_observable(np.random.default_rng(5), nmocks=200)],
                                         device='cpu')
    like.runtime_info.initialize()
    assert like.hartlap < 1.
    like.logpost_fn()
    nm, nd = 200, like.size
    nv = len(like.pipeline.varied_params) + len(like.pipeline.solved_params)
    A = 2. / ((nm - nd - 1.) * (nm - nd - 4.))
    B = (nm - nd - 2.) / ((nm - nd - 1.) * (nm - nd - 4.))
    m = (1. + B * (nd - nv)) / (1. + A + B * (nv + 1.))
    np.testing.assert_allclose(like.precision, like._precision_base / m, rtol=1e-12)
    np.testing.assert_allclose(like._whiten.T @ like._whiten, like.precision, rtol=1e-9, atol=1e-9 * np.abs(like.precision).max())
    precision = like.precision.copy()
    like.logpost_fn()
    np.testing.assert_array_equal(like.precision, precision)


def test_percival_outside_validity_degrades_to_hartlap(caplog):
    """``tests/test_likelihood.py::test_percival_outside_validity_degrades_to_hartlap``
    on the port: nmocks = ndata + 3 defines the Hartlap factor but not the
    Percival one, which logpost_fn skips with a warning, and the
    log-posterior is finite."""
    nd = len(bao_data((0.05, 0.15, 0.01)))
    observable = bao_observable(np.random.default_rng(6), nmocks=nd + 3)
    like = ObservablesGaussianLikelihood(observables=[observable], device='cpu')
    like.runtime_info.initialize()
    assert 0. < like.hartlap < 1.
    with caplog.at_level(logging.WARNING):
        fn = like.logpost_fn()
    assert any('Hartlap factor only' in record.message for record in caplog.records)
    np.testing.assert_array_equal(like.precision, like._precision_base)
    logpost, _ = fn({p.name: torch.tensor([p.value], dtype=torch.float32) for p in like.pipeline.varied_params})
    assert bool(torch.isfinite(logpost).all())


def test_observable_covariances():
    """Covariances that come with the observables, as the JAX package
    assembles them (``likelihoods/base.py:453-510``): two observables whose
    covariances come from 60 and 80 separate mocks, block-diagonal, each
    block over its own Hartlap factor and no global one; an
    ``ObservableCovariance`` from 200 mocks given to the likelihood (the
    global Hartlap factor from its nobs) with ``scale_covariance`` and a
    name."""
    rng = np.random.default_rng(7)
    observables = [bao_observable(rng, nmocks=60), bao_observable(rng, nmocks=80, klim=(0.06, 0.14, 0.01))]
    like = ObservablesGaussianLikelihood(observables=observables, device='cpu')
    like.runtime_info.initialize()
    blocks = []
    for observable in observables:
        size = len(observable.flatdata)
        blocks.append(observable.covariance / ((observable.nmocks - size - 2.) / (observable.nmocks - 1.)))
    from scipy.linalg import block_diag
    np.testing.assert_allclose(like.covariance, block_diag(*blocks), rtol=1e-12)
    assert like.hartlap == 1. and like._nmocks == 0
    observable = bao_observable(rng)
    observable.runtime_info.initialize()
    mocks = observable.flatdata + rng.normal(0, 0.05 * np.abs(observable.flatdata), (200, observable.flatdata.size))
    covariance = ObservableCovariance.from_observations([ObservableArray(x=observable.k, value=[mock], projs=[0])
                                                         for mock in mocks])
    like = ObservablesGaussianLikelihood(observables=[observable], covariance=covariance, scale_covariance=2.,
                                         name='bao', device='cpu')
    like.runtime_info.initialize()
    nd = len(observable.flatdata)
    assert like.name == 'bao' and like._nmocks == 200
    assert like.hartlap == pytest.approx((200 - nd - 2.) / 199., rel=1e-12)
    np.testing.assert_allclose(like.covariance, 2. * covariance.value, rtol=1e-12)
    np.testing.assert_allclose(like.precision, np.linalg.inv(2. * covariance.value) * like.hartlap, rtol=1e-9)
