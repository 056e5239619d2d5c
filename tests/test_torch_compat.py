"""The port's reference names (``compat``), import-path shims, installer,
weak-lensing gate and ``utils`` helpers against the JAX package's.

The JAX package is imported for its names, its classes' relations and its
numpy helpers; nothing of it is evaluated with JAX.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import desilike_tpu
import desilike_tpu_torch
from desilike_tpu import compat as jax_compat
from desilike_tpu_torch import compat


def canonical(cls, package):
    """The first class of ``cls``'s MRO that the package defines outside its
    compat module: what an alias resolves to."""
    for base in cls.__mro__:
        if base.__module__.startswith(package + '.') and not base.__module__.endswith('.compat'):
            return base
    return None


def public(module):
    return [name for name in dir(module) if not name.startswith('_') and not isinstance(
        getattr(module, name), type(os))]


def test_compat_names_resolve_as_in_jax():
    """Every public name of the JAX package's ``compat`` is in the port's and
    resolves the same way: an identity alias to the port's class of the same
    name, a subclass alias to a subclass of it (``tests/test_compat.py:70-178``),
    the exception aliases to the same built-in exceptions, the functions
    callable."""
    own = [name for name in public(jax_compat) if getattr(getattr(jax_compat, name), '__module__', '').startswith(
        'desilike_tpu') or isinstance(getattr(jax_compat, name), type)]
    assert len(own) > 60
    for name in own:
        theirs, ours = getattr(jax_compat, name), getattr(compat, name)
        if isinstance(theirs, type) and issubclass(theirs, BaseException):
            assert ours is theirs, name
        elif isinstance(theirs, type):
            jax_target, target = canonical(theirs, 'desilike_tpu'), canonical(ours, 'desilike_tpu_torch')
            assert (jax_target is None) == (target is None), name
            if target is not None:
                assert target.__name__ == jax_target.__name__, (name, target, jax_target)
                assert (ours is target) == (theirs is jax_target), name
            else:
                assert ours.__name__ == theirs.__name__, name
        else:
            assert callable(ours) and callable(theirs), name
    for module, jax_module in (('theories', desilike_tpu.theories), ('samplers', desilike_tpu.samplers),
                               ('profilers', desilike_tpu.profilers)):
        ours = importlib.import_module('desilike_tpu_torch.' + module)
        assert ours._COMPAT_NAMES == jax_module._COMPAT_NAMES
        for name in ours._COMPAT_NAMES:
            assert getattr(ours, name) is getattr(compat, name)
        with pytest.raises(AttributeError):
            getattr(ours, 'NoSuchAlias')


def test_theory_and_cosmology_aliases():
    """The wrapper names build and evaluate on the CPU: the bispectrum alias
    with the reference's constructor (``k=`` triangles, 3-tuple ells,
    wrapper options dropped), the 1-loop alias with ``kIR`` mapped to
    ``resum_ks``; ``Cosmoprimo`` maps a host Boltzmann engine to eh99 and
    'DESI' to the default fiducial, and refuses other named fiducials."""
    from desilike_tpu_torch.theories import (FOLPSAXTracerPowerSpectrumMultipoles, GeoFPTAXTracerBispectrumMultipoles,
                                             Cosmoprimo, ShapeFitPowerSpectrumTemplate)
    k = np.linspace(0.02, 0.08, 4)
    theory = GeoFPTAXTracerBispectrumMultipoles(k=[(kk, kk, kk) for kk in k], ells=((0, 0, 0), (2, 0, 0)),
                                                template=ShapeFitPowerSpectrumTemplate(z=1.), prior_basis='physical',
                                                device='cpu')
    B = theory.pipeline.evaluate({'b1': 2.})
    assert B.shape == (1, 2, 4) and bool(torch.isfinite(B).all())
    folps = FOLPSAXTracerPowerSpectrumMultipoles(kIR=0.3, nthreads=4, device='cpu')
    folps.runtime_info.initialize()
    assert folps._resum_q[-1] == pytest.approx(0.3, rel=1e-12)  # the IR damping integral up to kIR
    cosmo = Cosmoprimo(engine='class', fiducial='DESI', device='cpu')
    desilike_tpu_torch.Pipeline(cosmo).evaluate({})
    assert cosmo.engine == 'eh99' and bool(torch.isfinite(cosmo.rs_drag()).all())
    with pytest.raises(ValueError, match='named fiducial'):
        Cosmoprimo(fiducial='Planck2018', device='cpu').runtime_info.initialize()


def test_nested_alias_runs():
    """A dynesty-named sampler samples (the port's nested sampler) and drops
    dynesty's options (``tests/test_compat.py:107-118``)."""
    from desilike_tpu_torch.samplers import StaticDynestySampler
    from test_torch_sampler_steps import GaussianModel
    torch.set_num_threads(1)
    sampler = StaticDynestySampler(GaussianModel(device='cpu'), nlive=128, seed=42, bound='multi', sample='rslice')
    chain = sampler.run(dlogz=0.5)
    assert 'a' in chain.names() and abs(float(chain.mean('a')) - 1.) < 0.2


def test_quasi_random_sequence_and_jit():
    """``RQuasiRandomSequence`` gives the JAX package's points (float and
    integer seeds, across calls, after ``fast_forward`` and ``reset``);
    ``jit`` returns the calculator."""
    for seed in (0.5, 3):
        ours, theirs = compat.RQuasiRandomSequence(d=3, seed=seed), jax_compat.RQuasiRandomSequence(d=3, seed=seed)
        for step in (lambda q: q.random(5), lambda q: q.fast_forward(4).random(3), lambda q: q.reset().random(2)):
            np.testing.assert_allclose(step(ours), step(theirs), rtol=0., atol=1e-15)
    calc = desilike_tpu_torch.Cosmology(device='cpu')
    assert compat.jit(calc, index=2) is calc


def test_import_shims():
    """The reference's import paths resolve to the port's names
    (``tests/test_misc.py:525-545``, but for the ``jax`` idioms)."""
    from desilike_tpu_torch import BaseCalculator, Calculator, ParameterPrior, Prior, plotting, utils
    assert BaseCalculator is Calculator and ParameterPrior is Prior and plotting is not None and utils is not None
    from desilike_tpu_torch.base import BaseCalculator as base_calculator
    from desilike_tpu_torch.parameter import Parameter, ParameterPrior as prior, ParameterCollection  # noqa: F401
    from desilike_tpu_torch.galaxy_clustering import DirectPowerSpectrumTemplate
    from desilike_tpu_torch.theories.galaxy_clustering import (KaiserTracerPowerSpectrumMultipoles, APEffect,  # noqa: F401
                                                               ShapeFitPowerSpectrumTemplate)
    from desilike_tpu_torch.theories.primordial_cosmology import Cosmology
    from desilike_tpu_torch.observables.galaxy_clustering import (TracerPowerSpectrumMultipolesObservable,  # noqa: F401
                                                                  BoxFootprint, CutskyFootprint,
                                                                  WindowedPowerSpectrumMultipoles, BAOCompressionObservable)
    from desilike_tpu_torch.observables.lya import P1DCompressionObservable
    from desilike_tpu_torch.observables.weak_lensing import DESY3Observable
    from desilike_tpu_torch.likelihoods.hubble import Riess2020H0Likelihood
    from desilike_tpu_torch.likelihoods.bbn import Schoneberg2024BBNLikelihood
    from desilike_tpu_torch.likelihoods.galaxy_clustering import SNWeightedPowerSpectrumLikelihood  # noqa: F401
    from desilike_tpu_torch import theories, observables, likelihoods
    assert base_calculator is Calculator and prior is Prior
    assert DirectPowerSpectrumTemplate is theories.DirectPowerSpectrumTemplate
    assert ShapeFitPowerSpectrumTemplate is theories.ShapeFitPowerSpectrumTemplate and Cosmology is theories.Cosmology
    assert P1DCompressionObservable is observables.P1DCompressionObservable
    assert DESY3Observable is theories.DESY3Theory
    assert Riess2020H0Likelihood is likelihoods.Riess2020H0Likelihood
    assert Schoneberg2024BBNLikelihood is likelihoods.Schoneberg2024BBNLikelihood
    with pytest.raises(AttributeError, match='shim'):
        from desilike_tpu_torch import base
        base.NoSuchName


def test_installer(tmp_path, monkeypatch):
    """The installer's sectioned lookup (``tests/test_cmb.py:465-480``): the
    environment's base directory, a section under it, a section overridden
    by the configuration file, no directory where none is installed; and a
    likelihood called with neither data nor data_dir (``DESY5SNLikelihood``,
    the DES-Y5 layout that ``chip_smoke.write_probe_files`` writes) finds
    its section, with the log-posterior of ``data_dir=`` bit for bit.
    ``download`` raises."""
    from desilike_tpu_torch import Installer, DESY5SNLikelihood, Cosmology
    from desilike_tpu_torch.install import installed_data_dir, DATA_DIR_ENV
    from desilike_tpu.install import DATA_DIR_ENV as JAX_DATA_DIR_ENV, CONFIG_FN as JAX_CONFIG_FN
    from desilike_tpu_torch.install import CONFIG_FN
    from chip_smoke import write_probe_files
    assert (DATA_DIR_ENV, CONFIG_FN) == (JAX_DATA_DIR_ENV, JAX_CONFIG_FN)
    monkeypatch.setenv(DATA_DIR_ENV, str(tmp_path / 'data'))
    installer = Installer(config_fn=str(tmp_path / 'no_config.yaml'))
    assert installer.data_dir() == str(tmp_path / 'data')
    assert installer.data_dir('X') == str(tmp_path / 'data' / 'X') and installed_data_dir('X') is None
    other = Installer(config_fn=str(tmp_path / 'config' / 'config.yaml'))
    other.config['X'] = {'data_dir': str(tmp_path / 'elsewhere')}
    other.write()
    assert Installer(config_fn=other.config_fn).data_dir('X') == str(tmp_path / 'elsewhere')
    with pytest.raises(RuntimeError, match='downloads nothing'):
        installer.download('https://example.org/file')
    section = tmp_path / 'data' / 'DESY5SNLikelihood'
    section.mkdir(parents=True)
    write_probe_files(str(section), small=True)
    assert installed_data_dir('DESY5SNLikelihood') == str(section)
    logposts = []
    for kwargs in ({}, {'data_dir': str(section)}):
        cosmo = Cosmology()
        cosmo.init.params = {'h': dict(fixed=False)}
        like = DESY5SNLikelihood(cosmo=cosmo, device='cpu', **kwargs)
        logposts.append(like.logpost_fn()({'h': torch.tensor([0.66, 0.7]), 'Mb': torch.tensor([0., 0.02])})[0])
    assert torch.equal(logposts[0], logposts[1]) and bool(torch.isfinite(logposts[0]).all())


def test_desy3_theory():
    """``DES_Y3_PARAM_MAP`` is the JAX package's, and ``DESY3Theory`` raises
    at initialization without cosmosis as the JAX one does."""
    from desilike_tpu.theories.weak_lensing import DES_Y3_PARAM_MAP as JAX_MAP, DESY3Theory as JaxDESY3Theory
    from desilike_tpu_torch.theories import DESY3Theory, DES_Y3_PARAM_MAP
    assert DES_Y3_PARAM_MAP == JAX_MAP and len(DES_Y3_PARAM_MAP) == 53
    raised = []
    for cls in (DESY3Theory, JaxDESY3Theory):
        with pytest.raises(ImportError, match='cosmosis') as info:
            cls().runtime_info.initialize()
        raised.append(str(info.value))
    assert raised[0] == raised[1]


def test_utils_helpers():
    """The 17 ``utils`` helpers the port adds, against the JAX package's on
    seeded inputs (exact, but the float64 linear algebra within 1e-12)."""
    from desilike_tpu import utils as jax_utils
    from desilike_tpu_torch import utils
    rng = np.random.default_rng(42)
    A = rng.normal(size=(6, 6))
    cov = A @ A.T + 6. * np.eye(6)
    X = rng.normal(size=(200, 4)) @ rng.normal(size=(4, 4))
    for name, args, kwargs in (('cov_to_corrcoef', (cov,), {}), ('cov_to_corrcoef', (2.,), {}),
                               ('rebin', (np.arange(24.).reshape(4, 6), (2, 3)), {}),
                               ('rebin', (np.arange(12.), 4), dict(statistic=np.mean)),
                               ('subspace', (X,), dict(npcs=2)), ('subspace', (X,), dict(precision=np.eye(4), chi2min=1.)),
                               ('weights_trapz', (np.sort(rng.uniform(size=9)),), {}), ('weights_trapz', (np.ones(1),), {}),
                               ('weights_leggauss', (5,), {}), ('weights_leggauss', (5,), dict(sym=True)),
                               ('weights_mu', (8,), {}), ('weights_mu', (6,), dict(method='trapz')),
                               ('matrix_lininterp', (np.linspace(0., 1., 7), np.linspace(-0.1, 1.2, 11)), {}),
                               ('inv', (cov,), {}), ('inv', (np.zeros((2, 2)),), dict(check_valid='pinv')),
                               ('blockinv', ([[cov[:2, :2], cov[:2, 2:]], [cov[2:, :2], cov[2:, 2:]]],), {}),
                               ('expand_dict', ({'a*': 1, 'b': 2}, ['a1', 'a2', 'b', 'c']), {})):
        got, expected = getattr(utils, name)(*args, **kwargs), getattr(jax_utils, name)(*args, **kwargs)
        if isinstance(expected, dict):
            assert got == expected, name
        else:
            for g, e in zip(np.atleast_1d(got) if not isinstance(got, tuple) else got,
                            np.atleast_1d(expected) if not isinstance(expected, tuple) else expected):
                np.testing.assert_allclose(g, e, rtol=1e-12, atol=1e-15, err_msg=name)
    values = [{'a': np.arange(3.), 'b': [1, (2, 'c')]}, {'a': np.arange(3.), 'b': [1, (2, 'd')]}, 1., 'x']
    for one in values:
        for two in values:
            assert utils.deep_eq(one, two) == jax_utils.deep_eq(one, two)
    assert utils.is_path('a/b') and not utils.is_path(3) and utils.import_class('os.path.join') is os.path.join
    assert utils.import_class('Cosmology', registry=[desilike_tpu_torch.Cosmology]) is desilike_tpu_torch.Cosmology
    with pytest.raises(ImportError):
        utils.import_class('Nothing', registry=[])
    with utils.Monitor(('time', 'mem')) as monitor:
        sum(range(1000))
    assert monitor.counter == 1 and monitor.get('time') >= 0. and monitor.get('mem') >= 0.
    with utils.TaskManager(nprocs_per_task=2) as tm:
        assert (tm.nworkers, tm.worker) == (1, 0) and list(tm.iterate(range(5))) == list(range(5))
    shim = utils.forward_module_getattr('desilike_tpu_torch.theories')
    assert shim('Cosmology') is desilike_tpu_torch.Cosmology
    utils.mkdir('')
