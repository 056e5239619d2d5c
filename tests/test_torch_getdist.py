"""The getdist files, the pipeline profiler, logging and the top-level names
of the port against the JAX package's.

Files each package writes are read by the other, within 1e-12 (the text
files round to 18 digits): a ``Chain``'s ``.txt`` / ``.paramnames``
(``desilike_tpu/samples/chain.py:247-314``, numbered files included), a
``ParameterCovariance``'s ``.covmat`` and a ``LikelihoodFisher`` read from
one (``parameters/covariance.py:111-150``, ``fisher.py:159-168``). Without
getdist, ``Chain.to_getdist`` gives the JAX package's dict, and the exports
that need getdist raise ImportError as there. ``Pipeline.profile_speed``
as ``tests/test_inference.py:128-130`` holds the JAX package's;
``setup_logging``; and the public names of the JAX package's top level and
subpackages, each held to the port's whatever other tests imported before.
"""

import importlib
import logging
import io as _io
import pkgutil
import types

import numpy as np
import pytest

import desilike_tpu
import desilike_tpu_torch
from desilike_tpu.samples.chain import Chain as JaxChain
from desilike_tpu.parameters.covariance import ParameterCovariance as JaxCovariance
from desilike_tpu.fisher import LikelihoodFisher as JaxLikelihoodFisher
from desilike_tpu_torch import Chain, ParameterCovariance, LikelihoodFisher, Profiles


def close(got, expected):
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-15)


def make_chains(rng):
    draws = rng.normal(size=(40, 3, 2))
    chains = []
    for cls in (Chain, JaxChain):
        chain = cls()
        chain['a'], chain['b'] = draws[..., 0], draws[..., 1]
        chain['logposterior'] = -0.5 * (draws ** 2).sum(-1)
        chain['aweight'] = rng.uniform(0.5, 1.5, draws.shape[:2]) if cls is Chain else chains[0]['aweight']
        chains.append(chain)
    return chains


def test_chain_getdist_both_ways(tmp_path):
    """Each package's chain files read by the other; numbered files with
    ``ichains`` and ``concatenate``; the dict of ``to_getdist`` without getdist."""
    ours, theirs = make_chains(np.random.default_rng(1))
    ours.write_getdist(str(tmp_path / 'port'))
    theirs.write_getdist(str(tmp_path / 'jax'))
    assert (tmp_path / 'port.paramnames').read_text() == (tmp_path / 'jax.paramnames').read_text()
    for base in ('port', 'jax'):
        got, expected = Chain.from_getdist(str(tmp_path / base)), JaxChain.from_getdist(str(tmp_path / base))
        for name in ('a', 'b', 'aweight', 'logposterior'):
            close(got[name], expected[name])
            close(got[name], np.asarray(ours[name]).reshape(-1))
    for i in (1, 2):
        ours.write_getdist(str(tmp_path / 'run_{:d}'.format(i)))
    both = Chain.read_getdist(str(tmp_path / 'run'), concatenate=True)
    both_jax = JaxChain.read_getdist(str(tmp_path / 'run'), concatenate=True)
    assert both.shape == both_jax.shape == (240,)
    close(both['a'], both_jax['a'])
    listed = Chain.read_getdist(str(tmp_path / 'run'), ichains=[1, 2])
    assert len(listed) == 2 and listed[1].shape == (120,)
    got, expected = ours.to_getdist(), theirs.to_getdist()
    assert isinstance(got, dict) and got.keys() == expected.keys()
    assert got['names'] == expected['names'] and got['labels'] == expected['labels']
    for key in ('samples', 'weights', 'logposterior'):
        close(got[key], expected[key])


def test_covariance_and_fisher_getdist_both_ways(tmp_path):
    """``.covmat`` files both ways, and the Fisher read from one."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, 3))
    cov = A @ A.T + 3. * np.eye(3)
    names = ['a', 'b', 'c']
    ParameterCovariance(cov, names).write_getdist(str(tmp_path / 'port.covmat'))
    JaxCovariance(cov, names).write_getdist(str(tmp_path / 'jax.covmat'))
    for fn in ('port.covmat', 'jax.covmat'):
        path = str(tmp_path / fn)
        ours, theirs = ParameterCovariance.read_getdist(path), JaxCovariance.read_getdist(path)
        assert ours.names() == theirs.names() == names
        close(ours.view(), np.asarray(theirs.view()))
        close(ours.view(), cov)
        fisher, jax_fisher = LikelihoodFisher.read_getdist(path), JaxLikelihoodFisher.read_getdist(path)
        assert fisher.names() == jax_fisher.names()
        close(fisher.hessian, np.asarray(jax_fisher.hessian))
        close(fisher.covariance(), cov)


def test_getdist_exports_need_getdist():
    """Without getdist, the exports that build getdist objects raise
    ImportError in both packages."""
    cov = ParameterCovariance(np.eye(2), ['a', 'b'])
    profiles = Profiles(['a', 'b'])
    profiles.bestfit['a'], profiles.bestfit['b'] = np.array([1.]), np.array([2.])
    profiles.bestfit['logposterior'] = np.array([-1.])
    profiles.covariance = np.eye(2)
    calls = [cov.to_getdist, cov.to_fisher().to_getdist, profiles.to_getdist,
             JaxCovariance(np.eye(2), ['a', 'b']).to_getdist]
    for call in calls:
        with pytest.raises(ImportError):
            call()


def test_profile_speed():
    """The JAX package's ``tests/test_inference.py:128-130`` on the port,
    with a batch of 4 chains."""
    from test_torch_sampler_steps import GaussianModel
    like = GaussianModel(device='cpu')
    out = like.pipeline.profile_speed(niterations=3, batch=4)
    assert 'compiled_evals_per_sec' in out and out['compiled_evals_per_sec'] > 0
    assert 'GaussianModel' in out['eager_per_calculator']
    assert out['batch'] == 4 and out['per_call'] > 0


def test_setup_logging():
    """The root logger's level and format, as the JAX package's sets them."""
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        for setup in (desilike_tpu_torch.setup_logging, desilike_tpu.setup_logging):
            stream = _io.StringIO()
            setup('warning', stream=stream)
            assert root.level == logging.WARNING and len(root.handlers) == 1
            logging.getLogger('Probe').warning('hello')
            logging.getLogger('Probe').info('hidden')
            text = stream.getvalue()
            assert 'Probe' in text and 'WARNING' in text and 'hello' in text and 'hidden' not in text
    finally:
        root.handlers[:], root.level = saved[0], saved[1]


SUBPACKAGES = ('theories', 'observables', 'likelihoods', 'likelihoods.cmb', 'samplers', 'profilers', 'emulators',
               'samples', 'parameters', 'core', 'parallel', 'utils', 'interop', 'io', 'fisher', 'plotting')


def own_api(module):
    """The public names ``module`` defines or re-exports from its own
    package: no submodule (what other tests imported binds them), nothing
    defined in another of the package's modules (``emulators.Pipeline``,
    ``io.BaseClass``: imports, not API) or outside the package (numpy)."""
    package = module.__name__.split('.')[0]
    names = set()
    for name in dir(module):
        obj = getattr(module, name)
        if name.startswith('_') or isinstance(obj, types.ModuleType):
            continue
        origin = getattr(obj, '__module__', None)
        if isinstance(origin, str) and (origin.split('.')[0] != package or not (
                origin == module.__name__ or origin.startswith(module.__name__ + '.'))):
            continue
        names.add(name)
    return names


def submodules(package):
    return {info.name for info in pkgutil.iter_modules(package.__path__)}


def test_top_level_names():
    """The JAX package's top-level names and submodules against the port's,
    with the aliases to the same kinds of objects: none is missing but the
    submodule ``jax`` (the JAX idioms' shims, not ported). Module objects
    are left to :func:`submodules`, so that what other tests imported
    before cannot change the result."""
    jax_names = {name for name in dir(desilike_tpu) if not name.startswith('_')
                 and not isinstance(getattr(desilike_tpu, name), types.ModuleType)}
    ours = {name for name in dir(desilike_tpu_torch) if not name.startswith('_')}
    assert not jax_names - ours, sorted(jax_names - ours)
    assert submodules(desilike_tpu) - submodules(desilike_tpu_torch) == {'jax'}
    assert desilike_tpu_torch.BaseCalculator is desilike_tpu_torch.Calculator
    assert desilike_tpu_torch.ParameterPrior is desilike_tpu_torch.Prior
    assert desilike_tpu_torch.PipelineError is RuntimeError
    assert desilike_tpu_torch.ParameterArray.__name__ == 'DerivArray'
    for name in ('setup_logging', 'Samples', 'Deriv', 'CollectionCalculator', 'vmap', 'BaseConfig', 'from_config'):
        assert callable(getattr(desilike_tpu_torch, name)), name


def test_subpackage_names():
    """Each subpackage's own public names (:func:`own_api`) and submodules
    in the port too."""
    for name in SUBPACKAGES:
        jax_module = importlib.import_module('desilike_tpu.' + name)
        ours = importlib.import_module('desilike_tpu_torch.' + name)
        missing = own_api(jax_module) - set(dir(ours))
        assert not missing, (name, sorted(missing))
        if hasattr(jax_module, '__path__'):
            missing = submodules(jax_module) - submodules(ours)
            assert not missing, (name, sorted(missing))
