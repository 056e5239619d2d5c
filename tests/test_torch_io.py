"""The port's YAML configuration (``desilike_tpu_torch/io.py``) and batch
facade (``desilike_tpu_torch/core/collection.py`` ``vmap``).

Config 1 (the likelihood of ``__graft_entry__._build_likelihood``) written
as one YAML file and built by ``from_config`` on the CPU: its
log-posterior and gradient at the 16 points of
``tests/data/torch_port_bao_reference.npz`` against the JAX package's
float64 values frozen there, at config 1's limits (2e-3 on the
log-posterior, 5e-4 on the gradient relative to its norm:
``tests/test_torch_bao_likelihood.py``), and bit for bit against
``chip_smoke.build_likelihood``'s. The dialect against the JAX package's
``BaseConfig`` on the same files; the facade's policies as
``tests/test_misc.py:32``, ``:109-121`` hold the JAX package's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from desilike_tpu_torch import from_config, BaseConfig, vmap
from desilike_tpu_torch.io import calculator_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REFERENCE = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_bao_reference.npz'))


def logpost_and_grad(like, points):
    names = list(REFERENCE['names'])
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, _ = like.logpost_fn()(values)
    logpost.sum().backward()
    return logpost.detach().numpy(), torch.stack([values[n].grad for n in names], dim=-1).numpy()


def test_from_config_yaml(tmp_path):
    """The JAX package's ``tests/test_misc.py:12-23`` on the port."""
    fn = tmp_path / 'theory.yaml'
    fn.write_text("""
class: DampedBAOWigglesTracerPowerSpectrumMultipoles
init:
  ells: [0, 2]
  k: e'np.linspace(0.02, 0.3, 29)'
  device: cpu
params:
  'al*':
    derived: '.marg'
""")
    theory = from_config(str(fn))
    power = theory.pipeline.evaluate({'b1': 2.0})
    assert tuple(power.shape) == (1, 2, 29)
    assert len(theory.pipeline.solved_params) == 10


def test_config1_yaml_matches_jax(tmp_path):
    """Config 1 from YAML (``chip_smoke.CONFIG1_YAML``, the file phase A16
    builds on the card): the frozen JAX x64 values at config 1's limits, and
    ``chip_smoke.build_likelihood``'s numbers bit for bit."""
    import chip_smoke
    fn = tmp_path / 'config1.yaml'
    fn.write_text(chip_smoke.CONFIG1_YAML)
    like = from_config(str(fn), device='cpu')
    assert like.pipeline.varied_params.names() == list(REFERENCE['names'])
    logpost, grad = logpost_and_grad(like, REFERENCE['points'])
    np.testing.assert_allclose(logpost, REFERENCE['logpost_x64'], rtol=0., atol=2e-3)
    err = np.linalg.norm(grad - REFERENCE['grad_x64'], axis=-1) / np.linalg.norm(REFERENCE['grad_x64'], axis=-1)
    assert err.max() < 5e-4, err
    built = logpost_and_grad(chip_smoke.build_likelihood('cpu'), REFERENCE['points'])
    np.testing.assert_array_equal(logpost, built[0])
    np.testing.assert_array_equal(grad, built[1])


def test_base_config_dialect_matches_jax(tmp_path):
    """Expressions, multi-document indexing by class, the missing-class
    errors: the same dicts as the JAX package's ``BaseConfig``."""
    from desilike_tpu.io import BaseConfig as JaxBaseConfig
    fn = tmp_path / 'multi.yaml'
    fn.write_text("""class: A
init: {k: "e'np.arange(0.02, 0.3, 0.05)'", n: 3}
---
class: B
init: {values: ["e'2 * 3'", 4, {x: "e'np.ones(2)'"}], name: b}
""")
    for index in (None, 'A', 'B'):
        ours, theirs = BaseConfig(str(fn), index=index), JaxBaseConfig(str(fn), index=index)
        assert ours.keys() == theirs.keys() and ours['class'] == theirs['class']
        assert repr(ours['init']) == repr(theirs['init'])
    assert BaseConfig(str(fn))['class'] == 'A'
    np.testing.assert_allclose(BaseConfig(str(fn))['init']['k'], np.arange(0.02, 0.3, 0.05))
    assert BaseConfig(str(fn), index='B')['init']['values'][0] == 6
    with pytest.raises(KeyError, match='class C'):
        BaseConfig(str(fn), index='C')
    with pytest.raises(ValueError, match='class'):
        from_config({'init': {}})
    assert BaseConfig({'a': "e'1 + 1'"})['a'] == 2


def test_calculator_registry_covers_jax():
    """Every calculator the JAX package's registry names is in the port's
    (``DESY3Theory``, the cosmosis-gated weak-lensing theory, too)."""
    from desilike_tpu.io import calculator_registry as jax_calculator_registry
    ours, theirs = set(calculator_registry()), set(jax_calculator_registry())
    assert not theirs - ours, sorted(theirs - ours)
    assert {'BoxFootprint', 'ObservablesGaussianLikelihood', 'BAOPowerSpectrumTemplate'} <= ours


def test_vmap_facade():
    """The JAX package's ``tests/test_misc.py:32`` on the port."""
    from test_torch_sampler_steps import GaussianModel
    like = GaussianModel(device='cpu')
    fn = like.logpost_fn()
    batched = vmap(lambda v: fn(v)[0])
    out = batched({'a': np.linspace(0.5, 1.5, 8), 'b': np.full(8, -0.5)})
    assert out.shape == (8,)
    assert bool(torch.isfinite(out).all())


def test_vmap_error_policies():
    """The JAX package's ``tests/test_misc.py:109-121`` on the port:
    'raise' names the failed rows, 'ref' puts the output at ``ref_values``
    in their place and leaves the others, 'nan' leaves them for the caller."""

    def fn(values):
        x = values['x']
        return {'y': torch.where(x > 0, torch.log(x), torch.full_like(x, np.nan))[:, None] * torch.ones(3)}

    batch = {'x': torch.tensor([1., -1., 2.])}
    out = vmap(fn, errors='nan')(batch)
    assert bool(torch.isnan(out['y'][1]).all()) and bool(torch.isfinite(out['y'][0]).all())
    with pytest.raises(FloatingPointError, match=r'\[1\]'):
        vmap(fn, errors='raise')(batch)
    out = vmap(fn, errors='ref', ref_values={'x': 1.})(batch)
    np.testing.assert_allclose(out['y'][1].numpy(), 0.)  # log(1) substituted
    np.testing.assert_allclose(out['y'][2].numpy(), np.log(2.), rtol=1e-6)
    with pytest.raises(ValueError, match='ref_values'):
        vmap(fn, errors='ref')
