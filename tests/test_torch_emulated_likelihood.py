"""Config 5 on the port, on the CPU: config 4 with emulated templates (MLP
for the ShapeFit templates, Taylor order 3 for the BAO ones), the JAX
package's emulators carried across from
``tests/data/torch_port_emulator_reference.npz``
(``scripts/make_torch_port_reference.py emu``): its log-posterior and
gradient against the JAX package's at 16 frozen points, its Fisher against
config 4's, a short NUTS run; and ``Differentiation`` with the default
getter against the JAX package's frozen values. Each test states its
tolerance.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import ShapeFitPowerSpectrumTemplate, Differentiation, Fisher
from desilike_tpu_torch.samplers import NUTSSampler
from chip_smoke import build_emulated_likelihood, build_joint_likelihood, at_points

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_emulator_reference.npz'))
X64_ATOL, X64_GRAD_RTOL = 2e-2, 5e-4  # config 4's limits against JAX x64
F32_ATOL, F32_GRAD_RTOL = 0.15, 1e-2  # config 4's limits against the JAX package's float32 values
TAYLOR_K = np.geomspace(1e-3, 0.5, 120)  # the ShapeFit template of tests/test_emulators.py:12


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def config5():
    return build_emulated_likelihood('cpu', reference=REFERENCE)


def close(label, got, expected, atol, grad, expected_grad, grad_rtol):
    err = np.abs(got - expected).max()
    gerr = (np.linalg.norm(grad - expected_grad, axis=-1) / np.linalg.norm(expected_grad, axis=-1)).max()
    assert err <= atol and gerr <= grad_rtol, (label, err, gerr)


def test_config5_matches_jax(config5):
    """Config 5's 18 varied and 30 solved parameters over 368 data, as the
    JAX package builds it; log-posterior and gradient at the 16 frozen
    points within 2e-2 and 5e-4 of the gradient's norm of the JAX package
    in x64 (the same emulators, the MLP in float32 in both), and within its
    own float32 error (0.15, 1e-2) of its float32 values."""
    pipe = config5.pipeline
    names = pipe.varied_params.names()
    assert names == list(REFERENCE['names']) and config5.size == 368
    assert [p.name for p in pipe.solved_params] == list(REFERENCE['solved_names'])
    lp, g = at_points(config5, names, REFERENCE['points'])
    close('x64', lp, REFERENCE['logpost_x64'], X64_ATOL, g, REFERENCE['grad_x64'], X64_GRAD_RTOL)
    close('float32', lp, REFERENCE['logpost'], F32_ATOL, g, REFERENCE['grad'], F32_GRAD_RTOL)


def test_fisher_against_config4(config5):
    """``Fisher`` of config 5 against config 4's at their fiducial values:
    the standard deviations of qpar, dm, df and b1 of each tracer within a
    factor 0.7-1.4 (the bound of tests/test_config5.py:38-42)."""
    fisher = Fisher(config5)()
    exact = Fisher(build_joint_likelihood('cpu'))()
    for tracer in ('LRG', 'ELG'):
        for name in ('qpar', 'dm', 'df', 'b1'):
            name = '{}.{}'.format(tracer, name)
            ratio = fisher.std(name) / exact.std(name)
            assert 0.7 < ratio < 1.4, (name, ratio)


def test_nuts_short_run(config5):
    """NUTS over 2 chains of config 5 (4 warmup and 3 sampling iterations,
    max_depth 3): every recorded log-posterior finite, and the share of
    sampling transitions that moved a chain in (0, 1]."""
    sampler = NUTSSampler(config5, nchains=2, max_depth=3, seed=3)
    chain = sampler.run(nsteps=3, nwarmup=4)
    assert np.isfinite(chain['logposterior']).all()
    x = np.stack([chain[name] for name in sampler.names], axis=-1)
    assert 0. < np.any(x[1:] != x[:-1], axis=-1).mean() <= 1.


def test_differentiation_default_getter():
    """``Differentiation`` without a getter differentiates the root's state
    snapshot: at order 1 on the ShapeFit template, every entry and its
    derivatives against the JAX package's default (frozen, float32 both;
    within 1e-5 of each derivative's largest magnitude, 1e-12 absolute)."""
    result = Differentiation(ShapeFitPowerSpectrumTemplate(z=0.8, k=TAYLOR_K, device='cpu'), order=1)()
    names = {key[7:] for key in REFERENCE.files if key.startswith('getter:') and key != 'getter:derivs'}
    assert set(result) == names == {'pk_dd', 'pknow_dd', 'f', 'fsigma8', 'qpar', 'qper'}
    for name in names:
        value = result[name]
        assert [repr(sorted(d.items())) for d in value.derivs] == list(REFERENCE['getter:derivs'])
        want = REFERENCE['getter:' + name].reshape(len(value.derivs), -1)
        err = np.abs(value.value.reshape(len(want), -1) - want).max(axis=-1)
        assert (err <= 1e-5 * np.abs(want).max(axis=-1) + 1e-12).all(), (name, err)
