"""Fiber collisions, systematic templates and the window options of the
port against the JAX package, live: both build their kernels and matrices
on the host in float64 numpy from a theory's grid, so the theory here is a
grid alone (no cosmology is evaluated) and each case takes well under a
second. The fiber-collision kernels in P(k) and xi (top-hat and general,
``to_tophat``), the windows' folded matrices, constant offsets (the
kernel's uncorrelated term and the shot noise) and templates: within 1e-10
of their largest value; each per-evaluation contraction in float64 on CPU
tensors against the same product in numpy: 1e-12.
"""

import os
import sys

import numpy as np
import pytest
import torch

from desilike_tpu.core import Calculator as JaxCalculator
from desilike_tpu import observables as jax_observables
from desilike_tpu_torch import Calculator, Pipeline
from desilike_tpu_torch import observables
from test_interop import make_window_state

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), 'scripts'))
from make_torch_port_reference import window_offset  # noqa: E402

KIN = np.geomspace(1e-3, 0.4, 60)
S = np.linspace(20., 150., 27)
SEP, KERNEL = np.linspace(0., 1., 6), np.array([0.5, 0.45, 0.4, 0.3, 0.2, 0.1])
TEMPLATES = {'syst_a': lambda k: 1e2 / k, 'syst_b': lambda k: 0. * k + 50.}


def grid_theory(base, xname):
    """A theory that is its grid: ``xname`` and ells from its init; in the
    port, multipoles b1 * table (the table fixed by the grid)."""

    class GridTheory(base):

        _params = {'b1': dict(value=1.)}

        def initialize(self, ells=(0, 2, 4), **kwargs):
            setattr(self, xname, np.asarray(kwargs[xname], dtype='f8'))
            self.ells = tuple(ells)
            x = getattr(self, xname)
            self.table = np.array([(1. + ell) * 1e4 / (1. + (x / 0.1) ** 1.5) for ell in self.ells])

        def calculate(self, b1=1.):
            setattr(self, 'power' if xname == 'k' else 'corr', b1[..., None, None] * self.const('table'))

    return GridTheory


def both(name, theory_kwargs, xname='k', **kwargs):
    """The calculator ``name`` of each package over a grid theory; kwargs
    whose value is a callable of the package's observables module are
    resolved per package."""
    out = []
    for module, base in ((observables, Calculator), (jax_observables, JaxCalculator)):
        theory = grid_theory(base, xname)(**theory_kwargs)
        resolved = {key: value(module) if callable(value) and getattr(value, 'per_module', False) else value
                    for key, value in kwargs.items()}
        calc = getattr(module, name)(theory=theory, **resolved)
        calc.runtime_info.initialize()
        out.append(calc)
    return out


def per_module(fn):
    fn.per_module = True
    return fn


def assert_close(got, expected, label):
    got, expected = np.asarray(got, dtype='f8'), np.asarray(expected, dtype='f8')
    assert got.shape == expected.shape, label
    np.testing.assert_allclose(got, expected, rtol=0., atol=1e-10 * max(np.abs(expected).max(), 1e-300), err_msg=label)


def evaluate(calc, values):
    pipe = Pipeline(calc)
    return pipe.evaluate({name: torch.tensor(value, dtype=torch.float64) for name, value in values.items()},
                         device='cpu', dtype=torch.float64)


@pytest.mark.parametrize('kind', ['tophat', 'general'])
def test_fiber_collision_kernels_pk(kind):
    """The P(k) kernels on an output grid of 30 (top-hat) or 12 (general) k
    from an input grid of 60, multipoles (0, 2, 4), and the per-evaluation
    contraction of the port."""
    if kind == 'tophat':
        port, ref = both('TopHatFiberCollisionsPowerSpectrumMultipoles', dict(k=KIN), k=np.linspace(0.01, 0.2, 30),
                         fs=0.5, Dfc=0.5)
    else:
        port, ref = both('FiberCollisionsPowerSpectrumMultipoles', dict(k=KIN[::2]), k=np.linspace(0.01, 0.2, 12),
                         sep=SEP, kernel=KERNEL)
    assert_close(port.kernel_correlated, ref.kernel_correlated, 'correlated')
    assert_close(port.kernel_uncorrelated, ref.kernel_uncorrelated, 'uncorrelated')
    got = evaluate(port, {'b1': [1.5, 2.]}).numpy()
    expected = np.einsum('abij,bj->ai', port.kernel_correlated, port.theory.table) * np.array([1.5, 2.])[:, None, None] \
        + port.kernel_uncorrelated
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12 * np.abs(expected).max())


@pytest.mark.parametrize('kind', ['tophat', 'tophat_mu_range_cut', 'general'])
def test_fiber_collision_kernels_xi(kind):
    """The xi kernels (diagonal in s) on 27 separations, 20 Mpc/h under and
    over the collision scale; the general kernel's top-hat equivalent
    (``to_tophat``: its fs, Dfc and kernels); the port's contraction."""
    if kind == 'general':
        port, ref = both('FiberCollisionsCorrelationFunctionMultipoles', dict(s=S), xname='s', sep=30. * SEP,
                         kernel=KERNEL)
        port_top, ref_top = port.to_tophat(), ref.to_tophat()
        assert port_top.fs == pytest.approx(ref_top.fs, rel=1e-12) and port_top.Dfc == pytest.approx(ref_top.Dfc, rel=1e-12)
        assert_close(port_top.kernel_correlated, ref_top.kernel_correlated, 'to_tophat correlated')
    else:
        port, ref = both('TopHatFiberCollisionsCorrelationFunctionMultipoles', dict(s=S), xname='s', fs=0.5, Dfc=30.,
                         mu_range_cut=kind.endswith('cut'))
    assert_close(port.kernel_correlated, ref.kernel_correlated, 'correlated')
    assert_close(port.kernel_uncorrelated, ref.kernel_uncorrelated, 'uncorrelated')
    got = evaluate(port, {'b1': [1.5, 2.]}).numpy()
    expected = np.einsum('abj,bj->aj', port.kernel_correlated, port.theory.table) * np.array([1.5, 2.])[:, None, None] \
        + port.kernel_uncorrelated
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12 * np.abs(expected).max())


def test_systematic_template_calculators():
    """The additive template calculators in P(k) and xi: parameters syst_i
    (the JAX package's), and the power shifted by exactly a_i T_i."""
    templates = [np.outer([1., 0.5, 0.], 1e3 / KIN), np.ones((3, KIN.size))]
    port, ref = both('SystematicTemplatePowerSpectrumMultipoles', dict(k=KIN), templates=templates)
    assert port.runtime_info.params.names() == ref.runtime_info.params.names() == ['syst_0', 'syst_1']
    got = evaluate(port, {'b1': [2.], 'syst_0': [0.3], 'syst_1': [-2.]}).numpy()[0]
    np.testing.assert_allclose(got, 2. * port.theory.table + 0.3 * templates[0] - 2. * templates[1], rtol=1e-12)
    port, ref = both('SystematicTemplateCorrelationFunctionMultipoles', dict(s=S, ells=(0, 2)), xname='s',
                     templates=[np.ones((2, S.size)) / S ** 2])
    assert port.runtime_info.params.names() == ref.runtime_info.params.names() == ['syst_0']
    got = evaluate(port, {'b1': [2.], 'syst_0': [3.]}).numpy()[0]
    np.testing.assert_allclose(got, 2. * port.theory.table + 3. / S ** 2, rtol=1e-12)


WINDOW_CASES = {
    'explicit_kinlim': ('k', dict(k=np.linspace(0.02, 0.2, 10), ells=(0, 2), shotnoise=0.,
                                  wmatrix=(KIN, np.random.default_rng(0).uniform(size=(20, 2 * KIN.size))),
                                  kinlim=(0.005, 0.3))),
    'shotnoise_monopole_second': ('k', dict(k=np.linspace(0.02, 0.2, 19), ells=(2, 0), shotnoise=1e3,
                                            wmatrix={'resolution': 2})),
    'fiber_collisions_templates': ('k', dict(klim={0: (0.02, 0.18, 0.01), 2: (0.02, 0.18, 0.01)}, shotnoise=1e3,
                                             fiber_collisions=per_module(
                                                 lambda m: m.TopHatFiberCollisionsPowerSpectrumMultipoles(fs=0.5, Dfc=0.5)),
                                             systematic_templates=TEMPLATES)),
    'file_wshotnoise_fiber_collisions': ('k', dict(klim={0: (0.02, 0.2), 2: (0.02, 0.2)}, shotnoise=2e3,
                                                   wmatrix=make_window_state(np.geomspace(1e-3, 0.5, 80),
                                                                             np.arange(0.005, 0.3, 0.005) + 0.0025),
                                                   fiber_collisions=per_module(
                                                       lambda m: m.TopHatFiberCollisionsPowerSpectrumMultipoles(
                                                           fs=0.5, Dfc=0.5)))),
    'xi_fiber_collisions_templates': ('s', dict(slim={0: (40., 120., 8.), 2: (40., 120., 8.)},
                                                fiber_collisions=per_module(
                                                    lambda m: m.TopHatFiberCollisionsCorrelationFunctionMultipoles(
                                                        fs=0.5, Dfc=30.)),
                                                systematic_templates=[lambda s: 1. / s ** 2]))}


@pytest.mark.parametrize('case', list(WINDOW_CASES))
def test_window_options(case):
    """The windows' host tables against the JAX package's: an explicit (kin,
    matrix) window cut by kinlim; output grids given as k centres with a
    shot noise, the monopole second; fiber collisions folded into the
    bin-integration matrix with systematic templates; a window file with
    its shot-noise response and fiber collisions (the JAX package's order:
    the folded window, the response, the offset); the xi window with fiber
    collisions and a template. Then the port's evaluation (one GEMM, the
    offset, the templates) in float64 against the same in numpy."""
    xname, kwargs = WINDOW_CASES[case]
    name = 'WindowedCorrelationFunctionMultipoles' if xname == 's' else 'WindowedPowerSpectrumMultipoles'
    port, ref = both(name, {xname: KIN if xname == 'k' else S}, xname=xname, **kwargs)
    assert port.ellsin == ref.ellsin and port.ells == ref.ells
    for a, b in zip(port.k if xname == 'k' else port.s, ref.k if xname == 'k' else ref.s):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert_close(port.wmatrix, ref.wmatrix, 'wmatrix')
    assert_close(port.kin if xname == 'k' else port.sin, ref.kin if xname == 'k' else ref.sin, 'input grid')
    expected_offset = window_offset(ref) if xname == 'k' else (np.zeros(ref.wmatrix.shape[0]) if ref._offset is None
                                                               else ref._offset)
    assert_close(np.zeros_like(expected_offset) if port.offset is None else port.offset, expected_offset, 'offset')
    if ref._templates is None:
        assert port.templates is None
    else:
        assert_close(port.templates, ref._templates, 'templates')
    amplitudes = {name: value for name, value in zip(port._template_param_names, [0.3, -2.])}
    flat = evaluate(port, dict({'b1': [1.5]}, **{n: [v] for n, v in amplitudes.items()})).numpy()[0]
    expected = port.wmatrix @ (1.5 * port.theory.table.ravel()) + expected_offset
    if port.templates is not None:
        expected = expected + np.array(list(amplitudes.values())) @ port.templates
    np.testing.assert_allclose(flat, expected, rtol=0., atol=1e-12 * np.abs(expected).max())

