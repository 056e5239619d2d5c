"""The ShapeFit template and the Kaiser / EFT-like Kaiser theories of the
PyTorch port (``desilike_tpu_torch/theories``), on the CPU, against the live
JAX classes at the same parameters and against the golden vectors of
``tests/data/golden_theories.npz``; namespaces against the JAX package's.

Both packages evaluate in float32 here; the port's fiducial tables are
float64 on the host and the JAX package's float32, so the two agree to the
golden tolerance of ``tests/test_golden.py`` (2e-5 of the largest value plus
2e-5 relative), not to rounding.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from desilike_tpu.core import Pipeline as JaxPipeline
from desilike_tpu.theories import (ShapeFitPowerSpectrumTemplate as JaxShapeFit,
                                   KaiserTracerPowerSpectrumMultipoles as JaxKaiser,
                                   EFTLikeKaiserTracerPowerSpectrumMultipoles as JaxEFTKaiser)
from desilike_tpu_torch import (Pipeline, Calculator, ShapeFitPowerSpectrumTemplate, BAOPowerSpectrumTemplate,
                                KaiserTracerPowerSpectrumMultipoles, EFTLikeKaiserTracerPowerSpectrumMultipoles,
                                DampedBAOWigglesTracerPowerSpectrumMultipoles,
                                TracerPowerSpectrumMultipolesObservable)
from desilike_tpu_torch.theories import KaiserPowerSpectrumMultipoles
from test_golden import GOLDEN, K, VALUES

torch.set_num_threads(2)

# three points: ShapeFit (dm, df), AP (qpar, qper), bias, counterterms and stochastic terms all move
POINTS = [
    {'qpar': 1.02, 'qper': 0.98, 'df': 1.05, 'dm': 0.02, 'b1': 1.8, 'sn0': 500., 'ct0_2': 10., 'ct2_2': 5.,
     'sn0_2': 3., 'sn2_2': -2.},
    {'qpar': 0.97, 'qper': 1.03, 'df': 0.9, 'dm': -0.04, 'b1': 2.2, 'sn0': -0.5, 'ct0_2': -20., 'ct2_2': 15.,
     'sn0_2': -1., 'sn2_2': 4.},
    {'qpar': 1., 'qper': 1., 'df': 1., 'dm': 0., 'b1': 1.3, 'sn0': 0., 'ct0_2': 0., 'ct2_2': 0.,
     'sn0_2': 0., 'sn2_2': 0.},
]


def assert_golden_close(got, expected):
    expected = np.asarray(expected, dtype='f8')
    np.testing.assert_allclose(np.asarray(got, dtype='f8'), expected, atol=2e-5 * np.abs(expected).max(), rtol=2e-5)


def batch_values(pipe, points):
    """The points' values that ``pipe`` takes, as (B,) float32 tensors."""
    allowed = set(pipe.params.basenames())
    return {name: torch.tensor([point[name] for point in points], dtype=torch.float32)
            for name in points[0] if name in allowed}


@pytest.fixture(scope='module')
def theories():
    """name -> (port theory pipeline, JAX theory pipeline), the port's on the CPU."""
    built = {}
    for name, port_cls, jax_cls, ells in [('kaiser', KaiserTracerPowerSpectrumMultipoles, JaxKaiser, (0, 2, 4)),
                                          ('eft_kaiser', EFTLikeKaiserTracerPowerSpectrumMultipoles, JaxEFTKaiser,
                                           (0, 2))]:
        port = Pipeline(port_cls(ells=ells, k=K, template=ShapeFitPowerSpectrumTemplate(z=0.8), device='cpu'))
        ref = JaxPipeline(jax_cls(ells=ells, k=K, template=JaxShapeFit(z=0.8)))
        built[name] = (port, ref)
    return built


def test_shapefit_template_matches_jax():
    """Per-chain tables, growth and derived parameters of the template alone,
    on its default grid, at three points in one batch."""
    port, ref = ShapeFitPowerSpectrumTemplate(z=0.8, device='cpu'), JaxShapeFit(z=0.8)
    ppipe, rpipe = Pipeline(port), JaxPipeline(ref)
    assert ppipe.params.names() == rpipe.params.names()
    assert ppipe.varied_params.names() == rpipe.varied_params.names() == ['qpar', 'qper', 'df', 'dm']
    for attr in ('Ap_fid', 'n_fid', 'f_fid', 'kp_shape', 'a_shape'):
        np.testing.assert_allclose(getattr(port, attr), getattr(ref, attr), rtol=1e-5)
    # the slope is a difference of ln pknow over 2% in k: the JAX package's float32 table
    # (1e-7 relative) leaves it 1e-5 of absolute error (measured 1.6e-5)
    np.testing.assert_allclose(port.m_fid, ref.m_fid, rtol=0., atol=5e-5)
    ppipe.evaluate(batch_values(ppipe, POINTS))
    assert port.pk_dd.shape == port.pknow_dd.shape == (3, 400) and port.pk_dd.dtype == torch.float32
    for b, point in enumerate(POINTS):
        rpipe.evaluate({name: point[name] for name in ('qpar', 'qper', 'df', 'dm')})
        for attr in ('pk_dd', 'pknow_dd'):
            np.testing.assert_allclose(getattr(port, attr)[b].numpy(), np.asarray(getattr(ref, attr)), rtol=2e-5)
        for attr in ('f', 'fsigma8', 'f_sqrt_Ap', 'n', 'qpar', 'qper'):
            np.testing.assert_allclose(float(getattr(port, attr)[b]), float(getattr(ref, attr)), rtol=1e-5)
        np.testing.assert_allclose(float(port.m[b]), float(ref.m), rtol=0., atol=5e-5)
    for attr in ('f_sqrt_Ap', 'm', 'n'):
        assert ppipe.derived[attr].shape == (3,)


@pytest.mark.parametrize('name', ['kaiser', 'eft_kaiser'])
def test_theory_matches_jax(theories, name):
    """Tracer multipoles and the PT tables under them, batched in the port,
    one point at a time in the JAX package."""
    port, ref = theories[name]
    assert port.params.names() == ref.params.names()
    assert [type(c).__name__ for c in port.calculators] == [type(c).__name__ for c in ref.calculators]
    port.evaluate(batch_values(port, POINTS))
    nell = 3 if name == 'kaiser' else 2
    assert port.root.power.shape == (3, nell, 29) and port.root.power.dtype == torch.float32
    for b, point in enumerate(POINTS):
        allowed = set(ref.params.basenames())
        ref.evaluate({key: value for key, value in point.items() if key in allowed})
        assert_golden_close(port.root.power[b].numpy(), ref.root.power)
        for table in ('pk_dd', 'pk_dt', 'pk_tt', 'pk11'):
            assert_golden_close(port.root.pt.pktable[table][b].numpy(), ref.root.pt.pktable[table])


@pytest.mark.parametrize('name', ['kaiser', 'eft_kaiser'])
def test_theory_matches_golden(theories, name):
    """The golden vectors of tests/test_golden.py ((3, 29) and (2, 29)), at
    its tolerance, from a float32 evaluation in the port."""
    port = theories[name][0]
    allowed = set(port.params.basenames())
    port.evaluate({key: value for key, value in VALUES.items() if key in allowed})
    got = port.root.power[0].numpy()
    assert got.shape == GOLDEN[name].shape
    assert_golden_close(got, GOLDEN[name])


def test_solved_power_basis_matches_jax(theories):
    """d power / d ct, which the analytic marginalization reads after the
    primal run: against the JAX package's, and against a unit step of the
    counterterm in the port itself (the term is exactly linear)."""
    port, ref = theories['eft_kaiser']
    theory = port.root
    assert theory.solved_basis_names == ref.root.solved_basis_names == ('ct0_2', 'ct2_2')
    assert theory._static_linear_solved == ref.root._static_linear_solved == ('sn*',)
    values = batch_values(port, POINTS)
    port.evaluate(values)
    power = theory.power.clone()
    bases = {name: theory.solved_power_basis(name) for name in theory.solved_basis_names}
    for b, point in enumerate(POINTS):
        allowed = set(ref.params.basenames())
        ref.evaluate({key: value for key, value in point.items() if key in allowed})
        for name, basis in bases.items():
            assert basis.shape == (3, 2, 29)
            assert_golden_close(basis[b].numpy(), ref.root.solved_power_basis(name))
    for name, basis in bases.items():
        port.evaluate(dict(values, **{name: values[name] + 1.}))
        scale = float(power.abs().max())  # the step is a difference of two float32 powers
        np.testing.assert_allclose((theory.power - power).numpy(), basis.numpy(), rtol=0., atol=2e-6 * scale)


def test_shapefit_lookups_take_per_row_coefficients(monkeypatch):
    """With a ShapeFit template the coefficients are fitted once per
    evaluation and table, (B, order), and the lookup's queries go to the
    kernel's wrapper as (B, nk x nmu); a BAO template keeps its constant
    (order,) coefficients."""
    from desilike_tpu_torch.ops import chebyshev
    calls = []
    original = chebyshev.clenshaw
    monkeypatch.setattr(chebyshev, 'clenshaw', lambda x, c, log_values: calls.append((tuple(x.shape), tuple(c.shape)))
                        or original(x, c, log_values))
    k = np.linspace(0.0225, 0.1975, 36)
    template = ShapeFitPowerSpectrumTemplate(z=0.8)
    pipe = Pipeline(KaiserPowerSpectrumMultipoles(ells=(0, 2), k=k, template=template, device='cpu'))
    fits = []
    fit = template._cheb.coeffs
    monkeypatch.setattr(template._cheb, 'coeffs', lambda values: fits.append(tuple(values.shape)) or fit(values))
    pipe.evaluate({'dm': torch.tensor([0.01, -0.02, 0.03, 0., 0.05])})
    assert template._cheb.order == 202 and template.k.size == 500
    assert calls == [((5, 288), (5, 202))] and fits == [(5, 500)]
    template.pk_dd_interp(torch.full((5, 3), 0.1)), template.pknow_dd_interp(torch.full((5, 3), 0.1))
    assert fits == [(5, 500), (5, 500)]  # pk_dd cached by the table's identity, pknow_dd fitted once
    del calls[:]
    bao = Pipeline(DampedBAOWigglesTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=k, template=BAOPowerSpectrumTemplate(z=0.8), device='cpu'))
    bao.evaluate({'qpar': torch.tensor([1., 1.01])})
    assert calls == [((2, 360), (202,)), ((2, 360), (202,)), ((36, 1), (202,))]


def test_namespaces_match_jax():
    """namespace= prefixes the parameters and passes to the sub-calculators
    created implicitly; ``init.params`` patterns match basenames; a full name
    addresses one namespace's parameter (``data={'LRG.b1': 2.}``)."""
    from desilike_tpu.theories import (DampedBAOWigglesTracerPowerSpectrumMultipoles as JaxBAO,
                                       BAOPowerSpectrumTemplate as JaxBAOTemplate)
    from desilike_tpu.observables import TracerPowerSpectrumMultipolesObservable as JaxObservable
    names = []
    for eft_cls, shapefit_cls, bao_cls, template_cls, pipeline_cls in [
            (JaxEFTKaiser, JaxShapeFit, JaxBAO, JaxBAOTemplate, JaxPipeline),
            (EFTLikeKaiserTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate,
             DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate, Pipeline)]:
        fs = eft_cls(ells=(0, 2), k=K, template=shapefit_cls(z=0.8, namespace='LRG'), namespace='LRG')
        fs.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
        bao = bao_cls(ells=(0, 2), k=K, template=template_cls(z=0.8, namespace='LRGbao'), namespace='LRGbao')
        bao.init.params = {'al*': dict(derived='.marg')}
        for theory in (fs, bao):
            pipe = pipeline_cls(theory)
            names.append((pipe.params.names(), pipe.varied_params.names(), pipe.solved_params.names(),
                          [c.runtime_info.namespace for c in pipe.calculators]))
    assert names[2:] == names[:2]
    fs_names = names[2]
    assert fs_names[1] == ['LRG.qpar', 'LRG.qper', 'LRG.df', 'LRG.dm', 'LRG.b1']
    assert fs_names[2] == ['LRG.sn0', 'LRG.ct0_2', 'LRG.sn0_2', 'LRG.ct2_2', 'LRG.sn2_2']
    assert fs_names[3] == ['LRG'] * 4  # apeffect and pt inherit it
    assert 'LRGbao.sigmapar' in names[3][0]  # forwarded to the pt node, under the namespace

    # a full name reaches the namespaced parameter; the data vectors of two values differ
    def data(b1, cls=TracerPowerSpectrumMultipolesObservable, theory=EFTLikeKaiserTracerPowerSpectrumMultipoles,
             template=ShapeFitPowerSpectrumTemplate):
        obs = cls(data={'LRG.b1': b1}, klim={0: (0.02, 0.2, 0.02), 2: (0.02, 0.2, 0.02)},
                  theory=theory(ells=(0, 2), template=template(z=0.8, namespace='LRG'), namespace='LRG'))
        obs.runtime_info.initialize()
        return np.asarray(obs.flatdata)

    low, high = data(1.5), data(2.)
    assert low.shape == (18,) and not np.allclose(low, high)
    assert_golden_close(high, data(2., JaxObservable, JaxEFTKaiser, JaxShapeFit))


def test_namespace_does_not_pass_to_shared_nodes():
    class Shared(Calculator):
        _params = {'h': dict(value=0.7)}
        _propagate_namespace = False

    class Own(Calculator):
        _params = {'a': dict(value=1.)}

    class Root(Calculator):
        _params = {'b': dict(value=2.)}

        def initialize(self, shared=None):
            self.shared, self.own = shared, Own()

    pipe = Pipeline(Root(shared=Shared(), namespace='X', device='cpu'))
    assert sorted(pipe.params.names()) == ['X.a', 'X.b', 'h']
