"""The port's emulators and state snapshots on the CPU against the JAX
package's.

The state snapshots of the BAO and ShapeFit templates and of the Kaiser
theory, and the Point engine, are compared with the live JAX package; the
JAX-trained MLP weights and Sobol training set of config 5's templates, its
JAX-written Taylor files and the Taylor coefficients of the ShapeFit
template fitted in float64 with the frozen values of
``tests/data/torch_port_emulator_reference.npz``
(``scripts/make_torch_port_reference.py emu``). Each test states its
tolerance.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from desilike_tpu.emulators import Emulator as JaxEmulator, PointEmulatorEngine as JaxPointEmulatorEngine
from desilike_tpu.theories import (BAOPowerSpectrumTemplate as JaxBAOPowerSpectrumTemplate,
                                   ShapeFitPowerSpectrumTemplate as JaxShapeFitPowerSpectrumTemplate,
                                   KaiserTracerPowerSpectrumMultipoles as JaxKaiserTracerPowerSpectrumMultipoles)
from desilike_tpu_torch import (config, BAOPowerSpectrumTemplate, ShapeFitPowerSpectrumTemplate,
                                KaiserTracerPowerSpectrumMultipoles, DampedBAOWigglesTracerPowerSpectrumMultipoles,
                                Emulator, PointEmulatorEngine, TaylorEmulatorEngine, MLPEmulatorEngine)
from chip_smoke import carried_emulator, EMU_FS_K, EMU_BAO_K

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_emulator_reference.npz'))
TAYLOR_K = np.geomspace(1e-3, 0.5, 120)  # the ShapeFit template of tests/test_emulators.py:12
K29 = np.linspace(0.02, 0.3, 29)


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def float64():
    dtype = config.get_dtype()
    config.set_dtype('float64')
    try:
        yield
    finally:
        config.set_dtype(dtype)


def flat(prediction):
    return np.concatenate([np.asarray(v.detach(), dtype='f8').reshape(len(v), -1) for v in prediction.values()],
                          axis=-1)


def test_state_snapshots_match_jax():
    """``__getstate__`` of the BAO template, and of the Kaiser theory, its
    PT node (``power``, ``pktable``) and its ShapeFit template, against the
    JAX package's at one point (float32 both; 2e-6 of each entry's
    magnitude). Entries that vary with the parameters keep the batch axis,
    constant ones (the BAO template's tables) have none."""
    values = {'qpar': 1.01, 'qper': 0.99, 'df': 1.05, 'dm': 0.02, 'b1': 1.8}
    bao, jax_bao = BAOPowerSpectrumTemplate(z=0.8, device='cpu'), JaxBAOPowerSpectrumTemplate(z=0.8)
    theory = KaiserTracerPowerSpectrumMultipoles(ells=(0, 2, 4), k=K29, template=ShapeFitPowerSpectrumTemplate(
        z=0.8, device='cpu'))
    jax_theory = JaxKaiserTracerPowerSpectrumMultipoles(ells=(0, 2, 4), k=K29,
                                                        template=JaxShapeFitPowerSpectrumTemplate(z=0.8))
    pairs = []
    for calc, jax_calc in ((bao, jax_bao), (theory, jax_theory)):
        names = [n for n in values if n in calc.pipeline.params.names()]
        calc.pipeline.evaluate({n: values[n] for n in names})
        jax_calc.pipeline.evaluate({n: values[n] for n in names})
    pairs = [(bao.__getstate__(), jax_bao.__getstate__(), {'pk_dd', 'pknow_dd'}),
             (theory.__getstate__(), jax_theory.__getstate__(), set()),
             (theory.template.__getstate__(), jax_theory.template.__getstate__(), set())]
    pt, jax_pt = theory.pt.__getstate__(), jax_theory.pt.__getstate__()
    assert set(pt) == set(jax_pt) == {'power', 'pktable'}
    pairs += [(pt['pktable'], jax_pt.pop('pktable'), set()), ({'power': pt['power']}, jax_pt, set())]
    for state, jax_state, constant in pairs:
        assert set(state) == set(jax_state), (set(state), set(jax_state))
        for name, expected in jax_state.items():
            expected = np.asarray(expected, dtype='f8')
            got = state[name]
            if name in constant:
                assert np.ndim(got) == expected.ndim, name
                got = np.asarray(got, dtype='f8')
            else:
                assert got.shape == (1,) + expected.shape, (name, got.shape)
                got = got[0].numpy().astype('f8')
            np.testing.assert_allclose(got, expected, rtol=0., atol=2e-6 * np.abs(expected).max(), err_msg=name)


@pytest.fixture(scope='module')
def taylor_shapefit():
    """The Taylor emulator (order 3) of the ShapeFit template on TAYLOR_K,
    fitted in float64 on the CPU."""
    with float64():
        return Emulator(ShapeFitPowerSpectrumTemplate(z=0.8, k=TAYLOR_K, device='cpu'),
                        engine=TaylorEmulatorEngine(order=3)).fit()


def test_taylor_coefficients_match_jax_x64(taylor_shapefit):
    """Nested forward mode through the port (float64, CPU) against the JAX
    package's nested ``jacfwd`` (x64): the same 35 derivative keys, the
    coefficients of each within 1e-8 of that key's largest."""
    emu = taylor_shapefit
    assert emu.names == list(REFERENCE['taylor_x64:names'])
    assert emu.varied_names == list(REFERENCE['taylor_x64:varied_names'])
    assert list(emu.engine.__getstate__()['derivs']) == list(REFERENCE['taylor_x64:derivs'])
    expected = REFERENCE['taylor_x64:coeffs']
    assert emu.engine.coeffs.shape == expected.shape == (35, 2 * len(TAYLOR_K) + 4)
    err = np.abs(emu.engine.coeffs - expected).max(axis=-1)
    assert (err <= 1e-8 * np.abs(expected).max(axis=-1)).all(), err / np.abs(expected).max(axis=-1)


def test_jax_taylor_files_predict():
    """Config 5's BAO Taylor emulators (order 3; LRGbao, ELGbao), written by
    the JAX package and loaded by ``Emulator.load``: the prediction at the
    frozen points within 1e-6 of the JAX package's, relative (float32), and
    the fixed tables as the files hold them."""
    for namespace, z in (('LRGbao', 0.8), ('ELGbao', 1.1)):
        template = BAOPowerSpectrumTemplate(z=z, k=EMU_BAO_K, namespace=namespace, device='cpu')
        emu = carried_emulator(REFERENCE, namespace, template)
        assert emu.engine.name == 'taylor' and emu.varied_names == ['qpar', 'qper']
        assert set(emu.fixed_state) == {'pk_dd', 'pknow_dd', 'f', 'fsigma8'}
        np.testing.assert_array_equal(emu.fixed_state['pk_dd'], REFERENCE[namespace + ':fixed:pk_dd'])
        theta = torch.tensor(REFERENCE[namespace + ':predict_theta'], dtype=torch.float32)
        np.testing.assert_allclose(flat(emu.predict(theta)), REFERENCE[namespace + ':predict'], rtol=1e-6, atol=0.)


def test_point_engine():
    """The Point engine: the state at the center whatever theta, against the
    JAX package's (float32 both, 2e-6 of each entry's magnitude), in a
    (B, *shape) batch."""
    emu = Emulator(ShapeFitPowerSpectrumTemplate(z=0.8, k=TAYLOR_K, device='cpu'), engine=PointEmulatorEngine()).fit()
    jax_emu = JaxEmulator(JaxShapeFitPowerSpectrumTemplate(z=0.8, k=TAYLOR_K), engine=JaxPointEmulatorEngine()).fit()
    assert emu.varied_names == jax_emu.varied_names
    theta = torch.tensor(emu.center + np.random.default_rng(0).normal(scale=0.01, size=(3, len(emu.names))),
                         dtype=torch.float32)
    got = emu.predict(theta)
    assert got['pk_dd'].shape == (3, len(TAYLOR_K)) and got['qpar'].shape == (3,)
    expected = np.asarray(jax_emu.engine._value, dtype='f8')
    for row in flat(got):
        np.testing.assert_allclose(row, expected, rtol=2e-6, atol=0.)


@pytest.mark.parametrize('namespace,z', [('LRG', 0.8), ('ELG', 1.1)])
def test_carried_mlp_predicts(namespace, z):
    """Config 5's MLP emulators trained by the JAX package, carried across
    (their emulator files and ``interop.mlp_state_from_flax``): the
    prediction at the frozen points within 1e-5 of the JAX package's,
    relative (float32 both; tanh GELU, the flax kernel transposed)."""
    template = ShapeFitPowerSpectrumTemplate(z=z, k=EMU_FS_K, namespace=namespace, device='cpu')
    emu = carried_emulator(REFERENCE, namespace, template)
    assert emu.engine.name == 'mlp' and emu.fixed_state == {}
    assert emu.varied_names == ['pk_dd', 'pknow_dd', 'f', 'fsigma8', 'qpar', 'qper']
    assert not any(p.requires_grad for p in emu.engine._model(torch.device('cpu')).parameters())
    theta = torch.tensor(REFERENCE[namespace + ':predict_theta'], dtype=torch.float32)
    np.testing.assert_allclose(flat(emu.predict(theta)), REFERENCE[namespace + ':predict'], rtol=1e-5, atol=0.)


def test_mlp_sobol_samples_match_jax():
    """The MLP's training set on config 5's LRG template: the Sobol draws
    through ``Prior.ppf`` equal the JAX package's bit for bit, and the
    state at them (one batched call, float32) within 1e-6 of the JAX
    package's single-point evaluations, relative, on the frozen rows."""
    template = ShapeFitPowerSpectrumTemplate(z=0.8, k=EMU_FS_K, namespace='LRG', device='cpu')
    engine = MLPEmulatorEngine()
    Emulator(template, engine=engine).set_samples()
    np.testing.assert_array_equal(engine.X, REFERENCE['LRG:X'])
    expected = REFERENCE['LRG:Y']
    np.testing.assert_allclose(engine.Y[:len(expected)], expected, rtol=1e-6, atol=0.)


def test_trained_mlp_check():
    """An MLP trained by the port at tests/test_emulators.py:41's size
    (hidden (32, 32), 128 samples, 800 steps) reaches the JAX package's
    bound there: ``check()`` below 0.05; its weights are frozen."""
    template = ShapeFitPowerSpectrumTemplate(z=0.8, k=np.geomspace(1e-3, 0.5, 80), device='cpu')
    emu = Emulator(template, engine=MLPEmulatorEngine(hidden=(32, 32), nsamples=128, nsteps=800)).fit()
    err = emu.check(ntests=5)
    assert err < 0.05, err
    assert np.isfinite(emu.engine.loss)
    assert not any(p.requires_grad for p in emu.engine._model(torch.device('cpu')).parameters())


def test_emulated_node_drop_in_and_round_trip(tmp_path):
    """tests/test_emulators.py:19-37 and :49-66 on the port: a Taylor-emulated
    BAO template (qiso) in a damped BAO theory within 2e-2 of the exact one,
    finite over a batch of 8; saved and reloaded (here and by the JAX
    package, the same file layout) it predicts the same (exact here, 1e-6
    in the JAX package, float32)."""
    values = {'qiso': 1.01, 'b1': 2.0, 'dbeta': 1.05}
    tpl = BAOPowerSpectrumTemplate(z=0.8, apmode='qiso', device='cpu')
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,), k=K29, template=tpl)
    exact = theory.pipeline.evaluate(values).numpy()
    emu = Emulator(tpl, engine=TaylorEmulatorEngine(order=3)).fit()
    theory2 = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,), k=K29, template=emu.to_calculator())
    approx = theory2.pipeline.evaluate(values).numpy()
    np.testing.assert_allclose(approx, exact, rtol=2e-2)
    batch = {p.name: torch.full((8,), p.value) + 0.01 * torch.arange(8.) for p in theory2.pipeline.varied_params}
    assert torch.isfinite(theory2.pipeline.evaluate(batch)).all()

    emu.save(tmp_path / 'emu.npz')
    # the same configuration: the k grid the theory gave the original template
    loaded = Emulator.load(tmp_path / 'emu.npz', calculator=BAOPowerSpectrumTemplate(z=0.8, apmode='qiso', k=tpl.k,
                                                                                    device='cpu'))
    theta = torch.tensor([[1.01], [0.98]])
    for name, value in emu.predict(theta).items():
        np.testing.assert_array_equal(loaded.predict(theta)[name].numpy(), value.numpy())
    node = loaded.to_calculator()
    theory3 = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,), k=K29, template=node)
    np.testing.assert_array_equal(theory3.pipeline.evaluate(values).numpy(), approx)
    jax_loaded = JaxEmulator.load(str(tmp_path / 'emu.npz'), calculator=JaxBAOPowerSpectrumTemplate(
        z=0.8, apmode='qiso', k=tpl.k))
    for row in theta.numpy():
        for name, value in jax_loaded.predict(row.astype('f8')).items():
            np.testing.assert_allclose(np.asarray(value), emu.predict(torch.tensor(row[None]))[name][0].numpy(),
                                       rtol=1e-6)


def test_gradient_through_emulated_node(taylor_shapefit):
    """The gradient of a Kaiser theory's weighted power through a
    Taylor-emulated ShapeFit template (float64) against central differences
    (step 1e-6, within 1e-6 relative); through the carried-across MLP
    node (float32) it is finite and nonzero in every parameter."""
    weights = torch.tensor(np.random.default_rng(1).normal(size=(3, len(K29))))
    with float64():
        theory = KaiserTracerPowerSpectrumMultipoles(ells=(0, 2, 4), k=K29, template=taylor_shapefit.to_calculator())
        pipe = theory.pipeline
        names = pipe.varied_params.names()
        center = {'qpar': 1.01, 'qper': 0.99, 'df': 1.02, 'dm': 0.003, 'b1': 1.8, 'sn0': 0.1}

        def loss(theta):
            return (pipe.evaluate(dict(zip(names, theta.unbind(-1)))) * weights).sum(dim=(-2, -1))

        theta = torch.tensor([[center[n] for n in names]], dtype=torch.float64, requires_grad=True)
        (grad,) = torch.autograd.grad(loss(theta).sum(), theta)
        step = 1e-6 * torch.eye(len(names), dtype=torch.float64)
        with torch.no_grad():
            numeric = (loss(theta.detach() + step) - loss(theta.detach() - step)) / 2e-6
        np.testing.assert_allclose(grad[0].numpy(), numeric.numpy(), rtol=1e-6, atol=1e-6 * float(numeric.abs().max()))
    node = carried_emulator(REFERENCE, 'LRG', ShapeFitPowerSpectrumTemplate(
        z=0.8, k=EMU_FS_K, namespace='LRG', device='cpu')).to_calculator()
    theory = KaiserTracerPowerSpectrumMultipoles(ells=(0, 2, 4), k=K29, template=node, namespace='LRG')
    pipe = theory.pipeline
    values = {p.name: torch.full((2,), float(p.value), requires_grad=True) for p in pipe.varied_params}
    (pipe.evaluate(values) * weights.float()).sum().backward()
    grads = torch.stack([v.grad for v in values.values()])
    assert torch.isfinite(grads).all() and (grads.abs().sum(dim=-1) > 0).all()
