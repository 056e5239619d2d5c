"""The cosmology emulator engine of the PyTorch port
(``desilike_tpu_torch/cosmology/emulator.py``, ``Cosmology(engine=
'emulator')``) on the CPU, on the synthetic truth of
``tests/test_boltzmann_emulator.py`` (EH99 = EH98 x the neutrino
free-streaming ratio, an rs_drag shifted with h): the JAX package's weights,
trained there for 20000 Adam steps, its initial weights and its loss after
20 steps are frozen in ``tests/data/torch_port_theories_reference.npz``
(``scripts/make_torch_port_reference.py theories``).

Tolerances: the carried weights' ln-ratio tables against the JAX package's
(both float32 networks) within 1e-6 absolute (measured ~1e-8), their
held-out error under the JAX test's 5e-4 (and within 1e-3 of the JAX
package's own); the port's ln-ratio targets from the frozen truth tables
within 1e-5 of the JAX package's (its float32 EH98; measured 3.0e-6); 20 Adam steps from the JAX
package's initial weights within 1e-4 (relative) of its loss; the
npz round trip exact in both directions; the Direct template on the
emulator engine in float64 against the JAX package's x64 values within
1e-6 (relative; both networks in float32).
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu.cosmology import emulator as jax_emulator
from desilike_tpu_torch import Pipeline, theories
from desilike_tpu_torch.cosmology import emulator
from desilike_tpu_torch.likelihoods.cmb import cl_emulator
from desilike_tpu_torch.ops.spt import OneLoopIntegrals
from desilike_tpu_torch.ops.spt_fftlog import FFTLogOneLoop
from desilike_tpu_torch.interop import pk_emulator_weights_from_jax

torch.set_num_threads(2)

REFERENCE = os.path.join(os.path.dirname(__file__), 'data', 'torch_port_theories_reference.npz')


def jax_weights(reference):
    """The JAX-trained weights dict, as ``load_weights`` of the JAX package gives it."""
    weights = {key[6:]: reference[key] for key in reference.files if key.startswith('emu_w_') and key[6] not in 'Wb'}
    weights['param_names'] = tuple(reference['emu_names'])
    weights['layers'] = [(reference['emu_w_W%d' % i], reference['emu_w_b%d' % i]) for i in range(3)]
    return weights


def holdout(n, seed=2, fraction=0.1):
    """The training and held-out rows of ``train_mlp`` (its seeded permutation)."""
    perm = np.random.default_rng(seed).permutation(n)
    nho = max(1, int(fraction * n))
    return perm[nho:], perm[:nho]


def test_carried_weights_predict_jax_tables():
    reference = np.load(REFERENCE)
    weights = pk_emulator_weights_from_jax(jax_weights(reference))
    lnr, rs_ratio = emulator.predict_tables(weights, reference['emu_points'])
    np.testing.assert_allclose(lnr, reference['emu_lnr'], rtol=0., atol=1e-6)
    np.testing.assert_allclose(rs_ratio, reference['emu_rs_ratio'], rtol=1e-6)
    X, Y = reference['emu_X'], reference['emu_Y']
    # the port's targets from the frozen truth tables, its own EH98 in float64: within the JAX package's
    # float32 EH98 (measured 3.0e-6)
    np.testing.assert_allclose(emulator.make_targets(weights['param_names'], X, reference['emu_pk_tables'],
                                                     reference['emu_rs'], weights['k_grid'], weights['z_grid']),
                               Y, rtol=0., atol=1e-5)
    _, idx = holdout(len(X))
    err = np.abs(np.exp(emulator.predict_raw(weights, X[idx]) - Y[idx]) - 1.).max()
    np.testing.assert_allclose(err, reference['emu_holdout_err'], rtol=1e-3)
    assert err < 5e-4


def test_training_from_jax_initial_weights():
    """20 Adam steps (cosine decay over 20) from the JAX package's initial
    weights (zero biases) on the same normalized set reach its loss."""
    reference = np.load(REFERENCE)
    X, Y = reference['emu_X'], reference['emu_Y']
    idx_tr, _ = holdout(len(X))
    xm, xs = X[idx_tr].mean(0), X[idx_tr].std(0) + 1e-30
    ym, ys = Y[idx_tr].mean(0), Y[idx_tr].std(0) + 1e-12
    layers = [(reference['emu_init_W%d' % i], np.zeros(reference['emu_init_W%d' % i].shape[1], dtype='f4'))
              for i in range(3)]
    _, loss = emulator.fit_layers(layers, ((X[idx_tr] - xm) / xs).astype('f4'), ((Y[idx_tr] - ym) / ys).astype('f4'),
                                  nsteps=20, learning_rate=1e-3, device='cpu')
    np.testing.assert_allclose(loss, reference['emu_loss_20'], rtol=1e-4)


def test_trainers_default_to_the_card(monkeypatch):
    """The trainers and table makers called without ``device`` ask for the
    card, as a pipeline does: with no card they raise (here, and anywhere
    with ``torch.cuda.is_available`` reporting none), they never train on
    the CPU unasked."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rng = np.random.default_rng(0)
    X, Y = rng.normal(size=(16, 2)), rng.normal(size=(16, 3))
    layers = emulator.init_layers((2, 4, 3))
    k = np.geomspace(0.02, 0.2, 4)
    calls = [lambda: emulator.fit_layers(layers, X.astype('f4'), Y.astype('f4'), nsteps=1),
             lambda: emulator.train_mlp(('a', 'b'), X, Y, nsteps=1),
             lambda: emulator.train_pk_emulator(('a', 'b'), X, Y, np.ones(3), np.ones(1), nsteps=1),
             lambda: emulator.layer_tensors({'layers': layers}),
             lambda: cl_emulator.train_cl_emulator(('a', 'b'), X, {'tt': np.ones((16, 8))}, nsteps=1),
             lambda: OneLoopIntegrals(k, nr=8, nx=4).tables(lambda q: q),
             lambda: FFTLogOneLoop(k, nfft=16, nr=8, nx=4).tables(lambda q: q),
             lambda: FFTLogOneLoop(k, nfft=16, nr=8, nx=4).coefficients(lambda q: q)]
    for call in calls:
        with pytest.raises(RuntimeError, match='cuda'):
            call()
    assert len(emulator.layer_tensors({'layers': layers}, device='cpu')) == 2


def test_save_load_round_trip(tmp_path):
    """The port reads the JAX package's file and the JAX package the port's."""
    reference = np.load(REFERENCE)
    weights = pk_emulator_weights_from_jax(jax_weights(reference))
    jax_emulator.save_weights(tmp_path / 'jax.npz', jax_weights(reference))
    emulator.save_weights(tmp_path / 'torch.npz', weights)
    theta = reference['emu_points']
    expected = emulator.predict_raw(weights, theta)
    for loaded in (emulator.load_weights(tmp_path / 'jax.npz'), jax_emulator.load_weights(tmp_path / 'torch.npz')):
        assert tuple(loaded['param_names']) == weights['param_names']
        np.testing.assert_array_equal(emulator.predict_raw(loaded, theta), expected)


def test_direct_template_on_the_emulator_engine():
    """``DirectPowerSpectrumTemplate(engine='emulator')`` per chain (4
    cosmologies in one batch, float64): pk_dd, its no-wiggle companion, the
    scale-dependent growth rate and rs_drag against the JAX package's x64."""
    reference = np.load(REFERENCE)
    weights = pk_emulator_weights_from_jax(jax_weights(reference))
    template = theories.DirectPowerSpectrumTemplate(z=0.8, k=np.linspace(0.02, 0.3, 29), engine='emulator',
                                                    emulator=weights, device='cpu')
    points = reference['emu_points']
    Pipeline(template).evaluate({name: torch.tensor(points[:, i]) for i, name in enumerate(('h', 'omega_cdm', 'logA'))},
                                dtype=torch.float64)
    for got, key in ((template.pk_dd, 'pk'), (template.pknow_dd, 'pknow'), (template.fk, 'fk'),
                     (template.cosmo.rs_drag(), 'rs')):
        np.testing.assert_allclose(got.numpy(), reference['emu_template_{}_x64'.format(key)], rtol=1e-6)
