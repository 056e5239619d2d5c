"""The joint two-tracer full-shape + BAO likelihood (BASELINE config 4) in
the PyTorch port, on the CPU.

- A reduced build against the live JAX package is in
  ``tests/test_torch_joint_reduced.py``, which uses the helpers here.
- The full-width port (``chip_smoke.build_joint_likelihood``) against the
  frozen JAX values of ``tests/data/torch_port_joint_reference.npz``
  (``scripts/make_torch_port_reference.py joint``), with its own host state
  and with the JAX package's (``interop.state_from_numpy``).
  ``tests/test_torch_joint_reference.py`` recomputes points of that file
  with the live JAX package. The same likelihood on the card is tested by
  ``tests/test_torch_gpu.py``.

Tolerances. At the 16 frozen points the JAX package's float32 log-posterior
differs from its own float64 (x64) value by up to 5.5e-2 and its gradient by
2.0e-3 of the gradient's norm: it forms the marginalized chi2 by cancelling
terms of ~1e4. The port in float32 is within 8.1e-3 and 5.6e-5 of the x64
values (the float32 rounding of the theory vector, 1e-6 relative against data
errors of ~2%, over 368 data), and within 9e-11 and 3e-12 in float64.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import config
from desilike_tpu_torch.interop import state_from_numpy, state_keys
from chip_smoke import build_joint_likelihood, JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL, JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_joint_reference.npz'))
NAMES = list(REFERENCE['names'])
SOLVED = list(REFERENCE['solved_names'])



def expected_names():
    """Varied and solved names of config 4 in the pipeline's order: per tracer
    (ELG first: the last observable's calculators come first in the walk) the
    BAO observable, then the full-shape one."""
    varied, solved = [], []
    for tracer in ('ELG', 'LRG'):
        varied += ['{}bao.{}'.format(tracer, b) for b in ('qpar', 'qper', 'b1', 'dbeta')]
        varied += ['{}.{}'.format(tracer, b) for b in ('qpar', 'qper', 'df', 'dm', 'b1')]
        solved += ['{}bao.al{:d}_{:d}'.format(tracer, ell, p) for ell in (0, 2) for p in range(-3, 2)]
        solved += ['{}.{}'.format(tracer, b) for b in ('sn0', 'ct0_2', 'sn0_2', 'ct2_2', 'sn2_2')]
    return varied, solved


def evaluate(like, points, names=NAMES, dtype=torch.float32):
    """Port log-posterior, gradient (B, nvaried) and aux at ``points``."""
    values = {n: torch.tensor(points[:, i], dtype=dtype, requires_grad=True) for i, n in enumerate(names)}
    logpost, aux = like.logpost_fn()(values)
    logpost.sum().backward()
    grad = torch.stack([values[n].grad for n in names], dim=-1)
    return logpost.detach().numpy(), grad.numpy(), aux


def assert_matches(logpost, grad, ref_logpost, ref_grad, atol, grad_rtol):
    np.testing.assert_allclose(logpost, ref_logpost, rtol=0., atol=atol)
    err = np.linalg.norm(grad - ref_grad, axis=-1) / np.linalg.norm(ref_grad, axis=-1)
    assert err.max() < grad_rtol, err


@pytest.fixture(scope='module')
def own_likelihood():
    return build_joint_likelihood('cpu')


@pytest.fixture(scope='module')
def loaded_likelihood():
    return state_from_numpy(build_joint_likelihood('cpu'), REFERENCE)


def test_full_width_layout(own_likelihood):
    pipe = own_likelihood.pipeline
    assert pipe.varied_params.names() == NAMES and pipe.solved_params.names() == SOLVED
    assert len(NAMES) == 18 and len(SOLVED) == 30
    assert [len(obs.flatdata) for obs in own_likelihood.observables] == [72, 112, 72, 112]
    assert own_likelihood.size == 368
    templates = [obs.wmatrix.theory.template for obs in own_likelihood.observables]
    assert [t.k.size for t in templates] == [500, 2000, 500, 2000]
    assert [t._cheb.order for t in templates] == [202] * 4
    assert sorted(state_keys(4)) == sorted(key for key in REFERENCE.files if key not in (
        'names', 'solved_names', 'points', 'logpost', 'grad', 'solved', 'logpost_x64', 'grad_x64', 'solved_x64'))


def test_logpost_with_own_initialization_matches_jax(own_likelihood):
    logpost, grad, aux = evaluate(own_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL)
    # against the JAX package in float64: the port's float32 error alone (measured 8.1e-3 and 5.6e-5)
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL)
    assert list(aux['solved']) == SOLVED


def test_logpost_with_loaded_state_matches_jax(loaded_likelihood):
    """With the JAX package's float32 host state the port stays as close to
    its float32 values (measured 6.2e-2 and 5.8e-4)."""
    logpost, grad, _ = evaluate(loaded_likelihood, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL)


def test_logpost_float64_matches_jax_x64(own_likelihood):
    """Both packages in float64 with their own initialization: the same
    numbers to rounding (measured 9e-11 on the log-posterior, 3e-12 on the
    gradient, 3e-10 of their largest value on the solved parameters)."""
    config.set_dtype('float64')
    try:
        logpost, grad, aux = evaluate(own_likelihood, REFERENCE['points'], dtype=torch.float64)
    finally:
        config.set_dtype('float32')
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], 1e-8, 1e-8)
    solved = torch.stack([aux['solved'][name] for name in SOLVED], dim=-1).detach().numpy()
    scale = np.abs(REFERENCE['solved_x64']).max(axis=0)
    np.testing.assert_allclose(solved / scale, REFERENCE['solved_x64'] / scale, rtol=0., atol=1e-7)


def test_batch_rows_match_single_evaluations(own_likelihood):
    fn = own_likelihood.logpost_fn()
    points = REFERENCE['points'][:3]
    batch, aux = fn({n: torch.tensor(points[:, i], dtype=torch.float32) for i, n in enumerate(NAMES)})
    assert batch.shape == (3,) and aux['solved']['LRG.ct0_2'].shape == (3,)
    single = [float(fn(dict(zip(NAMES, row)))[0][0]) for row in points]
    # another batch size sums its matrix products in another order: the float32 level stated above
    np.testing.assert_allclose(batch.numpy(), single, rtol=0., atol=JOINT_X64_ATOL)


def test_not_positive_definite_raises(own_likelihood):
    """A chain whose Schur complement cannot be factored must not pass
    silently, nor stop the other chains: NaN parameters poison it, it reads
    -inf, ``aux['solved_info']`` flags it for the caller to check after the
    call (nothing is read on the host inside it), and the other chain keeps
    the value it has in a batch without the NaN."""
    fn = own_likelihood.logpost_fn()
    values = {n: torch.tensor(REFERENCE['points'][:2, i], dtype=torch.float32) for i, n in enumerate(NAMES)}
    values['LRG.dm'] = torch.tensor([0., 0.])
    clean, clean_aux = fn(values)
    values['LRG.dm'] = torch.tensor([0., float('nan')])
    logpost, aux = fn(values)
    assert clean_aux['solved_info'].tolist() == [0, 0]
    assert aux['solved_info'][0] == 0 and aux['solved_info'][1] != 0
    assert logpost[1] == -np.inf
    assert torch.equal(logpost[0], clean[0])


def test_unsolvable_parameters_raise():
    """A solved parameter with neither a static design row nor an analytic
    basis (b1 enters quadratically), which raised before the linearize path
    was ported: it takes that path beside the counterterms' analytic rows,
    and its one Newton step from its default moves it toward the value the
    data were made with (b1 = 2), every chain factored."""
    from desilike_tpu_torch import (ShapeFitPowerSpectrumTemplate, EFTLikeKaiserTracerPowerSpectrumMultipoles,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    theory = EFTLikeKaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=ShapeFitPowerSpectrumTemplate(z=0.8))
    theory.init.params = {'b1': dict(derived='.marg'), 'ct*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(data={'b1': 2.}, klim={0: (0.02, 0.2, 0.02), 2: (0.02, 0.2, 0.02)},
                                                         theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device='cpu')
    pipe = like.pipeline
    assert pipe.solved_params.names() == ['b1', 'ct0_2', 'ct2_2']
    aidx, _ = like._analytic_basis_plan(pipe.solved_params, [0, 1, 2], [like])
    assert aidx == [1, 2]
    b1 = pipe.params['b1'].value
    values = {p.name: torch.full((2,), p.value) for p in pipe.varied_params}
    logpost, aux = like.logpost_fn()(values)
    assert bool(torch.isfinite(logpost).all()) and aux['solved_info'].tolist() == [0, 0]
    assert float((aux['solved']['b1'] - 2.).abs().max()) < abs(b1 - 2.)
