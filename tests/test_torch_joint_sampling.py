"""What the gradient samplers need from config 4 (the joint two-tracer
full-shape + BAO likelihood), in the port on the CPU.

- One chain whose solved-parameter factorization fails (here: a per-chain
  design row made non-finite) reads -inf with a finite gradient, and every
  other chain's value and gradient stays bit-identical to the batch without
  it; ``aux['solved_info']`` says which chain failed and nothing raises.
- The samplers' start-point Hessian of the log-density in their
  unconstrained space (the logit transform of the bounded parameters and
  its log-Jacobian), by one batch of ``ndim`` copies of the point and a
  double backward, against the Hessian of the JAX package's
  ``NUTSSampler._logdens_grad`` in float64 (central differences of its x64
  gradient, error ~1e-8), frozen in
  ``tests/data/torch_port_hessian_reference.npz``
  (``scripts/make_torch_port_reference.py hessian``). Tolerances: the
  diagonal, and the whole Hessian, within 1e-4 of their largest entry
  (measured on the CPU: 5.3e-6, float32 rounding of the second derivatives), the
  log-density and its gradient within the float32 tolerances of config 4
  against x64 (2e-2 and 5e-4 of the gradient's norm; measured 5.1e-4 and
  1.6e-6).
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import build_joint_likelihood, chains, fail_chain, JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL
from desilike_tpu_torch.samplers import NUTSSampler

torch.set_num_threads(2)

HESSIAN = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_hessian_reference.npz'))
HESSIAN_RTOL = 1e-4
FAILED = 3


@pytest.fixture(scope='module')
def like():
    return build_joint_likelihood('cpu')


def logpost_and_grad(fn, names, values):
    values = {name: value.detach().clone().requires_grad_(True) for name, value in values.items()}
    logpost, aux = fn(values)
    logpost.sum().backward()
    return logpost.detach(), torch.stack([values[n].grad for n in names], dim=-1), aux


def test_one_failed_chain_leaves_the_others(like):
    names = like.pipeline.varied_params.names()
    values = chains(names, 8, seed=0, device='cpu')
    fn = like.logpost_fn()
    logpost, grad, aux = logpost_and_grad(fn, names, values)
    assert torch.isfinite(logpost).all() and torch.equal(aux['solved_info'], torch.zeros(8, dtype=torch.int32))

    with fail_chain(like, FAILED):  # its per-chain design rows are not finite
        logpost_f, grad_f, aux_f = logpost_and_grad(fn, names, values)
    others = torch.arange(8) != FAILED
    assert torch.equal(logpost_f[others], logpost[others])
    assert torch.equal(grad_f[others], grad[others])
    assert logpost_f[FAILED] == -np.inf
    assert torch.isfinite(grad_f[FAILED]).all()
    assert aux_f['solved_info'].tolist() == [0, 0, 0, -1, 0, 0, 0, 0]
    for name, value in aux_f['solved'].items():
        assert torch.equal(value[others], aux['solved'][name][others]), name


def test_start_hessian_matches_jax_x64(like):
    sampler = NUTSSampler(like, nchains=1)
    assert sampler.names == list(HESSIAN['names'])
    u = torch.tensor(HESSIAN['u'], dtype=torch.float32)
    np.testing.assert_allclose(sampler._unconstrain(HESSIAN['point']), HESSIAN['u'], rtol=1e-12)
    logdens, grad = sampler._logdens_grad()(u[None])
    assert abs(float(logdens[0]) - float(HESSIAN['logdens'])) <= JOINT_X64_ATOL
    assert np.linalg.norm(grad[0].numpy() - HESSIAN['grad']) <= JOINT_X64_GRAD_RTOL * np.linalg.norm(HESSIAN['grad'])
    mass = sampler.initial_mass(u[None])
    hessian = sampler.start_hessian.numpy()
    expected = HESSIAN['hessian']
    diag = np.diag(expected)
    assert np.abs(np.diag(hessian) - diag).max() <= HESSIAN_RTOL * np.abs(diag).max()
    assert np.abs(hessian - expected).max() <= HESSIAN_RTOL * np.abs(expected).max()
    # the inverse mass: -1 / diag where the curvature is negative, else 1
    own = np.diag(hessian)
    np.testing.assert_array_equal(mass.numpy(), np.clip(np.where(own < -1e-12, -1. / own, 1.), 1e-12, 1e12).astype('f4'))
    assert np.array_equal(own < -1e-12, diag < -1e-12)
