"""The port's ensemble samplers against the JAX package's, on the CPU.

One step of the stretch move and one of the differential slice move at 16
walkers on the 2-parameter Gaussian of ``tests/test_samplers.py``, fed the
draws that the JAX package's step derives from its key (frozen in
``tests/data/torch_port_samplers_reference.npz``,
``scripts/make_torch_port_reference.py samplers``: the partner indices and
both uniforms of each half; for the slice move the walker pair, the slice
height's and the bracket offset's uniforms and one shrink uniform an
iteration), held to the JAX step's walkers, log-posteriors, acceptances
and calls within 1e-5 relative, both sides in float32. Then the recovery
test of ``tests/test_samplers.py`` for both samplers.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch.samplers import EnsembleSampler, EnsembleSliceSampler
from test_torch_sampler_steps import GaussianModel, MEAN, analytic_cov, close, t

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_samplers_reference.npz'))
COV = analytic_cov()


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The per-step ops here are tiny: one thread each (more only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draws(name, ihalf, count):
    return tuple(torch.as_tensor(REFERENCE['{}_draws{}_{}'.format(name, ihalf, j)]) for j in range(count))


@pytest.mark.parametrize('name,cls,ndraws', [('stretch', EnsembleSampler, 3), ('slice', EnsembleSliceSampler, 5)])
def test_step_same_draws(name, cls, ndraws):
    sampler = cls(GaussianModel(device='cpu'), nwalkers=16, seed=1)
    x0 = t(REFERENCE[name + '_x0'])
    lp0, aux0 = sampler.logpost_batch(x0)
    close(lp0, REFERENCE[name + '_lp0'])
    zero = torch.zeros((), dtype=torch.int64)
    state = (x0, lp0, aux0, zero) + ((zero,) if name == 'slice' else ())
    state, record = sampler.step(state, draws(name, 0, ndraws), draws(name, 1, ndraws))
    close(state[0], REFERENCE[name + '_x'])
    close(state[1], REFERENCE[name + '_lp'])
    close(record['loglikelihood'] + record['logprior'], REFERENCE[name + '_lp'])
    assert int(state[3]) == int(REFERENCE[name + '_naccept'])
    if name == 'slice':
        assert int(state[4]) == int(REFERENCE['slice_ncall'])


@pytest.mark.parametrize('cls,nsteps', [(EnsembleSampler, 800), (EnsembleSliceSampler, 300)], ids=['stretch', 'slice'])
def test_ensemble_recovers_gaussian(cls, nsteps):
    """``test_sampler_recovers_gaussian`` of tests/test_samplers.py: mean
    within 0.4 sigma, std within 25%, R-hat below 1.2."""
    sampler = cls(GaussianModel(device='cpu'), seed=7, nwalkers=64)
    chain = sampler.run(nsteps=nsteps).remove_burnin(0.5)
    for i, name in enumerate(('a', 'b')):
        assert chain.mean(name) == pytest.approx(MEAN[i], abs=0.4 * np.sqrt(COV[i, i]))
        assert chain.std(name) == pytest.approx(np.sqrt(COV[i, i]), rel=0.25)
    assert np.all(chain.gelman_rubin(('a', 'b')) < 1.2)
    assert 0. < sampler.diagnostics['acceptance_rate'] <= 1.
    # resume continues from the last state
    again = sampler.run(nsteps=2, resume=True)
    assert again.shape == (2, 64)
