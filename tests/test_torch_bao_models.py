"""The BAO models of the PyTorch port beyond the damped one, on the CPU:
the spline broadbands ('ngp', 'cic', 'tsc', 'pcs') in a tracer and the
resummed model in its reconstruction modes ('recsym', 'reciso'), from a
float32 evaluation against the JAX package's x64 vectors frozen in
``tests/data/torch_port_theories_reference.npz`` (``scripts/
make_torch_port_reference.py theories``), within 2e-5 of their largest
value (the goldens' tolerance; measured 4e-8 to 8e-8 for the broadbands,
1.7e-6 and 2.8e-6 for the modes). A spline parameter whose kernel is zero
on every k is fixed, as in the JAX package. The simple, resummed and
flexible models' goldens are in ``tests/test_torch_theories_golden.py``,
their xi forms in ``tests/test_torch_unported.py``.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import Pipeline, theories

torch.set_num_threads(2)

REFERENCE = os.path.join(os.path.dirname(__file__), 'data', 'torch_port_theories_reference.npz')
BAO_K = np.linspace(0.02, 0.3, 29)
# the values of scripts/make_torch_port_reference.py theory_cases()
VALUES = {'qpar': 1.02, 'qper': 0.98, 'b1': 1.8, 'sigmapar': 9., 'sigmaper': 6., 'sigmas': 2., 'dbeta': 1.1,
          'df': 1.05, 'dm': 0.02, 'sn0': 500., 'ct0_2': 10., 'ct2_2': 5., 'b2': 0.5, 'bs': -0.2, 'ml0_0': 1.,
          'ml2_1': 0.5, 'fnl_loc': 10., 'p': 1., 'sigmav': 4., 'bphi': 1.5, 'bfnl_loc': 20., 'bv': 1.2, 'sigmau': 3.,
          'bs2': -0.3, 'snB': 0.5, 'al0_1': 200., 'al2_2': -100., 'al0_4': 50.}


def evaluate(theory, values, attr):
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames())
    pipe.evaluate({key: value for key, value in values.items() if key in allowed})
    out = getattr(theory, attr)
    assert out.dtype == torch.float32
    return out[0].numpy().astype('f8'), pipe


def assert_close(got, expected, rtol=2e-5):
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0., atol=rtol * np.abs(expected).max())


@pytest.mark.parametrize('kernel', ['ngp', 'cic', 'tsc', 'pcs'])
def test_spline_broadband(kernel):
    reference = np.load(REFERENCE)
    theory = theories.DampedBAOWigglesTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=BAO_K, broadband=kernel, template=theories.BAOPowerSpectrumTemplate(z=0.8), device='cpu')
    got, pipe = evaluate(theory, VALUES, 'power')
    assert_close(got, reference['vector:bao_' + kernel])
    fixed = sorted(p.basename for p in pipe.params if p.basename.startswith('al') and p.fixed)
    assert fixed == sorted(reference['fixed:bao_' + kernel])
    # the spline coefficients stay a static solved basis: one design row each, scaled by the fiducial pknow
    assert theory._static_linear_solved == ('al*',) and theory.broadband_design.shape == (
        len(theory._broadband_names), 2 * BAO_K.size)


@pytest.mark.parametrize('mode', ['recsym', 'reciso'])
def test_resummed_reconstruction_modes(mode):
    reference = np.load(REFERENCE)
    theory = theories.ResummedBAOWigglesTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=BAO_K, mode=mode, template=theories.BAOPowerSpectrumTemplate(z=0.8), device='cpu')
    got, pipe = evaluate(theory, VALUES, 'power')
    assert_close(got, reference['vector:resummed_' + mode])
    # the resummed model's damping comes from the (1 - j0) integrals: no sigmapar/sigmaper, a fixed d
    names = pipe.params.basenames()
    assert 'sigmapar' not in names and 'sigmaper' not in names and pipe.params['d'].fixed


def test_simple_tracer_matches_jax():
    """``SimpleTracerPowerSpectrumMultipoles`` (the damped Kaiser model on a
    Standard template), two chains in the port (the second at 1.01 times
    b1), against the JAX package's float32 multipoles at the same points
    (frozen in ``tests/data/torch_port_tier1_reference.npz``), within 2e-5
    of the largest value (measured 1.1e-7)."""
    frozen = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tier1_reference.npz'))
    values = {'qpar': 1.02, 'qper': 0.98, 'b1': 1.8, 'sn0': 500., 'sigmapar': 4., 'sigmaper': 2., 'df': 1.05}
    theory = theories.SimpleTracerPowerSpectrumMultipoles(ells=(0, 2, 4), k=BAO_K, device='cpu',
                                                          template=theories.StandardPowerSpectrumTemplate(z=0.8))
    pipe = Pipeline(theory)
    assert pipe.params.names() == list(frozen['simple_tracer_params'])
    pipe.evaluate(dict(values, b1=torch.tensor([1.8, 1.818])))
    for b in range(2):
        assert_close(theory.power[b].numpy().astype('f8'), frozen['simple_tracer_power'][b])
