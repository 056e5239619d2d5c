"""The golden vectors of ``tests/test_golden.py`` for the theories ported
beside the TNS path (the simple, resummed and flexible BAO models, TNS with
quadrature and FFTLog loops, PNG, the tree-level bispectrum), from a
float32 evaluation in the port on the CPU, at the tolerance of
``tests/test_golden.py`` (2e-5 of the largest value plus 2e-5 relative).
Measured: 1e-6 to 7e-6 of the largest value for the BAO models, 1.5e-7 for
the TNS pair, 1.2e-7 for PNG, 1.3e-6 for the bispectrum. The full-width TNS
goldens (the A/B tables' pk at 460800 points through the plain Clenshaw
recurrence) take about a second each. Beside them, the Kaiser tracer on the
eh99 engine against the JAX package's frozen multipoles.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import Pipeline, theories
from test_golden import GOLDEN, K, VALUES

torch.set_num_threads(2)


def build(name):
    if name in ('simple_bao', 'resummed_bao', 'flexible_bao'):
        cls = {'simple_bao': theories.SimpleBAOWigglesTracerPowerSpectrumMultipoles,
               'resummed_bao': theories.ResummedBAOWigglesTracerPowerSpectrumMultipoles,
               'flexible_bao': theories.FlexibleBAOWigglesTracerPowerSpectrumMultipoles}[name]
        return cls(ells=(0, 2), k=K, template=theories.BAOPowerSpectrumTemplate(z=0.8), device='cpu')
    if name == 'tns':
        return theories.TNSTracerPowerSpectrumMultipoles(ells=(0, 2), k=K, loop_method='quadrature', device='cpu',
                                                         template=theories.ShapeFitPowerSpectrumTemplate(z=0.8))
    if name == 'efttns_fftlog':
        return theories.EFTLikeTNSTracerPowerSpectrumMultipoles(ells=(0, 2), k=K, loop_method='fftlog', device='cpu',
                                                                template=theories.ShapeFitPowerSpectrumTemplate(z=0.8))
    if name == 'png':
        return theories.PNGTracerPowerSpectrumMultipoles(ells=(0, 2), k=K, device='cpu')
    return theories.TreeLevelBispectrumMultipoles(template=theories.ShapeFitPowerSpectrumTemplate(z=0.8), device='cpu')


@pytest.mark.parametrize('name', ['simple_bao', 'resummed_bao', 'flexible_bao', 'tns', 'efttns_fftlog', 'png',
                                  'bispectrum'])
def test_theory_matches_golden(name):
    theory = build(name)
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames()) | set(pipe.params.names())
    pipe.evaluate({key: value for key, value in VALUES.items() if key in allowed})
    output = theory.get()
    got = output[0].numpy().astype('f8')
    assert output.dtype == torch.float32 and got.shape == GOLDEN[name].shape
    np.testing.assert_allclose(got, GOLDEN[name], atol=2e-5 * np.abs(GOLDEN[name]).max(), rtol=2e-5)


def test_kaiser_on_the_eh99_engine():
    """The Kaiser tracer on a Direct template with the eh99 engine, whose
    growth rate at the AP-remapped k is a (B, nk, nmu) lookup of its fk
    table (before this, the theory broadcast it as a per-chain scalar and
    raised), two chains (h 0.66 and 0.7), against the JAX package's float32
    multipoles frozen in ``tests/data/torch_port_tier1_reference.npz``,
    within 2e-5 of the largest value."""
    frozen = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_tier1_reference.npz'))
    theory = theories.KaiserTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=K, template=theories.DirectPowerSpectrumTemplate(z=0.8, engine='eh99'), device='cpu')
    Pipeline(theory).evaluate({'b1': 1.8, 'h': torch.tensor([0.66, 0.7])})
    for b in range(2):
        expected = frozen['kaiser_eh99_power'][b]
        np.testing.assert_allclose(theory.power[b].numpy(), expected, atol=2e-5 * np.abs(expected).max(), rtol=2e-5)
