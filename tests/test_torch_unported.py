"""Options of the port's full-shape theories that are not ported yet raise
``NotImplementedError`` naming what is missing or its ROADMAP item. The
theories themselves are held against the JAX package in
``tests/test_torch_full_shape.py``; these cases live apart so that that
file holds fewer tests than ``tests/test_bindings.py``: pytest-xdist's
``--dist loadfile`` hands out the files with more tests first, and
``tests/test_bindings.py``, the longest file, sets the tier-1 run's wall
time by when it starts.
"""

import types

import pytest

from desilike_tpu_torch import (Pipeline, ShapeFitPowerSpectrumTemplate, KaiserTracerPowerSpectrumMultipoles,
                                EPTTracerPowerSpectrumMultipoles, EPTTracerCorrelationFunctionMultipoles)
from test_golden import K


@pytest.mark.parametrize('kwargs, match', [(dict(with_now='wallish2018'), 'peakaverage'), (dict(only_now=True), 'only_now')])
def test_unported_template_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        ShapeFitPowerSpectrumTemplate(z=0.8, **kwargs).runtime_info.initialize()


@pytest.mark.parametrize('cls', [KaiserTracerPowerSpectrumMultipoles, EPTTracerPowerSpectrumMultipoles])
def test_pt_without_template_raises(cls):
    """The default DirectPowerSpectrumTemplate waits for the cosmology (A11)."""
    with pytest.raises(NotImplementedError, match='A11'):
        Pipeline(cls(ells=(0, 2), k=K, device='cpu'))


def test_ept_correlation_function_raises():
    with pytest.raises(NotImplementedError, match='A10'):
        Pipeline(EPTTracerCorrelationFunctionMultipoles(template=ShapeFitPowerSpectrumTemplate(z=0.8), device='cpu'))


def test_eh99_scale_dependent_growth_raises():
    """A template on the eh99 engine has a scale-dependent f(k), which the
    EPT and Kaiser theories read through ``f_of_k``: it waits for A11."""
    template = ShapeFitPowerSpectrumTemplate(z=0.8, device='cpu')
    template.runtime_info.initialize()
    template.cosmo = types.SimpleNamespace(engine='eh99')
    with pytest.raises(NotImplementedError, match='eh99.*A11'):
        template.f_of_k(K)
