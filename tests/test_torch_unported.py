"""Options of the port's theories, observables and likelihood that are not
ported yet raise ``NotImplementedError`` naming what is missing or its
ROADMAP item. The modules themselves are held against the JAX package in
``tests/test_torch_full_shape.py``, ``tests/test_torch_xi.py`` and the
likelihood files; these cases live apart so that those files hold fewer
tests than ``tests/test_bindings.py``: pytest-xdist's ``--dist loadfile``
hands out the files with more tests first, and ``tests/test_bindings.py``,
the longest file, sets the tier-1 run's wall time by when it starts. The
cases here take well under a second each, but for the counterterms solved
through xi (a few seconds), which raised before the linearize path was
ported and is now held against the frozen JAX values.
"""

import os
import types

import numpy as np
import pytest
import torch

from desilike_tpu_torch import (Pipeline, ShapeFitPowerSpectrumTemplate, BAOPowerSpectrumTemplate,
                                KaiserTracerPowerSpectrumMultipoles, EPTTracerPowerSpectrumMultipoles,
                                DampedBAOWigglesTracerCorrelationFunctionMultipoles,
                                EFTLikeKaiserTracerCorrelationFunctionMultipoles,
                                TracerCorrelationFunctionMultipolesObservable, BoxFootprint,
                                ObservablesGaussianLikelihood)
from desilike_tpu_torch import theories
from test_golden import K

SLIM = {0: (48., 152., 4.), 2: (48., 152., 4.)}
REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_marg_reference.npz'))


@pytest.mark.parametrize('kwargs, match', [(dict(with_now='wallish2018'), 'peakaverage'), (dict(only_now=True), 'only_now')])
def test_unported_template_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        ShapeFitPowerSpectrumTemplate(z=0.8, **kwargs).runtime_info.initialize()


@pytest.mark.parametrize('cls', [KaiserTracerPowerSpectrumMultipoles, EPTTracerPowerSpectrumMultipoles])
def test_pt_without_template_raises(cls):
    """The default DirectPowerSpectrumTemplate waits for the cosmology (A11)."""
    with pytest.raises(NotImplementedError, match='A11'):
        Pipeline(cls(ells=(0, 2), k=K, device='cpu'))


def test_eh99_scale_dependent_growth_raises():
    """A template on the eh99 engine has a scale-dependent f(k), which the
    EPT and Kaiser theories read through ``f_of_k``: it waits for A11."""
    template = ShapeFitPowerSpectrumTemplate(z=0.8, device='cpu')
    template.runtime_info.initialize()
    template.cosmo = types.SimpleNamespace(engine='eh99')
    with pytest.raises(NotImplementedError, match='eh99.*A11'):
        template.f_of_k(K)


@pytest.mark.parametrize('name', ['SimpleBAOWigglesCorrelationFunctionMultipoles',
                                  'ResummedBAOWigglesCorrelationFunctionMultipoles',
                                  'FlexibleBAOWigglesCorrelationFunctionMultipoles',
                                  'SimpleBAOWigglesTracerCorrelationFunctionMultipoles',
                                  'ResummedBAOWigglesTracerCorrelationFunctionMultipoles',
                                  'FlexibleBAOWigglesTracerCorrelationFunctionMultipoles'])
def test_remaining_bao_correlation_functions_raise(name):
    """The simple, resummed and flexible BAO xi models wait for their P(k)
    models (A11)."""
    with pytest.raises(NotImplementedError, match='A11'):
        Pipeline(getattr(theories, name)(template=BAOPowerSpectrumTemplate(z=0.8), device='cpu'))


def test_solved_counterterms_through_xi_raise():
    """Solving the counterterms ct* through xi, which raised before the
    general marginalization path was ported: a correlation-function theory
    has no analytic basis for its power node's counterterms, so they take the
    linearize path, while the stochastic terms keep their static design
    matrix. Against the frozen JAX x64 values of
    ``tests/data/torch_port_marg_reference.npz`` at 4 points: the
    log-posterior within 2e-3, the gradient within 5e-4 of its norm (config
    1's limits), the solved parameters within 1e-3 of their prior width or of
    their value."""
    theory = EFTLikeKaiserTracerCorrelationFunctionMultipoles(ells=(0, 2), template=ShapeFitPowerSpectrumTemplate(z=0.8))
    observable = TracerCorrelationFunctionMultipolesObservable(data={'b1': 2.}, slim=SLIM, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device='cpu')
    # the parameters live on the xi node's P(k) node: solve them on the pipeline
    like.pipeline.params.update({'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}, basename=True)
    pipe = like.pipeline
    solved = pipe.solved_params
    assert solved.names() == ['sn0', 'ct0_2', 'sn0_2', 'ct2_2', 'sn2_2'] == list(REFERENCE['eft_xi_solved_names'])
    assert [solved[i].name for i in like._static_linear_indices(pipe, solved)] == ['sn0', 'sn0_2', 'sn2_2']
    names, points = list(REFERENCE['eft_xi_names']), REFERENCE['eft_xi_points']
    assert pipe.varied_params.names() == names
    values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
    logpost, aux = like.logpost_fn()(values)
    logpost.sum().backward()
    np.testing.assert_allclose(logpost.detach().numpy(), REFERENCE['eft_xi_logpost_x64'], rtol=0., atol=2e-3)
    grad, ref = torch.stack([values[n].grad for n in names], dim=-1).numpy(), REFERENCE['eft_xi_grad_x64']
    assert np.max(np.linalg.norm(grad - ref, axis=-1) / np.linalg.norm(ref, axis=-1)) < 5e-4
    got = torch.stack([aux['solved'][n] for n in solved.names()], dim=-1).detach().numpy()
    width = np.array([p.prior.scale for p in solved])
    ref = REFERENCE['eft_xi_solved_x64']
    assert np.all(np.abs(got - ref) <= 1e-3 * np.maximum(width, np.abs(ref)))


@pytest.mark.parametrize('kwargs', [dict(fiber_collisions=object()), dict(systematic_templates={'syst': np.ones(52)}),
                                    dict(data=np.zeros(52)), dict(covariance=np.eye(52))],
                         ids=['fiber_collisions', 'systematic_templates', 'array_data', 'covariance'])
def test_unported_xi_observable_options_raise(kwargs):
    """Fiber collisions, systematic templates, measured data vectors and
    covariances attached to the observable wait for A12."""
    theory = DampedBAOWigglesTracerCorrelationFunctionMultipoles(ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8))
    observable = TracerCorrelationFunctionMultipolesObservable(slim=SLIM, theory=theory, device='cpu',
                                                               **dict(dict(data={'b1': 2.}), **kwargs))
    with pytest.raises(NotImplementedError, match='A12'):
        observable.runtime_info.initialize()
