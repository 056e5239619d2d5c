"""Config 3d (BASELINE's config 3: the 1-loop EPT full-shape likelihood on
direct cosmology parameters) in the PyTorch port, on the CPU: at full width
(``chip_smoke.build_ept_direct_likelihood``: the calls of
``scripts/bench_ept.py`` on ``DirectPowerSpectrumTemplate(z=0.8)``, its
cosmology evaluated per chain) and reduced to the widths of
``tests/test_ept.py:91-112``, against the frozen JAX values of
``tests/data/torch_port_direct_reference.npz``
(``scripts/make_torch_port_reference.py direct``); the eh99 golden and
growth rate through the Direct template; two Direct templates sharing one
``Cosmology`` node. The same likelihood on the card is checked by
``chip_smoke.py`` phase 3.

Tolerances: config 3's (``chip_smoke.EPT_*``: 2e-2 / 5e-4 of JAX x64, 0.15 /
1e-2 of JAX float32, which carries that package's own float32 error); in
float64 both packages compute the same numbers to rounding (1e-8). Measured
on the CPU in float32: 8.2e-4 / 2.1e-4 of x64 at full width, 5.4e-3 /
4.2e-4 for the reduced build; in float64 7.8e-10 / 4.4e-12.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import (config, Cosmology, DirectPowerSpectrumTemplate, EPTTracerPowerSpectrumMultipoles,
                                KaiserTracerPowerSpectrumMultipoles, TracerPowerSpectrumMultipolesObservable,
                                BoxFootprint, ObservablesGaussianLikelihood, Pipeline)
from desilike_tpu_torch.interop import state_from_numpy
from chip_smoke import build_ept_direct_likelihood, EPT_F32_ATOL, EPT_F32_GRAD_RTOL, EPT_X64_ATOL, EPT_X64_GRAD_RTOL
from test_golden import K, GOLDEN

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_direct_reference.npz'))
NAMES = list(REFERENCE['names'])
SOLVED = list(REFERENCE['solved_names'])


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


def build_small():
    """The reduced config 3d of ``tests/test_ept.py:91-112``: ``small_ept``
    widths (19 k, mu 6, 64 loop points, a 500-point template), h, omega_cdm
    and logA varied, monopole and quadrupole over 0.02-0.2 in 0.01 bins."""
    theory = EPTTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=np.linspace(0.02, 0.2, 19), nr=96, nx=48, nk_loop=64, mu=6, nk_template=500,
        template=DirectPowerSpectrumTemplate(z=0.8, varied=('h', 'omega_cdm', 'logA')))
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(
        data={'b1': 1.7}, klim={0: (0.02, 0.2, 0.01), 2: (0.02, 0.2, 0.01)}, theory=theory)
    return ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=5e9, nbar=1e-3)],
                                         device='cpu')


@pytest.fixture(scope='module')
def own_likelihood():
    return build_ept_direct_likelihood('cpu')


def test_full_width_layout(own_likelihood):
    """The five cosmological parameters and the four biases varied, 6 solved,
    108 data; the template on config 3's 1200 points (order 320), per chain
    from its eh98 ``Cosmology`` node, with the geometric AP effect."""
    pipe = own_likelihood.pipeline
    assert pipe.varied_params.names() == NAMES == ['h', 'omega_cdm', 'omega_b', 'logA', 'n_s', 'b1', 'b2', 'bs',
                                                   'b3nl']
    assert pipe.solved_params.names() == SOLVED == ['sn0', 'ct0_2', 'ct2_2', 'ct4_2', 'sn2_2', 'sn4_2']
    assert own_likelihood.size == 108
    template = own_likelihood.observables[0].wmatrix.theory.template
    assert isinstance(template, DirectPowerSpectrumTemplate) and template.cosmo.engine == 'eh98'
    assert template.k.size == 1200 and template._cheb.order == 320 and template.apeffect.mode == 'geometry'
    assert template.apeffect.cosmo is template.cosmo
    assert sum(isinstance(c, Cosmology) for c in pipe.calculators) == 1


@pytest.mark.parametrize('state', ['own', 'jax'])
def test_full_width_matches_jax(own_likelihood, state):
    """At the 16 frozen points, with the port's own host state and with the
    JAX package's (its window, data, whitening and static rows)."""
    like = own_likelihood if state == 'own' else state_from_numpy(build_ept_direct_likelihood('cpu'), REFERENCE)
    logpost, grad, aux = evaluate(like, REFERENCE['points'])
    assert_matches(logpost, grad, REFERENCE['logpost'], REFERENCE['grad'], EPT_F32_ATOL, EPT_F32_GRAD_RTOL)
    assert_matches(logpost, grad, REFERENCE['logpost_x64'], REFERENCE['grad_x64'], EPT_X64_ATOL, EPT_X64_GRAD_RTOL)
    assert list(aux['solved']) == SOLVED


def test_small_width_matches_jax():
    """The reduced config 3d at its 16 frozen points against JAX x64, in
    float32 at config 3's limits and in float64 to rounding. (The JAX
    package's own float32 values are 0.21 from its x64 ones here, at a
    log-posterior of -567: they are frozen, but hold nothing.)"""
    like = build_small()
    names = list(REFERENCE['small_names'])
    assert like.pipeline.varied_params.names() == names
    assert like.pipeline.solved_params.names() == list(REFERENCE['small_solved_names'])
    points = REFERENCE['small_points']
    logpost, grad, _ = evaluate(like, points, names)
    assert_matches(logpost, grad, REFERENCE['small_logpost_x64'], REFERENCE['small_grad_x64'], EPT_X64_ATOL,
                   EPT_X64_GRAD_RTOL)
    config.set_dtype('float64')
    try:
        logpost, grad, _ = evaluate(like, points, names, dtype=torch.float64)
    finally:
        config.set_dtype('float32')
    assert_matches(logpost, grad, REFERENCE['small_logpost_x64'], REFERENCE['small_grad_x64'], 1e-8, 1e-8)


def test_eh99_golden_and_growth_rate():
    """The ``eh99_pk`` golden vector through a Direct template on the eh99
    engine, at the tolerance of ``tests/test_golden.py:112`` (2e-5); and
    eh99's scale-dependent growth rate read by ``f_of_k`` (the Chebyshev
    lookup of the template's fk table) against the JAX node's
    ``growth_rate_k`` in x64 (1e-5: the lookup's interpolation)."""
    template = DirectPowerSpectrumTemplate(z=0.8, k=K, engine='eh99', device='cpu')
    Pipeline(template).evaluate({})
    got, ref = template.pk_dd[0].numpy(), GOLDEN['eh99_pk']
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=2e-5)
    varied = {'h': 0.7, 'omega_cdm': 0.125, 'omega_b': 0.023, 'logA': 3.1, 'n_s': 0.95, 'm_ncdm': 0.1,
              'Omega_k': 0.02, 'w0_fde': -0.9, 'wa_fde': 0.1}
    template = DirectPowerSpectrumTemplate(z=0.8, k=np.geomspace(5e-4, 2., 600), engine='eh99', varied=tuple(varied),
                                           device='cpu')
    Pipeline(template).evaluate(varied, dtype=torch.float64)
    k = torch.tensor(np.geomspace(1e-3, 1., 64))[None]
    np.testing.assert_allclose(template.f_of_k(k)[0].numpy(), REFERENCE['node_eh99_growth_rate_k'], rtol=1e-5)
    np.testing.assert_allclose(template.fk[0].numpy()[[0, -1]], template.f_of_k(
        torch.tensor(template.k[[0, -1]])[None])[0].numpy(), rtol=1e-5)


def test_shared_cosmology_node():
    """Two tracers' Direct templates on one ``Cosmology`` node: the pipeline
    holds one node, evaluated once a call, and one set of cosmological
    parameters beside each tracer's biases; each tracer's template equals
    one with a node of its own."""
    cosmo = Cosmology(device='cpu')
    theories = [KaiserTracerPowerSpectrumMultipoles(ells=(0, 2), k=K, namespace=name,
                                                    template=DirectPowerSpectrumTemplate(z=z, cosmo=cosmo))
                for name, z in (('LRG', 0.8), ('ELG', 1.1))]
    observables = [TracerPowerSpectrumMultipolesObservable(data={'{}.b1'.format(t.init._namespace): 2.},
                                                           klim={0: (0.02, 0.2, 0.01)}, theory=t) for t in theories]
    like = ObservablesGaussianLikelihood(observables=observables, footprints=[BoxFootprint(volume=2e9, nbar=5e-4)] * 2,
                                         device='cpu')
    pipe = like.pipeline
    assert [c for c in pipe.calculators if isinstance(c, Cosmology)] == [cosmo]
    names = pipe.varied_params.names()
    assert [n for n in names if '.' not in n] == ['h', 'omega_cdm', 'omega_b', 'logA', 'n_s']
    assert sorted(n for n in names if '.' in n) == ['ELG.b1', 'ELG.sn0', 'LRG.b1', 'LRG.sn0']
    calls = []
    calculate = cosmo.calculate
    cosmo.calculate = lambda **params: (calls.append(1), calculate(**params))
    values = {'h': torch.tensor([0.7, 0.66]), 'omega_cdm': torch.tensor([0.125, 0.115]), 'LRG.b1': torch.tensor([2.1, 1.9]),
              'ELG.b1': torch.tensor([1.3, 1.4])}
    like.logpost_fn()(values)
    assert len(calls) == 1
    for theory in theories:
        shared = theory.template
        alone = DirectPowerSpectrumTemplate(z=shared.z, k=shared.k, device='cpu')
        Pipeline(alone).evaluate({'h': values['h'], 'omega_cdm': values['omega_cdm']})
        for name in ('pk_dd', 'pknow_dd', 'f', 'sigma8', 'qpar', 'qper'):
            np.testing.assert_allclose(getattr(shared, name).detach().numpy(), getattr(alone, name).numpy(), rtol=1e-6)
