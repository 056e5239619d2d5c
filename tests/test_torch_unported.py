"""The cases here once held the options of the port that raised
``NotImplementedError`` naming what was missing or its ROADMAP item; every
item is ported now (no raise names A12, A15, A16 or A17), and each case
holds the behaviour in place of its raise. The modules themselves are held against the JAX package in
``tests/test_torch_full_shape.py``, ``tests/test_torch_xi.py`` and the
likelihood files; these cases live apart so that those files hold fewer
tests than ``tests/test_bindings.py``: pytest-xdist's ``--dist loadfile``
hands out the files with more tests first, and ``tests/test_bindings.py``,
the longest file, sets the tier-1 run's wall time by when it starts. The
cases here take well under a second each, but for the counterterms solved
through xi (a few seconds), which raised before the linearize path was
ported and is now held against the frozen JAX values, and the default
template of the EPT theory (a few seconds to build its FFTLog tables): that
and the template options and eh99's growth rate raised before the per-chain
cosmology was ported, the remaining BAO xi models and the emulator engine
before the other theories were, and the xi observable's options and the
windows' default theories before the observables layer was: the cases that
held the raises now hold the behaviour; so do the external cosmology engine,
its injection and the installer's lookup, which raised before the hosts and
bindings were ported.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import (Pipeline, ShapeFitPowerSpectrumTemplate, BAOPowerSpectrumTemplate, Cosmology,
                                DirectPowerSpectrumTemplate,
                                KaiserTracerPowerSpectrumMultipoles, EPTTracerPowerSpectrumMultipoles,
                                DampedBAOWigglesTracerCorrelationFunctionMultipoles,
                                EFTLikeKaiserTracerCorrelationFunctionMultipoles,
                                TracerCorrelationFunctionMultipolesObservable, BoxFootprint,
                                ObservablesGaussianLikelihood)
from desilike_tpu_torch import theories
from test_golden import K
from test_torch_bao_models import VALUES as BAO_VALUES

SLIM = {0: (48., 152., 4.), 2: (48., 152., 4.)}
REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_marg_reference.npz'))
THEORIES = os.path.join(os.path.dirname(__file__), 'data', 'torch_port_theories_reference.npz')


@pytest.mark.parametrize('kwargs, match', [(dict(with_now='wallish2018'), 'peakaverage'), (dict(only_now=True), 'only_now')])
def test_unported_template_options_raise(kwargs, match):
    """The template options that raised before the per-chain cosmology was
    ported, now working as in the JAX package (``power_template.py:39-82``):
    any ``with_now`` builds the one no-wiggle filter's table ('peakaverage'
    and 'wallish2018' alike), and ``only_now`` replaces ``pk_dd`` by the
    no-wiggle table, in the ShapeFit rescaling and in the lookups."""
    template = ShapeFitPowerSpectrumTemplate(z=0.8, device='cpu', **kwargs)
    pipe = Pipeline(template)
    default = ShapeFitPowerSpectrumTemplate(z=0.8, device='cpu')
    Pipeline(default).evaluate({'dm': 0.05})
    pipe.evaluate({'dm': 0.05})
    np.testing.assert_array_equal(template.pknow_dd_fid, default.pknow_dd_fid)
    np.testing.assert_array_equal(template.pknow_dd.numpy(), default.pknow_dd.numpy())
    k = torch.tensor(K)[None]
    if match == 'only_now':
        assert template.pk_dd is template.pknow_dd
        np.testing.assert_array_equal(template.pk_dd_interp(k).numpy(), default.pknow_dd_interp(k).numpy())
    else:
        assert template.with_now == 'wallish2018'
        np.testing.assert_array_equal(template.pk_dd.numpy(), default.pk_dd.numpy())


@pytest.mark.parametrize('cls', [KaiserTracerPowerSpectrumMultipoles, EPTTracerPowerSpectrumMultipoles])
def test_pt_without_template_raises(cls):
    """The PT theories without ``template=``, which raised before the
    per-chain cosmology was ported: their default template is
    ``DirectPowerSpectrumTemplate`` (``desilike_tpu/theories/full_shape.py:28-29``,
    ``ept.py:174-175``), with its five cosmological parameters varied."""
    theory = cls(ells=(0, 2), k=K, device='cpu')
    pipe = Pipeline(theory)
    assert isinstance(theory.template, DirectPowerSpectrumTemplate) and theory.template.cosmo.engine == 'eh98'
    assert pipe.varied_params.names()[:5] == ['h', 'omega_cdm', 'omega_b', 'logA', 'n_s']
    if cls is KaiserTracerPowerSpectrumMultipoles:
        power = pipe.evaluate({'h': torch.tensor([0.66, 0.7]), 'b1': 2.})
        assert power.shape == (2, 2, K.size) and bool(torch.isfinite(power).all())


def test_eh99_scale_dependent_growth_raises():
    """A template on the eh99 engine, whose scale-dependent f(k) the EPT and
    Kaiser theories read through ``f_of_k``, which raised before the
    per-chain cosmology was ported: it is now the lookup of the template's fk
    table, per chain, equal to the engine's growth_rate_k at the table's
    points (1e-5: the Chebyshev lookup) and below the scalar f where the
    neutrinos free-stream."""
    template = DirectPowerSpectrumTemplate(z=0.8, engine='eh99', device='cpu')
    Pipeline(template).evaluate({'h': torch.tensor([0.66, 0.7])})
    k = torch.tensor(template.k[::40])[None].expand(2, -1)
    fk = template.f_of_k(k)
    assert fk.shape == (2, k.shape[1])
    np.testing.assert_allclose(fk.numpy(), template.fk[:, ::40].numpy(), rtol=1e-5)
    assert bool((fk[:, -1] < template.f * 0.999).all()) and bool((fk[:, 0] / template.f - 1).abs().max() < 1e-3)


@pytest.mark.parametrize('kwargs, match', [(dict(theta=True), 'A13'), (dict(engine='emulator'), 'A11c'),
                                           (dict(engine='external'), 'external'), (None, 'inject')],
                         ids=['theta', 'emulator', 'external', 'inject'])
def test_unported_cosmology_options_raise(kwargs, match):
    """The ``Cosmology`` node's options that raised before they were ported.
    The external engine and state injection: the node initializes on its
    default grids (z 0-4 in 65 steps, k 1e-4-10 in 256 log steps, z_pk 0-3
    in 13) with the EH98 tables of its cosmology, and its growth rate,
    sigma8 and E(z) at z = 0.8 agree with the eh98 node's within 1e-3 (the
    grids' interpolation), E(z) one value a chain and the growth quantities
    one for every chain; ``inject`` of a table of the
    grid's shape changes pk_dd by its ratio, of another shape raises, and on
    another engine raises. The trained emulator engine (A11c), which raised
    before it was ported, now builds from the JAX package's weights
    (``tests/data/torch_port_theories_reference.npz``) and gives, in float64
    for 4 cosmologies in one batch, the JAX package's x64 pk_dd and rs_drag
    within 1e-6 (relative; both networks in float32). h solved from 100
    theta_* (A13), which raised before the recombination-era quantities were
    ported, gives in float32 the JAX package's x64 h at the 16 points of
    ``tests/data/torch_port_probes_reference.npz`` within 5e-6, in one batch
    (the limit of ``tests/test_torch_external.py``)."""
    if match == 'A13':
        probes = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_probes_reference.npz'))
        names = list(probes['theta_names'])
        cosmo = Cosmology(device='cpu', **kwargs)
        cosmo.init.params = {name: dict(fixed=False) for name in names}
        pipe = Pipeline(cosmo)
        assert pipe.varied_params.names()[-1] == 'theta_MC_100' and 'h' not in pipe.varied_params.names()
        pipe.evaluate({name: torch.tensor(probes['theta_points'][:, i], dtype=torch.float32)
                       for i, name in enumerate(names)}, dtype=torch.float32)
        np.testing.assert_allclose(cosmo.h.numpy(), probes['theta_h_x64'], rtol=0., atol=5e-6)
        return
    if match == 'A11c':
        reference = np.load(THEORIES)
        from test_torch_cosmo_emulator import jax_weights
        from desilike_tpu_torch.interop import pk_emulator_weights_from_jax
        cosmo = Cosmology(device='cpu', emulator=pk_emulator_weights_from_jax(jax_weights(reference)), **kwargs)
        points = reference['emu_points']
        cosmo.init.params = {name: dict(fixed=False) for name in ('h', 'omega_cdm', 'logA')}
        pipe = Pipeline(cosmo)
        pipe.evaluate({name: torch.tensor(points[:, i]) for i, name in enumerate(('h', 'omega_cdm', 'logA'))},
                      dtype=torch.float64)
        np.testing.assert_allclose(cosmo.pk_dd(np.linspace(0.02, 0.3, 29), 0.8).numpy(),
                                   reference['emu_template_pk_x64'], rtol=1e-6)
        np.testing.assert_allclose(cosmo.rs_drag().numpy(), reference['emu_template_rs_x64'], rtol=1e-6)
        return
    external, eh98 = Cosmology(engine='external', device='cpu'), Cosmology(device='cpu')
    for node in (external, eh98):
        Pipeline(node).evaluate({'h': torch.tensor([0.6736, 0.6736])})
    if match == 'external':
        assert (external.z_grid.size, external.k_grid.size, external.zpk_grid.size) == (65, 256, 13)
        assert external.pk_tab.shape == (13, 256) and external.efunc_tab.shape == (65,)
        for name in ('growth_rate', 'sigma8', 'efunc', 'comoving_radial_distance'):
            got, expected = getattr(external, name)(0.8), getattr(eh98, name)(0.8)
            # the distances one row a chain, the growth quantities one value for every chain
            assert expected.shape == (2,) and got.shape == ((2,) if name in ('efunc', 'comoving_radial_distance') else ())
            np.testing.assert_allclose(np.broadcast_to(got.numpy(), (2,)), expected.numpy(), rtol=1e-3, err_msg=name)
        return
    k = external.k_grid[100:104]
    before = external.pk_dd(k, 0.).numpy()
    external.inject(pk_tab=2. * external.pk_tab)
    np.testing.assert_allclose(external.pk_dd(k, 0.).numpy(), 2. * before, rtol=1e-6)
    with pytest.raises(ValueError, match='shape'):
        external.inject(pk_tab=np.ones(3))
    with pytest.raises(ValueError, match="engine='external'"):
        eh98.inject(pk_tab=np.ones(3))


@pytest.mark.parametrize('name', ['SimpleBAOWigglesCorrelationFunctionMultipoles',
                                  'ResummedBAOWigglesCorrelationFunctionMultipoles',
                                  'FlexibleBAOWigglesCorrelationFunctionMultipoles',
                                  'SimpleBAOWigglesTracerCorrelationFunctionMultipoles',
                                  'ResummedBAOWigglesTracerCorrelationFunctionMultipoles',
                                  'FlexibleBAOWigglesTracerCorrelationFunctionMultipoles'])
def test_remaining_bao_correlation_functions_raise(name):
    """The simple, resummed and flexible BAO xi models, which raised before
    their P(k) models were ported: each builds and, in float32 (the pk ->
    xi step in float64), gives the JAX package's x64 multipoles (0, 2) on s
    = 40-140 Mpc/h frozen in ``tests/data/torch_port_theories_reference.npz``
    within 2e-5 of their largest value (measured 5.9e-7 to 1.0e-6)."""
    reference = np.load(THEORIES)
    theory = getattr(theories, name)(ells=(0, 2), s=np.linspace(40., 140., 26),
                                     template=BAOPowerSpectrumTemplate(z=0.8), device='cpu')
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames())
    pipe.evaluate({key: value for key, value in dict(BAO_VALUES, **{'al0_0': 1e-3, 'al2_-1': 0.1}).items()
                   if key in allowed})
    got, expected = theory.corr[0].numpy().astype('f8'), reference['vector:' + name]
    assert theory.corr.dtype == torch.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0., atol=2e-5 * np.abs(expected).max())


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


@pytest.mark.parametrize('kwargs', [dict(fiber_collisions=True), dict(systematic_templates={'syst': np.ones(52)}),
                                    dict(data='array'), dict(covariance=1e-6 * np.eye(52))],
                         ids=['fiber_collisions', 'systematic_templates', 'array_data', 'covariance'])
def test_unported_xi_observable_options_raise(request, kwargs):
    """The options of the xi observable that raised before the observables
    layer was ported (top-hat fiber collisions, fs = 0.5, Dfc = 20 Mpc/h,
    folded into the window; a flat systematic template with its amplitude
    varied; a measured data vector, 0.05% off the generated one; a
    covariance attached to the observable), each in a Gaussian likelihood
    (the footprint's covariance unless the observable carries one), against
    the JAX package's x64 log-posterior at two points frozen in
    ``tests/data/torch_port_observables_reference.npz``: within 2e-3 (config
    1's limit), in float32."""
    case = request.node.callspec.id
    from desilike_tpu_torch.observables import TopHatFiberCollisionsCorrelationFunctionMultipoles
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_observables_reference.npz'))
    if case == 'fiber_collisions':
        kwargs = dict(fiber_collisions=TopHatFiberCollisionsCorrelationFunctionMultipoles(fs=0.5, Dfc=20.))
    elif case == 'array_data':
        kwargs = dict(data=reference['xi_option_array_data'])
    theory = DampedBAOWigglesTracerCorrelationFunctionMultipoles(ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8))
    observable = TracerCorrelationFunctionMultipolesObservable(slim=SLIM, theory=theory, device='cpu',
                                                               **dict(dict(data={'b1': 2.}), **kwargs))
    footprints = None if case == 'covariance' else [BoxFootprint(volume=2e9, nbar=5e-4)]
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=footprints, device='cpu')
    like.runtime_info.initialize()
    np.testing.assert_allclose(like.flatdata, reference['xi_option_{}_flatdata'.format(case)], rtol=1e-5,
                               atol=1e-5 * np.abs(like.flatdata).max())
    names = ['b1'] + (['syst'] if case == 'systematic_templates' else [])
    assert set(names) <= set(like.pipeline.varied_params.names())
    points = [[2.0], [2.1]] if case != 'systematic_templates' else [[2.0, 0.], [2.1, 3e-4]]
    values = {name: torch.tensor([point[i] for point in points]) for i, name in enumerate(names)}
    logpost, _ = like.logpost_fn()(values)
    np.testing.assert_allclose(logpost.numpy(), reference['xi_option_{}_logpost_x64'.format(case)], rtol=0., atol=2e-3)


def test_no_a12_raise(tmp_path):
    """No ``NotImplementedError`` of the port names ROADMAP A12 (the
    observables layer is ported), A15 (the samplers, profilers, profile
    containers and plots are), A16 (the chain mesh is) or A17 (the
    user-facing surface, the hosts, bindings and shims are): the plots of an ``ObservableArray`` and of
    the P(k) observable write a figure, and ``load_source`` of a
    ``Profiles`` returns its best fit."""
    import re
    import matplotlib
    matplotlib.use('Agg')
    from matplotlib import pyplot as plt
    from desilike_tpu_torch import interop, ObservableArray, TracerPowerSpectrumMultipolesObservable, Profiles
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'desilike_tpu_torch')
    for directory, _, files in os.walk(root):
        for name in files:
            if name.endswith('.py'):
                with open(os.path.join(directory, name)) as file:
                    source = file.read()
                for raised in re.findall(r'NotImplementedError\((.*?)\)\n', source, flags=re.S):
                    assert 'A12' not in raised and 'A15' not in raised and 'A16' not in raised, (name, raised)
                    assert 'A17' not in raised, (name, raised)
    for obj, fn in ((ObservableArray(x=[K], value=[np.ones_like(K)]), tmp_path / 'array.png'),
                    (TracerPowerSpectrumMultipolesObservable(data=np.zeros(K.size), k=K, ells=(0,)), tmp_path / 'pk.png')):
        obj.plot(fn=fn)
        assert fn.stat().st_size > 0
    plt.close('all')
    profiles = Profiles(['a', 'b'])
    profiles.bestfit['a'], profiles.bestfit['b'] = np.array([1., 2.]), np.array([3., 4.])
    profiles.bestfit['logposterior'] = np.array([-2., -1.])
    assert interop.load_source(profiles) == {'a': 2., 'b': 4.}


def test_default_window_theories():
    """The windows' default theories, which raised before the observables
    layer was ported, as the JAX package's (``observables/window.py:230-232``,
    :424-426): the Kaiser tracer multipoles in P(k), on the window's input
    grid; the damped BAO wiggles in xi."""
    from desilike_tpu_torch import WindowedPowerSpectrumMultipoles, WindowedCorrelationFunctionMultipoles
    window = WindowedPowerSpectrumMultipoles(klim={0: (0.02, 0.2, 0.01)}, device='cpu')
    window.runtime_info.initialize()
    assert isinstance(window.theory, KaiserTracerPowerSpectrumMultipoles)
    np.testing.assert_array_equal(window.theory.k, window.kin)
    window = WindowedCorrelationFunctionMultipoles(slim=SLIM, device='cpu')
    window.runtime_info.initialize()
    assert isinstance(window.theory, DampedBAOWigglesTracerCorrelationFunctionMultipoles)
    np.testing.assert_array_equal(window.theory.s, window.sin)


def test_installer_path_raises(tmp_path, monkeypatch):
    """Without data=, data_dir= or arrays, the supernova and CMB likelihoods
    look their data up through the installer (``desilike_tpu_torch/install.py``,
    as the JAX package's ``desilike_tpu/install.py``), which raised before it
    was ported: with nothing installed under ``DESILIKE_TPU_DATA_DIR`` each
    class raises as the JAX package's does (a ValueError asking for data;
    the supernova classes fall through to their arrays, None), never naming
    a ROADMAP item; with the DES-Y5 layout installed in its section,
    ``DESY5SNLikelihood`` builds from it."""
    from desilike_tpu_torch.likelihoods import supernovae, cmb
    from desilike_tpu_torch.install import DATA_DIR_ENV
    from chip_smoke import write_probe_files
    monkeypatch.setenv(DATA_DIR_ENV, str(tmp_path))
    classes = [getattr(supernovae, name) for name in ('PantheonSNLikelihood', 'PantheonPlusSNLikelihood',
                                                      'PantheonPlusSHOESSNLikelihood', 'Union3SNLikelihood',
                                                      'DESY5SNLikelihood')]
    classes += [getattr(cmb, name) for name in ('TTTEEEHighlPlanck2018LiteLikelihood', 'TTLowlPlanck2018Likelihood',
                                                'EELowlPlanck2018Likelihood', 'EELowlPlanck2020LollipopLikelihood',
                                                'ACTDR6LensingLikelihood', 'Planck2018LensingLikelihood',
                                                'TTTEEEHighlPlanckNPIPECamspecLikelihood',
                                                'TTTEEEHighlPlanck2020HillipopLikelihood')]
    for cls in classes:
        expected = TypeError if issubclass(cls, supernovae.BaseSNLikelihood) else ValueError
        with pytest.raises(expected) as info:
            cls(theory=cmb.ClTheory(tables=cmb.synthetic_cl_tables(lmax=100)), device='cpu').runtime_info.initialize()
        assert 'A17' not in str(info.value), cls
    with pytest.raises(ValueError, match='installed Planck 2018 grid'):
        cmb.FullGridPlanck2018GaussianLikelihood(device='cpu').runtime_info.initialize()
    write_probe_files(str(tmp_path / 'DESY5SNLikelihood'), small=True)
    like = supernovae.DESY5SNLikelihood(device='cpu')
    like.runtime_info.initialize()
    assert like.flatdata.shape == (64,)
