"""Freeze the JAX package's likelihoods for the PyTorch port.

Builds a configuration at full width with ``desilike_tpu`` on the CPU and
writes its reference file under ``tests/data``:

- ``bao``: config 1, ``__graft_entry__._build_likelihood()`` ->
  ``torch_port_bao_reference.npz``;
- ``joint``: config 4, ``bench.build_likelihood()`` (two tracers, full shape
  + BAO, four observables) -> ``torch_port_joint_reference.npz``;
- ``ept``: config 3, ``scripts/bench_ept.build()`` (the 1-loop EPT
  full-shape likelihood: ShapeFit template, IR-resummed EPT multipoles
  (0, 2, 4), counterterms and stochastic terms marginalized) ->
  ``torch_port_ept_reference.npz``;
- ``xi``: config xi, config 1's likelihood in configuration space
  (:func:`build_xi_likelihood`: damped BAO xi multipoles (0, 2) over 48-152
  Mpc/h in 4 Mpc/h bins, broadband ``al*`` marginalized, the xi-xi Gaussian
  covariance) -> ``torch_port_xi_reference.npz``, with besides (see
  :func:`xi_extras`) the start-point Hessian of its samplers' log-density,
  its xi-xi covariance and the covariance of config 1's P(k) observable
  beside its xi observable on one footprint (pk-pk, pk-xi, xi-xi), and the
  xi theory vectors at the golden parameters, all in float64 (x64), and the
  Kaiser and EFT-like Kaiser xi vectors in float32;
- ``marg``: the general marginalization path and the Fisher forecast ->
  ``torch_port_marg_reference.npz`` (see :func:`marg_reference`): config
  3xi (config 3's EPT theory in configuration space, its counterterms
  solved by the linearize path) at full width and reduced, the Fisher
  matrix of config xi, the sum of a compressed likelihood from that Fisher
  with config 3, and the EFT-like Kaiser xi multipoles with their
  counterterms and stochastic terms solved;
- ``emu``: config 5, config 4 with emulated templates
  (:func:`emulated_reference`) -> ``torch_port_emulator_reference.npz``;
- ``direct``: config 3d, BASELINE's config 3 on direct cosmology parameters
  (:func:`build_ept_direct_likelihood`: config 3's EPT likelihood on
  ``DirectPowerSpectrumTemplate(z=0.8)``) -> ``torch_port_direct_reference.npz``,
  with besides (:func:`direct_reference`) its reduced build at 16 points,
  the cosmology functions at 16 seeded cosmologies, the ``Cosmology`` node's
  engines and alternative inputs, and ``APEffect`` in its 'geometry' and
  'bao' modes, those in float64 (x64);
- ``templates``: the other templates and the extractors at the settings of
  ``tests/test_templates_extra.py`` (:func:`templates_reference`), in
  float64 (x64) -> ``torch_port_templates_reference.npz``;
- ``tns``: config tns, config 3's likelihood with the EFT-like TNS theory
  (:func:`build_tns_likelihood`), at full width and at a small width (the
  TNS grid at nq 40, nmu 8, 48 working points), its log-posterior,
  gradient and solved parameters at 16 points, in float64 (x64) only ->
  ``torch_port_tns_reference.npz`` (``names``, ``points``,
  ``logpost_x64``, ``grad_x64``, ``solved_x64``, ``solved_names``, and the
  same prefixed ``small_``);
- ``theories``: the other theories (:func:`theories_reference`) ->
  ``torch_port_theories_reference.npz``: in float32, the cosmology
  emulator trained on the synthetic truth of
  ``tests/test_boltzmann_emulator.py`` (its weights, training set, targets,
  predictions, held-out error), its initial weights and its loss after 20
  Adam steps; in float64 (x64, a child process), the BAO models with the
  spline broadbands and the reconstruction modes, the six remaining BAO xi
  classes, PNG's modes and velocity multipoles, the 1-loop bispectrum and
  its observable's likelihood at 4 points, the Lyman-alpha extractor at 4
  cosmologies, and the Direct template on the emulator engine;
- ``tier1``: JAX evaluations that port tests ran live, frozen for the
  tier-1 clock (:func:`tier1_reference`), in float32 as the tests ran them
  -> ``torch_port_tier1_reference.npz``: config 4's reduced build of
  ``tests/test_torch_joint_reduced.py`` (its layout, data, covariance, the
  log-posterior, solved parameters and directional derivatives at 4 points,
  the theory vector and whitened residual with every parameter given) and
  the IR-resummed EPT theory with quadrature loops of
  ``tests/test_torch_ept.py`` at two points, and
  ``SimpleTracerPowerSpectrumMultipoles`` and the Kaiser tracer on the
  eh99 engine (a scale-dependent growth rate) at two points each;
- ``observables``: the observables layer, in float64 (x64)
  (:func:`observables_reference`) -> ``torch_port_observables_reference.npz``:
  config 3f (config 3d fed from the files that ``chip_smoke.write_files``
  writes: measured data, 1000 mocks, a window file, fiber collisions and
  systematic templates; :func:`build_files_likelihood`) at full width and
  small, the fiducial multipoles the files are made from, the small build's
  host state, the xi observable's options, the compression observables and
  the BAO compression likelihood, the bispectrum likelihood with mocks and
  the cut-sky footprints;
- ``probes``: the external, supernova and CMB likelihoods, in float64 (x64)
  (:func:`probes_reference`) -> ``torch_port_probes_reference.npz``: config
  3j (config 3d + the CMB distance prior + DES-Y5 supernovae + BBN, from the
  files ``chip_smoke.write_probe_files`` writes) at full width and small,
  ``Cosmology(theta=True)``, the recombination-era quantities, the external
  likelihoods, the supernova dataset classes and the CMB family;
- ``samplers``: the samplers and profilers of ROADMAP A15 (:func:`samplers_reference`)
  -> ``torch_port_samplers_reference.npz``: on the 2-parameter Gaussian of
  ``tests/test_samplers.py``, in float32, each step of the Metropolis
  (every carry of 6 adaptation and 2 frozen steps), stretch, slice and
  nested samplers from a key, with the draws derived from that key, the
  blocked sampler's run of one chain on the host-node likelihood (with and
  without dragging) from a fixed start and numpy seed, the profilers' best
  fits, Hessian, intervals, contour grid and 1D profile from fixed starts,
  20 optax Adam steps and the warmup-cosine schedule; and in x64, config
  1's grid (size 3) and the importance weights of a 64-point chain;
- ``hessian``: config 4's log-density in the gradient samplers' unconstrained
  space (``NUTSSampler._logdens_grad``: the logit transform of the bounded
  parameters and its log-Jacobian), its gradient and its Hessian, in
  float64 (x64), at the unconstrained image of the first reference point ->
  ``torch_port_hessian_reference.npz`` (``names``, ``point``, ``u``,
  ``logdens``, ``grad``, ``hessian``). The Hessian is the central
  difference, with step 1e-4 in u, of the JAX package's x64 gradient, one
  jitted batch of 37 points (~10 min on an 8-core CPU, mostly the gradient's compile):
  ``jax.hessian`` of the same function did not compile within 50 min on the
  CPU. Its error is of order 1e-8 of its largest entry (the asymmetry of
  the differences, measured: 7e-9). The samplers set their initial mass
  from this Hessian's diagonal.

Each file holds:

- the host state that ``desilike_tpu_torch.interop.state_from_numpy`` loads
  (``interop.state_keys``): the template tables ``pk_dd_fid`` and
  ``pknow_dd_fid`` and the window ``wmatrix`` (with several observables once
  per observable, as ``pk_dd_fid.0``, ``pk_dd_fid.1``, ...), and the joint
  ``flatdata``, ``whiten`` and ``static_J`` (the design rows of the solved
  parameters that have a static one, in the solved order);
- 16 parameter points from ``np.random.default_rng(0)``, exact in float32
  (``names``, ``points``, one row per point), and ``solved_names``;
- the JAX log-posterior at each point (``logpost``), its gradient with
  respect to the varied parameters (``grad``, same layout as ``points``) and
  the best-fit solved parameters (``solved``, one column per solved name);
- the same, with the JAX package in float64 (x64 mode, its own float64
  initialization), computed in a child process so that x64 never leaks
  into the float32 run (``logpost_x64``, ``grad_x64``, ``solved_x64``). The
  float32 values differ from these by the package's own float32 error.

The machine with the card has no JAX: ``chip_smoke.py`` reads these files
with numpy alone, and ``tests/test_torch_bao_likelihood.py`` and
``tests/test_torch_joint_likelihood.py`` recompute some points with the live
JAX package so that the files cannot go stale.

Run from the repository root:
``JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py [bao|joint|ept|xi|marg|hessian|emu|direct|templates|tns|theories|tier1|observables|probes|samplers]``
(all fifteen when no name is given).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = {name: os.path.join(ROOT, 'tests', 'data', 'torch_port_{}_reference.npz'.format(name))
           for name in ('bao', 'joint', 'ept', 'xi', 'marg', 'hessian', 'direct', 'templates', 'tns', 'theories',
                        'tier1', 'observables', 'probes', 'samplers')}
OUTPUTS['emu'] = os.path.join(ROOT, 'tests', 'data', 'torch_port_emulator_reference.npz')
NPOINTS = 16
HESSIAN_STEP = 1e-4  # central differences of the x64 gradient in the unconstrained space

# centers and half-widths of the points, by basename: inside the priors and
# away from their edges (so no clip is active); b1 is centered on the value
# the tracer's data were generated with
WIDTHS = {'qpar': 0.04, 'qper': 0.04, 'b1': 0.3, 'dbeta': 0.1, 'df': 0.1, 'dm': 0.05,
          'b2': 0.5, 'bs': 0.5, 'b3nl': 0.5, 'sn0': 1., 'sn2_2': 5.,
          'h': 0.02, 'omega_cdm': 0.006, 'omega_b': 0.0008, 'logA': 0.1, 'n_s': 0.02, 'b3': 0.5, 'sigmav': 1.,
          'bs2': 0.5, 'snB': 1.}
CENTERS = {'qpar': 1., 'qper': 1., 'dbeta': 1., 'df': 1., 'dm': 0., 'b2': 0., 'bs': 0., 'b3nl': 0., 'sn0': 0.,
           'sn2_2': 0., 'h': 0.6736, 'omega_cdm': 0.12, 'omega_b': 0.02237, 'logA': 3.036394, 'n_s': 0.9649,
           'b3': 0., 'sigmav': 4., 'bs2': 0., 'snB': 0.}
TNS_SMALL = dict(nq_tns=40, nmu_tns=8, nk_loop=48)  # config tns at a small width: the CPU tests'
B1 = {'': 2., 'LRG': 2., 'LRGbao': 2., 'ELG': 1.3, 'ELGbao': 1.3}


def reference_points(names, npoints=NPOINTS, seed=0):
    """Points around the fiducial, one column per varied name."""
    rng = np.random.default_rng(seed)
    columns = []
    for name in names:
        namespace, _, basename = name.rpartition('.')
        center = B1[namespace] if basename == 'b1' else CENTERS[basename]
        columns.append(center + WIDTHS[basename] * rng.uniform(-1., 1., npoints))
    return np.column_stack(columns)


# the parameter values of tests/test_golden.py that the xi theories take, and its s grid
GOLDEN_VALUES = {'qpar': 1.02, 'qper': 0.98, 'b1': 1.8, 'sigmapar': 9., 'sigmaper': 6., 'sigmas': 2., 'dbeta': 1.1,
                 'df': 1.05, 'dm': 0.02, 'sn0': 500., 'ct0_2': 10., 'ct2_2': 5., 'b2': 0.5, 'bs': -0.2}
GOLDEN_S = np.linspace(40., 140., 26)


def build_xi_likelihood(pk_observable=False):
    """Config xi in the JAX package: ``__graft_entry__._build_likelihood``
    in configuration space. With ``pk_observable``, returns (config 1's P(k)
    observable, the xi observable, their footprint) instead."""
    from desilike_tpu.theories import (DampedBAOWigglesTracerCorrelationFunctionMultipoles, BAOPowerSpectrumTemplate,
                                       DampedBAOWigglesTracerPowerSpectrumMultipoles)
    from desilike_tpu.observables import (TracerCorrelationFunctionMultipolesObservable,
                                          TracerPowerSpectrumMultipolesObservable, BoxFootprint)
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    theory = DampedBAOWigglesTracerCorrelationFunctionMultipoles(
        ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper'))
    theory.init.params = {'al*': dict(derived='.marg')}
    observable = TracerCorrelationFunctionMultipolesObservable(
        data={'qpar': 1.0, 'qper': 1.0, 'b1': 2.0}, slim={0: (48., 152., 4.), 2: (48., 152., 4.)}, theory=theory)
    footprint = BoxFootprint(volume=2e9, nbar=5e-4)
    if pk_observable:
        pk_theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(
            ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper'))
        pk = TracerPowerSpectrumMultipolesObservable(
            data={'qpar': 1.0, 'qper': 1.0, 'b1': 2.0}, klim={0: (0.02, 0.3, 0.005), 2: (0.02, 0.3, 0.005)},
            theory=pk_theory)
        return pk, observable, footprint
    return ObservablesGaussianLikelihood(observables=[observable], footprints=[footprint])


def golden_xi_theories():
    """{name: (xi theory, built as tests/test_golden.py builds the goldens)}:
    the three xi goldens and the Kaiser and EFT-like Kaiser xi multipoles."""
    from desilike_tpu.theories import (DampedBAOWigglesTracerCorrelationFunctionMultipoles, BAOPowerSpectrumTemplate,
                                       ShapeFitPowerSpectrumTemplate, EPTTracerCorrelationFunctionMultipoles,
                                       KaiserTracerCorrelationFunctionMultipoles,
                                       EFTLikeKaiserTracerCorrelationFunctionMultipoles)
    return {
        'damped_bao_xi': DampedBAOWigglesTracerCorrelationFunctionMultipoles(
            ells=(0, 2), s=GOLDEN_S, template=BAOPowerSpectrumTemplate(z=0.8)),
        'ept_xi': EPTTracerCorrelationFunctionMultipoles(
            ells=(0, 2), s=GOLDEN_S, template=ShapeFitPowerSpectrumTemplate(z=0.8), resum=None),
        'ept_xi_resum': EPTTracerCorrelationFunctionMultipoles(
            ells=(0, 2), s=GOLDEN_S, template=ShapeFitPowerSpectrumTemplate(z=0.8)),
        'kaiser_xi': KaiserTracerCorrelationFunctionMultipoles(
            ells=(0, 2, 4), s=GOLDEN_S, template=ShapeFitPowerSpectrumTemplate(z=0.8)),
        'eft_kaiser_xi': EFTLikeKaiserTracerCorrelationFunctionMultipoles(
            ells=(0, 2), s=GOLDEN_S, template=ShapeFitPowerSpectrumTemplate(z=0.8))}


def xi_theory_vectors(names):
    """The xi multipoles of :func:`golden_xi_theories` ``names`` at the golden
    parameter values, in the package's current dtype, as float64 numpy."""
    from desilike_tpu.core import Pipeline
    out = {}
    for name, theory in golden_xi_theories().items():
        if name in names:
            pipe = Pipeline(theory)
            allowed = set(pipe.params.basenames())
            pipe.evaluate({key: value for key, value in GOLDEN_VALUES.items() if key in allowed})
            out[name] = np.asarray(theory.corr, dtype='f8')
    return out


def xi_extras(path):
    """Config xi's float64 (x64) extras, written to ``path``: the
    samplers' start-point log-density, gradient and Hessian (central
    differences of the x64 gradient, step HESSIAN_STEP in u) at the first
    reference point; the xi-xi covariance; the covariance of config 1's
    P(k) observable and the xi observable on one footprint; and the xi
    theory vectors at the golden parameters."""
    import jax
    import jax.numpy as jnp
    from desilike_tpu.samplers import NUTSSampler
    from desilike_tpu.observables.covariance import ObservablesCovarianceMatrix

    like = build_xi_likelihood()
    sampler = NUTSSampler(like, nchains=1)
    names = sampler.names
    point = reference_points(names)[0].astype('f4').astype('f8')
    u = np.asarray(sampler._unconstrain(point))
    step = HESSIAN_STEP * np.eye(len(u))
    logdens, grad = jax.jit(jax.vmap(sampler._logdens_grad()))(jnp.asarray(np.concatenate([u[None], u + step, u - step])))
    grad = np.asarray(grad)
    pk, xi, footprint = build_xi_likelihood(pk_observable=True)
    arrays = dict(hessian_names=np.array(names), hessian_point=point, hessian_u=u,
                  hessian_logdens=np.asarray(logdens)[0], hessian_grad=grad[0],
                  hessian=(grad[1:1 + len(u)] - grad[1 + len(u):]) / (2. * HESSIAN_STEP),
                  covariance_xi=np.asarray(like.covariance, dtype='f8'),
                  covariance_pk_xi=np.asarray(ObservablesCovarianceMatrix([pk, xi], footprints=footprint)(), dtype='f8'))
    for name, vector in xi_theory_vectors(list(golden_xi_theories())).items():
        arrays[name + '_x64'] = vector
    np.savez(path, **arrays)


def build_ept_xi_likelihood(ells=(0, 2, 4), step=4.):
    """Config 3xi in the JAX package: the EPT theory of
    ``scripts/bench_ept.py:20-31`` in configuration space, s = 30-150 Mpc/h
    in ``step`` Mpc/h bins for each multipole of ``ells`` (full width: (0, 2,
    4), 4 Mpc/h, 90 data), ``data={'b1': 2.0}``, the xi-xi Gaussian
    covariance, the counterterms ``ct*`` solved on the pipeline (their xi node
    has no analytic basis: the linearize path); the stochastic terms varied,
    as the xi theory leaves them."""
    from desilike_tpu.theories import EPTTracerCorrelationFunctionMultipoles, ShapeFitPowerSpectrumTemplate
    from desilike_tpu.observables import TracerCorrelationFunctionMultipolesObservable, BoxFootprint
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    theory = EPTTracerCorrelationFunctionMultipoles(ells=ells, template=ShapeFitPowerSpectrumTemplate(z=0.8))
    observable = TracerCorrelationFunctionMultipolesObservable(
        data={'b1': 2.0}, slim={ell: (30., 150., step) for ell in ells}, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)])
    like.pipeline.params.update({'ct*': dict(derived='.marg')}, basename=True)
    return like


def build_eft_xi_likelihood():
    """EFT-like Kaiser xi multipoles (0, 2) over 48-152 Mpc/h in 4 Mpc/h bins,
    ``data={'b1': 2.0}``, counterterms and stochastic terms solved on the
    pipeline (the counterterms by the linearize path, the stochastic terms
    with a static design matrix)."""
    from desilike_tpu.theories import EFTLikeKaiserTracerCorrelationFunctionMultipoles, ShapeFitPowerSpectrumTemplate
    from desilike_tpu.observables import TracerCorrelationFunctionMultipolesObservable, BoxFootprint
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    theory = EFTLikeKaiserTracerCorrelationFunctionMultipoles(ells=(0, 2), template=ShapeFitPowerSpectrumTemplate(z=0.8))
    observable = TracerCorrelationFunctionMultipolesObservable(
        data={'b1': 2.}, slim={ell: (48., 152., 4.) for ell in (0, 2)}, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)])
    like.pipeline.params.update({'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}, basename=True)
    return like


def build_bao_likelihood(params, transform=None, data=None):
    """The BAO likelihood of ``tests/test_likelihood.py`` reduced to the
    monopole, over 0.02-0.3 h/Mpc, with ``params`` on its theory and the
    observable's ``transform``."""
    from desilike_tpu.theories import DampedBAOWigglesTracerPowerSpectrumMultipoles
    from desilike_tpu.observables import TracerPowerSpectrumMultipolesObservable, BoxFootprint
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,))
    theory.init.params = params
    observable = TracerPowerSpectrumMultipolesObservable(data=data or {}, klim={0: (0.02, 0.3, 0.01)}, theory=theory,
                                                         transform=transform)
    return ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=1e10, nbar=1e-3)])


# the solved broadband of the BAO likelihood under the cubic transform (every term on the linearize path, al0_0
# '.best' beside the others' '.marg'), and its al0_0 folded into the covariance ('.prec'), the others fixed
BAO_CUBIC_PARAMS = {'al*': dict(derived='.marg', prior=dict(dist='norm', loc=0., scale=1e3)),
                    'al0_0': dict(derived='.best', prior=dict(dist='norm', loc=0., scale=1e3))}
BAO_PREC_PARAMS = {'al*': dict(fixed=True),
                   'al0_0': dict(derived='.prec', fixed=False, prior=dict(dist='norm', loc=0., scale=100.))}


def returned_solved_names(like):
    """The solved parameters whose values the log-posterior returns: all but
    those folded into the covariance ('.prec')."""
    return [p.name for p in like.pipeline.solved_params if p.derived != '.prec']


def evaluate_likelihood(like, names, points):
    """JAX log-posterior, its gradient and the solved parameters of ``like``
    at ``points`` (one row per point, one column per name of ``names``)."""
    import jax
    import jax.numpy as jnp
    logpost = like.logpost_fn(jit=False)
    solved_names = returned_solved_names(like)

    def scalar(theta):
        value, aux = logpost(dict(zip(names, theta)))
        return value, jnp.asarray([aux['solved'][name] for name in solved_names])

    (values, solved), grads = jax.jit(jax.vmap(jax.value_and_grad(scalar, has_aux=True)))(jnp.asarray(points))
    return [np.asarray(a, dtype='f8') for a in (values, grads, solved)]


def marg_likelihoods():
    """{prefix: (the function that builds the likelihood, number of points)} of :func:`marg_reference`."""
    return {'ept_xi': (build_ept_xi_likelihood, NPOINTS),
            'ept_xi_small': (lambda: build_ept_xi_likelihood(ells=(0, 2), step=8.), 4),
            'eft_xi': (build_eft_xi_likelihood, 4),
            'bao_cubic': (lambda: build_bao_likelihood(BAO_CUBIC_PARAMS, transform='cubic', data={'b1': 2.2}), 4),
            'bao_prec': (lambda: build_bao_likelihood(BAO_PREC_PARAMS), 4)}


def marg_reference(path, x64):
    """The arrays of ``torch_port_marg_reference.npz`` in the package's
    current dtype, written to ``path``; keys suffixed ``_x64`` in x64 mode.

    - ``{ept_xi, ept_xi_small, eft_xi, bao_cubic, bao_prec}_{names,
      solved_names, points}``, and the log-posterior, its gradient and the
      solved parameters at the points (``_logpost``, ``_grad``,
      ``_solved``): config 3xi at full width (16 points) and reduced to (0,
      2) in 8 Mpc/h bins (4 points), the EFT-like Kaiser xi (4 points), and
      the BAO likelihood under the cubic transform and with '.prec' (4
      points each, :data:`BAO_CUBIC_PARAMS`, :data:`BAO_PREC_PARAMS`);
    - ``fisher_xi_{names, center, hessian, gradient}``: ``Fisher`` of config
      xi (:func:`build_xi_likelihood`) at its fiducial (the parameters'
      values, b1 = 2.0 at which the data were made), over its 4 varied and 6
      solved parameters;
    - ``sum_{fisher_names, fisher_center, fisher_hessian}``: that Fisher's
      ``view(['qpar', 'qper'])``, and ``sum_{names, points, logpost, grad,
      solved}``: ``FisherGaussianLikelihood`` of it + config 3
      (``scripts/bench_ept.build``) at 16 points. The two share ``qpar``
      and ``qper``: the sum's pipeline merges parameters of one name.
    """
    from desilike_tpu.fisher import Fisher
    from desilike_tpu.likelihoods import FisherGaussianLikelihood
    suffix = '_x64' if x64 else ''
    arrays = {}
    for prefix, (build, npoints) in marg_likelihoods().items():
        like = build()
        names = like.pipeline.varied_params.names()
        points = reference_points(names, npoints).astype('f4').astype('f8')
        arrays.update({prefix + '_names': np.array(names), prefix + '_points': points,
                       prefix + '_solved_names': np.array(returned_solved_names(like))})
        for key, value in zip(('logpost', 'grad', 'solved'), evaluate_likelihood(like, names, points)):
            arrays['{}_{}{}'.format(prefix, key, suffix)] = value
    fisher = Fisher(build_xi_likelihood())(b1=2.0)
    arrays.update({'fisher_xi_names' + suffix: np.array(fisher.names()), 'fisher_xi_center' + suffix: fisher.center,
                   'fisher_xi_hessian' + suffix: fisher.hessian, 'fisher_xi_gradient' + suffix: fisher.gradient})
    view = fisher.view(['qpar', 'qper'])
    total = FisherGaussianLikelihood(fisher=view) + build_jax_likelihood('ept')
    names = total.pipeline.varied_params.names()
    points = reference_points(names).astype('f4').astype('f8')
    arrays.update({'sum_fisher_names': np.array(view.names()), 'sum_fisher_center' + suffix: view.center,
                   'sum_fisher_hessian' + suffix: view.hessian, 'sum_names': np.array(names), 'sum_points': points,
                   'sum_solved_names': np.array(total.pipeline.solved_params.names())})
    for key, value in zip(('logpost', 'grad', 'solved'), evaluate_likelihood(total, names, points)):
        arrays['sum_{}{}'.format(key, suffix)] = value
    np.savez(path, **arrays)


def build_ept_direct_likelihood(small=False):
    """Config 3d in the JAX package: BASELINE's config 3 (the EPT likelihood
    of ``scripts/bench_ept.py:20-31``) on ``DirectPowerSpectrumTemplate(z=0.8)``
    with its default varied parameters; with ``small``, the reduced build of
    ``tests/test_ept.py:91-112`` (``small_ept`` widths, h, omega_cdm and logA
    varied)."""
    from desilike_tpu.theories import EPTTracerPowerSpectrumMultipoles, DirectPowerSpectrumTemplate
    from desilike_tpu.observables import TracerPowerSpectrumMultipolesObservable, BoxFootprint
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    if small:
        theory = EPTTracerPowerSpectrumMultipoles(
            ells=(0, 2), k=np.linspace(0.02, 0.2, 19), nr=96, nx=48, nk_loop=64, mu=6, nk_template=500,
            template=DirectPowerSpectrumTemplate(z=0.8, varied=('h', 'omega_cdm', 'logA')))
        klim, data, footprint = {0: (0.02, 0.2, 0.01), 2: (0.02, 0.2, 0.01)}, {'b1': 1.7}, (5e9, 1e-3)
    else:
        theory = EPTTracerPowerSpectrumMultipoles(ells=(0, 2, 4), template=DirectPowerSpectrumTemplate(z=0.8))
        klim, data, footprint = {ell: (0.02, 0.2, 0.005) for ell in (0, 2, 4)}, {'b1': 2.0}, (2e9, 5e-4)
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(data=data, klim=klim, theory=theory)
    return ObservablesGaussianLikelihood(observables=[observable],
                                         footprints=[BoxFootprint(volume=footprint[0], nbar=footprint[1])])


# the cosmologies at which the cosmology functions are frozen: uniform draws from np.random.default_rng(1), the
# first with m_ncdm = 0 (varied: the massive formula, the massless density), the second with Omega_k = 0
COSMO_RANGES = {'h': (0.6, 0.75), 'omega_cdm': (0.1, 0.14), 'omega_b': (0.02, 0.025), 'logA': (2.9, 3.2),
                'n_s': (0.92, 1.), 'm_ncdm': (0.02, 0.3), 'Omega_k': (-0.05, 0.05), 'w0_fde': (-1.2, -0.8),
                'wa_fde': (-0.3, 0.3)}
COSMO_Z = np.array([0., 0.3, 0.8, 1.5, 3.])
COSMO_K = np.geomspace(1e-4, 2., 200)


def cosmology_points():
    rng = np.random.default_rng(1)
    points = np.column_stack([rng.uniform(lo, hi, NPOINTS) for lo, hi in COSMO_RANGES.values()])
    points[0, list(COSMO_RANGES).index('m_ncdm')] = 0.
    points[1, list(COSMO_RANGES).index('Omega_k')] = 0.
    return points


def cosmology_functions():
    """{name: function of a resolved parameter dict}: the JAX package's
    cosmology functions that the port's ``cosmology`` modules hold."""
    import jax.numpy as jnp
    from desilike_tpu.cosmology import background as bg, linear as lin, eh
    k, z = jnp.asarray(COSMO_K), jnp.asarray(COSMO_Z)
    nowiggle = lin.NoWiggleFilter(COSMO_K)
    return {'efunc': lambda p: bg.efunc(p, z), 'comoving_radial_distance': lambda p: bg.comoving_radial_distance(p, z),
            'comoving_angular_distance': lambda p: bg.comoving_angular_distance(p, z),
            'hubble_distance': lambda p: bg.hubble_distance(p, z), 'rs_drag': bg.rs_drag,
            'growth_factor': lambda p: bg.growth_factor(p, z), 'growth_factor_md': lambda p: bg.growth_factor(p, z, 'md'),
            'growth_rate': lambda p: bg.growth_rate(p, z), 'transfer': lambda p: eh.transfer(p, k),
            'transfer_nowiggle': lambda p: eh.transfer_nowiggle(p, k), 'sound_horizon_eh': eh.sound_horizon_eh,
            'neutrino_ratio': lambda p: eh.neutrino_ratio(p, k, 0.8),
            'growth_rate_ratio': lambda p: eh.growth_rate_ratio(p, k, 0.8),
            'pk_lin': lambda p: lin.pk_lin(p, k, 0.8), 'pk_lin_nowiggle': lambda p: lin.pk_lin(p, k, 0.8, nowiggle=True),
            'sigma8': lambda p: lin.sigma_r(p, 8., 0.8),
            'pknow': lambda p: nowiggle(lin.pk_lin(p, k, 0.8), lin.pk_lin(p, k, 0.8, nowiggle=True)),
            'primordial_curvature': lambda p: lin.primordial_curvature(dict(p, alpha_s=0.01), k)}


def node_cases():
    """{name: (Cosmology node kwargs, parameter updates, values)}: the JAX
    package's ``Cosmology`` node, evaluated through a pipeline (``cosmo_*``
    keys of :func:`direct_reference`)."""
    varied = {'h': 0.7, 'omega_cdm': 0.125, 'omega_b': 0.023, 'logA': 3.1, 'n_s': 0.95, 'm_ncdm': 0.1,
              'Omega_k': 0.02, 'w0_fde': -0.9, 'wa_fde': 0.1}
    return {'eh98': (dict(engine='eh98'), {n: dict(fixed=False) for n in varied}, varied),
            'eh99': (dict(engine='eh99'), {n: dict(fixed=False) for n in varied}, varied),
            'table': ('table', {n: dict(fixed=False) for n in ('h', 'omega_cdm', 'logA', 'n_s')},
                      {'h': 0.7, 'omega_cdm': 0.125, 'logA': 3.1, 'n_s': 0.95}),
            'massless_fixed': (dict(engine='eh98'), {'m_ncdm': dict(value=0., fixed=True)}, {}),
            'massless_varied': (dict(engine='eh98'), {'m_ncdm': dict(fixed=False)}, {'m_ncdm': 0.}),
            'Omega_m': (dict(engine='eh98'), {'Omega_m': dict(value=0.3153, prior=dict(limits=[0.01, 1.]),
                                                              fixed=False)}, {'Omega_m': 0.35}),
            'w0_fld': (dict(engine='eh98'), {'w0_fld': dict(value=-0.9, fixed=False)}, {'w0_fld': -0.9}),
            'N_eff': (dict(engine='eh98'), {'N_eff': dict(value=3.4, fixed=False)}, {'N_eff': 3.4}),
            'alpha_s': (dict(engine='eh98'), {'alpha_s': dict(value=0., prior=dict(limits=[-0.1, 0.1]),
                                                              fixed=False)}, {'alpha_s': 0.05})}


NODE_K = np.geomspace(1e-3, 1., 64)


def fake_boltzmann_table():
    """The stand-in CLASS table of ``tests/test_pk_injection.py``: EH98 x a
    smooth 3% shape distortion, on k = geomspace(1e-4, 10, 512)."""
    import jax.numpy as jnp
    from desilike_tpu.cosmology import background as bg, linear as lin
    ktab = np.geomspace(1e-4, 10., 512)
    pk = np.asarray(lin.pk_lin(bg.resolve({}), jnp.asarray(ktab), 0.), dtype='f8')
    return ktab, pk * (1. + 0.03 * np.tanh(np.log(ktab / 0.05)))


def direct_reference(path, x64):
    """The extras of ``torch_port_direct_reference.npz`` in the package's
    current dtype, written to ``path``; keys suffixed ``_x64`` in x64 mode.

    - ``small_{names, solved_names, points, logpost, grad, solved}``: the
      reduced config 3d (:func:`build_ept_direct_likelihood` with
      ``small``) at 16 points;
    - in x64 only, ``cosmo_points`` (one row per cosmology of
      :func:`cosmology_points`, the columns :data:`COSMO_RANGES`' names) and
      each function of :func:`cosmology_functions` there (``fn_<name>``), by
      ``jax.jit`` of ``jax.vmap``: the parameters are traced, as a varied
      parameter is;
    - in x64 only, the ``Cosmology`` node of each :func:`node_cases` case
      through ``Pipeline.evaluate`` (``node_<case>_<quantity>``): pk_dd,
      pk_dd_now and growth_rate_k on :data:`NODE_K` at z = 0.8, sigma8,
      fsigma8, efunc, comoving_angular_distance, growth_factor at z = 0.8
      and rs_drag;
    - in x64 only, ``ap_<mode>_{qpar, qper}``: ``APEffect`` in the
      'geometry' and 'bao' modes on a cosmology with h, omega_cdm varied
      (at 0.7, 0.125), against the fiducial and against ``fiducial={'h':
      0.65}`` (``ap_<mode>_fid_*``).
    """
    import jax
    import jax.numpy as jnp
    from desilike_tpu.core import Pipeline
    from desilike_tpu.cosmology import background as bg
    from desilike_tpu.theories import Cosmology
    from desilike_tpu.theories.base import APEffect
    suffix = '_x64' if x64 else ''
    like = build_ept_direct_likelihood(small=True)
    names = like.pipeline.varied_params.names()
    points = reference_points(names).astype('f4').astype('f8')
    arrays = {'small_names': np.array(names), 'small_points': points,
              'small_solved_names': np.array(returned_solved_names(like))}
    for key, value in zip(('logpost', 'grad', 'solved'), evaluate_likelihood(like, names, points)):
        arrays['small_{}{}'.format(key, suffix)] = value
    if x64:
        points = cosmology_points()
        arrays['cosmo_points'] = points
        for name, fn in cosmology_functions().items():
            values = jax.jit(jax.vmap(lambda row: fn(bg.resolve(dict(zip(COSMO_RANGES, row))))))(jnp.asarray(points))
            arrays['fn_' + name] = np.asarray(values, dtype='f8')
        k = jnp.asarray(NODE_K)
        for case, (kwargs, params, values) in node_cases().items():
            if kwargs == 'table':
                kwargs = dict(engine='table', pk_table=fake_boltzmann_table())
            cosmo = Cosmology(**kwargs)
            cosmo.init.params = params
            pipe = Pipeline(cosmo)

            def node(values):
                pipe.run_once(pipe._resolve_values(values))
                return {'pk_dd': cosmo.pk_dd(k, 0.8), 'pk_dd_now': cosmo.pk_dd_now(k, 0.8),
                        'growth_rate_k': cosmo.growth_rate_k(k, 0.8), 'sigma8': cosmo.sigma8(0.8),
                        'fsigma8': cosmo.fsigma8(0.8), 'efunc': cosmo.efunc(0.8),
                        'comoving_angular_distance': cosmo.comoving_angular_distance(0.8),
                        'growth_factor': cosmo.growth_factor(0.8), 'rs_drag': cosmo.rs_drag()}

            # jitted, as logpost_fn is: the varied parameters are traced, the fixed ones host numbers
            out = jax.jit(node)({name: jnp.asarray(value, dtype=float) for name, value in values.items()})
            arrays.update({'node_{}_{}'.format(case, q): np.asarray(v, dtype='f8') for q, v in out.items()})
        for mode in ('geometry', 'bao'):
            for label, fiducial in (('', None), ('fid_', {'h': 0.65})):
                cosmo = Cosmology()
                cosmo.init.params = {'h': dict(fixed=False), 'omega_cdm': dict(fixed=False)}
                ap = APEffect(z=0.8, mode=mode, cosmo=cosmo, fiducial=fiducial)
                pipe = Pipeline(ap)

                def qs(values):
                    pipe.run_once(pipe._resolve_values(values))
                    return ap.qpar, ap.qper

                qpar, qper = jax.jit(qs)({'h': jnp.asarray(0.7), 'omega_cdm': jnp.asarray(0.125)})
                arrays['ap_{}_{}qpar'.format(mode, label)] = np.asarray(qpar, dtype='f8')
                arrays['ap_{}_{}qper'.format(mode, label)] = np.asarray(qper, dtype='f8')
    np.savez(path, **arrays)


# the templates and extractors frozen by ``templates``: {case: (class, init kwargs, parameter values at each point,
# attributes)}, the settings of tests/test_templates_extra.py; the extractors on a Cosmology node that varies
# EXTRACTOR_POINTS' parameters
TEMPLATE_CASES = {
    'fixed': ('FixedPowerSpectrumTemplate', dict(z=1., k=np.geomspace(1e-3, 0.6, 300)), [{}],
              ('pk_dd', 'pknow_dd', 'f', 'fsigma8', 'qpar', 'qper')),
    'standard': ('StandardPowerSpectrumTemplate', dict(z=1., k=np.geomspace(1e-3, 0.6, 300)),
                 [{'df': 1.1, 'qpar': 1.02, 'qper': 0.99}, {'df': 0.95, 'qpar': 0.98, 'qper': 1.01}],
                 ('pk_dd', 'f', 'fsigma8', 'qpar', 'qper')),
    'bao_phaseshift': ('BAOPhaseShiftPowerSpectrumTemplate',
                       dict(z=0.8, k=np.geomspace(1e-3, 0.6, 400), apmode='qiso'),
                       [{'baoshift': 1.}, {'baoshift': 2., 'qiso': 1.02}], ('pk_dd', 'pknow_dd', 'f', 'DV_over_rd')),
    'wigglesplit': ('WiggleSplitPowerSpectrumTemplate', dict(z=1., k=np.geomspace(1e-3, 0.6, 300)),
                    [{'qbao': 1., 'dm': 0., 'df': 1.}, {'qbao': 1.05, 'dm': 0.02, 'df': 1.1, 'qap': 1.01}],
                    ('pk_dd', 'pknow_dd', 'f', 'qpar', 'qper')),
    'wigglesplit_tophat': ('WiggleSplitPowerSpectrumTemplate',
                           dict(z=1., k=np.geomspace(1e-3, 0.6, 300), kernel='tophat'),
                           [{'qbao': 1.05, 'dm': 0.02, 'df': 1.1}], ('pk_dd', 'pknow_dd')),
    'bandvelocity': ('BandVelocityPowerSpectrumTemplate',
                     dict(z=1., kp=[0.02, 0.05, 0.1, 0.2], k=np.geomspace(5e-3, 0.4, 200)),
                     [{'dptt1': 1.2}, {'dptt0': 0.9, 'dptt3': 1.1, 'df': 1.05, 'qap': 0.99}],
                     ('pk_dd', 'pknow_dd', 'pk_tt', 'f', 'qpar')),
    'turnover': ('TurnOverPowerSpectrumTemplate', dict(z=0.5, k=np.geomspace(3e-3, 0.3, 300)),
                 [{}, {'qto': 1.1, 'dpto': 1.05, 'm': 0.6, 'n': 0.9, 'qap': 1.02}],
                 ('pk_dd', 'DV_times_kTO', 'DH_over_DM', 'kto')),
    'direct_wigglesplit': ('DirectWiggleSplitPowerSpectrumTemplate', dict(z=1., k=np.logspace(-2.2, -0.3, 200)),
                           [{'qbao': 1.05}, {'sigmabao': 50.}, {'omega_cdm': 0.13, 'qbao': 0.97, 'sigmabao': 3.}],
                           ('pk_dd', 'pknow_dd', 'f', 'qpar', 'qper'))}
EXTRACTOR_CASES = {
    'bao': ('BAOExtractor', dict(z=0.8), ('DH_over_rd', 'DM_over_rd', 'DV_over_rd', 'DH_over_DM', 'qpar', 'qper',
                                          'qiso', 'qap')),
    'standard': ('StandardPowerSpectrumExtractor', dict(z=0.8), ('df', 'fsigmar')),
    'shapefit': ('ShapeFitPowerSpectrumExtractor', dict(z=0.8), ('dm', 'dn', 'df', 'm', 'f_sqrt_Ap')),
    'shapefit_n': ('ShapeFitPowerSpectrumExtractor', dict(z=0.8, n_varied=True), ('dm', 'df', 'm')),
    'wigglesplit': ('WiggleSplitPowerSpectrumExtractor', dict(z=0.8), ('qbao', 'df', 'dm', 'm', 'fsigmar')),
    'wigglesplit_tophat': ('WiggleSplitPowerSpectrumExtractor', dict(z=0.8, kernel='tophat'), ('df', 'dm', 'm')),
    'bandvelocity': ('BandVelocityPowerSpectrumExtractor', dict(z=0.8, kp=[0.02, 0.05, 0.1, 0.2]),
                     ('dptt', 'df', 'fsigmar', 'qap')),
    'turnover': ('TurnOverPowerSpectrumExtractor', dict(z=0.8), ('kTO', 'DV_times_kTO', 'DM_over_DH', 'qto')),
    'baophaseshift': ('BAOPhaseShiftExtractor', dict(z=0.8), ('baoshift', 'qiso'))}
EXTRACTOR_POINTS = [{'h': 0.7, 'omega_cdm': 0.125, 'omega_b': 0.023, 'logA': 3.1, 'n_s': 0.95, 'N_ur': 2.3},
                    {'h': 0.65, 'omega_cdm': 0.115, 'omega_b': 0.021, 'logA': 3.0, 'n_s': 0.98, 'N_ur': 1.9}]
BAND_KP = [0.02, 0.05, 0.1, 0.2]


def templates_reference(path):
    """``torch_port_templates_reference.npz``, in x64, written to ``path``:
    ``<case>_<attribute>`` (one row per point) of :data:`TEMPLATE_CASES` and
    ``extractor_<case>_<attribute>`` of :data:`EXTRACTOR_CASES` at
    :data:`EXTRACTOR_POINTS`, each through ``Pipeline.evaluate``; and
    ``calculator_power``: the Kaiser multipoles (0, 2) on k =
    linspace(0.02, 0.2, 19) of a BandVelocityPowerSpectrumTemplate (z = 0.8,
    kp = BAND_KP) rewired by ``BandVelocityPowerSpectrumCalculator`` onto a
    Cosmology node varying EXTRACTOR_POINTS' parameters, at those points
    with b1 = 2."""
    from desilike_tpu import theories
    from desilike_tpu.core import Pipeline
    arrays = {}
    for case, (cls, kwargs, points, attrs) in TEMPLATE_CASES.items():
        node = getattr(theories, cls)(**kwargs)
        pipe = Pipeline(node)
        rows = {attr: [] for attr in attrs}
        for values in points:
            pipe.evaluate(values)
            for attr in attrs:
                rows[attr].append(np.asarray(getattr(node, attr), dtype='f8'))
        arrays.update({'{}_{}'.format(case, attr): np.array(row) for attr, row in rows.items()})
        if case == 'turnover':
            arrays.update(turnover_kto_fid=np.asarray(node.kto_fid), turnover_pkto_fid=np.asarray(node.pkto_fid))
    for case, (cls, kwargs, attrs) in EXTRACTOR_CASES.items():
        cosmo = theories.Cosmology()
        cosmo.init.params = {name: dict(fixed=False) for name in EXTRACTOR_POINTS[0]}
        node = getattr(theories, cls)(cosmo=cosmo, **kwargs)
        pipe = Pipeline(node)
        rows = {attr: [] for attr in attrs}
        for values in EXTRACTOR_POINTS:
            pipe.evaluate(values)
            for attr in attrs:
                rows[attr].append(np.asarray(getattr(node, attr), dtype='f8'))
        arrays.update({'extractor_{}_{}'.format(case, attr): np.array(row) for attr, row in rows.items()})
    theory = theories.KaiserTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=np.linspace(0.02, 0.2, 19), template=theories.BandVelocityPowerSpectrumTemplate(z=0.8, kp=BAND_KP))
    cosmo = theories.Cosmology()
    cosmo.init.params = {name: dict(fixed=False) for name in EXTRACTOR_POINTS[0]}
    theories.BandVelocityPowerSpectrumCalculator(theory, cosmo=cosmo)
    pipe = Pipeline(theory)
    rows = []
    for values in EXTRACTOR_POINTS:
        pipe.evaluate(dict(values, b1=2.))
        rows.append(np.asarray(theory.power, dtype='f8'))
    arrays['calculator_power'] = np.array(rows)
    np.savez(path, **arrays)


# config 5's template grids: those the theories give their templates (full_shape.py and bao.py ``_klim``),
# so that the emulated tables have config 4's shapes
EMU_FS_K = np.geomspace(1e-3, 1., 500)
EMU_BAO_K = np.geomspace(1e-4, 1., 2000)
EMU_TRACERS = (('LRG', 0.8, 2.0), ('ELG', 1.1, 1.3))
EMU_NPREDICT = 8  # seeded points at which each emulator's prediction is frozen
EMU_NY = 64  # rows of the MLP's training set Y frozen (LRG), of its 512
TAYLOR_K = np.geomspace(1e-3, 0.5, 120)  # the ShapeFit template of tests/test_emulators.py:12


def build_emulated_likelihood(nodes):
    """Config 5: config 4 (``bench.build_likelihood``) with each tracer's
    templates replaced by the nodes ``nodes[tracer]`` (ShapeFit) and
    ``nodes[tracer + 'bao']`` (BAO)."""
    from desilike_tpu.theories import DampedBAOWigglesTracerPowerSpectrumMultipoles
    from desilike_tpu.theories.full_shape import EFTLikeKaiserTracerPowerSpectrumMultipoles
    from desilike_tpu.observables import TracerPowerSpectrumMultipolesObservable, BoxFootprint
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    observables, footprints = [], []
    for tracer, z, b1 in EMU_TRACERS:
        fs_theory = EFTLikeKaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=nodes[tracer], namespace=tracer)
        fs_theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
        observables.append(TracerPowerSpectrumMultipolesObservable(
            data={'{}.b1'.format(tracer): b1},
            klim={0: (0.02, 0.2, 0.005), 2: (0.02, 0.2, 0.005)}, theory=fs_theory))
        footprints.append(BoxFootprint(volume=2e9, nbar=5e-4))
        bao_theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0, 2), template=nodes[tracer + 'bao'],
                                                                   namespace=tracer + 'bao')
        bao_theory.init.params = {'al*': dict(derived='.marg')}
        observables.append(TracerPowerSpectrumMultipolesObservable(
            data={'{}bao.b1'.format(tracer): b1},
            klim={0: (0.02, 0.3, 0.005), 2: (0.02, 0.3, 0.005)}, theory=bao_theory))
        footprints.append(BoxFootprint(volume=2e9, nbar=5e-4))
    return ObservablesGaussianLikelihood(observables=observables, footprints=footprints)


def emu_templates():
    """{namespace: (template, engine name)}: config 5's templates before emulation."""
    from desilike_tpu.theories import ShapeFitPowerSpectrumTemplate, BAOPowerSpectrumTemplate
    out = {}
    for tracer, z, _ in EMU_TRACERS:
        out[tracer] = (ShapeFitPowerSpectrumTemplate(z=z, k=EMU_FS_K, namespace=tracer), 'mlp')
        out[tracer + 'bao'] = (BAOPowerSpectrumTemplate(z=z, k=EMU_BAO_K, namespace=tracer + 'bao'), 'taylor')
    return out


def emu_predictions(emu, seed):
    """EMU_NPREDICT seeded points around the emulator's center (inside its
    reference ranges) and the emulator's flat prediction at each."""
    rng = np.random.default_rng(seed)
    theta = np.array([[p.value + 0.5 * (p.ref.std if p.ref is not None else 0.01) * rng.uniform(-1., 1.)
                       for p in emu.varied_params] for _ in range(EMU_NPREDICT)]).astype('f4').astype('f8')
    pred = np.array([np.concatenate([np.asarray(v, dtype='f8').reshape(-1) for v in emu.predict(t).values()])
                     for t in theta])
    return theta, pred


def saved_arrays(emu, prefix):
    """The arrays of ``emu.save`` (the JAX package's emulator file), keys prefixed."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'emu.npz')
        emu.save(path)
        return {prefix + key: value for key, value in np.load(path).items()}


def emulated_reference(path):
    """Config 5's arrays (float32, the package's default), written to
    ``path``; then their x64 values from a child process:

    - for each tracer's ShapeFit template (``LRG``, ``ELG``; on EMU_FS_K) its
      MLP emulator (the engine's defaults: hidden (64, 64), 512 Sobol
      samples, 3000 Adam steps, lr 3e-3, seed 7): ``<ns>:<key>`` the arrays
      of its emulator file (``meta``, ``engine:loss``), ``<ns>:flax:Dense_i:
      {kernel,bias}`` the trained weights, ``<ns>:norm:0`` to ``<ns>:norm:3``
      its ``_norm`` (xm, xs, ym, ys) and ``<ns>:check`` its ``check()``; for LRG the Sobol inputs ``LRG:X`` and
      the first EMU_NY rows of its outputs ``LRG:Y``;
    - for each tracer's BAO template (``LRGbao``, ``ELGbao``; on EMU_BAO_K)
      its Taylor emulator (order 3): ``<ns>:<key>`` its emulator file
      (``meta``, ``fixed:*``, ``engine:{coeffs,center,derivs}``);
    - for each emulator ``<ns>:predict_theta`` (EMU_NPREDICT points) and
      ``<ns>:predict`` (the flat predicted state);
    - config 5 (:func:`build_emulated_likelihood`) at 16 points: ``names``,
      ``solved_names``, ``points``, ``logpost``, ``grad``, ``solved`` and
      their ``_x64`` twins (the same emulators, the pipeline in float64;
      the MLP runs in float32 even so);
    - ``taylor_x64:{coeffs,derivs,names,varied_names}``: Taylor order 3 of
      the ShapeFit template at z = 0.8 on TAYLOR_K, fitted in float64;
    - ``getter:*`` (:func:`default_getter_reference`).
    """
    from desilike_tpu.emulators import Emulator, MLPEmulatorEngine, TaylorEmulatorEngine
    arrays, nodes = {}, {}
    for i, (ns, (template, engine)) in enumerate(emu_templates().items()):
        if engine == 'mlp':
            emu = Emulator(template, engine=MLPEmulatorEngine()).fit()
            arrays.update(saved_arrays(emu, ns + ':'))
            for layer, weights in emu.engine._params['params'].items():
                for key, value in weights.items():
                    arrays['{}:flax:{}:{}'.format(ns, layer, key)] = np.asarray(value)
            for j, value in enumerate(emu.engine._norm):
                arrays['{}:norm:{:d}'.format(ns, j)] = np.asarray(value)
            arrays[ns + ':check'] = np.array(emu.check())
            if ns == 'LRG':
                arrays['LRG:X'], arrays['LRG:Y'] = emu.engine.X, np.asarray(emu.engine.Y[:EMU_NY])
        else:
            emu = Emulator(template, engine=TaylorEmulatorEngine(order=3)).fit()
            arrays.update(saved_arrays(emu, ns + ':'))
        arrays[ns + ':predict_theta'], arrays[ns + ':predict'] = emu_predictions(emu, seed=i)
        nodes[ns] = emu.to_calculator()
    arrays.update(default_getter_reference())
    like = build_emulated_likelihood(nodes)
    names = like.pipeline.varied_params.names()
    points = reference_points(names).astype('f4').astype('f8')
    arrays.update(names=np.array(names), points=points, solved_names=np.array(returned_solved_names(like)))
    for key, value in zip(('logpost', 'grad', 'solved'), evaluate_likelihood(like, names, points)):
        arrays[key] = value
    np.savez(path, **arrays)
    env = dict(os.environ, JAX_PLATFORMS='cpu', JAX_ENABLE_X64='1', DESILIKE_TPU_X64='1')
    subprocess.run([sys.executable, os.path.abspath(__file__), '--x64-emu', path], env=env, check=True)


def default_getter_reference():
    """``Differentiation`` without a getter (the root's state snapshot) at
    order 1 on the ShapeFit template at z = 0.8 on TAYLOR_K, float32:
    ``getter:<entry>`` the values and derivatives of each state entry (one
    row a derivative key), ``getter:derivs`` the keys."""
    from desilike_tpu.differentiation import Differentiation
    from desilike_tpu.theories import ShapeFitPowerSpectrumTemplate
    result = Differentiation(ShapeFitPowerSpectrumTemplate(z=0.8, k=TAYLOR_K), order=1)()
    arrays = {'getter:' + name: np.asarray(value.value, dtype='f8') for name, value in result.items()}
    arrays['getter:derivs'] = np.array([repr(sorted(d.items())) for d in next(iter(result.values())).derivs])
    return arrays


def emulated_x64(path):
    """The x64 child of :func:`emulated_reference`: rebuilds its emulators from
    the arrays in ``path`` (the MLP from its flax weights, the Taylor ones
    from their files), evaluates config 5 in float64 at its points, fits the
    Taylor check case in float64, and adds the ``_x64`` arrays to ``path``."""
    import flax.linen as nn
    from desilike_tpu.emulators import Emulator, MLPEmulatorEngine, TaylorEmulatorEngine
    from desilike_tpu.theories import ShapeFitPowerSpectrumTemplate
    arrays = dict(np.load(path))
    nodes = {}
    for ns, (template, engine) in emu_templates().items():
        if engine == 'mlp':
            emu = Emulator(template, engine=MLPEmulatorEngine())
            layers = sorted({key.split(':')[2] for key in arrays if key.startswith(ns + ':flax:')})
            params = {'params': {layer: {key: arrays['{}:flax:{}:{}'.format(ns, layer, key)] for key in ('kernel', 'bias')}
                                 for layer in layers}}
            sizes = [params['params'][layer]['bias'].shape[0] for layer in layers]

            class MLP(nn.Module):  # the engine's network (emulators/__init__.py:332-337)
                @nn.compact
                def __call__(self, x):
                    for h in sizes[:-1]:
                        x = nn.gelu(nn.Dense(h)(x))
                    return nn.Dense(sizes[-1])(x)

            emu.engine._model, emu.engine._params = MLP(), params
            emu.engine._norm = tuple(arrays['{}:norm:{:d}'.format(ns, j)] for j in range(4))
        else:
            with tempfile.TemporaryDirectory() as tmp:
                file = os.path.join(tmp, 'emu.npz')
                np.savez(file, **{key[len(ns) + 1:]: value for key, value in arrays.items() if key.startswith(ns + ':')
                                  and not key.startswith(ns + ':predict')})
                emu = Emulator.load(file, calculator=template)
        nodes[ns] = emu.to_calculator()
    like = build_emulated_likelihood(nodes)
    names = list(arrays['names'])
    if like.pipeline.varied_params.names() != names:
        raise AssertionError('the x64 build varies {}'.format(like.pipeline.varied_params.names()))
    for key, value in zip(('logpost', 'grad', 'solved'), evaluate_likelihood(like, names, arrays['points'])):
        arrays[key + '_x64'] = value
    emu = Emulator(ShapeFitPowerSpectrumTemplate(z=0.8, k=TAYLOR_K), engine=TaylorEmulatorEngine(order=3)).fit()
    arrays.update({'taylor_x64:coeffs': np.asarray(emu.engine.coeffs, dtype='f8'),
                   'taylor_x64:derivs': emu.engine.__getstate__()['derivs'],
                   'taylor_x64:names': np.array(emu.names), 'taylor_x64:varied_names': np.array(emu.varied_names)})
    np.savez(path, **arrays)


def build_emulated_reference():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'emu.npz')
        emulated_reference(path)
        return dict(np.load(path))


def build_tns_likelihood(small=False):
    """Config tns: config 3's calls (``scripts/bench_ept.py``) with the
    EFT-like TNS theory at its defaults (FFTLog loops, nk_loop 96, nq_tns
    300, nmu_tns 16, Lorentzian FoG), or at :data:`TNS_SMALL`."""
    from desilike_tpu.theories import EFTLikeTNSTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate
    from desilike_tpu.observables import TracerPowerSpectrumMultipolesObservable, BoxFootprint
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    theory = EFTLikeTNSTracerPowerSpectrumMultipoles(ells=(0, 2, 4), template=ShapeFitPowerSpectrumTemplate(z=0.8),
                                                    **(TNS_SMALL if small else {}))
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    obs = TracerPowerSpectrumMultipolesObservable(
        data={'b1': 2.0}, klim={ell: (0.02, 0.2, 0.005) for ell in (0, 2, 4)}, theory=theory)
    return ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)])


def tns_reference(path):
    """The x64 child of the ``tns`` mode: config tns at full width and
    small, 16 points each, written to ``path``."""
    arrays = {}
    for prefix, small in (('', False), ('small_', True)):
        like = build_tns_likelihood(small)
        names = like.pipeline.varied_params.names()
        points = reference_points(names).astype('f4').astype('f8')
        values, grads, solved = evaluate_likelihood(like, names, points)
        arrays.update({prefix + 'names': np.array(names), prefix + 'points': points,
                       prefix + 'solved_names': np.array(like.pipeline.solved_params.names()),
                       prefix + 'logpost_x64': values, prefix + 'grad_x64': grads, prefix + 'solved_x64': solved})
    np.savez(path, **arrays)


# the synthetic truth of tests/test_boltzmann_emulator.py
EMU_RANGES = {'h': (0.64, 0.71), 'omega_cdm': (0.11, 0.13), 'logA': (2.95, 3.12), 'm_ncdm': (0.03, 0.3)}
EMU_K = np.geomspace(1e-3, 5., 64)
EMU_Z = np.array([0., 1., 2.])
EMU_POINTS = np.array([[0.685, 0.122, 3.05, 0.12], [0.65, 0.115, 2.98, 0.05], [0.70, 0.128, 3.10, 0.25],
                       [0.67, 0.119, 3.02, 0.2]])
BAO_K = np.linspace(0.02, 0.3, 29)


def emulator_reference():
    """The cosmology emulator of ``tests/test_boltzmann_emulator.py``'s
    fixture, in float32: Sobol X (512 rows, seed 5), the EH99 truth tables,
    the targets, weights trained 20000 Adam steps (seed 2); the initial
    weights of ``train_mlp`` at seed 2 and its loss after 20 steps; the
    predicted tables at :data:`EMU_POINTS`."""
    import jax
    import jax.numpy as jnp
    from desilike_tpu.cosmology import background as bg, linear as lin, eh
    from desilike_tpu.cosmology import emulator as emu
    names, X = emu.sobol_grid(EMU_RANGES, n=512, seed=5)
    k = jnp.asarray(EMU_K)

    @jax.jit
    def row(theta):
        p = bg.resolve({n: t for n, t in zip(names, theta)})
        pk = jnp.stack([lin.pk_lin(p, k, float(z)) * eh.neutrino_ratio(p, k, float(z)) for z in EMU_Z])
        return pk, bg.rs_drag(p) * (1.01 + 0.5 * (p['h'] - 0.6736))

    tables = [row(jnp.asarray(x)) for x in X]
    pk_tables = np.asarray([np.asarray(t[0]) for t in tables])
    rs = np.asarray([float(t[1]) for t in tables])
    Y = emu.make_targets(names, X, pk_tables, rs, EMU_K, EMU_Z)
    weights = emu.train_pk_emulator(names, X, Y, EMU_K, EMU_Z, hidden=(64, 64), nsteps=20000, learning_rate=1e-3,
                                    seed=2)
    short = emu.train_mlp(names, X, Y, hidden=(64, 64), nsteps=20, learning_rate=1e-3, seed=2)
    # the initial weights train_mlp draws at seed 2 (its key splitting)
    key = jax.random.key(2)
    sizes = (X.shape[1], 64, 64, Y.shape[1])
    arrays = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        key, sub = jax.random.split(key)
        arrays['emu_init_W%d' % i] = np.asarray(jax.random.normal(sub, (fan_in, fan_out), dtype=jnp.float32)
                                                / np.sqrt(fan_in))
    lnr, rs_ratio = zip(*[emu.predict_tables(weights, jnp.asarray(point)) for point in EMU_POINTS])
    arrays.update({'emu_names': np.array(names), 'emu_X': X, 'emu_Y': Y, 'emu_pk_tables': pk_tables, 'emu_rs': rs,
                   'emu_loss_20': short['loss'], 'emu_holdout_err': weights['holdout_err'], 'emu_loss': weights['loss'],
                   'emu_points': EMU_POINTS, 'emu_lnr': np.asarray(lnr), 'emu_rs_ratio': np.asarray(rs_ratio)})
    for key in ('x_mean', 'x_std', 'y_mean', 'y_std', 'k_grid', 'z_grid'):
        arrays['emu_w_' + key] = np.asarray(weights[key])
    for i, (W, b) in enumerate(weights['layers']):
        arrays['emu_w_W%d' % i], arrays['emu_w_b%d' % i] = np.asarray(W), np.asarray(b)
    return arrays


def emulator_weights(arrays):
    """The weights dict of :func:`emulator_reference`'s arrays."""
    weights = {key[6:]: arrays[key] for key in arrays if key.startswith('emu_w_') and key[6] not in 'Wb'}
    weights['param_names'] = tuple(str(name) for name in arrays['emu_names'])
    n = len([key for key in arrays if key.startswith('emu_w_W')])
    weights['layers'] = [(arrays['emu_w_W%d' % i], arrays['emu_w_b%d' % i]) for i in range(n)]
    return weights


def theory_vector(theory, values, attr='power'):
    from desilike_tpu.core import Pipeline
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames())
    pipe.evaluate({key: value for key, value in values.items() if key in allowed})
    return np.asarray(getattr(theory, attr), dtype='f8')


# two chains of the TNS xi theories (``tests/test_torch_tns.py`` evaluates both in one batch)
TNS_XI_CHAINS = ({'qpar': 1.02, 'qper': 0.98, 'df': 1.05, 'dm': 0.02, 'b1': 1.8, 'b2': 0.5, 'bs': -0.2, 'b3': 0.3,
                  'sigmav': 3., 'sn0': 0.5, 'ct0_2': 10., 'ct2_2': 5.},
                 {'qpar': 0.99, 'qper': 1.01, 'df': 0.97, 'dm': -0.01, 'b1': 2.1, 'b2': -0.3, 'bs': 0.1, 'b3': -0.4,
                  'sigmav': 5., 'sn0': -0.3, 'ct0_2': -5., 'ct2_2': 2.})


def theory_cases():
    """(name, constructor, values, attribute) of the theory vectors the
    ``theories`` mode freezes in x64."""
    from desilike_tpu import theories as T
    values = dict(GOLDEN_VALUES, ml0_0=1., ml2_1=0.5, fnl_loc=10., p=1., sigmav=4., bphi=1.5, bfnl_loc=20., bv=1.2,
                  sigmau=3., bs2=-0.3, snB=0.5, al0_1=200., al2_2=-100., al0_4=50.)
    cases = []
    for kernel in ('ngp', 'cic', 'tsc', 'pcs'):
        cases.append(('bao_' + kernel, lambda kernel=kernel: T.DampedBAOWigglesTracerPowerSpectrumMultipoles(
            ells=(0, 2), k=BAO_K, broadband=kernel, template=T.BAOPowerSpectrumTemplate(z=0.8)), values, 'power'))
    for mode in ('recsym', 'reciso'):
        cases.append(('resummed_' + mode, lambda mode=mode: T.ResummedBAOWigglesTracerPowerSpectrumMultipoles(
            ells=(0, 2), k=BAO_K, mode=mode, template=T.BAOPowerSpectrumTemplate(z=0.8)), values, 'power'))
    for name in ('SimpleBAOWigglesCorrelationFunctionMultipoles', 'ResummedBAOWigglesCorrelationFunctionMultipoles',
                 'FlexibleBAOWigglesCorrelationFunctionMultipoles', 'SimpleBAOWigglesTracerCorrelationFunctionMultipoles',
                 'ResummedBAOWigglesTracerCorrelationFunctionMultipoles',
                 'FlexibleBAOWigglesTracerCorrelationFunctionMultipoles'):
        cases.append((name, lambda name=name: getattr(T, name)(ells=(0, 2), s=GOLDEN_S,
                                                               template=T.BAOPowerSpectrumTemplate(z=0.8)),
                      dict(values, **{'al0_0': 1e-3, 'al2_-1': 0.1}), 'corr'))
    for mode in ('b-p', 'bphi', 'bfnl'):
        cases.append(('png_' + mode, lambda mode=mode: T.PNGTracerPowerSpectrumMultipoles(ells=(0, 2), k=BAO_K, mode=mode),
                      values, 'power'))
        cases.append(('png_velocity_' + mode, lambda mode=mode: T.PNGTracerVelocityPowerSpectrumMultipoles(
            k=BAO_K, mode=mode), values, 'power'))
    cases.append(('bispectrum_1loop', lambda: T.TreeLevelBispectrumMultipoles(
        template=T.ShapeFitPowerSpectrumTemplate(z=0.8), pt='1loop', ells=(0, 2, (0, 2, 0))), values, 'bispectrum'))
    for name in ('EFTLikeTNSTracerCorrelationFunctionMultipoles', 'TNSTracerCorrelationFunctionMultipoles'):
        for i, chain in enumerate(TNS_XI_CHAINS):
            cases.append(('{}_{:d}'.format(name, i), lambda name=name: getattr(T, name)(
                ells=(0, 2), s=GOLDEN_S, nq_tns=40, nmu_tns=8, template=T.ShapeFitPowerSpectrumTemplate(z=0.8)),
                chain, 'corr'))
    return cases


BISPECTRUM_TRIANGLES = [(0.05, 0.05, 0.05), (0.05, 0.08, 0.1), (0.08, 0.08, 0.1), (0.1, 0.1, 0.12),
                        (0.04, 0.07, 0.09)]


def build_bispectrum_likelihood():
    """The bispectrum observable (monopole and quadrupole, 5 triangles) in
    a Gaussian likelihood with an explicit diagonal covariance."""
    from desilike_tpu.theories import TreeLevelBispectrumMultipoles, ShapeFitPowerSpectrumTemplate
    from desilike_tpu.observables.bispectrum import TracerBispectrumMultipolesObservable
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    theory = TreeLevelBispectrumMultipoles(template=ShapeFitPowerSpectrumTemplate(z=0.8))
    data = {'b1': 2., 'b2': 0.3}
    obs = TracerBispectrumMultipolesObservable(data=data, triangles=BISPECTRUM_TRIANGLES, ells=(0, 2), theory=theory)
    obs.runtime_info.initialize()
    cov = np.diag((0.05 * np.abs(obs.flatdata)) ** 2 + 1e3)
    obs = TracerBispectrumMultipolesObservable(data=data, covariance=cov, triangles=BISPECTRUM_TRIANGLES, ells=(0, 2),
                                               theory=TreeLevelBispectrumMultipoles(
                                                   template=ShapeFitPowerSpectrumTemplate(z=0.8)))
    return ObservablesGaussianLikelihood(observables=[obs])


LYA_POINTS = np.array([[0.6736, 0.12, 3.036394], [0.65, 0.115, 2.98], [0.70, 0.126, 3.10], [0.68, 0.118, 3.05]])


def theories_x64(path):
    """The x64 child of :func:`theories_reference`: adds the x64 arrays to
    ``path``, which holds the emulator's arrays."""
    from desilike_tpu.core import Pipeline
    from desilike_tpu import theories as T
    arrays = dict(np.load(path))
    for name, build, values, attr in theory_cases():
        theory = build()
        arrays['vector:' + name] = theory_vector(theory, values, attr)
        if name.startswith('bao_'):
            arrays['fixed:' + name] = np.array([p.basename for p in Pipeline(theory).params
                                                if p.basename.startswith('al') and p.fixed], dtype='U16')
    like = build_bispectrum_likelihood()
    names = like.pipeline.varied_params.names()
    points = reference_points(names, npoints=4).astype('f4').astype('f8')
    values, grads, _ = evaluate_likelihood(like, names, points)
    arrays.update({'bispectrum_like_names': np.array(names), 'bispectrum_like_points': points,
                   'bispectrum_like_flatdata': np.asarray(like.flatdata, dtype='f8'),
                   'bispectrum_like_logpost_x64': values, 'bispectrum_like_grad_x64': grads})
    lya = []
    for point in LYA_POINTS:
        extractor = T.P1DPowerSpectrumExtractor(cosmo=T.Cosmology(fixed=('h', 'omega_cdm', 'logA')))
        Pipeline(extractor).evaluate(dict(zip(('h', 'omega_cdm', 'logA'), point)))
        lya.append([float(extractor.delta2_star), float(extractor.n_star)])
    arrays['lya_points'], arrays['lya_x64'] = LYA_POINTS, np.array(lya)
    weights = emulator_weights(arrays)
    template = T.DirectPowerSpectrumTemplate(z=0.8, k=BAO_K, engine='emulator', emulator=weights)
    pipe = Pipeline(template)
    pk, pknow, fk, rs = [], [], [], []
    for point in EMU_POINTS:
        pipe.evaluate({'h': point[0], 'omega_cdm': point[1], 'logA': point[2]})
        pk.append(np.asarray(template.pk_dd))
        pknow.append(np.asarray(template.pknow_dd))
        fk.append(np.asarray(template.fk))
        rs.append(float(template.cosmo.rs_drag()))
    arrays.update({'emu_template_pk_x64': np.array(pk), 'emu_template_pknow_x64': np.array(pknow),
                   'emu_template_fk_x64': np.array(fk), 'emu_template_rs_x64': np.array(rs)})
    np.savez(path, **arrays)


def theories_reference():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    env = dict(os.environ, JAX_PLATFORMS='cpu', JAX_ENABLE_X64='1', DESILIKE_TPU_X64='1')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'theories.npz')
        np.savez(path, **emulator_reference())
        subprocess.run([sys.executable, os.path.abspath(__file__), '--x64-theories', path], env=env, check=True)
        return dict(np.load(path))


def build_reduced_joint(step=0.02):
    """Config 4 with wider k bins (``tests/test_torch_joint_reduced.py``)."""
    from desilike_tpu import theories
    from desilike_tpu.theories import full_shape
    from desilike_tpu import observables as observables_module
    from desilike_tpu import likelihoods
    observables, footprints = [], []
    for tracer, z, b1 in [('LRG', 0.8, 2.0), ('ELG', 1.1, 1.3)]:
        fs_theory = full_shape.EFTLikeKaiserTracerPowerSpectrumMultipoles(
            ells=(0, 2), template=theories.ShapeFitPowerSpectrumTemplate(z=z, namespace=tracer), namespace=tracer)
        fs_theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
        observables.append(observables_module.TracerPowerSpectrumMultipolesObservable(
            data={'{}.b1'.format(tracer): b1}, klim={0: (0.02, 0.2, step), 2: (0.02, 0.2, step)}, theory=fs_theory))
        footprints.append(observables_module.BoxFootprint(volume=2e9, nbar=5e-4))
        bao_theory = theories.DampedBAOWigglesTracerPowerSpectrumMultipoles(
            ells=(0, 2), template=theories.BAOPowerSpectrumTemplate(z=z, namespace=tracer + 'bao'),
            namespace=tracer + 'bao')
        bao_theory.init.params = {'al*': dict(derived='.marg')}
        observables.append(observables_module.TracerPowerSpectrumMultipolesObservable(
            data={'{}bao.b1'.format(tracer): b1}, klim={0: (0.02, 0.3, step), 2: (0.02, 0.3, step)},
            theory=bao_theory))
        footprints.append(observables_module.BoxFootprint(volume=2e9, nbar=5e-4))
    return likelihoods.ObservablesGaussianLikelihood(observables=observables, footprints=footprints)


def tier1_reference():
    """``torch_port_tier1_reference.npz`` (float32, as the tests ran them
    live): the reduced config 4 at the first 4 points of the joint reference
    with the directions of ``tests/test_torch_joint_reduced.py`` (one eager
    ``jax.jvp`` over all points and directions), its theory vector and
    whitened residual at 2 points with the solved parameters given; the EPT
    theory with quadrature loops (nr 32, nx 16) at the golden point and 1.01
    times it; the simple damped-Kaiser tracer on a Standard template at b1
    1.8 and 1.818; the Kaiser tracer on a Direct template with the eh99
    engine at h 0.66 and 0.7."""
    import jax
    import jax.numpy as jnp
    from desilike_tpu.core import Pipeline
    from desilike_tpu.theories import EPTTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate
    jax.config.update('jax_platforms', 'cpu')
    joint = np.load(OUTPUTS['joint'])
    ref = build_reduced_joint()
    names = ref.pipeline.varied_params.names()
    solved_names = ref.pipeline.solved_params.names()
    logpost = ref.logpost_fn(jit=False)

    def scalar(theta):
        value, aux = logpost(dict(zip(names, theta)))
        return value, jnp.stack([aux['solved'][name] for name in solved_names])

    def with_derivative(theta, direction):
        value, derivative, solved = jax.jvp(scalar, (theta,), (direction,), has_aux=True)
        return value, solved, derivative

    rows = [np.eye(len(names))[names.index(name)] for name in ('LRG.dm', 'ELG.dm', 'LRG.df', 'ELG.df')]
    rng = np.random.default_rng(11)
    rows += [v / np.linalg.norm(v) for v in rng.normal(size=(3, len(names)))]
    toward = np.array(rows, dtype='f4')
    points = joint['points'][:4].astype('f4')
    values, solved, derivatives = jax.vmap(jax.vmap(with_derivative, in_axes=(0, None)), in_axes=(None, 0))(
        jnp.asarray(points), jnp.asarray(toward))
    arrays = {'reduced_names': np.array(names), 'reduced_solved_names': np.array(solved_names),
              'reduced_param_names': np.array(ref.pipeline.params.names()),
              'reduced_calculators': np.array([type(c).__name__ for c in ref.pipeline.calculators]),
              'reduced_sizes': np.array([len(obs.flatdata) for obs in ref.observables]),
              'reduced_flatdata': np.asarray(ref.flatdata, dtype='f8'),
              'reduced_covariance': np.asarray(ref.covariance, dtype='f8'),
              'reduced_static': np.array(ref._static_linear_indices(ref.pipeline, ref.pipeline.solved_params,
                                                                    ref.likelihoods)),
              'reduced_points': points, 'reduced_directions': toward,
              'reduced_logpost': np.asarray(values[0], dtype='f8'), 'reduced_solved': np.asarray(solved[0], dtype='f8'),
              'reduced_derivatives': np.asarray(derivatives, dtype='f8').T}
    # the theory vector and whitened residual with all 48 parameters given (seeded solved values)
    rng = np.random.default_rng(3)
    theory, residual, given = [], [], []
    for row in points[:2]:
        point = dict(zip(names, (float(v) for v in row)))
        for name in solved_names:
            point[name] = float(np.float32(rng.normal() * (1. if '.ct' in name else 100.)))
        ref.pipeline.evaluate(point)
        given.append([point[name] for name in solved_names])
        theory.append(np.asarray(ref.flattheory(), dtype='f8'))
        residual.append(np.asarray(ref.flatdiff_white, dtype='f8'))
    arrays.update({'reduced_given_solved': np.array(given), 'reduced_flattheory': np.array(theory),
                   'reduced_flatdiff_white': np.array(residual)})
    golden = {'qpar': 1.02, 'qper': 0.98, 'b1': 1.8, 'df': 1.05, 'dm': 0.02, 'sn0': 500., 'ct0_2': 10., 'ct2_2': 5.,
              'b2': 0.5, 'bs': -0.2}
    theory = EPTTracerPowerSpectrumMultipoles(template=ShapeFitPowerSpectrumTemplate(z=0.8), ells=(0, 2),
                                              k=np.linspace(0.02, 0.3, 29), loop_method='quadrature', nr=32, nx=16)
    pipe = Pipeline(theory)
    values = {key: value for key, value in golden.items() if key in set(pipe.params.basenames())}
    powers = []
    for scale in (1., 1.01):
        pipe.evaluate({key: scale * value for key, value in values.items()})
        powers.append(np.asarray(theory.power, dtype='f8'))
    arrays['ept_quadrature_power'] = np.array(powers)
    from desilike_tpu.theories import SimpleTracerPowerSpectrumMultipoles, StandardPowerSpectrumTemplate
    theory = SimpleTracerPowerSpectrumMultipoles(ells=(0, 2, 4), k=np.linspace(0.02, 0.3, 29),
                                                 template=StandardPowerSpectrumTemplate(z=0.8))
    pipe = Pipeline(theory)
    values = {'qpar': 1.02, 'qper': 0.98, 'b1': 1.8, 'sn0': 500., 'sigmapar': 4., 'sigmaper': 2., 'df': 1.05}
    powers = []
    for b1 in (1.8, 1.818):
        pipe.evaluate(dict(values, b1=b1))
        powers.append(np.asarray(theory.power, dtype='f8'))
    arrays['simple_tracer_power'] = np.array(powers)
    arrays['simple_tracer_params'] = np.array(pipe.params.names())
    from desilike_tpu.theories import KaiserTracerPowerSpectrumMultipoles, DirectPowerSpectrumTemplate
    theory = KaiserTracerPowerSpectrumMultipoles(ells=(0, 2), k=np.linspace(0.02, 0.3, 29),
                                                 template=DirectPowerSpectrumTemplate(z=0.8, engine='eh99'))
    pipe = Pipeline(theory)
    powers = []
    for h in (0.66, 0.7):
        pipe.evaluate({'b1': 1.8, 'h': h})
        powers.append(np.asarray(theory.power, dtype='f8'))
    arrays['kaiser_eh99_power'] = np.array(powers)
    return arrays


def build_files_likelihood(directory, small=False):
    """Config 3f in the JAX package: config 3d (:func:`build_ept_direct_likelihood`)
    fed from the files that ``chip_smoke.write_files`` wrote into
    ``directory``, as ``chip_smoke.build_files_likelihood`` builds it in the
    port (the same layout, fiber collisions and systematic templates)."""
    import chip_smoke
    from desilike_tpu.theories import EPTTracerPowerSpectrumMultipoles, DirectPowerSpectrumTemplate
    from desilike_tpu.observables import (TracerPowerSpectrumMultipolesObservable,
                                          TopHatFiberCollisionsPowerSpectrumMultipoles)
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    layout = chip_smoke.files_layout(small)
    template = DirectPowerSpectrumTemplate(z=0.8, **({'varied': layout['varied']} if layout['varied'] else {}))
    theory = EPTTracerPowerSpectrumMultipoles(ells=chip_smoke.FILES_ELLS, template=template, **layout['ept'])
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(
        data=os.path.join(directory, 'data.npy'), covariance=[os.path.join(directory, 'mock_*.npy')],
        wmatrix=os.path.join(directory, 'wmatrix.npy'),
        klim={ell: (0.02, 0.2, layout['step']) for ell in chip_smoke.FILES_ELLS}, kinlim=chip_smoke.FILES_KINLIM,
        fiber_collisions=TopHatFiberCollisionsPowerSpectrumMultipoles(**chip_smoke.FILES_FIBER_COLLISIONS),
        systematic_templates=chip_smoke.SYSTEMATIC_TEMPLATES, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable])
    like.pipeline.params.update({'syst_*': dict(derived='.marg')}, basename=True)
    return like


def files_fiducial_power(small=False):
    """The EPT multipoles (0, 2, 4) of config 3f's theory on the window's
    input grid at b1 = 2 (the other parameters at their defaults), from
    which ``chip_smoke.write_files`` makes the data and the mocks."""
    import chip_smoke
    from desilike_tpu.theories import EPTTracerPowerSpectrumMultipoles, DirectPowerSpectrumTemplate
    layout = chip_smoke.files_layout(small)
    template = DirectPowerSpectrumTemplate(z=0.8, **({'varied': layout['varied']} if layout['varied'] else {}))
    theory = EPTTracerPowerSpectrumMultipoles(ells=chip_smoke.FILES_ELLS, k=layout['kin'], template=template,
                                              **layout['ept'])
    theory.pipeline.evaluate({'b1': 2.})
    return np.asarray(theory.power, dtype='f8')


def window_offset(window):
    """The constant that the JAX package's P(k) window adds per evaluation,
    as one vector: its folded fiber-collision term and its shot-noise
    response (``desilike_tpu/observables/window.py:363-392``)."""
    flat_ells = np.concatenate([np.full(len(kk), float(ell == 0)) for ell, kk in zip(window.ells, window.k)])
    offset = np.zeros(flat_ells.size) if window._offset is None else np.asarray(window._offset, dtype='f8')
    sn = window.shotnoise
    if sn and window._wshotnoise is not None:
        offset = offset - sn * (flat_ells - np.asarray(window._wshotnoise))
    elif sn:
        nin = len(window.kin)
        if 0 in window.ellsin:
            i0 = window.ellsin.index(0)
            offset = offset + sn * np.asarray(window.wmatrix)[:, i0 * nin:(i0 + 1) * nin].sum(axis=1)
        offset = offset - sn * flat_ells
    return offset


def files_state(like, prefix):
    """The host state of config 3f's JAX likelihood (its ``logpost_fn``
    built, so its whitening holds the Percival factor): what
    ``desilike_tpu_torch.interop.state_from_numpy`` loads, the mock factors
    and the inputs they come from."""
    pipe = like.pipeline
    window = like.observables[0].wmatrix
    solved = pipe.solved_params
    static_idx = like._static_linear_indices(pipe, solved, like.likelihoods)
    (static_J,) = like._compute_static_J(pipe, solved.names(), static_idx, like.likelihoods)
    whiten, base = np.asarray(like._whiten, dtype='f8'), np.asarray(like._whiten_base, dtype='f8')
    arrays = dict(flatdata=like.flatdata, whiten=whiten, whiten_base=base, static_J=static_J,
                  static_names=np.array([solved[i].name for i in static_idx]),
                  wmatrix=window.wmatrix, offset=window_offset(window), templates=window._templates, kin=window.kin,
                  k=np.array(window.k), covariance=like.observables[0].covariance, hartlap=like.hartlap,
                  percival=np.sum(base ** 2) / np.sum(whiten ** 2), nmocks=like._nmocks,
                  pk_dd_fid=window.theory.template.pk_dd_fid, pknow_dd_fid=window.theory.template.pknow_dd_fid)
    return {prefix + key: np.asarray(value) for key, value in arrays.items()}


# the options of the xi observable whose raises tests/test_torch_unported.py held, now compared: the theory, its
# bins, and the log-posterior at two points (b1, and the template amplitude where there is one)
XI_OPTION_SLIM = {0: (48., 152., 4.), 2: (48., 152., 4.)}
XI_OPTION_POINTS = {'fiber_collisions': [[2.0], [2.1]], 'systematic_templates': [[2.0, 0.], [2.1, 3e-4]],
                    'array_data': [[2.0], [2.1]], 'covariance': [[2.0], [2.1]]}


def xi_option_likelihood(case, data=None):
    """The damped BAO xi observable of :data:`XI_OPTION_SLIM` with the
    option ``case`` in a Gaussian likelihood (footprint 2e9, 5e-4 unless
    the observable carries its covariance)."""
    from desilike_tpu.theories import DampedBAOWigglesTracerCorrelationFunctionMultipoles, BAOPowerSpectrumTemplate
    from desilike_tpu.observables import (TracerCorrelationFunctionMultipolesObservable, BoxFootprint,
                                          TopHatFiberCollisionsCorrelationFunctionMultipoles)
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    theory = DampedBAOWigglesTracerCorrelationFunctionMultipoles(ells=(0, 2), template=BAOPowerSpectrumTemplate(z=0.8))
    kwargs = {'fiber_collisions': dict(fiber_collisions=TopHatFiberCollisionsCorrelationFunctionMultipoles(fs=0.5, Dfc=20.)),
              'systematic_templates': dict(systematic_templates={'syst': np.ones(52)}),
              'array_data': dict(data=data), 'covariance': dict(covariance=1e-6 * np.eye(52))}[case]
    observable = TracerCorrelationFunctionMultipolesObservable(slim=XI_OPTION_SLIM, theory=theory,
                                                               **dict(dict(data={'b1': 2.}), **kwargs))
    footprints = None if case == 'covariance' else [BoxFootprint(volume=2e9, nbar=5e-4)]
    return ObservablesGaussianLikelihood(observables=[observable], footprints=footprints)


# the compression observables at the extractors' settings of tests/test_torch_templates.py
COMPRESSION_CASES = {'BAOCompressionObservable': dict(z=0.8), 'ShapeFitCompressionObservable': dict(z=0.8),
                     'StandardCompressionObservable': dict(z=0.8), 'WiggleSplitCompressionObservable': dict(z=0.8),
                     'BandVelocityCompressionObservable': dict(z=0.8, kp=BAND_KP),
                     'TurnOverCompressionObservable': dict(z=0.8), 'P1DCompressionObservable': dict(z=3.),
                     'BAOPhaseShiftCompressionObservable': dict(z=0.8)}
# the BAO compression likelihood: DM/rd and DH/rd at z = 0.8 with 1.5% and 2.5% errors, correlated at -0.4, and
# h, omega_cdm, omega_b varied
BAO_COMPRESSION = dict(z=0.8, data=[17.9, 20.5], varied=('h', 'omega_cdm', 'omega_b'))


def bao_compression_covariance():
    sigma = np.array([0.015 * 17.9, 0.025 * 20.5])
    return np.outer(sigma, sigma) * np.array([[1., -0.4], [-0.4, 1.]])


def build_bao_compression_likelihood():
    from desilike_tpu.theories import Cosmology
    from desilike_tpu.observables import BAOCompressionObservable
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    cosmo = Cosmology()
    cosmo.init.params = {name: dict(fixed=False) for name in BAO_COMPRESSION['varied']}
    observable = BAOCompressionObservable(data=BAO_COMPRESSION['data'], covariance=bao_compression_covariance(),
                                          z=BAO_COMPRESSION['z'], cosmo=cosmo)
    return ObservablesGaussianLikelihood(observables=[observable])


def cutsky_cases():
    """The cut-sky footprints of the port's tests: one redshift bin with a
    constant density, and an n(z) profile over three bins."""
    return [dict(area=1000., zrange=(0.6, 1.0), nbar=5e-4),
            dict(area=14000., zrange=(0.4, 0.6, 0.8, 1.1), nbar=(3e-4, 5e-4, 2e-4))]


def observables_reference(path):
    """``torch_port_observables_reference.npz`` in x64, written to ``path``:
    config 3f's fiducial multipoles (``fiducial_power``, and
    ``small_fiducial_power`` at the small width) on its window's input grid;
    config 3f at the small width, from files written with them, its host
    state (:func:`files_state`, prefixed ``small_``) and its log-posterior,
    gradient and solved parameters at 16 points; config 3f at full width,
    its mock factors and the same at 16 points; the xi observable's options
    (:func:`xi_option_likelihood`) at two points each; the compression
    observables' flat theories at the extractors' two points and the BAO
    compression likelihood at 16 points; the bispectrum likelihood with a
    covariance from 40 mocks at its 4 points; the cut-sky footprints."""
    import chip_smoke
    from desilike_tpu.core import Pipeline
    from desilike_tpu import observables as O
    from desilike_tpu.theories import Cosmology
    arrays = {'fiducial_power': files_fiducial_power(), 'small_fiducial_power': files_fiducial_power(small=True)}
    for prefix, small in (('small_', True), ('', False)):
        with tempfile.TemporaryDirectory() as tmp:
            chip_smoke.write_files(tmp, chip_smoke.FILES_SEED, small=small,
                                   fiducial_power=arrays[prefix + 'fiducial_power'])
            like = build_files_likelihood(tmp, small=small)
            names = like.pipeline.varied_params.names()
            points = reference_points(names).astype('f4').astype('f8')
            values, grads, solved = evaluate_likelihood(like, names, points)
            arrays.update({prefix + 'names': np.array(names), prefix + 'points': points,
                           prefix + 'solved_names': np.array(returned_solved_names(like)),
                           prefix + 'logpost_x64': values, prefix + 'grad_x64': grads, prefix + 'solved_x64': solved})
            state = files_state(like, prefix)
            if small:
                arrays.update(state)
            else:
                arrays.update({key: state[key] for key in ('hartlap', 'percival', 'nmocks', 'flatdata', 'offset')})
    data = None
    for case, points in XI_OPTION_POINTS.items():
        like = xi_option_likelihood(case, data=data)
        like.runtime_info.initialize()
        if case == 'fiber_collisions':
            data = 1.0005 * np.asarray(like.flatdata)  # the array case's data: 0.05% off the generated data
            arrays['xi_option_array_data'] = data
        names = ['b1'] + [name for name in ('syst',) if name in like.pipeline.varied_params.names()]
        values, grads, _ = evaluate_likelihood(like, names, np.array(points, dtype='f8'))
        arrays['xi_option_{}_logpost_x64'.format(case)] = values
        arrays['xi_option_{}_flatdata'.format(case)] = np.asarray(like.flatdata, dtype='f8')
    for case, kwargs in COMPRESSION_CASES.items():
        cosmo = Cosmology()
        cosmo.init.params = {name: dict(fixed=False) for name in EXTRACTOR_POINTS[0]}
        cls = getattr(O, case)
        nquantities = len(cls._quantities_default(kwargs))
        observable = cls(data=np.ones(nquantities), covariance=np.eye(nquantities), cosmo=cosmo, **kwargs)
        pipe = Pipeline(observable)
        rows = []
        for values in EXTRACTOR_POINTS:
            pipe.evaluate(values)
            rows.append(np.asarray(observable.flattheory, dtype='f8'))
        arrays['compression_' + case] = np.array(rows)
    like = build_bao_compression_likelihood()
    names = like.pipeline.varied_params.names()
    points = reference_points(names).astype('f4').astype('f8')
    values, grads, _ = evaluate_likelihood(like, names, points)
    arrays.update({'bao_compression_names': np.array(names), 'bao_compression_points': points,
                   'bao_compression_logpost_x64': values, 'bao_compression_grad_x64': grads})
    like = build_bispectrum_likelihood()
    names = like.pipeline.varied_params.names()
    points = reference_points(names, npoints=4).astype('f4').astype('f8')
    flatdata = np.asarray(like.flatdata, dtype='f8')
    mocks = flatdata * (1. + 0.05 * np.random.default_rng(7).standard_normal((40, flatdata.size)))
    from desilike_tpu.theories import TreeLevelBispectrumMultipoles, ShapeFitPowerSpectrumTemplate
    from desilike_tpu.likelihoods import ObservablesGaussianLikelihood
    observable = O.TracerBispectrumMultipolesObservable(
        data=flatdata, covariance=list(mocks), triangles=BISPECTRUM_TRIANGLES, ells=(0, 2),
        theory=TreeLevelBispectrumMultipoles(template=ShapeFitPowerSpectrumTemplate(z=0.8)))
    like = ObservablesGaussianLikelihood(observables=[observable])
    values, grads, _ = evaluate_likelihood(like, names, points)
    arrays.update({'bispectrum_mocks': mocks, 'bispectrum_mocks_logpost_x64': values,
                   'bispectrum_mocks_grad_x64': grads, 'bispectrum_mocks_hartlap': like.hartlap,
                   'bispectrum_mocks_whiten': np.asarray(like._whiten, dtype='f8')})
    for i, kwargs in enumerate(cutsky_cases()):
        footprint = O.CutskyFootprint(**kwargs)
        arrays['cutsky_{:d}'.format(i)] = np.array([float(footprint.volume), float(footprint.size), footprint.zeff,
                                                    float(np.mean(footprint.nbar)), float(footprint.shotnoise)])
    np.savez(path, **{key: np.asarray(value) for key, value in arrays.items()})


def build_probes_likelihood(directory):
    """Config 3j in the JAX package, as ``chip_smoke.build_probes_likelihood``
    builds it in the port: config 3d + the CMB distance prior + DES-Y5
    supernovae (the files ``chip_smoke.write_probe_files`` wrote into
    ``directory``, ``Mb`` marginalized) + BBN, on config 3d's one
    ``Cosmology`` node."""
    from desilike_tpu.likelihoods import (SumLikelihood, CMBDistancePriorLikelihood, DESY5SNLikelihood,
                                          Schoneberg2024BBNLikelihood)
    from desilike_tpu.theories import DirectPowerSpectrumTemplate
    direct = build_ept_direct_likelihood()
    cosmo = next(calc for calc in direct.pipeline.calculators if isinstance(calc, DirectPowerSpectrumTemplate)).cosmo
    supernovae = DESY5SNLikelihood(data_dir=directory, cosmo=cosmo)
    supernovae.init.params = {'Mb': dict(derived='.marg')}
    return SumLikelihood(likelihoods=[direct, CMBDistancePriorLikelihood(cosmo=cosmo), supernovae,
                                      Schoneberg2024BBNLikelihood(cosmo=cosmo)])


def varied_cosmology(names, **kwargs):
    from desilike_tpu.theories import Cosmology
    cosmo = Cosmology(**kwargs)
    cosmo.init.params = {name: dict(fixed=False) for name in names}
    return cosmo


# the points of the theta=True check and of the external likelihoods: uniform draws from np.random.default_rng(2)
# within these half-widths of the centres
THETA_CENTER = {'theta_MC_100': 1.04109, 'omega_cdm': 0.12, 'omega_b': 0.02237}
THETA_WIDTH = {'theta_MC_100': 0.002, 'omega_cdm': 0.006, 'omega_b': 0.0008}
EXTERNAL_CENTER = {'h': 0.6736, 'omega_cdm': 0.12, 'omega_b': 0.02237, 'N_ur': 2.0328, 'Mb': -19.263, 'dM': -9.2}
EXTERNAL_WIDTH = {'h': 0.02, 'omega_cdm': 0.006, 'omega_b': 0.0008, 'N_ur': 0.3, 'Mb': 0.1, 'dM': 0.1}


def uniform_points(names, center, width, npoints, seed):
    rng = np.random.default_rng(seed)
    return np.column_stack([center[name] + width[name] * rng.uniform(-1., 1., npoints) for name in names])


def external_cases():
    """{case: (the JAX likelihood, its varied names)} of the external
    likelihoods frozen by the ``probes`` mode."""
    from desilike_tpu.likelihoods import (Schoneberg2024BBNLikelihood, Riess2020H0Likelihood, Riess2020MbLikelihood,
                                          CMBDistancePriorLikelihood)
    return {'bbn': Schoneberg2024BBNLikelihood(cosmo=varied_cosmology(('omega_b', 'N_ur'))),
            'h0': Riess2020H0Likelihood(cosmo=varied_cosmology(('h',))),
            'mb': Riess2020MbLikelihood(),
            'cmb_prior': CMBDistancePriorLikelihood(cosmo=varied_cosmology(('h', 'omega_cdm', 'omega_b')))}


# the supernova dataset fixtures of the ``probes`` mode: {case: (class name, columns, writer keywords, config name)}
SN_CASES = {'pantheon': ('PantheonSNLikelihood', ('zcmb', 'zhel', 'mb'), dict(config_fn='full_long.dataset')),
            'pantheonplus': ('PantheonPlusSNLikelihood', ('zHD', 'zHEL', 'm_b_corr'), dict(header='')),
            'pantheonplus_shoes': ('PantheonPlusSHOESSNLikelihood',
                                   ('zHD', 'zHEL', 'm_b_corr', 'IS_CALIBRATOR', 'CEPH_DIST'), dict(header='')),
            'union3': ('Union3SNLikelihood', ('zcmb', 'mb'), {}),
            'desy5': ('DESY5SNLikelihood', ('zHD', 'zHEL', 'MU', 'MUERR_FINAL'), dict(header='', sep=','))}


def sn_fixture(case, n=30, seed=5):
    """The light-curve columns and the covariance of supernova fixture
    ``case`` (its columns of :data:`SN_CASES`): redshifts from 0.004 (two
    below the Pantheon+ cut) to 1.4, magnitudes from the fiducial cosmology
    (``Mb`` -19.3, ``dM`` -9.2) plus 0.05 of scatter, a dense covariance."""
    from desilike_tpu.cosmology import background as bg
    rng = np.random.default_rng(seed)
    z = np.concatenate([[0.004, 0.008], np.linspace(0.02, 1.4, n - 2)])
    zhel = z + rng.normal(0., 5e-4, n)
    p = bg.resolve()
    dl = (1. + z) * np.asarray(bg.comoving_angular_distance(p, z), dtype='f8')
    mu = 5. * np.log10(dl / p['h']) + 25.
    scatter = 0.05 * rng.standard_normal(n)
    covariance = 0.03 ** 2 * np.exp(-0.5 * ((z[:, None] - z[None, :]) / 0.3) ** 2) + 0.05 ** 2 * np.eye(n)
    columns = {'zcmb': z, 'zHD': z, 'zhel': zhel, 'zHEL': zhel, 'mb': mu - 19.3 + scatter,
               'm_b_corr': mu - 19.3 + scatter, 'MU': mu + scatter, 'MUERR_FINAL': np.full(n, 0.05),
               'IS_CALIBRATOR': (np.arange(n) % 6 == 0).astype('f8'), 'CEPH_DIST': mu + 0.01 * scatter}
    if case == 'union3':
        columns['mb'] = 5. * np.log10(100. * dl) + 25. - 9.2 + scatter
    return {name: columns[name] for name in SN_CASES[case][1]}, covariance


def probes_reference(path):
    """``torch_port_probes_reference.npz`` in x64, written to ``path``:
    config 3j (:func:`build_probes_likelihood`) at full width (1829
    supernovae) and small (64), its log-posterior, gradient and solved
    parameters at 16 points (``probes_`` and ``probes_small_`` keys);
    ``Cosmology(theta=True)``'s h and its gradient in (theta_MC_100,
    omega_cdm, omega_b) at 16 points; each external likelihood and each
    supernova dataset class (from files written by the JAX package's writer
    from :func:`sn_fixture`) at 4 points; the recombination-era quantities
    at the fiducial and at the theta points; the CMB family (:func:`cmb_reference`)."""
    import chip_smoke
    import jax
    import jax.numpy as jnp
    from desilike_tpu.cosmology import background as bg
    from desilike_tpu import likelihoods as L
    from desilike_tpu.likelihoods.supernovae import write_sn_dataset
    arrays = cmb_reference()
    for prefix, small in (('probes_small_', True), ('probes_', False)):
        with tempfile.TemporaryDirectory() as tmp:
            arrays[prefix + 'nsn'] = chip_smoke.write_probe_files(tmp, chip_smoke.PROBES_SEED, small=small)
            like = build_probes_likelihood(tmp)
            names = like.pipeline.varied_params.names()
            points = reference_points(names).astype('f4').astype('f8')
            values, grads, solved = evaluate_likelihood(like, names, points)
            arrays.update({prefix + 'names': np.array(names), prefix + 'points': points,
                           prefix + 'solved_names': np.array(returned_solved_names(like)),
                           prefix + 'logpost_x64': values, prefix + 'grad_x64': grads, prefix + 'solved_x64': solved})
    names = list(THETA_CENTER)
    points = uniform_points(names, THETA_CENTER, THETA_WIDTH, NPOINTS, seed=2).astype('f4').astype('f8')
    cosmo = varied_cosmology(names, theta=True)
    cosmo.runtime_info.initialize()

    def solved_h(x):
        cosmo.calculate(**dict(zip(names, x)))
        return cosmo.h

    h, dh = jax.jit(jax.vmap(jax.value_and_grad(solved_h)))(jnp.asarray(points))
    arrays.update({'theta_names': np.array(names), 'theta_points': points, 'theta_h_x64': np.asarray(h),
                   'theta_grad_x64': np.asarray(dh)})
    recombination = []
    for row in [None] + list(points):
        p = bg.resolve({} if row is None else {'h': 0.6736, 'omega_cdm': row[1], 'omega_b': row[2]})
        zs = float(bg.z_star(p))
        recombination.append([zs, float(bg.sound_horizon(p, zs)), float(bg.comoving_angular_distance(p, zs)),
                              float(bg.theta_star_100(p))])
    arrays['recombination_x64'] = np.array(recombination)  # z_*, r_s(z_*), D_M(z_*), 100 theta_*
    for case, like in external_cases().items():
        names = like.pipeline.varied_params.names()
        points = uniform_points(names, EXTERNAL_CENTER, EXTERNAL_WIDTH, 4, seed=3).astype('f4').astype('f8')
        values, grads, _ = evaluate_likelihood(like, names, points)
        arrays.update({case + '_names': np.array(names), case + '_points': points, case + '_logpost_x64': values,
                       case + '_grad_x64': grads})
    for case, (cls, _, kwargs) in SN_CASES.items():
        columns, covariance = sn_fixture(case)
        with tempfile.TemporaryDirectory() as tmp:
            write_sn_dataset(tmp, columns, covariance, **kwargs)
            like = getattr(L, cls)(data_dir=tmp, cosmo=varied_cosmology(('h', 'omega_cdm')))
            names = like.pipeline.varied_params.names()
            center = dict(EXTERNAL_CENTER, Mb=0.) if case == 'desy5' else EXTERNAL_CENTER
            points = uniform_points(names, center, EXTERNAL_WIDTH, 4, seed=4).astype('f4').astype('f8')
            values, grads, _ = evaluate_likelihood(like, names, points)
        arrays.update({'sn_{}_{}'.format(case, name): value for name, value in columns.items()})
        arrays.update({'sn_{}_covariance'.format(case): covariance, 'sn_{}_names'.format(case): np.array(names),
                       'sn_{}_points'.format(case): points, 'sn_{}_logpost_x64'.format(case): values,
                       'sn_{}_grad_x64'.format(case): grads})
    np.savez(path, **{key: np.asarray(value) for key, value in arrays.items()})


def cmb_fixtures():
    """The data of the CMB cases (numpy, from ``tests/test_cmb.py``'s
    fixtures and the JAX package's numpy fixture generators)."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import test_cmb as T
    from desilike_tpu.likelihoods.cmb import synthetic_camspec_data, synthetic_planck2018_lensing_data
    out = {}
    plik = T.plik_lite_fixture()
    plik['weights'] = np.full(T.LMAX + 1, 1. / 30)
    out['plik'] = plik
    ells = np.arange(2, 30)
    dl_true = T.TABLES['tt'][2:30] * T.MUK2 * ells * (ells + 1) / (2 * np.pi)
    sig = 0.1 * np.abs(dl_true) + 10.
    grid = dl_true[:, None] + np.linspace(-8, 8, 200)[None, :] * sig[:, None]
    out['commander'] = dict(cl2x=np.stack([grid, (grid - dl_true[:, None]) / sig[:, None]], axis=-1),
                            mu=np.zeros(28), covariance=np.eye(28), mu_sigma=dl_true)
    # simall: the EE D_ell of ell = 2-29 moved inside the table's domain, as in test_eelowl_prob_table
    dl_ee = np.clip(T.TABLES['ee'][2:30] * T.MUK2 * ells * (ells + 1) / (2 * np.pi), 1e-3, 0.25)
    bins = 1e-4 * (0.5 + np.arange(3000))
    out['simall_ee'] = T.TABLES['ee'].copy()
    out['simall_ee'][2:30] = dl_ee * 2 * np.pi / (ells * (ells + 1)) / T.MUK2
    out['simall'] = dict(prob=-0.5 * ((bins[None, :] - dl_ee[:, None]) / (0.1 * dl_ee[:, None])) ** 2)
    # lollipop: the data's BB 10% above the model's, so that the two fields' H&L eigenvalues differ
    out['lollipop'] = T.lollipop_fixture()
    out['lollipop']['cl'][1] *= 1.1
    act = T.act_fixture()
    act['dN1_tt'] = np.full(act['dN1_tt'].shape, 1e-9)
    act['dAL_dC'][0] = 1e-8 * np.eye(act['dAL_dC'].shape[1])
    out['act'] = act
    out['lensing'] = synthetic_planck2018_lensing_data(variant='consext8', ellmax_pp=400, ellmax_cmb=1400,
                                                       cl_tables=T.TABLES)
    out['lensing_marged'] = synthetic_planck2018_lensing_data(variant='CMBmarged', ellmax_pp=400, ellmax_cmb=1400,
                                                              cl_tables=T.TABLES)
    out['camspec'] = synthetic_camspec_data(T.TABLES, seed=11, params=dict(
        amp_143=12., amp_217=25., amp_143x217=17., n_143=1.2, n_217=0.8, n_143x217=1., cal2=1.003, calTE=0.995,
        calEE=1.002, A_planck=1.001))
    out['hillipop'] = hillipop_fixture(T.TABLES, T.MUK2)
    return out


def hillipop_fixture(tables, muk2, lmax=200, nxspec=15, nxfreq=6, zero_weights=False):
    """The compact hillipop fixture of ``tests/test_cmb.py::test_hillipop_real_file_roundtrip``
    (multipoles 50-180, errors 0.01% of the signal, non-trivial weights, dust
    and tSZ/kSZ templates); with ``zero_weights``, the weights at ell < 2
    zero as there (the JAX package's gradient is then NaN: its weighted
    average divides 0 by 0 at ell < 2, outside the selected multipoles, and
    the NaN reaches the gradient through them)."""
    ells = np.arange(lmax + 1).astype('f8')
    fac = ells * (ells + 1) / (2 * np.pi) * muk2
    dlth = {m: tables[m.lower()][:lmax + 1] * fac for m in ('TT', 'EE', 'TE')}
    flat = np.concatenate([dlth[m][50:181] for m in ('TT', 'EE', 'TE') for _ in range(nxfreq)])
    data = dict(dldata={m: np.tile(dlth[m], (nxspec, 1)) for m in ('TT', 'EE', 'TE')},
                lmins={m: np.full(nxfreq, 50) for m in ('TT', 'EE', 'TE')},
                lmaxs={m: np.full(nxfreq, 180) for m in ('TT', 'EE', 'TE')},
                invcov=np.diag(1. / (1e-4 * np.abs(flat) + 1e-3) ** 2))
    rng = np.random.default_rng(3)
    data['dlweight'] = {m: 1. + rng.random(data['dldata'][m].shape) for m in data['dldata']}
    for m in data['dlweight']:
        data['dlweight'][m][:, :2] = 0. if zero_weights else data['dlweight'][m][:, :2]
    data['templates'] = {'dust_TT': rng.random((nxfreq, lmax + 1)), 'tsz': rng.random(lmax + 1),
                         'ksz': rng.random(lmax + 1)}
    return data


def hillipop_data(fixture, modes):
    """The hillipop fixture cut to ``modes`` (its precision to their blocks)."""
    sizes = {m: len(fixture['lmins'][m]) * int(fixture['lmaxs'][m][0] - fixture['lmins'][m][0] + 1)
             for m in ('TT', 'EE', 'TE')}
    start = np.cumsum([0] + [sizes[m] for m in ('TT', 'EE', 'TE')])
    keep = np.concatenate([np.arange(start[i], start[i + 1]) for i, m in enumerate(('TT', 'EE', 'TE')) if m in modes])
    return dict(fixture, invcov=fixture['invcov'][np.ix_(keep, keep)])


def cmb_cases(cmb, fixtures, **kwargs):
    """{case: likelihood} of the CMB family, built the same way from the
    module ``cmb`` (the JAX package's ``likelihoods.cmb`` or the port's) on
    the data of :func:`cmb_fixtures`; ``kwargs`` go to each ``ClTheory``
    (the port's ``device``)."""
    import chip_smoke
    response = chip_smoke.cmb_tables()

    def theory(**extra):
        return cmb.ClTheory(**dict(response, **extra, **kwargs))

    simall_tables = dict(response['tables'], ee=fixtures['simall_ee'])
    cases = {
        'plik_ttteee': cmb.TTTEEEHighlPlanck2018LiteLikelihood(theory=theory(), data=fixtures['plik'],
                                                               elllim=(30, 1500)),
        'plik_tt': cmb.TTHighlPlanck2018LiteLikelihood(theory=theory(), data=fixtures['plik'], elllim=(30, 1500)),
        'commander': cmb.TTLowlPlanck2018Likelihood(theory=theory(), data=fixtures['commander']),
        'simall': cmb.EELowlPlanck2018Likelihood(theory=cmb.ClTheory(tables=simall_tables, **kwargs),
                                                 data=fixtures['simall']),
        'lollipop_ee': cmb.EELowlPlanck2020LollipopLikelihood(theory=theory(), data=fixtures['lollipop']),
        'lollipop_bb': cmb.BBLowlPlanck2020LollipopLikelihood(theory=theory(), data=fixtures['lollipop']),
        'lollipop_eb': cmb.EBLowlPlanck2020LollipopLikelihood(theory=theory(), data=fixtures['lollipop']),
        'act': cmb.ACTDR6LensingLikelihood(theory=theory(), data=fixtures['act']),
        'lensing': cmb.Planck2018LensingLikelihood(theory=theory(), data=fixtures['lensing']),
        'lensing_marged': cmb.Planck2018LensingLikelihood(theory=theory(), data=fixtures['lensing_marged'],
                                                          variant='CMBmarged'),
        'camspec_ttteee': cmb.TTTEEEHighlPlanckNPIPECamspecLikelihood(theory=theory(), data=fixtures['camspec']),
        'camspec_tt': cmb.TTHighlPlanckNPIPECamspecLikelihood(theory=theory(), data=fixtures['camspec']),
    }
    for modes, cls in ((('TT', 'EE', 'TE'), 'TTTEEE'), (('TT',), 'TT'), (('EE',), 'EE'), (('TE',), 'TE')):
        cases['hillipop_' + cls.lower()] = getattr(cmb, '{}HighlPlanck2020HillipopLikelihood'.format(cls))(
            theory=theory(), data=hillipop_data(fixtures['hillipop'], modes))
    return cases


def cmb_reference():
    """The CMB family's arrays of the ``probes`` mode: each case of
    :func:`cmb_cases` at 4 points (``cmb_<case>_{names,points,logpost_x64,
    grad_x64}``); the golden Cl emulator through ``ClTheory(emulator=...)``
    (its C_ell at the golden theta, ``cl_emulator_<xy>_x64``); the
    compressed Gaussian likelihoods and the S/N-weighted P(k) likelihood."""
    import chip_smoke
    from desilike_tpu.likelihoods import cmb
    from desilike_tpu.likelihoods import SNWeightedPowerSpectrumLikelihood
    from desilike_tpu.theories import KaiserTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate
    from desilike_tpu.observables import BoxFootprint
    arrays = {}
    cases = cmb_cases(cmb, cmb_fixtures())
    cases['gaussian'] = cmb.Planck2018GaussianLikelihood(cosmo=varied_cosmology(('h', 'omega_cdm', 'omega_b')))
    cases['gaussian_derived'] = cmb.BasePlanck2018GaussianLikelihood(
        cosmo=varied_cosmology(('h', 'omega_cdm', 'omega_b')), quantities=GAUSSIAN_QUANTITIES,
        mean=GAUSSIAN_MEAN, covariance=np.diag(GAUSSIAN_STD) ** 2)
    cases['sn_weighted'] = SNWeightedPowerSpectrumLikelihood(
        theories=[KaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=ShapeFitPowerSpectrumTemplate(z=1.),
                                                      mu=6)],
        data={'b1': 2.0}, footprints=BoxFootprint(volume=1e9, nbar=1e-3), klim=(0.02, 0.2), mu=10)
    for case, like in cases.items():
        names = like.pipeline.varied_params.names()
        if case.startswith('gaussian'):
            points = uniform_points(names, EXTERNAL_CENTER, EXTERNAL_WIDTH, 4, seed=6).astype('f4').astype('f8')
        elif case == 'sn_weighted':  # b1 within 0.1 of its data's, the template at its defaults (test_inference.py:186)
            points = uniform_points(names, {**CENTERS, 'b1': 2.}, {name: 0.1 if name == 'b1' else 0. for name in names},
                                    4, seed=6).astype('f4').astype('f8')
        else:
            points = chip_smoke.cmb_points(names, fine=case.startswith('hillipop'))
        values, grads, _ = evaluate_likelihood(like, names, points)
        arrays.update({'cmb_{}_names'.format(case): np.array(names), 'cmb_{}_points'.format(case): points,
                       'cmb_{}_logpost_x64'.format(case): values, 'cmb_{}_grad_x64'.format(case): grads})
    return arrays


# a compressed Gaussian on derived quantities of the Cosmology node (``BasePlanck2018GaussianLikelihood``)
GAUSSIAN_QUANTITIES = ('H0', 'Omega_m', 'rs_drag_mpc', 'theta_star_100', 'z_star', 'sigma8', 'N_eff', 'logA')
GAUSSIAN_MEAN = (67.4, 0.315, 147.1, 1.0411, 1089.9, 0.811, 3.046, 3.044)
GAUSSIAN_STD = (0.5, 0.007, 0.3, 0.0003, 0.2, 0.006, 0.2, 0.014)


def build_jax_likelihood(config):
    if config == 'bao':
        import __graft_entry__
        return __graft_entry__._build_likelihood()
    if config == 'xi':
        return build_xi_likelihood()
    if config == 'direct':
        return build_ept_direct_likelihood()
    if config == 'ept':
        import importlib.util
        spec = importlib.util.spec_from_file_location('bench_ept', os.path.join(ROOT, 'scripts', 'bench_ept.py'))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.build()
    import bench
    return bench.build_likelihood()


def evaluate(config, names=None, points=None):
    """JAX log-posterior, its gradient and the solved parameters at
    ``points`` (in the package's current dtype; by default the reference
    points of the configuration's varied parameters, rounded to float32),
    and the built likelihood."""
    like = build_jax_likelihood(config)
    if names is None:
        names = like.pipeline.varied_params.names()
        points = reference_points(names).astype('f4')
    return like, names, np.asarray(points, dtype='f8'), evaluate_likelihood(like, names, points)


def evaluate_x64(config, names, points):
    """Run :func:`evaluate` in float64 in a child process."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', JAX_ENABLE_X64='1', DESILIKE_TPU_X64='1')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x64.npz')
        np.savez(path, names=np.array(names), points=points)
        subprocess.run([sys.executable, os.path.abspath(__file__), '--x64', config, path], env=env, check=True)
        out = np.load(path)
        return out['logpost'], out['grad'], out['solved']


def build_reference(config):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    like, names, points, (values, grads, solved) = evaluate(config)  # points exact in float32
    values_x64, grads_x64, solved_x64 = evaluate_x64(config, names, points)
    pipe = like.pipeline

    psolved = pipe.solved_params
    solved_names = psolved.names()
    static_idx = like._static_linear_indices(pipe, psolved, like.likelihoods)
    (static_J,) = like._compute_static_J(pipe, solved_names, static_idx, like.likelihoods)
    arrays = dict(
        flatdata=np.asarray(like.flatdata, dtype='f8'),
        whiten=np.asarray(like._whiten, dtype='f8'),
        static_J=np.asarray(static_J, dtype='f8'),
        names=np.array(names), solved_names=np.array(solved_names),
        points=points,
        logpost=values, grad=grads, solved=solved,
        logpost_x64=values_x64, grad_x64=grads_x64, solved_x64=solved_x64)
    suffixes = [''] if len(like.observables) == 1 else ['.{:d}'.format(i) for i in range(len(like.observables))]
    for observable, suffix in zip(like.observables, suffixes):
        template = observable.wmatrix.theory.template
        arrays['pk_dd_fid' + suffix] = np.asarray(template.pk_dd_fid, dtype='f8')
        arrays['pknow_dd_fid' + suffix] = np.asarray(template.pknow_dd_fid, dtype='f8')
        arrays['wmatrix' + suffix] = np.asarray(observable.wmatrix.wmatrix, dtype='f8')
    if config == 'xi':
        arrays.update(xi_theory_vectors(['kaiser_xi', 'eft_kaiser_xi']))
        arrays.update(run_x64('--x64-xi-extras'))
    if config == 'direct':
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'f32.npz')
            direct_reference(path, x64=False)
            arrays.update(np.load(path))
        arrays.update(run_x64('--x64-direct'))
    return arrays


SAMPLERS_NCHAINS = 8       # the Metropolis steps' batch on the 2-parameter Gaussian
SAMPLERS_NWALKERS = 16     # the ensembles' walkers there
SAMPLERS_NLIVE, SAMPLERS_NBATCH = 64, 16  # the nested batch step's live points and batch there


def host_node_likelihood():
    """The JAX package's likelihood with one host-evaluated node of
    ``tests/test_samplers.py:365-424`` (omega through the host code, b fast)."""
    import jax.numpy as jnp
    from desilike_tpu.core import Calculator
    from desilike_tpu.likelihoods import BaseGaussianLikelihood

    xgrid = np.linspace(0., 1., 40)

    class SlowHost(Calculator):
        _host_eval = True
        _state_attrs = ['shape']
        _params = {'omega': dict(value=0.3, prior=dict(limits=[0.1, 0.5]),
                                 ref=dict(dist='norm', loc=0.3, scale=0.01), proposal=0.01)}

        def calculate(self, omega=0.3, **kw):
            self.shape = jnp.asarray(np.exp(-float(omega) * xgrid))

        def get(self):
            return self.shape

    class HostLike(BaseGaussianLikelihood):
        _params = dict(BaseGaussianLikelihood._params)
        _params.update({'b': dict(value=2., prior=dict(limits=[0.5, 4.]),
                                  ref=dict(dist='norm', loc=2., scale=0.05), proposal=0.02)})

        def initialize(self, **kw):
            self.host = SlowHost()
            super().initialize(data=2. * np.exp(-0.3 * xgrid), covariance=np.eye(40) * 0.01 ** 2)

        def flattheory(self):
            return self._b * self.host.shape

        def calculate(self, b=2., **kw):
            self._b = b
            super().calculate()

    return HostLike()


def eager_scan(log):
    """A stand-in for ``lax.scan`` that loops in Python and appends each
    carry to ``log``: the JAX package's step closures then run eagerly, step
    by step, with their carries read out."""
    import jax
    import jax.numpy as jnp

    def scan(f, carry, xs):
        ys = []
        for x in xs:
            carry, y = f(carry, x)
            log.append(carry)
            ys.append(y)
        return carry, (jax.tree.map(lambda *a: jnp.stack(a), *ys) if ys and ys[0] is not None else None)
    return scan


def mcmc_draws(key, nchains, ndim):
    """The draws of one Metropolis step of the JAX package from its key."""
    import jax
    k1, k2 = jax.random.split(key)
    return np.asarray(jax.random.normal(k1, (nchains, ndim))), np.asarray(jax.random.uniform(k2, (nchains,)))


def stretch_draws(key, half):
    import jax
    out = []
    for k in jax.random.split(key):
        k1, k2, k3 = jax.random.split(k, 3)
        out.append([np.asarray(jax.random.randint(k1, (half,), 0, half)), np.asarray(jax.random.uniform(k2, (half,))),
                    np.asarray(jax.random.uniform(k3, (half,)))])
    return out


def slice_draws(key, half, maxsteps):
    """ia, ib, the slice height's uniform, the bracket offset's and one
    shrink uniform an iteration (maxsteps, half), of both halves."""
    import jax
    import jax.numpy as jnp
    out = []
    for k in jax.random.split(key):
        ia, ib, uy, w, shrink = [], [], [], [], []
        for kk in jax.random.split(k, half):
            ka, kb, ku, kw, ks = jax.random.split(kk, 5)
            a = jax.random.randint(ka, (), 0, half)
            b = jax.random.randint(kb, (), 0, half - 1)
            ia.append(int(a))
            ib.append(int(jnp.where(b >= a, b + 1, b)))
            uy.append(float(jax.random.uniform(ku)))
            w.append(float(jax.random.uniform(kw)))
            row, key_ = [], ks
            for _ in range(maxsteps):
                key_, kt = jax.random.split(key_)
                row.append(float(jax.random.uniform(kt)))
            shrink.append(row)
        out.append([np.array(ia), np.array(ib), np.array(uy, dtype='f4'), np.array(w, dtype='f4'),
                    np.array(shrink, dtype='f4').T])
    return out


def nested_draws(key, nlive, K, S, ndim, iterations=32):
    """pick (K,), the unit directions (S, K, ndim) and the shrink uniforms
    (S, iterations, K) of one batch step of the JAX package from its key."""
    import jax
    import jax.numpy as jnp
    kpick, krep = jax.random.split(key)
    pick = np.asarray(jax.random.randint(kpick, (K,), 0, nlive - K))
    dirs, shrink = np.zeros((S, K, ndim), dtype='f4'), np.zeros((S, iterations, K), dtype='f4')
    for j, kj in enumerate(jax.random.split(krep, K)):
        for i, ki in enumerate(jax.random.split(kj, S)):
            kd, kw = jax.random.split(ki)
            d = jax.random.normal(kd, (ndim,))
            dirs[i, j] = np.asarray(d / jnp.linalg.norm(d))
            key_ = kw
            for it in range(iterations):
                key_, kt = jax.random.split(key_)
                shrink[i, it, j] = float(jax.random.uniform(kt))
    return pick, dirs, shrink


def samplers_reference():
    """The JAX package's samplers and profilers on the 2-parameter Gaussian
    of ``tests/test_samplers.py`` and the host-node likelihood, in float32,
    and, from a child in x64, grid and importance on config 1."""
    import jax
    import jax.numpy as jnp
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from test_torch_sampler_steps import JaxGaussianModel
    from desilike_tpu.samplers import (MCMCSampler, BlockedMCMCSampler, EnsembleSampler, EnsembleSliceSampler,
                                       NestedSampler, mcmc as jax_mcmc)
    from desilike_tpu.profilers import ScipyProfiler, OptaxProfiler
    import optax
    arrays = {}
    rng = np.random.default_rng(42)
    like = JaxGaussianModel()

    # Metropolis: 6 adaptation steps and 2 frozen ones from a start, every carry read out
    sampler = MCMCSampler(like, nchains=SAMPLERS_NCHAINS, seed=3)
    x0 = (np.array([1., -0.5]) + 0.1 * rng.normal(size=(SAMPLERS_NCHAINS, 2))).astype('f4')
    lp0, aux0 = sampler.logpost_batch(jnp.asarray(x0))
    keys = jax.random.split(jax.random.key(11), 8)
    log, scan = [], jax_mcmc.lax.scan
    jax_mcmc.lax.scan = eager_scan(log)
    try:
        sampler._build_phases(6, 2)(jnp.asarray(x0), lp0, aux0, jnp.zeros(()), jnp.asarray(sampler._chol, dtype='f4'),
                                    keys)
    finally:
        jax_mcmc.lax.scan = scan
    draws = [mcmc_draws(k, SAMPLERS_NCHAINS, 2) for k in keys]
    arrays.update(mcmc_x0=x0, mcmc_lp0=np.asarray(lp0), mcmc_chol=sampler._chol, mcmc_z=np.stack([d[0] for d in draws]),
                  mcmc_u=np.stack([d[1] for d in draws]))
    for i, name in enumerate(('x', 'lp', 'aux', 'logscale', 'L', 'wmean', 'wm2', 'count', 'istep')):
        if name != 'aux':
            arrays['mcmc_' + name] = np.stack([np.asarray(c[i]) for c in log[:6]] +
                                              ([np.asarray(c[i]) for c in log[6:]] if i < 5 else []))

    # the blocked sampler on the host-node likelihood, one chain, without and with dragging
    for drag in (0, 2):
        blocked = BlockedMCMCSampler(host_node_likelihood(), nchains=1, seed=5, drag=drag)
        start = np.array([[0.31, 2.02]])
        lp_start = float(blocked.logpost_flat(jnp.asarray(start[0]))[0])
        blocked.get_start = lambda nchains, start=start, lp=lp_start: (start.copy(), np.array([lp]))
        _, sub = jax.random.split(jax.random.key(5))
        seed = int(jax.random.randint(sub, (), 0, 2 ** 31 - 1))
        chain = blocked.run(nsteps=60)
        prefix = 'blocked{}_'.format(drag)
        arrays.update({prefix + 'seed': seed, prefix + 'start': start, prefix + 'names': np.array(blocked.names),
                       prefix + 'x': np.stack([chain[n] for n in blocked.names], axis=-1),
                       prefix + 'lp': chain['logposterior'], prefix + 'acceptance': blocked.diagnostics['acceptance_rate']})

    # stretch and slice ensemble steps from one key each
    half = SAMPLERS_NWALKERS // 2
    xw = (np.array([1., -0.5]) + 0.1 * rng.normal(size=(SAMPLERS_NWALKERS, 2))).astype('f4')
    for name, cls in (('stretch', EnsembleSampler), ('slice', EnsembleSliceSampler)):
        ens = cls(like, nwalkers=SAMPLERS_NWALKERS, seed=1)
        lpw, auxw = ens.logpost_batch(jnp.asarray(xw))
        state = (jnp.asarray(xw), lpw, auxw, jnp.zeros((), dtype=jnp.int32)) + \
            ((jnp.zeros((), dtype=jnp.int32),) if name == 'slice' else ())
        key = jax.random.key(21)
        new, _ = ens._build_step()(state, key)
        draws = stretch_draws(key, half) if name == 'stretch' else slice_draws(key, half, ens.maxsteps)
        arrays.update({'{}_x0'.format(name): xw, '{}_lp0'.format(name): np.asarray(lpw),
                       '{}_x'.format(name): np.asarray(new[0]), '{}_lp'.format(name): np.asarray(new[1]),
                       '{}_naccept'.format(name): int(new[3])})
        if name == 'slice':
            arrays['slice_ncall'] = int(new[4])
        for ihalf, d in enumerate(draws):
            for j, v in enumerate(d):
                arrays['{}_draws{}_{}'.format(name, ihalf, j)] = v

    # one nested batch step
    nested = NestedSampler(like, nlive=SAMPLERS_NLIVE, nbatch=SAMPLERS_NBATCH, seed=2)
    u_live = jax.random.uniform(jax.random.key(4), (SAMPLERS_NLIVE, 2))
    L_live = jax.vmap(nested._nsloglike)(u_live)
    key = jax.random.key(8)
    (u_new, L_new), (u_dead, L_dead, ncall) = nested._build_batch_step()((u_live, L_live), key)
    pick, dirs, shrink = nested_draws(key, SAMPLERS_NLIVE, SAMPLERS_NBATCH, nested.num_slices, 2)
    arrays.update(nested_u0=np.asarray(u_live), nested_L0=np.asarray(L_live), nested_pick=pick, nested_dirs=dirs,
                  nested_shrink=shrink, nested_u=np.asarray(u_new), nested_L=np.asarray(L_new),
                  nested_u_dead=np.asarray(u_dead), nested_L_dead=np.asarray(L_dead), nested_ncall=int(ncall))

    # the profilers from three fixed starts
    starts = np.array([[1.2, -0.3], [0.7, -0.8], [1.05, -0.45]])
    profiler = ScipyProfiler(like)
    results = [profiler._minimize_one(s) for s in starts]
    xs, lps = np.array([r[0] for r in results]), np.array([r[1] for r in results])
    profiler.profiles.bestfit['a'], profiler.profiles.bestfit['b'] = xs[:, 0], xs[:, 1]
    profiler.profiles.bestfit['logposterior'] = lps
    best = xs[int(np.argmax(lps))]
    hessian = np.asarray(jax.hessian(profiler.logpost)(jnp.asarray(best)), dtype='f8')
    cov = np.linalg.inv(-hessian)
    profiler.profiles.covariance = cov
    profiler.profiles.error.update({n: float(np.sqrt(cov[i, i])) for i, n in enumerate('ab')})
    profiler.interval()
    profiler.contour('a', 'b', size=7)
    profiler.grid('a', np.linspace(0.9, 1.1, 5))
    entry = profiler.profiles.contour[('a', 'b')]
    arrays.update(profiler_starts=starts, profiler_x=xs, profiler_lp=lps, profiler_hessian=hessian,
                  profiler_interval=np.array([profiler.profiles.interval[n] for n in 'ab']),
                  profiler_contour_grid=np.stack(entry['grid'][:2]), profiler_contour_chi2=entry['grid'][2],
                  profiler_profile=np.stack(profiler.profiles.profile['a']))
    optax_profiler = OptaxProfiler(like, nsteps=300)
    results = [optax_profiler._minimize_one(s) for s in starts]
    arrays.update(optax_x=np.array([r[0] for r in results]), optax_lp=np.array([r[1] for r in results]))
    # 20 Adam steps from the first start, every state read out
    sched = optax.warmup_cosine_decay_schedule(0., 0.1, int(0.1 * 300) + 1, 300)
    opt = optax.adam(sched)
    scales = jnp.asarray(optax_profiler._scales)
    vg = jax.value_and_grad(lambda u: optax_profiler.chi2(u * scales))
    u = jnp.asarray(starts[0]) / scales
    state = opt.init(u)
    adam = []
    for _ in range(20):
        v, g = vg(u)
        updates, state = opt.update(g, state, u)
        u = optax.apply_updates(u, updates)
        adam.append(np.concatenate([np.asarray(g), np.asarray(updates), np.asarray(u)]))
    arrays.update(adam_u0=np.asarray(starts[0]) / optax_profiler._scales, adam=np.array(adam),
                  schedule=np.array([float(sched(i)) for i in range(300)]))
    arrays.update(run_x64('--x64-samplers'))
    return arrays


def samplers_x64(path):
    """Config 1 in x64: ``GridSampler(size=3)`` and ``ImportanceSampler`` of
    a 64-point chain (seeded points, logposterior 0) -> ``path``."""
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _build_likelihood
    from desilike_tpu.samplers import GridSampler, ImportanceSampler
    from desilike_tpu.samples.chain import Chain
    like = _build_likelihood()
    grid = GridSampler(like, size=3).run()
    names = like.pipeline.varied_params.names()
    rng = np.random.default_rng(7)
    chain = Chain()
    for name in names:
        p = like.pipeline.varied_params[name]
        chain[p] = (p.value + 0.5 * p.proposal * rng.normal(size=(16, 4))).astype('f4')
    weighted = ImportanceSampler(like).run(chain)
    np.savez(path, grid_names=np.array(names), grid_points=np.stack([grid[n] for n in names], axis=-1),
             grid_logpost_x64=grid['logposterior'], grid_shape=np.array(grid.attrs['grid_shape']),
             importance_points=np.stack([chain[n] for n in names], axis=-1),
             importance_logpost_x64=weighted['logposterior'], importance_aweight_x64=weighted['aweight'])


def run_x64(mode):
    """Run this script with ``mode`` (a child mode that writes one .npz) in
    float64 in a child process; returns its arrays."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', JAX_ENABLE_X64='1', DESILIKE_TPU_X64='1')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x64.npz')
        subprocess.run([sys.executable, os.path.abspath(__file__), mode, path], env=env, check=True)
        return dict(np.load(path))


def build_marg_reference():
    """:func:`marg_reference` in float32, then in x64 in a child process."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'f32.npz')
        marg_reference(path, x64=False)
        arrays = dict(np.load(path))
    arrays.update(run_x64('--x64-marg'))
    return arrays


def build_hessian_reference():
    """Config 4's unconstrained log-density, gradient and Hessian at the first
    reference point, computed in float64 in a child process."""
    return run_x64('--x64-hessian')


def evaluate_hessian(path):
    import jax
    import jax.numpy as jnp
    from desilike_tpu.samplers import NUTSSampler

    like = build_jax_likelihood('joint')
    sampler = NUTSSampler(like, nchains=1)
    names = sampler.names
    point = reference_points(names)[0].astype('f4').astype('f8')
    u = np.asarray(sampler._unconstrain(point))
    step = HESSIAN_STEP * np.eye(len(u))
    logdens, grad = jax.jit(jax.vmap(sampler._logdens_grad()))(jnp.asarray(np.concatenate([u[None], u + step, u - step])))
    grad = np.asarray(grad)
    hessian = (grad[1:1 + len(u)] - grad[1 + len(u):]) / (2. * HESSIAN_STEP)
    np.savez(path, names=np.array(names), point=point, u=u, logdens=np.asarray(logdens)[0], grad=grad[0],
             hessian=hessian)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ['--x64-hessian']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        evaluate_hessian(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-xi-extras']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        xi_extras(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-marg']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        marg_reference(sys.argv[2], x64=True)
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-direct']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        direct_reference(sys.argv[2], x64=True)
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-templates']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        templates_reference(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-tns']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        tns_reference(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-theories']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        theories_x64(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-observables']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        observables_reference(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-probes']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        probes_reference(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-samplers']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        samplers_x64(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64-emu']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        emulated_x64(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--x64']:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        data = np.load(sys.argv[3])
        _, _, _, (values, grads, solved) = evaluate(sys.argv[2], list(data['names']), data['points'])
        np.savez(sys.argv[3], logpost=values, grad=grads, solved=solved)
        sys.exit(0)
    for config in sys.argv[1:] or list(OUTPUTS):
        if config == 'hessian':
            arrays = build_hessian_reference()
        elif config == 'marg':
            arrays = build_marg_reference()
        elif config == 'emu':
            arrays = build_emulated_reference()
        elif config == 'templates':
            arrays = run_x64('--x64-templates')
        elif config == 'tns':
            arrays = run_x64('--x64-tns')
        elif config == 'observables':
            arrays = run_x64('--x64-observables')
        elif config == 'probes':
            arrays = run_x64('--x64-probes')
        elif config == 'theories':
            arrays = theories_reference()
        elif config == 'tier1':
            arrays = tier1_reference()
        elif config == 'samplers':
            arrays = samplers_reference()
        else:
            arrays = build_reference(config)
        np.savez_compressed(OUTPUTS[config], **arrays)
        print('wrote {} ({:d} bytes)'.format(OUTPUTS[config], os.path.getsize(OUTPUTS[config])))
