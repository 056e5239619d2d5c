"""Reference-name compatibility layer.

Counterpart of ``desilike_tpu/compat.py``. Users migrating from the
reference (cosmodesi/desilike) import model, sampler and profiler classes by
the names of the external codes they wrap (velocileptors, FOLPS, pybird,
geofptax, dynesty, nautilus, emcee, zeus, iminuit, ...). This package
implements the matching capability itself, usually under one canonical
class; this module maps the reference names onto those classes so that
existing scripts keep working. Each alias says what it maps to and what it
drops: where the reference wrapper's physics differs in scheme (Lagrangian
against Eulerian resummation, say), its docstring says so.
"""


import numpy as np

from .theories.ept import EPTTracerPowerSpectrumMultipoles, EPTTracerCorrelationFunctionMultipoles
from .theories.bispectrum import TreeLevelBispectrumMultipoles
from .theories.cosmology import Cosmology
from .samplers.nested import NestedSampler
from .samplers.ensemble import EnsembleSampler, EnsembleSliceSampler
from .profilers.base import ScipyProfiler


# --- theory model aliases -------------------------------------------------

_PT_WRAPPER_OPTIONS = ('nthreads', 'engine', 'use_Pzel', 'km', 'kp',
                       'eft_basis', 'with_stoch', 'tracers')


class _OneLoopPowerAlias(EPTTracerPowerSpectrumMultipoles):
    """1-loop full-shape pk multipoles under a reference wrapper name.

    Maps onto the in-framework 1-loop Eulerian PT model
    (:class:`EPTTracerPowerSpectrumMultipoles`, FFTLog-matrix loops,
    IR-resummed by default — matching the wrapped codes, all of which
    resum: velocileptors ept_fullresum, pybird with_resum='full', folpsax).
    ``prior_basis='physical'`` / ``freedom=`` / ``tracer=`` / ``fsat=`` /
    ``sigv=`` are honored natively (DESI-2024 physical priors; note the
    reference velocileptors wrappers DEFAULT to the physical basis — pass
    ``prior_basis='physical'`` explicitly here, the in-framework default is
    the Eulerian basis). ``kIR`` maps to the IR separation scale
    ``resum_ks``; external-code-specific options (threading, pole-table
    engine selection, ...) are accepted and ignored.
    """

    def initialize(self, *args, **kwargs):
        kIR = kwargs.get('kIR', None)
        if kIR is not None:
            # same role in both codes: upper limit of the IR damping integral
            kwargs.setdefault('resum_ks', float(kIR))
        for name in _PT_WRAPPER_OPTIONS:
            kwargs.pop(name, None)
        super().initialize(*args, **kwargs)


class _OneLoopCorrelationAlias(EPTTracerCorrelationFunctionMultipoles):
    """1-loop full-shape xi multipoles under a reference wrapper name (see
    :class:`_OneLoopPowerAlias`; IR-resummed by default, kIR -> resum_ks)."""

    def initialize(self, *args, **kwargs):
        kIR = kwargs.get('kIR', None)
        if kIR is not None:
            kwargs.setdefault('resum_ks', float(kIR))
        for name in _PT_WRAPPER_OPTIONS:
            kwargs.pop(name, None)
        super().initialize(*args, **kwargs)


class FOLPSTracerPowerSpectrumMultipoles(_OneLoopPowerAlias):
    """Reference full_shape.py:2131 (wraps FOLPS-nu) -> in-framework 1-loop EPT."""


class FOLPSAXTracerPowerSpectrumMultipoles(_OneLoopPowerAlias):
    """Reference full_shape.py:2301 (wraps folpsax, the JAX FOLPS port) ->
    in-framework 1-loop EPT (FFTLog matrices, batched bias recombination)."""


class LPTVelocileptorsTracerPowerSpectrumMultipoles(_OneLoopPowerAlias):
    """Reference full_shape.py:1229 (wraps velocileptors LPT_RSD).  The
    in-framework model is Eulerian (EPT) rather than Lagrangian: same
    1-loop order and bias freedom, different resummation scheme."""


class REPTVelocileptorsTracerPowerSpectrumMultipoles(_OneLoopPowerAlias):
    """Reference full_shape.py:1502 (wraps velocileptors REPT) ->
    in-framework 1-loop EPT (REPT is itself Eulerian; closest match)."""


class PyBirdTracerPowerSpectrumMultipoles(_OneLoopPowerAlias):
    """Reference full_shape.py:1786 (wraps pybird EFT) -> in-framework
    1-loop EPT with counterterm/stochastic freedom."""


class FOLPSTracerCorrelationFunctionMultipoles(_OneLoopCorrelationAlias):
    """Reference full_shape.py (FOLPS xi wrapper) -> in-framework EPT xi."""


class FOLPSAXTracerCorrelationFunctionMultipoles(_OneLoopCorrelationAlias):
    """Reference full_shape.py (folpsax xi wrapper) -> in-framework EPT xi."""


class LPTVelocileptorsTracerCorrelationFunctionMultipoles(_OneLoopCorrelationAlias):
    """Reference full_shape.py (velocileptors LPT xi wrapper) -> EPT xi."""


class REPTVelocileptorsTracerCorrelationFunctionMultipoles(_OneLoopCorrelationAlias):
    """Reference full_shape.py (velocileptors REPT xi wrapper) -> EPT xi."""


class PyBirdTracerCorrelationFunctionMultipoles(_OneLoopCorrelationAlias):
    """Reference full_shape.py:1920 (pybird xi wrapper) -> EPT xi."""


class GeoFPTAXTracerBispectrumMultipoles(TreeLevelBispectrumMultipoles):
    """Reference full_shape.py:2523 (wraps geofptax) -> in-framework
    bispectrum multipoles (tree-level RSD kernels, AP, FoG, optional
    pt='1loop' input pk).  ``k`` maps to ``triangles``; per-multipole
    shot-noise arrays are not supported (scalar number density only)."""

    def initialize(self, k=None, z=None, template=None,
                   ells=((0, 0, 0), (2, 0, 0), (0, 2, 0), (0, 0, 2)),
                   shotnoise=None, pt=None, **kwargs):
        # physical-basis options are honored by the 1-loop pk aliases but
        # have no counterpart in the tree-level bispectrum's bias tower —
        # swallowed here like the other wrapper-specific options
        for name in _PT_WRAPPER_OPTIONS + ('mu', 'prior_basis', 'freedom',
                                           'tracer', 'fsat', 'sigv'):
            kwargs.pop(name, None)
        if z is not None:
            if template is None:
                from .theories.power_template import ShapeFitPowerSpectrumTemplate
                template = ShapeFitPowerSpectrumTemplate(z=z)
            else:
                template.init.update(z=z)
        sn = 1e4
        if shotnoise is not None and np.ndim(shotnoise) == 0 and float(shotnoise):
            sn = float(shotnoise)
        super().initialize(triangles=k, ells=ells, template=template, pt=pt,
                           shotnoise=sn, **kwargs)


def JAXEffortTracerPowerSpectrumMultipoles(emulator_fn=None, calculator=None, **kwargs):
    """Reference full_shape.py:2722 wraps a pre-trained external neural
    emulator (jaxeffort).  The in-framework equivalent is an emulated theory
    node: train any tracer model with
    ``desilike_tpu_torch.emulators.Emulator(..., engine=MLPEmulatorEngine())``,
    ``save()`` it, and load it here as a drop-in calculator.

    Parameters
    ----------
    emulator_fn : path to a saved desilike_tpu_torch emulator
    calculator : the theory class/instance the emulator was built from
    """
    if emulator_fn is None:
        raise ValueError(
            'no bundled pre-trained net: train one with '
            'desilike_tpu_torch.emulators.Emulator(pipeline, engine=MLPEmulatorEngine()), '
            'save(), then pass emulator_fn=/path and calculator=TheoryClass')
    from .emulators import Emulator
    emulator = Emulator.load(emulator_fn, calculator)
    return emulator.to_calculator(**kwargs) if kwargs else emulator.to_calculator()


class Cosmoprimo(Cosmology):
    """Reference theories/primordial_cosmology.py:78 Boltzmann node name ->
    the in-framework :class:`Cosmology` calculator (background ODEs,
    EH98/99, injected tables, the emulated Boltzmann-quality engine,
    theta_MC_100 support).

    Host Boltzmann engine names ('class', 'camb', ...) map to
    ``engine='emulator'`` when trained weights are passed (the
    Boltzmann-quality standalone path, cosmology/emulator.py), else to the
    'eh99' approximation with a logged warning — there is no C Boltzmann
    code in the loop here."""

    _HOST_ENGINES = ('class', 'camb', 'classy', 'isitgr', 'mgcamb')

    def initialize(self, engine='eh98', emulator=None, fiducial=None, **kwargs):
        if isinstance(fiducial, str):
            # the framework default IS the DESI fiducial
            # (cosmology/background.DEFAULT_PARAMS) — accept only names that
            # actually mean it; anything else silently running with DESI
            # parameters would corrupt a ported reference script
            if fiducial in ('DESI', 'DESI2024'):
                fiducial = None
            else:
                raise ValueError(
                    "unknown named fiducial {!r}: only 'DESI' maps onto the "
                    'built-in default; pass an explicit parameter dict for other '
                    'fiducial cosmologies'.format(fiducial))
        if str(engine) in self._HOST_ENGINES:
            if emulator is not None:
                engine = 'emulator'
            else:
                self.log.warning(
                    "engine='{}' is a host Boltzmann code; falling back to the "
                    "'eh99' approximation (few-percent transfer function). For "
                    'Boltzmann-quality standalone fits train the emulated engine '
                    '(scripts/generate_boltzmann_tables.py + '
                    'train_boltzmann_emulator.py) and pass emulator=.'.format(engine))
                engine = 'eh99'
        super().initialize(engine=engine, emulator=emulator, fiducial=fiducial, **kwargs)


# --- sampler aliases ------------------------------------------------------

class _NestedAlias(NestedSampler):
    """Nested sampling under a reference wrapper name: maps onto the
    in-framework batched live-set slice nested sampler (logZ + weighted
    posterior samples); wrapper-specific options are accepted and ignored."""

    _ignored_options = ('nlive_init', 'nlive_batch', 'bound', 'sample',
                        'n_networks', 'n_eff', 'precondition', 'dynamic',
                        'bootstrap', 'enlarge', 'walks', 'facc', 'slices',
                        'fmove', 'max_move', 'update_interval', 'num_repeats',
                        'do_clustering', 'boost_posterior', 'feedback',
                        'precision_criterion')

    def __init__(self, likelihood, nlive=None, **kwargs):
        for name in self._ignored_options:
            kwargs.pop(name, None)
        if nlive is not None:
            kwargs['nlive'] = int(nlive)
        super().__init__(likelihood, **kwargs)


class StaticDynestySampler(_NestedAlias):
    """Reference samplers/dynesty.py:175 -> in-framework nested sampler."""


class DynamicDynestySampler(_NestedAlias):
    """Reference samplers/dynesty.py:237 -> in-framework nested sampler
    (fixed live set; the dynamic reallocation strategy is not reproduced)."""


class PolychordSampler(_NestedAlias):
    """Reference samplers/polychord.py:13 (Fortran, slice-based) ->
    in-framework nested sampler (also slice-based, batched on the device)."""


class NautilusSampler(_NestedAlias):
    """Reference samplers/nautilus.py (neural nested) -> in-framework
    nested sampler (no neural proposal; batched slice replacement)."""


class PocoMCSampler(_NestedAlias):
    """Reference samplers/pocomc.py (preconditioned MC evidence) ->
    in-framework nested sampler for logZ + posterior."""


class EmceeSampler(EnsembleSampler):
    """Reference samplers/emcee.py:8 (affine-invariant stretch move) ->
    in-framework batched ensemble sampler (same algorithm, on the device)."""


class ZeusSampler(EnsembleSliceSampler):
    """Reference samplers/zeus.py:12 (ensemble slice sampling) ->
    in-framework batched ensemble slice sampler (same algorithm)."""


# --- profiler aliases -----------------------------------------------------

class MinuitProfiler(ScipyProfiler):
    """Reference profilers/minuit.py:16 (iminuit/Minuit2 migrad+minos) ->
    the in-framework profiler: L-BFGS-B maximization with autodiff
    gradients, parabolic covariance (hesse analog) and Delta-chi2
    root-finding intervals/contours (minos analog).

    Robustness caveat: migrad combines a variable-metric search with
    heuristic recovery steps that handle mildly non-smooth or noisy
    posteriors; a pure quasi-Newton solve does not. This alias therefore
    runs with ``fallback='nelder-mead'`` by default: any start whose
    gradient-based solve fails (or returns a non-finite posterior) is
    re-polished derivative-free. For genuinely non-smooth objectives prefer
    ``ScipyProfiler(method='powell')`` or more ``maximize(niterations=...)``
    multi-starts."""

    def __init__(self, likelihood, **kwargs):
        kwargs.setdefault('method', 'l-bfgs-b')
        kwargs.setdefault('fallback', 'nelder-mead')
        super().__init__(likelihood, **kwargs)


class BOBYQAProfiler(ScipyProfiler):
    """Reference profilers/bobyqa.py:10 (Py-BOBYQA derivative-free) ->
    derivative-free profiling via Powell's method (no gradients used).

    Caveat: Powell is a line-search method, not BOBYQA's model-based trust
    region; on noisy objectives it can terminate early — raise
    ``maximize(niterations=...)`` to compensate."""

    def __init__(self, likelihood, **kwargs):
        kwargs.setdefault('method', 'powell')
        super().__init__(likelihood, **kwargs)


# --- tier-2 aliases: reference base-class / container / module names -------
#
# Plain assignments (identity-preserving: isinstance checks against the
# reference name see the canonical class). Each line states the reference
# definition site and what plays its role here. Names deliberately NOT
# provided (no meaningful equivalent in a batched, MPI-free design):
# CurrentMPIComm (desilike/mpi.py — parallel.distributed + mesh sharding
# replace the comm layer; utils.TaskManager covers the task-splitting role),
# ParameterConfig/ParameterCollectionConfig/YamlLoader (io.py's YAML dialect
# feeds plain dicts), Info (init metadata is the InitConfig), FastFisher
# (analytic marginalization is fused into likelihoods.base), and the
# cosmoprimo Section shims Background/Thermodynamics/Primordial/Fourier/
# BaseExternalEngine (host cosmology enters through
# Cosmology(engine='external') + Pipeline.external_values instead).

from .core.calculator import Calculator, InitConfig  # noqa: E402
from .core.pipeline import Pipeline  # noqa: E402
from .parameters import (Prior, ParameterCollection, DerivArray,  # noqa: E402
                         ParameterCovariance, ParameterPrecision)
from .fisher import PriorFisher  # noqa: E402
from .samplers.base import BasePosteriorSampler  # noqa: E402
from .theories.base import (BaseTheoryPowerSpectrumMultipoles, WedgesMixin,  # noqa: E402
                            BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles)
from .theories.full_shape import (BaseTracerPowerSpectrumMultipoles,  # noqa: E402
                                  EFTLikeKaiserTracerPowerSpectrumMultipoles)
from .theories.bao import ResummedBAOWigglesPowerSpectrumMultipoles  # noqa: E402
from .theories.tns import TNSTracerPowerSpectrumMultipoles  # noqa: E402
from .theories.weak_lensing import DESY3Theory  # noqa: E402
from .observables.fiber_collisions import SystematicTemplatePowerSpectrumMultipoles  # noqa: E402
from .likelihoods.cmb.hillipop import BaseHillipopLikelihood, FgComponent  # noqa: E402
from .likelihoods.cmb.planck2018 import BasePlanck2018Likelihood  # noqa: E402

# core runtime (reference base.py:1119, 387; samplers/base.py:409)
BaseCalculator = Calculator
BasePipeline = Pipeline
BaseBatchPosteriorSampler = BasePosteriorSampler  # run()/check() batching is built in

# parameter layer (reference parameter.py:1905, 405, 1038, 2527, 2820)
ParameterPrior = Prior
ParameterArray = DerivArray  # ndarray + Deriv-keyed derivative blocks
BaseParameterCollection = ParameterCollection
BaseParameterMatrix = ParameterCovariance

# theory bases (reference theories/galaxy_clustering/*.py)
BasePrimordialCosmology = Cosmology  # primordial_cosmology.py:25


class BaseTheoryPowerSpectrumMultipolesFromWedges(BaseTheoryPowerSpectrumMultipoles, WedgesMixin):
    """Reference galaxy_clustering/base.py:193 — P_l(k) built by mu-quadrature
    over wedges; here the quadrature/Legendre projection lives in WedgesMixin."""


BaseTracerCorrelationFunctionFromPowerSpectrumMultipoles = \
    BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles  # base.py:46
BasePTCorrelationFunctionMultipoles = \
    BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles  # full_shape.py:330
BaseTracerTheory = Calculator  # full_shape.py:59 — namespacing lives on Calculator
BaseTracerTwoPointTheory = BaseTracerPowerSpectrumMultipoles  # full_shape.py:136
BaseTracerThreePointTheory = TreeLevelBispectrumMultipoles  # full_shape.py (bispectrum base)
BaseEFTLikeTracerPowerSpectrumMultipoles = EFTLikeKaiserTracerPowerSpectrumMultipoles  # full_shape.py:577
BasePowerSpectrumExtractor = Calculator  # power_template.py:25 — extractors subclass Calculator
BaseSystematicTemplateMultipoles = SystematicTemplatePowerSpectrumMultipoles  # window.py:1275
ResummedPowerSpectrumWiggles = ResummedBAOWigglesPowerSpectrumMultipoles  # bao.py:165 — Sigma
# integrals are computed inside the model rather than in a separate node
TNSPowerSpectrumMultipoles = TNSTracerPowerSpectrumMultipoles  # full_shape.py:836 — the
# non-tracer/tracer split is folded into one class (the bias enters the same graph)

# non-tracer 1-loop wrapper names (reference full_shape.py:1229/1502/1647/2070/2301)
BaseVelocileptorsPowerSpectrumMultipoles = _OneLoopPowerAlias
BaseVelocileptorsTracerPowerSpectrumMultipoles = _OneLoopPowerAlias
BaseVelocileptorsCorrelationFunctionMultipoles = _OneLoopCorrelationAlias
BaseVelocileptorsTracerCorrelationFunctionMultipoles = _OneLoopCorrelationAlias
LPTVelocileptorsPowerSpectrumMultipoles = _OneLoopPowerAlias
REPTVelocileptorsPowerSpectrumMultipoles = _OneLoopPowerAlias
FOLPSPowerSpectrumMultipoles = _OneLoopPowerAlias
FOLPSAXPowerSpectrumMultipoles = _OneLoopPowerAlias
PyBirdPowerSpectrumMultipoles = _OneLoopPowerAlias
PyBirdCorrelationFunctionMultipoles = _OneLoopCorrelationAlias

# observables / likelihoods
DESY3Observable = DESY3Theory  # observables/weak_lensing/des_y3.py:7 — the host-eval
# node carries both the theory and data-vector roles here
HillipopLikelihood = BaseHillipopLikelihood  # cmb/hillipop.py base name
fgmodel = FgComponent  # cmb/hillipop.py:26 foreground-component base
BasePlanck2018ClikLikelihood = BasePlanck2018Likelihood  # planck2018_clik.py:122 — the
# clik-era class names alias the native reimplementations (see likelihoods.cmb)

# samplers / services
BaseDynestySampler = _NestedAlias  # dynesty.py base
PriorCalculator = PriorFisher  # fisher.py:14 — prior curvature enters Fisher directly


class RQuasiRandomSequence(object):
    """Roberts' R_d additive quasi-random sequence (reference
    samplers/qmc.py ``RQuasiRandomSequence``; scipy.qmc-style interface).
    The production sampler path is ``QMCSampler(engine='rqrs')`` — this
    class exposes the bare sequence for scripts that used it directly."""

    def __init__(self, d=1, seed=0.5):
        self.d = int(d)
        # the reference seeds with a float u0 applied to every dimension;
        # integer seeds draw u0 per dimension like QMCSampler does
        self._seed = seed
        self.num_generated = 0  # advances across random() calls (reference qmc.py:26-27)

    def reset(self):
        """Restart the stream (reference qmc.py:31, scipy QMCEngine API)."""
        self.num_generated = 0
        return self

    def fast_forward(self, n):
        """Skip ``n`` points (scipy QMCEngine API, reference qmc.py:35)."""
        self.num_generated += int(n)
        return self

    def random(self, n=1):
        from .samplers.deterministic import _rqrs
        n = int(n)
        start = self.num_generated
        self.num_generated += n
        if isinstance(self._seed, float):
            phi = 2.
            for _ in range(64):
                phi = (1. + phi) ** (1. / (self.d + 1.))
            alpha = (1. / phi) ** (1. + np.arange(self.d))
            steps = np.arange(start + 1, start + n + 1)[:, None]
            return (self._seed + steps * alpha) % 1.
        return _rqrs(self.d, start + n, seed=self._seed)[start:]


def jit(calculator, index=None):
    """Reference base.py ``jit(calculator)``, which wraps a sub-pipeline into
    one compiled function. Here every pipeline call evaluates the whole
    batched graph, so there is nothing to wrap: this returns the calculator
    unchanged. Kept so that reference scripts calling ``desilike.jit(theory)``
    keep working; ``index`` is accepted and ignored."""
    return calculator

# exception names (reference io.py/parameter.py/base.py/install.py): the
# framework raises the standard exceptions these referred to, so the aliases
# bind to them — `except ParameterError:` keeps catching what it caught
ConfigError = ValueError
ParameterError = ValueError
ParameterPriorError = ValueError
PipelineError = RuntimeError
InstallError = RuntimeError
