"""desilike_tpu_torch: the PyTorch / CUDA port of desilike_tpu for NVIDIA Hopper.

A second package beside ``desilike_tpu`` (the JAX reference). It ports the
single-tracer BAO likelihood, the joint two-tracer full-shape + BAO
likelihood, the 1-loop EPT full-shape likelihood and the
correlation-function BAO likelihood: calculator graph with namespaces,
host-side fiducial cosmology, BAO and ShapeFit templates, damped-wiggle,
(EFT-like) Kaiser and 1-loop EPT theories (FFTLog one-loop tables, IR
resummation, both prior bases) in P(k) and, by the FFTLog Hankel transform,
in xi(s), windowed observables (with the 'cubic' Gaussianization of P(k)),
analytic covariance, Gaussian likelihoods and their sums with analytic
marginalization over the solved parameters ('.marg', '.best', '.prec'; static
rows, per-chain basis rows and, for the rest, forward mode through the
pipeline); the gradient samplers over them (``samplers``: ChEES, NUTS, HMC,
MCLMC) with their chains and diagnostics (``samples``); and the Fisher
forecast (``Fisher``, ``LikelihoodFisher``, ``FisherGaussianLikelihood``) with
``Differentiation``; and the emulators (``emulators``: ``Emulator`` with the
Point, Taylor and MLP engines) that replace a calculator by a surrogate
node. The other theories: the simple, resummed and flexible BAO models
(spline broadbands too), the simple damped Kaiser model, TNS with its A/B
tables, local-fNL PNG (density and velocity), the tree-level bispectrum
and its observable, the Lyman-alpha P1D extractor, and the cosmology
node's trained ``emulator`` engine (``cosmology.emulator``). The
observables layer: measured data and window files (``interop``), mock
covariances with the Hartlap and Percival factors, fiber collisions and
systematic templates folded into the window, cut-sky footprints, the
``ObservableArray`` / ``ObservableCovariance`` containers, and the
compression observables. The external likelihoods (BBN, H0, Mb, the CMB
distance prior), the supernova samples and the CMB family
(``likelihoods.cmb``), with the recombination-era quantities and h solved
from 100 theta_* (``Cosmology(theta=True)``). The other samplers
(Metropolis, blocked Metropolis for pipelines with host-evaluated nodes,
the stretch and slice ensembles, nested, grid, QMC, importance), the
profilers (``profilers``), the ``Profiles`` and ``ParameterCovariance``
containers and the plots (``plotting``).
Per-evaluation compute runs on a batch of chains, in float32, on the CUDA
card unless the caller asks for the CPU by name (``device='cpu'``); the
Chebyshev lookups and their gradients run through hand-written CUDA kernels
(``ops/cuda_kernels.py``).
"""

__version__ = '0.1.0'

from .config import set_dtype, get_dtype
from .utils import BaseClass
from .parameters import Parameter, ParameterCollection, Prior, ParameterCovariance, ParameterPrecision
from .core import Calculator, Pipeline
from .theories import (DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate,
                       ShapeFitPowerSpectrumTemplate, DirectPowerSpectrumTemplate, Cosmology, KaiserTracerPowerSpectrumMultipoles,
                       EFTLikeKaiserTracerPowerSpectrumMultipoles, EPTTracerPowerSpectrumMultipoles,
                       DampedBAOWigglesCorrelationFunctionMultipoles, DampedBAOWigglesTracerCorrelationFunctionMultipoles,
                       KaiserTracerCorrelationFunctionMultipoles,
                       EFTLikeKaiserTracerCorrelationFunctionMultipoles, EPTTracerCorrelationFunctionMultipoles,
                       SimpleBAOWigglesTracerPowerSpectrumMultipoles, ResummedBAOWigglesTracerPowerSpectrumMultipoles,
                       FlexibleBAOWigglesTracerPowerSpectrumMultipoles, SimpleBAOWigglesTracerCorrelationFunctionMultipoles,
                       ResummedBAOWigglesTracerCorrelationFunctionMultipoles,
                       FlexibleBAOWigglesTracerCorrelationFunctionMultipoles, SimpleTracerPowerSpectrumMultipoles,
                       TNSTracerPowerSpectrumMultipoles, EFTLikeTNSTracerPowerSpectrumMultipoles,
                       TNSTracerCorrelationFunctionMultipoles, EFTLikeTNSTracerCorrelationFunctionMultipoles,
                       PNGTracerPowerSpectrumMultipoles, PNGTracerVelocityPowerSpectrumMultipoles,
                       TreeLevelBispectrumMultipoles, P1DPowerSpectrumExtractor)
from .observables import (TracerPowerSpectrumMultipolesObservable, TracerCorrelationFunctionMultipolesObservable,
                          TracerBispectrumMultipolesObservable, BoxFootprint, CutskyFootprint,
                          WindowedPowerSpectrumMultipoles, WindowedCorrelationFunctionMultipoles,
                          ObservablesCovarianceMatrix, ObservableArray, ObservableCovariance,
                          BAOCompressionObservable, ShapeFitCompressionObservable, StandardCompressionObservable,
                          WiggleSplitCompressionObservable, BandVelocityCompressionObservable,
                          TurnOverCompressionObservable, P1DCompressionObservable, BAOPhaseShiftCompressionObservable,
                          TopHatFiberCollisionsPowerSpectrumMultipoles, FiberCollisionsPowerSpectrumMultipoles,
                          SystematicTemplatePowerSpectrumMultipoles, TopHatFiberCollisionsCorrelationFunctionMultipoles,
                          FiberCollisionsCorrelationFunctionMultipoles, SystematicTemplateCorrelationFunctionMultipoles)
from .likelihoods import (BaseLikelihood, BaseGaussianLikelihood, ObservablesGaussianLikelihood,
                          FisherGaussianLikelihood, SumLikelihood, Schoneberg2024BBNLikelihood,
                          Riess2020H0Likelihood, Riess2020MbLikelihood, CMBDistancePriorLikelihood,
                          DESY5SNLikelihood)
from .differentiation import Differentiation
from .fisher import Fisher, LikelihoodFisher, PriorFisher
from .emulators import (Emulator, EmulatedCalculator, PointEmulatorEngine, TaylorEmulatorEngine,
                        MLPEmulatorEngine)
from .samples import Chain, Profiles
from . import plotting, utils  # noqa: E402
