from .base import (APEffect, BaseTheoryPowerSpectrumMultipoles, BaseTheoryCorrelationFunctionMultipoles,
                   BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles, WedgesMixin, ap_k_mu, ap_s_mu)
from .cosmology import Cosmology
from .power_template import (BasePowerSpectrumTemplate, FixedPowerSpectrumTemplate, BAOPowerSpectrumTemplate,
                             BAOPhaseShiftPowerSpectrumTemplate, StandardPowerSpectrumTemplate,
                             ShapeFitPowerSpectrumTemplate, DirectPowerSpectrumTemplate,
                             DirectWiggleSplitPowerSpectrumTemplate, WiggleSplitPowerSpectrumTemplate,
                             BandVelocityPowerSpectrumTemplate, TurnOverPowerSpectrumTemplate,
                             ExtractedBandVelocityPowerSpectrumTemplate, BandVelocityPowerSpectrumCalculator)
from .extractors import (BAOExtractor, StandardPowerSpectrumExtractor, ShapeFitPowerSpectrumExtractor,
                         WiggleSplitPowerSpectrumExtractor, BandVelocityPowerSpectrumExtractor,
                         TurnOverPowerSpectrumExtractor, BAOPhaseShiftExtractor)
from .bao import (BaseBAOWigglesPowerSpectrumMultipoles, DampedBAOWigglesPowerSpectrumMultipoles,
                  SimpleBAOWigglesPowerSpectrumMultipoles, ResummedBAOWigglesPowerSpectrumMultipoles,
                  FlexibleBAOWigglesPowerSpectrumMultipoles,
                  BaseBAOWigglesTracerPowerSpectrumMultipoles, DampedBAOWigglesTracerPowerSpectrumMultipoles,
                  SimpleBAOWigglesTracerPowerSpectrumMultipoles, ResummedBAOWigglesTracerPowerSpectrumMultipoles,
                  FlexibleBAOWigglesTracerPowerSpectrumMultipoles,
                  BaseBAOWigglesCorrelationFunctionMultipoles, DampedBAOWigglesCorrelationFunctionMultipoles,
                  SimpleBAOWigglesCorrelationFunctionMultipoles, ResummedBAOWigglesCorrelationFunctionMultipoles,
                  FlexibleBAOWigglesCorrelationFunctionMultipoles, BaseBAOWigglesTracerCorrelationFunctionMultipoles,
                  DampedBAOWigglesTracerCorrelationFunctionMultipoles,
                  SimpleBAOWigglesTracerCorrelationFunctionMultipoles,
                  ResummedBAOWigglesTracerCorrelationFunctionMultipoles,
                  FlexibleBAOWigglesTracerCorrelationFunctionMultipoles)
from .full_shape import (BasePTPowerSpectrumMultipoles, KaiserPowerSpectrumMultipoles,
                         BaseTracerPowerSpectrumMultipoles, KaiserTracerPowerSpectrumMultipoles,
                         EFTLikeKaiserTracerPowerSpectrumMultipoles, BaseTracerCorrelationFunctionMultipoles,
                         KaiserTracerCorrelationFunctionMultipoles, EFTLikeKaiserTracerCorrelationFunctionMultipoles,
                         SimpleTracerPowerSpectrumMultipoles)
from .ept import EPTTracerPowerSpectrumMultipoles, EPTTracerCorrelationFunctionMultipoles
from .tns import (TNSTracerPowerSpectrumMultipoles, EFTLikeTNSTracerPowerSpectrumMultipoles,
                  TNSTracerCorrelationFunctionMultipoles, EFTLikeTNSTracerCorrelationFunctionMultipoles)
from .png import PNGTracerPowerSpectrumMultipoles, PNGTracerVelocityPowerSpectrumMultipoles
from .bispectrum import TreeLevelBispectrumMultipoles
from .lya import P1DPowerSpectrumExtractor
from .weak_lensing import DESY3Theory, DES_Y3_PARAM_MAP

# the reference's class names (``desilike_tpu_torch.compat``), resolved at first use (PEP 562): compat imports
# the samplers and profilers, which import this package
_COMPAT_NAMES = ('FOLPSTracerPowerSpectrumMultipoles', 'FOLPSAXTracerPowerSpectrumMultipoles',
                 'LPTVelocileptorsTracerPowerSpectrumMultipoles', 'REPTVelocileptorsTracerPowerSpectrumMultipoles',
                 'PyBirdTracerPowerSpectrumMultipoles', 'FOLPSTracerCorrelationFunctionMultipoles',
                 'FOLPSAXTracerCorrelationFunctionMultipoles', 'LPTVelocileptorsTracerCorrelationFunctionMultipoles',
                 'REPTVelocileptorsTracerCorrelationFunctionMultipoles', 'PyBirdTracerCorrelationFunctionMultipoles',
                 'GeoFPTAXTracerBispectrumMultipoles', 'JAXEffortTracerPowerSpectrumMultipoles', 'Cosmoprimo')


def __getattr__(name):
    if name in _COMPAT_NAMES:
        from .. import compat
        return getattr(compat, name)
    raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
