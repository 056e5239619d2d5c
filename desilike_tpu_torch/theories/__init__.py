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
