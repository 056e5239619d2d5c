from .base import APEffect, BaseTheoryPowerSpectrumMultipoles, WedgesMixin, ap_k_mu
from .power_template import BasePowerSpectrumTemplate, BAOPowerSpectrumTemplate, ShapeFitPowerSpectrumTemplate
from .bao import (BaseBAOWigglesPowerSpectrumMultipoles, DampedBAOWigglesPowerSpectrumMultipoles,
                  BaseBAOWigglesTracerPowerSpectrumMultipoles, DampedBAOWigglesTracerPowerSpectrumMultipoles)
from .full_shape import (BasePTPowerSpectrumMultipoles, KaiserPowerSpectrumMultipoles,
                         BaseTracerPowerSpectrumMultipoles, KaiserTracerPowerSpectrumMultipoles,
                         EFTLikeKaiserTracerPowerSpectrumMultipoles)
from .ept import EPTTracerPowerSpectrumMultipoles, EPTTracerCorrelationFunctionMultipoles
