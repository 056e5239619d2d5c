from .window import (WindowedPowerSpectrumMultipoles, WindowedCorrelationFunctionMultipoles, window_matrix_bininteg,
                     window_matrix_RR, matrix_lininterp)
from .power_spectrum import TracerPowerSpectrumMultipolesObservable
from .covariance import (BaseFootprint, BoxFootprint, CutskyFootprint, ObservablesCovarianceMatrix,
                         integral_legendre_product)
from .correlation_function import TracerCorrelationFunctionMultipolesObservable
from .compression import (BaseCompressionObservable, BAOCompressionObservable, ShapeFitCompressionObservable,
                          StandardCompressionObservable, WiggleSplitCompressionObservable,
                          BandVelocityCompressionObservable, TurnOverCompressionObservable, P1DCompressionObservable,
                          BAOPhaseShiftCompressionObservable)
from .fiber_collisions import (BaseFiberCollisionsPowerSpectrumMultipoles, BaseFiberCollisionsCorrelationFunctionMultipoles,
                               TopHatFiberCollisionsPowerSpectrumMultipoles, FiberCollisionsPowerSpectrumMultipoles,
                               SystematicTemplatePowerSpectrumMultipoles,
                               TopHatFiberCollisionsCorrelationFunctionMultipoles,
                               FiberCollisionsCorrelationFunctionMultipoles,
                               SystematicTemplateCorrelationFunctionMultipoles)
from .bispectrum import TracerBispectrumMultipolesObservable
from .types import ObservableArray, ObservableCovariance
