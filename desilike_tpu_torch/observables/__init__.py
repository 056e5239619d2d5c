from .window import (WindowedPowerSpectrumMultipoles, WindowedCorrelationFunctionMultipoles, window_matrix_bininteg,
                     window_matrix_RR, matrix_lininterp)
from .power_spectrum import TracerPowerSpectrumMultipolesObservable
from .correlation_function import TracerCorrelationFunctionMultipolesObservable
from .covariance import BaseFootprint, BoxFootprint, ObservablesCovarianceMatrix, integral_legendre_product
from .bispectrum import TracerBispectrumMultipolesObservable
