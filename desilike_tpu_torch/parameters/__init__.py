from .prior import Prior
from .parameter import Parameter, ParameterCollection, Deriv
from .samples import Samples, DerivArray
from .covariance import ParameterCovariance, ParameterPrecision
