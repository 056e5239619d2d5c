from .prior import Prior
from .parameter import Parameter, ParameterCollection
from .samples import Samples
