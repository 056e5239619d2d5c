from .chain import Chain
from .profiles import Profiles, ParameterBestFit, ParameterProfiles, ParameterGrid, ParameterContours
from . import diagnostics
from . import plotting
from ..interop import load_source, is_path, get_params_in_source  # noqa: F401
from ..parameters import Samples  # noqa: F401
from ..parameters.covariance import ParameterCovariance, ParameterPrecision  # noqa: F401
from ..utils import BaseClass  # noqa: F401
