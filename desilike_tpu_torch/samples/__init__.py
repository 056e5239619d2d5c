from .chain import Chain
from . import diagnostics
from ..parameters import Samples  # noqa: F401  (the reference's samples.Samples)
