from .base import BasePosteriorSampler, Diagnostics
from .nuts import NUTSSampler
from .hmc import HMCSampler, MCLMCSampler
from .chees import ChEESSampler
