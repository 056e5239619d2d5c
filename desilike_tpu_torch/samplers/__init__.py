from .base import BasePosteriorSampler, Diagnostics
from .ensemble import EnsembleSampler, EnsembleSliceSampler
from .mcmc import MCMCSampler, BlockedMCMCSampler
from .nuts import NUTSSampler
from .deterministic import GridSampler, QMCSampler, ImportanceSampler
from .hmc import HMCSampler, MCLMCSampler
from .nested import NestedSampler
from .chees import ChEESSampler
