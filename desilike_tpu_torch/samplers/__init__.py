from .base import BasePosteriorSampler, Diagnostics
from .ensemble import EnsembleSampler, EnsembleSliceSampler
from .mcmc import MCMCSampler, BlockedMCMCSampler
from .nuts import NUTSSampler
from .deterministic import GridSampler, QMCSampler, ImportanceSampler
from .hmc import HMCSampler, MCLMCSampler
from .nested import NestedSampler
from .chees import ChEESSampler

# the reference's class names (``desilike_tpu_torch.compat``), resolved at first use (PEP 562)
_COMPAT_NAMES = ('StaticDynestySampler', 'DynamicDynestySampler', 'PolychordSampler',
                 'NautilusSampler', 'PocoMCSampler', 'EmceeSampler', 'ZeusSampler')


def __getattr__(name):
    if name in _COMPAT_NAMES:
        from .. import compat
        return getattr(compat, name)
    raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
