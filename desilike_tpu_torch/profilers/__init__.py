from .base import BaseProfiler, ScipyProfiler, OptaxProfiler

# the reference's class names (``desilike_tpu_torch.compat``), resolved at first use (PEP 562)
_COMPAT_NAMES = ('MinuitProfiler', 'BOBYQAProfiler')


def __getattr__(name):
    if name in _COMPAT_NAMES:
        from .. import compat
        return getattr(compat, name)
    raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
