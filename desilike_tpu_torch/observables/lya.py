"""Reference import-path shim: ``desilike.observables.lya``
(P1DCompressionObservable)."""

from ..utils import forward_module_getattr

from .compression import P1DCompressionObservable  # noqa: F401
__getattr__ = forward_module_getattr('desilike_tpu_torch.observables')
