"""Reference import-path shim: ``desilike.observables.weak_lensing``
(DESY3Observable; the host-evaluated node is
:class:`desilike_tpu_torch.theories.DESY3Theory`)."""

from ..utils import forward_module_getattr

__getattr__ = forward_module_getattr('desilike_tpu_torch.compat', 'desilike_tpu_torch.theories')
