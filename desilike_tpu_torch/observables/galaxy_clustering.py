"""Reference import-path shim: ``desilike.observables.galaxy_clustering``
(observables, footprints, window and fiber-collision operators, compression
observables)."""

from ..utils import forward_module_getattr

__getattr__ = forward_module_getattr('desilike_tpu_torch.observables', 'desilike_tpu_torch.compat')
