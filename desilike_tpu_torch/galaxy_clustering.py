"""Reference import-path shim: ``desilike.galaxy_clustering``, the path the
reference's getting-started guide imports templates from (its shorthand for
``desilike.theories.galaxy_clustering``)."""

from .utils import forward_module_getattr

__getattr__ = forward_module_getattr('desilike_tpu_torch.theories', 'desilike_tpu_torch.observables',
                                     'desilike_tpu_torch.compat')
