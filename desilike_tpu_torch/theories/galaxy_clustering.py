"""Reference import-path shim: ``desilike.theories.galaxy_clustering`` (the
BAO, full-shape, PNG and bispectrum family). The names live in
:mod:`desilike_tpu_torch.theories` or :mod:`desilike_tpu_torch.compat`."""

from ..utils import forward_module_getattr

__getattr__ = forward_module_getattr('desilike_tpu_torch.theories', 'desilike_tpu_torch.compat')
