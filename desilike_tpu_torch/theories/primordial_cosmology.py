"""Reference import-path shim: ``desilike.theories.primordial_cosmology``.
The node is :class:`desilike_tpu_torch.theories.Cosmology`."""

from ..utils import forward_module_getattr

from .cosmology import Cosmology  # noqa: F401
__getattr__ = forward_module_getattr('desilike_tpu_torch.theories', 'desilike_tpu_torch.compat')
