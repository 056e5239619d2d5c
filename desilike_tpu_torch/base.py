"""Reference import-path shim: ``desilike.base`` (the calculator and
pipeline core). ``from desilike.base import BaseCalculator`` resolves here;
the names live in :mod:`desilike_tpu_torch.core`, the package root and
:mod:`desilike_tpu_torch.compat`."""

from .utils import forward_module_getattr

__getattr__ = forward_module_getattr('desilike_tpu_torch', 'desilike_tpu_torch.core', 'desilike_tpu_torch.compat')
