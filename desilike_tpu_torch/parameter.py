"""Reference import-path shim: ``desilike.parameter``. The parameter layer
lives in :mod:`desilike_tpu_torch.parameters` (plural), with the
reference's aliases (ParameterPrior, ParameterArray) in the package root and
:mod:`desilike_tpu_torch.compat`."""

from .utils import forward_module_getattr

__getattr__ = forward_module_getattr('desilike_tpu_torch.parameters', 'desilike_tpu_torch',
                                     'desilike_tpu_torch.compat')
