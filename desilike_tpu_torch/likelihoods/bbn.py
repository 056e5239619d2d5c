"""Reference import-path shim: ``desilike.likelihoods.bbn``
(Schoneberg2024BBNLikelihood), implemented in
:mod:`desilike_tpu_torch.likelihoods.external`."""

from ..utils import forward_module_getattr

from .external import BaseBBNLikelihood, Schoneberg2024BBNLikelihood  # noqa: F401
__getattr__ = forward_module_getattr('desilike_tpu_torch.likelihoods')
