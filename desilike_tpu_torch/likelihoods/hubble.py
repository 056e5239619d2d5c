"""Reference import-path shim: ``desilike.likelihoods.hubble``
(Riess2020H0Likelihood, Riess2020MbLikelihood), implemented in
:mod:`desilike_tpu_torch.likelihoods.external`."""

from ..utils import forward_module_getattr

from .external import H0Likelihood, Riess2020H0Likelihood, MbLikelihood, Riess2020MbLikelihood  # noqa: F401
__getattr__ = forward_module_getattr('desilike_tpu_torch.likelihoods')
