"""desilike_tpu_torch: the PyTorch / CUDA port of desilike_tpu for NVIDIA Hopper.

A second package beside ``desilike_tpu`` (the JAX reference). It ports the
single-tracer BAO likelihood: calculator graph, host-side fiducial
cosmology, BAO template and damped-wiggle theory, windowed observable,
analytic covariance and the Gaussian likelihood with static-J analytic
marginalization. Per-evaluation compute runs on a batch of chains, in
float32, on the CUDA card unless the caller asks for the CPU by name
(``device='cpu'``); the Chebyshev lookups run
through a hand-written CUDA kernel (``ops/cuda_kernels.py``).
"""

__version__ = '0.1.0'

from .config import set_dtype, get_dtype
from .utils import BaseClass
from .parameters import Parameter, ParameterCollection, Prior
from .core import Calculator, Pipeline
from .theories import DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate
from .observables import TracerPowerSpectrumMultipolesObservable, BoxFootprint
from .likelihoods import ObservablesGaussianLikelihood
