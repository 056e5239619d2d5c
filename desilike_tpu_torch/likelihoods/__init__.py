from .base import (BaseLikelihood, BaseGaussianLikelihood, ObservablesGaussianLikelihood, FisherGaussianLikelihood,
                   SumLikelihood)
