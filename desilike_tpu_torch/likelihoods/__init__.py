from .base import (BaseLikelihood, BaseGaussianLikelihood, ObservablesGaussianLikelihood, FisherGaussianLikelihood,
                   SumLikelihood)
from .external import (BaseBBNLikelihood, Schoneberg2024BBNLikelihood, H0Likelihood, Riess2020H0Likelihood,
                       MbLikelihood, Riess2020MbLikelihood, CMBDistancePriorLikelihood)
from .supernovae import (BaseSNLikelihood, PantheonSNLikelihood, PantheonPlusSNLikelihood,
                         PantheonPlusSHOESSNLikelihood, Union3SNLikelihood, DESY5SNLikelihood,
                         PantheonLikelihood, PantheonPlusLikelihood, Union3Likelihood)
from . import cmb
from .galaxy_clustering import SNWeightedPowerSpectrumLikelihood
