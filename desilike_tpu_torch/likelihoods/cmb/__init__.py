"""The CMB likelihood family (counterpart of ``desilike_tpu/likelihoods/cmb``):
``ClTheory`` (injected tables with a Taylor response, or the emulated-Cl
engine) and the Planck 2018, Planck PR4 and ACT DR6 likelihoods, per chain."""

from .base import ClTheory, synthetic_cl_tables
from .planck2018 import (BasePlanck2018Likelihood,
                         TTTEEEHighlPlanck2018LiteLikelihood, TTHighlPlanck2018LiteLikelihood,
                         TTLowlPlanck2018Likelihood, EELowlPlanck2018Likelihood)
from .planck2018_gaussian import (BasePlanck2018GaussianLikelihood, Planck2018GaussianLikelihood,
                                  FullGridPlanck2018GaussianLikelihood,
                                  planck2018_base_fn, read_getdist_chains,
                                  read_planck2018_chain,
                                  read_getdist_covmat, read_getdist_margestats,
                                  convert_planck2018_params)
from .lollipop import (LollipopLikelihood, EELowlPlanck2020LollipopLikelihood,
                       BBLowlPlanck2020LollipopLikelihood, EBLowlPlanck2020LollipopLikelihood)
from .act_dr6_lensing import ACTDR6LensingLikelihood
from .planck2018_lensing import (Planck2018LensingLikelihood,
                                 read_planck2018_lensing_data,
                                 write_planck2018_lensing_data,
                                 synthetic_planck2018_lensing_data)
from .hillipop import (BaseHillipopLikelihood, TTTEEEHighlPlanck2020HillipopLikelihood,
                       TTHighlPlanck2020HillipopLikelihood, EEHighlPlanck2020HillipopLikelihood,
                       TEHighlPlanck2020HillipopLikelihood)
from .camspec import (BasePlanckNPIPECamspecLikelihood,
                      TTTEEEHighlPlanckNPIPECamspecLikelihood,
                      TTHighlPlanckNPIPECamspecLikelihood,
                      synthetic_camspec_data)


# --- clik-name aliases -----------------------------------------------------
# The clik names of the same Planck 2018 products (the JAX package's aliases;
# the clik C library is not wrapped). The lite/commander/simall clik names are
# the SAME likelihoods:

BasePlanck2018ClikLikelihood = BasePlanck2018Likelihood
TTHighlPlanck2018PlikLiteLikelihood = TTHighlPlanck2018LiteLikelihood
TTTEEEHighlPlanck2018PlikLiteLikelihood = TTTEEEHighlPlanck2018LiteLikelihood
TTLowlPlanck2018ClikLikelihood = TTLowlPlanck2018Likelihood
EELowlPlanck2018ClikLikelihood = EELowlPlanck2018Likelihood


class TTHighlPlanck2018PlikLikelihood(TTHighlPlanck2018LiteLikelihood):
    """Reference planck2018_clik.py:194 (full plik: per-frequency spectra with
    ~20 foreground/calibration nuisances via clik). Mapped onto the
    foreground-MARGINALIZED plik-lite reimplementation: same underlying data,
    no foreground nuisance parameters beyond A_planck."""


class TTTEEEHighlPlanck2018PlikLikelihood(TTTEEEHighlPlanck2018LiteLikelihood):
    """Reference planck2018_clik.py:278 — see
    :class:`TTHighlPlanck2018PlikLikelihood` for what the mapping drops."""


class TTHighlPlanck2018PlikUnbinnedLikelihood(TTHighlPlanck2018LiteLikelihood):
    """Reference planck2018_clik.py:250 (unbinned plik). Mapped onto the
    BINNED foreground-marginalized plik-lite reimplementation."""


class TTTEEEHighlPlanck2018PlikUnbinnedLikelihood(TTTEEEHighlPlanck2018LiteLikelihood):
    """Reference planck2018_clik.py:334 — see
    :class:`TTHighlPlanck2018PlikUnbinnedLikelihood`."""


class LensingPlanck2018ClikLikelihood(Planck2018LensingLikelihood):
    """Reference planck2018_clik.py:362 (Planck 2018 lensing bandpowers via
    clik). Mapped onto the native :class:`Planck2018LensingLikelihood`
    reimplementation (Gaussian bandpowers + CMB renormalization correction
    matrices); the clik_lensing binary container is not read — data ship as
    the documented directory layout (``write_planck2018_lensing_data``)."""
