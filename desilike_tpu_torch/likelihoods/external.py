"""External (non-clustering) likelihoods: BBN, local H0 and Mb, the CMB
distance prior.

Counterpart of ``desilike_tpu/likelihoods/external.py``. Each theory is a
few (B,) quantities of the shared ``Cosmology`` node, stacked into a
(B, n) flat theory; the published measurements are those of the cited
papers.
"""

import numpy as np
import torch

from ..theories.cosmology import Cosmology
from ..cosmology import background as bg
from .base import BaseGaussianLikelihood


def stack(values, like):
    """(B, n) from n quantities, each a (B,) tensor or a number (broadcast to
    the batch of ``like``, a (B,) tensor of the evaluation)."""
    return torch.stack([torch.as_tensor(v, dtype=like.dtype, device=like.device).expand(like.shape) for v in values],
                       dim=-1)


class BaseBBNLikelihood(BaseGaussianLikelihood):
    """Gaussian likelihood on (omega_b, N_eff)-type quantities."""

    quantities = ('omega_b', 'N_eff')
    mean = None
    covariance = None

    def initialize(self, mean=None, covariance=None, quantities=None, cosmo=None, **kwargs):
        mean = self.mean if mean is None else mean
        covariance = self.covariance if covariance is None else covariance
        self.quantities = list(quantities or self.quantities)
        self.cosmo = cosmo if cosmo is not None else Cosmology()
        super().initialize(data=np.asarray(mean, dtype='f8'), covariance=np.asarray(covariance, dtype='f8'))

    def flattheory(self):
        p = self.cosmo.p
        values = [self.cosmo.N_eff if q == 'N_eff' else p[q] for q in self.quantities]
        return stack(values, bg.ref(p))


class Schoneberg2024BBNLikelihood(BaseBBNLikelihood):
    """BBN (omega_b, N_eff) from Schoneberg 2024 (arXiv:2401.15054)."""

    mean = [0.02196, 2.904]
    covariance = [[4.03112260e-07, 7.30390042e-05],
                  [7.30390042e-05, 4.52831584e-02]]


class H0Likelihood(BaseGaussianLikelihood):
    """Gaussian likelihood on H0 = 100 h."""

    mean = None
    std = None

    def initialize(self, mean=None, std=None, cosmo=None, **kwargs):
        mean = self.mean if mean is None else mean
        std = self.std if std is None else std
        self.cosmo = cosmo if cosmo is not None else Cosmology()
        super().initialize(data=[float(mean)], covariance=[[float(std) ** 2]])

    def flattheory(self):
        h = self.cosmo.p['h']
        return stack([100. * h], bg.ref(self.cosmo.p))


class Riess2020H0Likelihood(H0Likelihood):
    """Local H0 from Riess et al. 2020 (arXiv:2012.08534)."""

    mean = 73.2
    std = 1.3


class MbLikelihood(BaseGaussianLikelihood):
    """Gaussian likelihood on the SN absolute magnitude Mb."""

    mean = None
    std = None
    _params = dict(BaseGaussianLikelihood._params)
    _params.update({'Mb': dict(value=-19.263, prior=dict(limits=[-20., -18.]), latex='M_b')})

    def initialize(self, mean=None, std=None, **kwargs):
        mean = self.mean if mean is None else mean
        std = self.std if std is None else std
        super().initialize(data=[float(mean)], covariance=[[float(std) ** 2]])

    def flattheory(self):
        return self._mb[..., None]

    def calculate(self, Mb=-19.263, **kw):
        self._mb = Mb
        super().calculate()


class Riess2020MbLikelihood(MbLikelihood):
    mean = -19.263
    std = 0.049


class CMBDistancePriorLikelihood(BaseGaussianLikelihood):
    r"""CMB geometric compression: Gaussian on (R, l_A, omega_b), the
    distance-prior compression of the Planck 2018 likelihood (Chen, Huang &
    Wang 2019, arXiv:1808.05724: R = 1.7502 +- 0.0046, l_A = 301.471 +-
    0.090, omega_b = 0.02236 +- 0.00015, with their correlation matrix).

    Theory, per chain: z_* from the Hu & Sugiyama 1996 fit; D_M(z_*) from the
    background's quadrature at each chain's z_*; r_s(z_*) from this class's
    own integral (:meth:`rs_z`), not the background's ``sound_horizon``.
    These three and the whitened residual run in float64, which is then
    cast to the evaluation's dtype: sigma(l_A) is 3e-4 of l_A, so a chain
    40 sigma away (log-likelihood -908) carries 2 x 40 x the relative
    rounding of l_A / 3e-4 into chi2. In float32 the log-likelihood was
    9.8e-3 from the JAX package's x64 value there, and 7.6e-3 with the
    theory in float64 but its residual in float32 (config 3j's limit is 2e-2,
    and its chains go further out; measured on the CPU).
    """

    mean = [1.7502, 301.471, 0.02236]
    std = [0.0046, 0.090, 0.00015]
    corr = [[1.0, 0.46, -0.66],
            [0.46, 1.0, -0.33],
            [-0.66, -0.33, 1.0]]

    def initialize(self, mean=None, covariance=None, cosmo=None, **kwargs):
        mean = self.mean if mean is None else mean
        if covariance is None:
            std = np.asarray(self.std)
            covariance = np.asarray(self.corr) * np.outer(std, std)
        self.cosmo = cosmo if cosmo is not None else Cosmology()
        super().initialize(data=np.asarray(mean, dtype='f8'), covariance=np.asarray(covariance, dtype='f8'))

    @staticmethod
    def z_star(p):
        """Recombination redshift, Hu & Sugiyama 1996 fit (eq. E-1)."""
        return bg.z_star(p)

    @staticmethod
    def rs_z(p, z):
        """Comoving sound horizon at ``z`` (one a chain), Mpc/h: DH sum_i w_i
        c_s / (a E) over 512 points uniform in ln a from a = 1e-6 to a(z),
        no tail, w_i the central differences of the grid (``jnp.gradient``
        of a uniform grid: its step at every point, the ends included)."""
        t = np.arange(512) / 511.
        span = -torch.log1p(z) - np.log(1e-6)
        lna = np.log(1e-6) + span[..., None] * bg.as_grid(t, p)

        def integrand(q, row):
            a = torch.exp(row)
            cs = 1. / torch.sqrt(3. * (1. + 3. * q['omega_b'] / (4. * bg.omega_gamma(q)) * a))
            return cs / (a * bg.efunc_of_a(q, a))

        return bg.DH_100 * (span / 511.) * bg.per_chain(integrand, p, lna).sum(-1)

    def flattheory(self):
        p = bg.float64(self.cosmo.p)
        zs = self.z_star(p)
        dm = bg.comoving_angular_distance(p, zs)
        rs = self.rs_z(p, zs)
        R = torch.sqrt(bg.Omega_m(p)) * dm / bg.DH_100  # sqrt(Omega_m) H0 D_M(z_*) / c
        lA = np.pi * dm / rs
        return stack([R, lA, p['omega_b']], bg.ref(p))

    def calculate(self, **params):
        diff = self.flattheory() - self.const('flatdata', dtype=torch.float64)
        self.flatdiff_white = (diff @ self.const('_whiten', dtype=torch.float64).T).to(self.dtype)
        self.loglikelihood = -0.5 * (self.flatdiff_white ** 2).sum(-1)
