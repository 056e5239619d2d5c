"""Type Ia supernova likelihoods: distance-modulus Gaussian likelihoods.

Counterpart of ``desilike_tpu/likelihoods/supernovae.py`` (Pantheon,
Pantheon+, Pantheon+SH0ES, Union3, DES-Y5), with the same readers of the
real file layouts and the same fixture writer (numpy copies):

- the ``*.dataset`` config file ('key = value' text) naming the light-curve
  table and the magnitude covariance,
- the named-column light-curve table (whitespace- or comma-separated with a
  header line),
- the covariance file (first line = size, then the flattened matrix),
- per-dataset selections and corrections: the z > 0.01 cosmology mask
  (Pantheon+), the heliocentric-frame correction 5 log10((1+z_hel)/(1+z_cmb)),
  the SH0ES cepheid-host calibrator distances, the DES-Y5 diagonal
  MUERR_FINAL addition.

Everything data-side is static numpy at initialization. Per evaluation,
mu(z) comes from the background distances at every supernova, all from one
shared set of quadrature nodes (:class:`..cosmology.background.SharedQuadrature`:
one (B, 128) evaluation of E and one product onto the n redshifts, where
the JAX package evaluates a 64-node quadrature per redshift), plus the
magnitude offset, which is solved with a static design row
(``_static_linear_solved``).

Without ``data_dir=``, arrays or ``data_fn=``, the JAX package looks the
data up through its installer; that path is ROADMAP A17 here.
"""

import os

import numpy as np
import torch

from ..theories.cosmology import Cosmology
from ..cosmology import background as bg
from .base import BaseGaussianLikelihood


# --------------------------------------------------------------------------
# Real dataset file layouts: readers + fixture writer


def read_sn_config(fn):
    """'key = value' dataset file (reference supernovae/base.py:41-72)."""
    out = {}
    with open(fn) as fh:
        for line in fh:
            kv = [v.strip() for v in line.split('=')]
            if len(kv) == 2:
                out[kv[0]] = kv[1]
    return out


def read_light_curve_params(fn, header='#', sep=None, skip=None):
    """Named-column light-curve table (reference base.py:81-105): the first
    non-skipped line names the columns (stripped of the ``header`` prefix);
    ``sep=None`` splits on whitespace, ``sep=','`` reads CSV. Columns that
    parse as floats become float arrays, others stay string arrays."""
    names, rows = None, []
    with open(fn) as fh:
        for iline, line in enumerate(fh):
            if not line.strip():
                continue
            if skip is not None:
                if isinstance(skip, str):
                    if line.strip().startswith(skip):
                        continue
                elif iline <= skip:
                    continue
            if names is None:
                text = line[len(header):] if header and line.startswith(header) else line
                names = [n.strip() for n in text.split(sep) if n.strip()]
                continue
            rows.append([el.strip() for el in line.split(sep) if el.strip()])
    out = {}
    for i, name in enumerate(names):
        col = [row[i] for row in rows]
        try:
            out[name] = np.array([float(v) for v in col])
        except ValueError:
            out[name] = np.array(col)
    return out


def read_sn_covariance(fn):
    """Magnitude covariance: first line = size, then the flattened matrix
    (reference base.py:74-79)."""
    with open(fn) as fh:
        size = int(fh.readline())
    return np.loadtxt(fn, skiprows=1).reshape(size, size)


def write_sn_dataset(data_dir, light_curve, covariance, config_fn='config.dataset',
                     data_file='lcparams.txt', mag_covmat_file='sys_full.cov',
                     header='#', sep=' '):
    """Write the dataset layout the readers above consume (inverse of
    read_sn_config/read_light_curve_params/read_sn_covariance) -- fixture
    generator for exercising the real-format code paths without network
    access."""
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, config_fn), 'w') as fh:
        fh.write('name = fixture\n')
        fh.write('data_file = {}\n'.format(data_file))
        fh.write('mag_covmat_file = {}\n'.format(mag_covmat_file))
    names = list(light_curve)
    n = len(light_curve[names[0]])
    with open(os.path.join(data_dir, data_file), 'w') as fh:
        fh.write(header + sep.join(names) + '\n')
        for i in range(n):
            fh.write(sep.join('{!r}'.format(float(light_curve[c][i]))
                              if np.issubdtype(np.asarray(light_curve[c]).dtype, np.floating)
                              else str(light_curve[c][i]) for c in names) + '\n')
    covariance = np.asarray(covariance, dtype='f8')
    with open(os.path.join(data_dir, mag_covmat_file), 'w') as fh:
        fh.write('{:d}\n'.format(covariance.shape[0]))
        np.savetxt(fh, covariance.reshape(-1))


class BaseSNLikelihood(BaseGaussianLikelihood):
    r"""mu(z) = 5 log10(D_L / 10pc) + M_b against measured magnitudes.

    Parameters
    ----------
    z : array of redshifts (CMB frame)
    magnitudes : array of (corrected) apparent magnitudes m_B
    covariance : (n, n) covariance (stat+sys)
    zhel : optional heliocentric redshifts; adds the frame correction
        5 log10((1+z_hel)/(1+z_cmb)) to the theory side
    cosmo : optional shared Cosmology node
    data_dir : real dataset directory; per-dataset subclasses set the config
        name and column mapping
    """

    config_fn = 'config.dataset'
    lc_header, lc_sep, lc_skip = '#', None, None
    _static_linear_solved = ('Mb',)
    _params = dict(BaseGaussianLikelihood._params)
    _params.update({'Mb': dict(value=-19.2, prior=dict(limits=[-25., -15.]),
                               ref=dict(dist='norm', loc=-19.2, scale=0.05), latex='M_b')})

    def initialize(self, z=None, magnitudes=None, covariance=None, zhel=None, cosmo=None, data_dir=None,
                   config_fn=None, data_fn=None, cov_fn=None, **kwargs):
        if z is None and data_dir is None and data_fn is None:
            raise NotImplementedError('{} without data_dir=, data_fn= or arrays looks its data up through the '
                                      'installer: ROADMAP A17'.format(type(self).__name__))
        if data_dir is not None:
            config = read_sn_config(os.path.join(data_dir, config_fn or self.config_fn))
            lc = read_light_curve_params(os.path.join(data_dir, config['data_file']), header=self.lc_header,
                                         sep=self.lc_sep, skip=self.lc_skip)
            covariance = read_sn_covariance(os.path.join(data_dir, config['mag_covmat_file']))
            z, magnitudes, covariance, zhel = self._prepare(lc, covariance)
        elif data_fn is not None:
            # bare two-column (z, m_B) text + plain-text covariance
            arr = np.loadtxt(str(data_fn))
            z, magnitudes = arr[:, 0], arr[:, 1]
            if cov_fn is not None:
                covariance = np.loadtxt(str(cov_fn))
                n = len(z)
                if covariance.ndim == 1:
                    covariance = covariance[int(covariance[0] == n):].reshape(n, n)
        self.z = np.asarray(z, dtype='f8')
        self._distances = bg.SharedQuadrature(self.z)
        # static frame correction, added to the theory prediction
        self._mu_static = np.zeros(len(self.z)) if zhel is None \
            else 5. * np.log10((1. + np.asarray(zhel, dtype='f8')) / (1. + self.z))
        self._1pz = 1. + self.z
        self.cosmo = cosmo if cosmo is not None else Cosmology()
        super().initialize(data=np.asarray(magnitudes, dtype='f8'), covariance=covariance)

    def _prepare(self, light_curve, covariance):
        """(z_cmb, magnitudes, covariance, zhel) from the raw light-curve
        columns; per-dataset subclasses apply their selections here."""
        return (light_curve['zcmb'], light_curve['mb'], covariance, light_curve.get('zhel'))

    def _dl(self):
        """D_L = (1 + z) D_M in Mpc/h at every supernova, (B, n)."""
        return self.const('_1pz') * bg.comoving_angular_distances(self.cosmo.p, self._distances)

    def _mu_of_z(self):
        return 5. * torch.log10(self._dl() / self.cosmo.p['h'][..., None]) + 25.

    def flattheory(self):
        return self._mu_of_z() + self.const('_mu_static') + self._mb[..., None]

    def calculate(self, Mb=-19.2, **kw):
        self._mb = Mb
        super().calculate()


class PantheonSNLikelihood(BaseSNLikelihood):
    """Pantheon compilation (Scolnic et al. 2018): columns zcmb/zhel/mb,
    heliocentric frame correction."""

    name = 'PantheonSN'
    config_fn = 'full_long.dataset'


class PantheonPlusSNLikelihood(BaseSNLikelihood):
    """Pantheon+ without SH0ES (Brout et al. 2022): columns zHD/zHEL/m_b_corr,
    only z > 0.01 kept for cosmology, heliocentric correction."""

    name = 'PantheonPlusSN'
    lc_header = ''
    zcut = 0.01

    def _prepare(self, light_curve, covariance):
        z = light_curve['zHD']
        keep = z > self.zcut
        return (z[keep], light_curve['m_b_corr'][keep], covariance[np.ix_(keep, keep)], light_curve['zHEL'][keep])


class PantheonPlusSHOESSNLikelihood(BaseSNLikelihood):
    """Pantheon+ with SH0ES cepheid-host calibrators: keeps z > 0.01 or
    calibrator; the theory of a calibrator is its (static) cepheid host
    distance modulus, so the sample anchors M_b."""

    name = 'PantheonPlusSHOESSN'
    lc_header = ''
    zcut = 0.01

    def _prepare(self, light_curve, covariance):
        z = light_curve['zHD']
        is_cal = np.asarray(light_curve['IS_CALIBRATOR'], dtype='f8') > 0.5
        keep = (z > self.zcut) | is_cal
        self._is_calibrator = is_cal[keep]
        self._cepheid_distance = np.asarray(light_curve['CEPH_DIST'], dtype='f8')[keep]
        # calibrators use the cepheid distance: no frame term for them
        zhel = np.where(self._is_calibrator, z[keep], light_curve['zHEL'][keep])
        return z[keep], light_curve['m_b_corr'][keep], covariance[np.ix_(keep, keep)], zhel

    def flattheory(self):
        mu = self._mu_of_z() + self.const('_mu_static')
        mu = torch.where(self.const('_is_calibrator', dtype=torch.bool), self.const('_cepheid_distance'), mu)
        return mu + self._mb[..., None]


class Union3SNLikelihood(BaseSNLikelihood):
    """Union3 binned compilation (Rubin et al. 2023): 22 binned distance
    moduli; the nuisance is the offset dM on the dimensionless
    5 log10(100 D_L[Mpc/h]) + 25 prediction (the H0 dependence is absorbed
    in dM)."""

    name = 'Union3SN'
    _static_linear_solved = ('dM',)
    _params = dict(BaseGaussianLikelihood._params)
    _params.update({'dM': dict(value=-9.2, prior=dict(limits=[-20., 20.]), latex=r'\Delta \mathcal{M}_B')})

    def _prepare(self, light_curve, covariance):
        return light_curve['zcmb'], light_curve['mb'], covariance, None

    def flattheory(self):
        return 5. * torch.log10(100. * self._dl()) + 25. + self._mb[..., None]

    def calculate(self, dM=-9.2, **kw):
        self._mb = dM
        BaseGaussianLikelihood.calculate(self)


class DESY5SNLikelihood(BaseSNLikelihood):
    """DES 5-year sample (DES Collaboration 2024): CSV light-curve table with
    '#' comment lines, columns zHD/zHEL/MU/MUERR_FINAL; the diagonal
    MUERR_FINAL**2 is added to the covariance; data are distance moduli, so
    the offset prior is wide around zero."""

    name = 'DESY5SN'
    lc_header = ''
    lc_sep = ','
    lc_skip = '#'
    _params = dict(BaseGaussianLikelihood._params)
    _params.update({'Mb': dict(value=0., prior=dict(limits=[-5., 5.]), latex='M_b')})

    def _prepare(self, light_curve, covariance):
        covariance = covariance + np.diag(np.asarray(light_curve['MUERR_FINAL'], dtype='f8') ** 2)
        return light_curve['zHD'], light_curve['MU'], covariance, light_curve['zHEL']


# Short historical names kept for back-compatibility.
PantheonLikelihood = PantheonSNLikelihood
PantheonPlusLikelihood = PantheonPlusSNLikelihood
Union3Likelihood = Union3SNLikelihood
