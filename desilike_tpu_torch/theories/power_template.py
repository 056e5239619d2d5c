"""Linear power spectrum templates.

Counterpart of ``desilike_tpu/theories/power_template.py`` for
``BasePowerSpectrumTemplate``, ``BAOPowerSpectrumTemplate`` and
``ShapeFitPowerSpectrumTemplate``. Fiducial tables and their Chebyshev
coefficients are computed once at initialization, host-side in float64, and
cast to the evaluation's dtype and device on first use. The BAO template's
tables are constant (only the growth rate is rescaled per evaluation), so
its coefficients never change and its lookups share one coefficient row.
ShapeFit rescales the tables per chain: ``pk_dd`` and ``pknow_dd`` become
(B, nk) tensors, their coefficients are fitted once per evaluation and
table on the device (:meth:`ChebyshevLogInterp.coeffs`), and the lookups
take one coefficient row per chain. The other templates (Direct,
wiggle-split, ...), the scale-dependent growth ``fk``, ``only_now`` and
other ``with_now`` filters, and templates on another fiducial or a varied
cosmology wait for ROADMAP A11: the fiducial is DESI's, and the no-wiggle
table is always built with the 'peakaverage' filter.
"""

import numpy as np
import torch

from ..core import Calculator
from ..cosmology import background as bg
from ..cosmology import linear as lin
from ..ops.chebyshev import ChebyshevLogInterp
from .base import APEffect, ap_k_mu


class BasePowerSpectrumTemplate(Calculator):
    """Base template: fiducial linear pk tables + AP parameterization.

    Exposes (as attributes after calculate) f, sigma8, fsigma8, qpar and
    qper, the fiducial ``*_fid`` twins, and the pk lookups
    ``pk_dd_interp`` / ``pknow_dd_interp``.
    """

    _state_attrs = ['pk_dd', 'pknow_dd', 'f', 'fsigma8', 'qpar', 'qper']

    def initialize(self, k=None, z=1., apmode='qparqper', with_now='peakaverage', only_now=False, eta=1. / 3.):
        if with_now != 'peakaverage' or only_now:
            raise NotImplementedError("with_now={!r}, only_now={!r}: only the 'peakaverage' no-wiggle table "
                                      "beside the full one is ported (ROADMAP A11)".format(with_now, only_now))
        if k is None:
            k = np.logspace(-3., 1., 400)
        self.k = np.asarray(k, dtype='f8')
        self.z = float(np.asarray(z))
        self.fiducial = bg.resolve()
        self.apeffect = APEffect(z=self.z, mode=apmode, eta=eta)
        self._set_fiducial()

    def _set_fiducial(self):
        """Host-side fiducial tables (float64)."""
        p = self.fiducial
        self.f_fid = float(bg.growth_rate(p, self.z))
        self.sigma8_fid = float(lin.sigma_r(p, 8., self.z))
        self.fsigma8_fid = self.f_fid * self.sigma8_fid
        self.rs_drag_fid = float(bg.rs_drag(p))
        self._cheb = ChebyshevLogInterp(self.k)
        self._cheb_cache = {}
        pk_dd = lin.pk_lin(p, self.k, self.z)
        pknow_dd = lin.NoWiggleFilter(self.k)(pk_dd, lin.pk_lin(p, self.k, self.z, nowiggle=True))
        self.set_fiducial_tables(pk_dd, pknow_dd)

    def set_fiducial_tables(self, pk_dd, pknow_dd):
        """Set the fiducial pk and no-wiggle pk tables on ``self.k`` and their
        Chebyshev coefficients (host-side float64)."""
        self.pk_dd_fid = np.asarray(pk_dd, dtype='f8')
        self.pknow_dd_fid = np.asarray(pknow_dd, dtype='f8')
        self.pk_dd_coeffs_fid = self._cheb.coeffs(self.pk_dd_fid)
        self.pknow_dd_coeffs_fid = self._cheb.coeffs(self.pknow_dd_fid)

    def calculate(self, **params):
        self.f, self.sigma8, self.fsigma8 = self.f_fid, self.sigma8_fid, self.fsigma8_fid
        self.pk_dd, self.pknow_dd = self.const('pk_dd_fid'), self.const('pknow_dd_fid')
        self._cheb_cache = {}

    def _cheb_coeffs(self, name):
        """Chebyshev coefficients of the current table ``name``: the
        fiducial ones (host float64, constant) while the table is the
        fiducial one, else fitted on the device, once per evaluation and
        table (cached by the table's identity)."""
        table = getattr(self, name)
        if table is self.const(name + '_fid'):
            return self.const(name + '_coeffs_fid')
        cached = self._cheb_cache.get(name)
        if cached is None or cached[0] is not table:
            cached = self._cheb_cache[name] = (table, self._cheb.coeffs(table))
        return cached[1]

    def pk_dd_coeffs(self):
        """Chebyshev coefficients of the current pk_dd, (order,) or (B,
        order): pair with ``self._cheb.evaluate_static`` for static grids."""
        return self._cheb_coeffs('pk_dd')

    def pknow_dd_coeffs(self):
        """Chebyshev coefficients of the current no-wiggle pk (the wiggle /
        no-wiggle split that IR resummation reads)."""
        return self._cheb_coeffs('pknow_dd')

    def pk_dd_interp(self, k):
        """pk_dd at k (any shape; (B, nk, nmu) for AP-remapped queries)."""
        return self._cheb.evaluate(self._cheb_coeffs('pk_dd'), k)

    def pknow_dd_interp(self, k):
        return self._cheb.evaluate(self._cheb_coeffs('pknow_dd'), k)

    def f_of_k(self, k):
        """Growth rate at (AP-remapped) k: the scalar f. The scale-dependent
        growth of the eh99 engine raises (ROADMAP A11)."""
        if getattr(getattr(self, 'cosmo', None), 'engine', None) == 'eh99':
            raise NotImplementedError('the scale-dependent growth rate of the eh99 engine is ROADMAP A11')
        return self.f

    @property
    def qpar(self):
        return self.apeffect.qpar

    @property
    def qper(self):
        return self.apeffect.qper

    def ap_k_mu(self, k, mu):
        return ap_k_mu(k, mu, qpar=self.qpar, qper=self.qper)


class BAOPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    """BAO template: AP scaling parameters + optional growth rescaling df.
    Exposes derived DH_over_rd, DM_over_rd, DV_over_rd, DH_over_DM."""

    @staticmethod
    def _params(init):
        params = {'df': dict(value=1., prior=dict(limits=[0., 2.]), ref=dict(limits=[0.95, 1.05]),
                             delta=0.02, latex='df', fixed=init.get('df_fixed', True))}
        for name in ['DH_over_rd', 'DM_over_rd', 'DV_over_rd', 'DH_over_DM']:
            params[name] = dict(derived=True, latex=name.replace('_over_', '/'))
        return params

    def initialize(self, **kwargs):
        super().initialize(**kwargs)
        p = self.fiducial
        DH = float(bg.hubble_distance(p, self.z))
        DM = float(bg.comoving_angular_distance(p, self.z))
        DV = (DH * DM ** 2 * self.z) ** (1. / 3.) if self.z > 0 else DH
        rd = self.rs_drag_fid
        self.DH_over_rd_fid = DH / rd
        self.DM_over_rd_fid = DM / rd
        self.DV_over_rd_fid = DV / rd
        self.DH_over_DM_fid = DH / DM

    def calculate(self, df=1., **params):
        super().calculate(**params)
        self.f = self.f_fid * df
        self.fsigma8 = self.fsigma8_fid * df
        eta = self.apeffect.eta
        self.DH_over_rd = self.qpar * self.DH_over_rd_fid
        self.DM_over_rd = self.qper * self.DM_over_rd_fid
        self.DV_over_rd = self.qpar ** eta * self.qper ** (1. - eta) * self.DV_over_rd_fid
        self.DH_over_DM = self.qpar / self.qper * self.DH_over_DM_fid


class ShapeFitPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    r"""ShapeFit template (Brieden et al. 2021, arXiv:2106.07641).

    pk = pk_fid * exp(dm/a * tanh(a ln(k/kp)) + dn * ln(k/kp)), growth
    rescaled by df (normalized to f sqrt(Ap) at the pivot). The tables are
    (B, nk) tensors, one row per chain.
    """

    @staticmethod
    def _params(init):
        return {
            'df': dict(value=1., prior=dict(limits=[0., 2.]), ref=dict(limits=[0.95, 1.05]), delta=0.02, latex='df'),
            'dm': dict(value=0., prior=dict(limits=[-3., 3.]), ref=dict(limits=[-0.01, 0.01]), delta=0.01, latex='dm'),
            'dn': dict(value=0., fixed=True, prior=dict(limits=[-0.5, 0.5]), ref=dict(dist='norm', loc=0., scale=0.1), latex='dn'),
            'f_sqrt_Ap': dict(derived=True, latex=r'f A_p^{1/2}'),
            'm': dict(derived=True, latex='m'),
            'n': dict(derived=True, latex='n'),
        }

    def initialize(self, kp=0.03, a=0.6, **kwargs):
        self.kp_shape = float(kp)
        self.a_shape = float(a)
        super().initialize(**kwargs)
        self.n_fid = float(self.fiducial['n_s'])
        lnkkp = np.log(self.k / self.kp_shape)
        self.lnkkp = lnkkp
        self.tanh_lnkkp = np.tanh(self.a_shape * lnkkp) / self.a_shape

    def set_fiducial_tables(self, pk_dd, pknow_dd):
        super().set_fiducial_tables(pk_dd, pknow_dd)
        # fiducial amplitude Ap = pknow(kp) (eq. 3.11) and slope m at the pivot, from the no-wiggle pk
        self.Ap_fid = float(np.interp(self.kp_shape, self.k, self.pknow_dd_fid))
        dk = 1e-2
        kk = self.kp_shape * np.array([1. - dk, 1. + dk])
        pknw = np.interp(kk, self.k, self.pknow_dd_fid)
        self.m_fid = float(np.diff(np.log(pknw))[0] / np.diff(np.log(kk))[0])

    def calculate(self, df=1., dm=0., dn=0., **params):
        super().calculate(**params)
        factor = torch.exp(dm[..., None] * self.const('tanh_lnkkp') + dn[..., None] * self.const('lnkkp'))
        self.pk_dd = self.pk_dd * factor
        self.pknow_dd = self.pknow_dd * factor
        self.n = self.n_fid + dn
        self.m = self.m_fid + dm
        self.f = self.f_fid * df
        self.fsigma8 = self.fsigma8_fid * df
        self.f_sqrt_Ap = self.f * self.Ap_fid ** 0.5
