"""Linear power spectrum templates.

Counterpart of ``desilike_tpu/theories/power_template.py``. Fiducial tables
and their Chebyshev coefficients are computed once at initialization,
host-side in float64, and cast to the evaluation's dtype and device on first
use. The BAO template's tables are constant (only the growth rate is
rescaled per evaluation), so its coefficients never change and its lookups
share one coefficient row. ShapeFit rescales the tables per chain, and the
Direct template computes them per chain from its :class:`Cosmology` node
(the growth rate, sigma8, the linear pk and its no-wiggle filter, with the
geometric AP effect from the same node): ``pk_dd`` and ``pknow_dd`` become
(B, nk) tensors, their coefficients are fitted once per evaluation and
table on the device (:meth:`ChebyshevLogInterp.coeffs`), and the lookups
take one coefficient row per chain. Under the eh99 engine the growth rate
is scale-dependent: ``f_of_k`` reads its (B, nk) table through the same
lookup.
"""

import numpy as np
import torch

from ..core import Calculator
from ..cosmology import background as bg
from ..cosmology import linear as lin
from ..ops.chebyshev import ChebyshevLogInterp
from ..ops.interp import interp1d
from ..ops.legendre import trapz_weights
from .base import APEffect, ap_k_mu, ap_s_mu
from .cosmology import Cosmology, _COSMO_PARAM_DEFAULTS


def loglog_interp(template_k_log10, values, k):
    """Cubic interpolation of a pk table ``values`` (..., nk) against log10 k,
    on ``template_k_log10``, at the wavenumbers k."""
    return interp1d(torch.log10(k) if isinstance(k, torch.Tensor) else np.log10(k), template_k_log10, values,
                    method='cubic')


class BasePowerSpectrumTemplate(Calculator):
    """Base template: fiducial linear pk tables + AP parameterization.

    ``with_now`` (any truthy value: the JAX package has one filter) builds
    the no-wiggle table ``pknow_dd``; ``only_now`` replaces ``pk_dd`` by it.
    Exposes (as attributes after calculate) f, f0, sigma8, fsigma8, qpar and
    qper, the fiducial ``*_fid`` twins, and the pk lookups ``pk_dd_interp``
    / ``pknow_dd_interp``.
    """

    _state_attrs = ['pk_dd', 'pknow_dd', 'f', 'fsigma8', 'qpar', 'qper']

    def initialize(self, k=None, z=1., fiducial=None, apmode='qparqper', with_now='peakaverage', only_now=False,
                   eta=1. / 3., cosmo=None):
        if k is None:
            k = np.logspace(-3., 1., 400)
        self.k = np.asarray(k, dtype='f8')
        self.z = float(np.asarray(z))
        fiducial = fiducial if isinstance(fiducial, dict) else None
        self.fiducial = bg.resolve(fiducial)
        self.only_now = bool(only_now)
        self.with_now = with_now or (only_now and 'peakaverage')
        self.apeffect = APEffect(z=self.z, mode=apmode, eta=eta, cosmo=cosmo, fiducial=fiducial)
        self._set_fiducial()

    def _set_fiducial(self):
        """Host-side fiducial tables (float64)."""
        p = self.fiducial
        self.f_fid = float(bg.growth_rate(p, self.z))
        self.f0_fid = self.f_fid
        self.sigma8_fid = float(lin.sigma_r(p, 8., self.z))
        self.fsigma8_fid = self.f_fid * self.sigma8_fid
        self.rs_drag_fid = float(bg.rs_drag(p))
        self._cheb = ChebyshevLogInterp(self.k)
        self._cheb_cache = {}
        pk_dd = lin.pk_lin(p, self.k, self.z)
        pknow_dd = None
        if self.with_now:
            pknow_dd = lin.NoWiggleFilter(self.k)(pk_dd, lin.pk_lin(p, self.k, self.z, nowiggle=True))
        self.set_fiducial_tables(pk_dd, pknow_dd)

    def set_fiducial_tables(self, pk_dd, pknow_dd=None):
        """Set the fiducial pk and no-wiggle pk tables on ``self.k`` and their
        Chebyshev coefficients (host-side float64)."""
        self.pk_dd_fid = np.asarray(pk_dd, dtype='f8')
        self.pk_dd_coeffs_fid = self._cheb.coeffs(self.pk_dd_fid)
        if pknow_dd is not None:
            self.pknow_dd_fid = np.asarray(pknow_dd, dtype='f8')
            self.pknow_dd_coeffs_fid = self._cheb.coeffs(self.pknow_dd_fid)

    def calculate(self, **params):
        self.f = self.f0 = self.f_fid
        self.sigma8, self.fsigma8 = self.sigma8_fid, self.fsigma8_fid
        self.pk_dd = self.const('pk_dd_fid')
        if self.with_now:
            self.pknow_dd = self.const('pknow_dd_fid')
        if self.only_now:
            self.pk_dd = self.pknow_dd
        self._cheb_cache = {}

    def _cheb_coeffs(self, name):
        """Chebyshev coefficients of the current table ``name``: the
        fiducial ones (host float64, constant) while the table is a fiducial
        one, else fitted on the device, once per evaluation and table
        (cached by the table's identity)."""
        table = getattr(self, name)
        for fid in ('pk_dd', 'pknow_dd'):
            if hasattr(self, fid + '_fid') and table is self.const(fid + '_fid'):
                return self.const(fid + '_coeffs_fid')
        cached = self._cheb_cache.get(name)
        if cached is None or cached[0] is not table:
            # one row for every chain (a host-injected table) is fitted in float64 at no cost: its float32 fit
            # moved the external Kaiser likelihood's gradient near the data's point by 3.7e-3 of its norm
            coeffs = self._cheb.coeffs(table.double()).to(table.dtype) if table.ndim == 1 else self._cheb.coeffs(table)
            cached = self._cheb_cache[name] = (table, coeffs)
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
        """Growth rate at (AP-remapped) k: the scalar f, unless the cosmology
        engine gives a scale-dependent one (eh99's neutrino free-streaming):
        then the lookup of its table ``fk``."""
        if getattr(getattr(self, 'cosmo', None), 'engine', None) == 'eh99':
            return self._cheb.evaluate(self._cheb_coeffs('fk'), k)
        return self.f

    @property
    def qpar(self):
        return self.apeffect.qpar

    @property
    def qper(self):
        return self.apeffect.qper

    def ap_k_mu(self, k, mu):
        return ap_k_mu(k, mu, qpar=self.qpar, qper=self.qper)

    def ap_s_mu(self, s, mu):
        return ap_s_mu(s, mu, qpar=self.qpar, qper=self.qper)


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
        self.f0 = self.f0_fid * df
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
        self.pk_dd = self.const('pk_dd_fid') * factor
        if self.with_now:
            self.pknow_dd = self.pknow_dd * factor
        if self.only_now:
            self.pk_dd = self.pknow_dd
        self.n = self.n_fid + dn
        self.m = self.m_fid + dm
        self.f = self.f_fid * df
        self.f0 = self.f0_fid * df
        self.fsigma8 = self.fsigma8_fid * df
        self.f_sqrt_Ap = self.f * self.Ap_fid ** 0.5


class DirectPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    """Direct template: base cosmological parameters (``varied``, the others
    fixed) of a :class:`Cosmology` node, which it creates unless given one
    (``cosmo=``: two templates may share a node), and the geometric AP
    effect from the same node. Per evaluation, per chain: pk_dd and, with
    ``with_now``, its no-wiggle filter (one product with the static
    smoothing matrix), f, sigma8 and fk. The engine is the given node's; on
    ``'external'`` no cosmological parameter is varied here (the host code
    varies the cosmology and injects its products), and the tables are one
    for every chain."""

    def initialize(self, k=None, z=1., fiducial=None, with_now='peakaverage', only_now=False, eta=1. / 3.,
                   varied=('h', 'omega_cdm', 'omega_b', 'logA', 'n_s'), engine='eh98', pk_table=None,
                   emulator=None, cosmo=None):
        if cosmo is not None:
            self.cosmo = cosmo
            engine = cosmo.init.get('engine', engine)
        else:
            self.cosmo = Cosmology(fiducial=fiducial if isinstance(fiducial, dict) else None, engine=engine,
                                   pk_table=pk_table, emulator=emulator)
        if engine != 'external':
            for name in varied:
                self.cosmo.init.params.set(_direct_param(name))
        # the AP effect shares this cosmology node (passed through init, so that it survives re-initialization)
        super().initialize(k=k, z=z, fiducial=fiducial, apmode='geometry', with_now=with_now, only_now=only_now,
                           eta=eta, cosmo=self.cosmo)
        if self.with_now:
            self._filter = lin.NoWiggleFilter(self.k)

    def calculate(self, **params):
        k = self.const('k')
        self.pk_dd = self.cosmo.pk_dd(k, self.z)
        self.f = self.f0 = self.cosmo.growth_rate(self.z)
        # flat but for the eh99 engine (the neutrino-suppressed growth rate)
        self.fk = self.cosmo.growth_rate_k(k, self.z)
        self.sigma8 = self.cosmo.sigma_r(8., self.z)
        self.fsigma8 = self.f * self.sigma8
        if self.with_now:
            self.pknow_dd = self._filter(self.pk_dd, self.cosmo.pk_dd_now(k, self.z))
        if self.only_now:
            self.pk_dd = self.pknow_dd
        self._cheb_cache = {}


def _direct_param(name):
    from ..parameters import Parameter
    return Parameter(basename=name, **dict(_COSMO_PARAM_DEFAULTS[name], fixed=False))


class FixedPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    """Fixed fiducial template, no varied parameters."""

    def initialize(self, **kwargs):
        kwargs.setdefault('apmode', 'qparqper')
        super().initialize(**kwargs)
        # fix the AP parameters: a pure fiducial template
        self.apeffect.init.params = {'qpar': dict(value=1., fixed=True), 'qper': dict(value=1., fixed=True)}
        self.apeffect.runtime_info.initialized = False


class BAOPhaseShiftPowerSpectrumTemplate(BAOPowerSpectrumTemplate):
    r"""BAO template with the N_eff-induced phase shift of the wiggles
    (Baumann et al. 2018, arXiv:1803.10741): wiggles are evaluated at
    k + (baoshift - 1) * f_shift(k) with f_shift = phi_inf / (1 + (k*/k)^eps)
    / rd, by the lookup of the fiducial wiggles' series (shared
    coefficients) at each chain's shifted k."""

    @staticmethod
    def _params(init):
        params = dict(BAOPowerSpectrumTemplate._params(init))
        params['baoshift'] = dict(value=1., prior=dict(limits=[-2., 4.]), ref=dict(dist='norm', loc=1., scale=0.1),
                                  latex=r'eta_\phi')
        return params

    def initialize(self, phiinf=0.227, kstar=0.0324, epsilon=0.872, **kwargs):
        self.phiinf = float(phiinf)
        self.kstar = float(kstar)
        self.epsilon = float(epsilon)
        super().initialize(**kwargs)
        self._wigphase_cheb = ChebyshevLogInterp(self.k, log_values=False)
        self._wigphase_coeffs = self._wigphase_cheb.coeffs(self.pk_dd_fid - self.pknow_dd_fid)
        self._kshift = self.phiinf / (1. + (self.kstar / self.k) ** self.epsilon) / self.rs_drag_fid

    def calculate(self, df=1., baoshift=1., **params):
        super().calculate(df=df, **params)
        k = self.const('k')
        kq = torch.clamp(k + (baoshift[..., None] - 1.) * self.const('_kshift'), self.k[0], self.k[-1])
        self.pk_dd = self.const('pknow_dd_fid') + self._wigphase_cheb.evaluate(self.const('_wigphase_coeffs'), kq)
        if self.only_now:
            self.pk_dd = self.pknow_dd


class StandardPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    """Standard RSD template: qpar/qper + df."""

    @staticmethod
    def _params(init):
        return {'df': dict(value=1., prior=dict(limits=[0., 2.]), ref=dict(limits=[0.95, 1.05]), delta=0.02,
                           latex='df')}

    def initialize(self, **kwargs):
        kwargs.setdefault('apmode', 'qparqper')
        super().initialize(**kwargs)

    def calculate(self, df=1., **params):
        super().calculate(**params)
        self.f = self.f_fid * df
        self.f0 = self.f0_fid * df
        self.fsigma8 = self.fsigma8_fid * df


def _sigma_r2_grid(k, wk, pk, r, kernel='gauss'):
    """sigma_r^2 = 1/(2 pi^2) int k^2 P(k) K(kr) dk on the static grid ``k``
    with its trapezoid weights ``wk`` (tensors); pk (..., nk), r a number."""
    if kernel == 'gauss':
        w = torch.exp(-(k * r) ** 2)
    elif kernel == 'tophat':
        w = lin.tophat_window(k * r) ** 2
    else:
        raise ValueError(kernel)
    return torch.sum(wk * k ** 2 * pk * w, dim=-1) / (2. * np.pi ** 2)


class WiggleSplitPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    r"""Wiggle-split template: the BAO wiggles move with qbao independently of
    the broadband; dm tilts the broadband as (k/0.05)^dm; the amplitude is
    re-normalized so that f sigma_r scales exactly with df. AP mode 'qap'
    (isotropic dilation is degenerate with qbao here). The wiggles at each
    chain's k/qbao are the lookup of the fiducial wiggles' series (shared
    coefficients)."""

    @staticmethod
    def _params(init):
        return {
            'df': dict(value=1., prior=dict(limits=[0., 2.]), ref=dict(limits=[0.95, 1.05]), delta=0.02, latex='df'),
            'dm': dict(value=0., prior=dict(limits=[-3., 3.]), ref=dict(limits=[-0.01, 0.01]), delta=0.01, latex='dm'),
            'qbao': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(limits=[0.99, 1.01]), delta=0.008,
                         latex=r'q_{\rm BAO}'),
            'r': dict(derived=True, latex='r'),
        }

    def initialize(self, r=8., kernel='gauss', **kwargs):
        self.r = float(r)
        self.kernel = str(kernel)
        kwargs.setdefault('apmode', 'qap')
        kwargs.setdefault('with_now', 'peakaverage')
        super().initialize(**kwargs)
        self._wiggle_cheb = ChebyshevLogInterp(self.k, log_values=False)
        self._wiggle_coeffs = self._wiggle_cheb.coeffs(self.pk_dd_fid - self.pknow_dd_fid)
        self._wk = trapz_weights(self.k)
        self.fsigmar_fid = self.f_fid * float(torch.sqrt(_sigma_r2_grid(
            torch.as_tensor(self.k), torch.as_tensor(self._wk), torch.as_tensor(self.pk_dd_fid), self.r, self.kernel)))

    def calculate(self, df=1., dm=0., qbao=1., **params):
        super().calculate(**params)
        k = self.const('k')
        factor = (k / 0.05) ** dm[..., None]
        wiggles = self._wiggle_cheb.evaluate(self.const('_wiggle_coeffs'), k / qbao[..., None])
        pk_unnorm = (self.const('pknow_dd_fid') + wiggles) * factor
        pknow_unnorm = self.const('pknow_dd_fid') * factor
        self.f = self.f_fid * df
        self.f0 = self.f0_fid * df
        # normalize: f sigma_r = df * fsigmar_fid exactly
        norm = ((df * self.fsigmar_fid / self.f) ** 2
                / _sigma_r2_grid(k, self.const('_wk'), pk_unnorm, self.r, self.kernel))[..., None]
        self.pk_dd = pk_unnorm * norm
        self.pknow_dd = pknow_unnorm * norm
        if self.only_now:
            self.pk_dd = self.pknow_dd
        self.m = dm


class BandVelocityPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    r"""Band-power template: the velocity power spectrum scaled by free band
    amplitudes dptt{i} at pivots kp, linearly interpolated in ln k between
    bands (flat beyond the end bands), with qap anisotropic scaling and
    growth rescaling df: per chain, one (B, nbands) x (nbands, nk) product."""

    @staticmethod
    def _params(init):
        kp = init.get('kp', None)
        n = len(kp) if kp is not None else 0
        params = {
            'df': dict(value=1., prior=dict(limits=[0., 2.]), ref=dict(limits=[0.95, 1.05]), delta=0.02, latex='df'),
        }
        for i in range(n):
            params['dptt{:d}'.format(i)] = dict(
                value=1., prior=dict(limits=[0., 3.]), ref=dict(limits=[0.99, 1.01]),
                delta=0.01, latex=r'\Delta P_{{\theta\theta,{:d}}}'.format(i))
        return params

    def initialize(self, kp=None, **kwargs):
        if kp is None:
            raise ValueError('provide band pivots kp')
        self.kp = np.asarray(kp, dtype='f8')
        kwargs.setdefault('apmode', 'qap')
        super().initialize(**kwargs)
        # partition-of-unity hat basis over log k, flat at the ends
        lkp = np.log(self.kp)
        lk = np.log(self.k)
        basis = np.zeros((len(self.kp), len(self.k)))
        for i in range(len(self.kp)):
            lo = lkp[i - 1] if i > 0 else -np.inf
            hi = lkp[i + 1] if i < len(self.kp) - 1 else np.inf
            up = np.clip((lk - lo) / (lkp[i] - lo), 0., 1.) if np.isfinite(lo) else np.ones_like(lk)
            down = np.clip((hi - lk) / (hi - lkp[i]), 0., 1.) if np.isfinite(hi) else np.ones_like(lk)
            basis[i] = np.minimum(up, down)
        self._band_basis = basis
        self._band_rest = 1. - basis.sum(axis=0)

    def _set_bands(self, amps, df):
        """pk_dd, pknow_dd and the growth from the band amplitudes (B, nbands) and df."""
        scale = amps @ self.const('_band_basis') + self.const('_band_rest')
        self.pk_dd = self.const('pk_dd_fid') * scale
        if self.with_now:
            self.pknow_dd = self.const('pknow_dd_fid') * scale
        self.f = self.f_fid * df
        self.f0 = self.f0_fid * df
        self.pk_tt = self.f[..., None] ** 2 * self.pk_dd

    def calculate(self, df=1., **params):
        super().calculate()
        self._set_bands(torch.stack([params['dptt{:d}'.format(i)] for i in range(len(self.kp))], dim=-1), df)


class TurnOverPowerSpectrumTemplate(BasePowerSpectrumTemplate):
    r"""Turn-over template (arXiv:2302.07484): the parametric form

        P(k) = P_TO^{1 - m x^2} (k above the turn-over),
               P_TO^{1 - n x^2} (below),   x = log10(k)/log10(k_TO) - 1,

    with free shape exponents m, n, turn-over scale k_TO = qto * k_TO^fid
    and height P_TO = dpto * P_TO^fid; derived DV_times_kTO and DH_over_DM
    track the AP dilation."""

    @staticmethod
    def _params(init):
        return {
            'm': dict(value=0.57, prior=dict(limits=[-1., 10.]), ref=dict(limits=[0., 1.]), delta=0.01, latex='m'),
            'n': dict(value=0.89, prior=dict(limits=[0., 10.]), ref=dict(limits=[0.5, 1.]), delta=0.01, latex='n'),
            'qto': dict(value=1., prior=dict(limits=[0.5, 1.5]), ref=dict(limits=[0.99, 1.01]), delta=0.008,
                        latex=r'q_{\rm TO}'),
            'dpto': dict(value=1., fixed=True, prior=dict(limits=[0., 2.]), ref=dict(limits=[0.9, 1.1]), delta=0.01,
                         latex=r'(P/P^{\rm fid})(k_{\rm TO})'),
            'df': dict(value=1., fixed=True, prior=dict(limits=[0., 2.]), ref=dict(limits=[0.95, 1.05]), latex='df'),
            'DV_times_kTO': dict(derived=True, latex=r'D_V k_{\rm TO}'),
            'DH_over_DM': dict(derived=True, latex=r'D_H/D_M'),
        }

    def initialize(self, **kwargs):
        kwargs.setdefault('apmode', 'qap')
        kwargs.setdefault('with_now', False)
        super().initialize(**kwargs)
        # fiducial turn-over: parabolic interpolation of the log-log maximum
        pk = self.pk_dd_fid
        imax = int(np.argmax(pk))
        lk = np.log10(self.k[imax - 1:imax + 2])
        lp = np.log10(pk[imax - 1:imax + 2])
        denom = (lk[0] - lk[1]) * (lk[0] - lk[2])
        c0 = lp[0] / denom
        c1 = lp[1] / ((lk[1] - lk[0]) * (lk[1] - lk[2]))
        c2 = lp[2] / ((lk[2] - lk[0]) * (lk[2] - lk[1]))
        a = c0 + c1 + c2
        lk0 = (c0 * (lk[1] + lk[2]) + c1 * (lk[0] + lk[2]) + c2 * (lk[0] + lk[1])) / (2. * a)
        self.kto_fid = 10. ** lk0
        # height of the parabola at the maximum
        self.pkto_fid = 10. ** float(lp[1] - a * (lk[1] - lk0) ** 2) if np.isfinite(a) else float(pk[imax])
        p = self.fiducial
        DH = float(bg.hubble_distance(p, self.z))
        DM = float(bg.comoving_angular_distance(p, self.z))
        self.DV_fid = (DH * DM ** 2 * self.z) ** (1. / 3.) if self.z > 0 else DH
        self.DH_over_DM_fid = DH / DM
        self.DV_times_kTO_fid = self.DV_fid * self.kto_fid

    def calculate(self, df=1., m=0.57, n=0.89, qto=1., dpto=1., **params):
        super().calculate()
        kto = self.kto_fid * qto
        pkto = (self.pkto_fid * dpto)[..., None]
        x = torch.log10(self.const('k')) / torch.log10(kto)[..., None] - 1.
        # the published two-branch form
        self.pk_dd = torch.where(x > 0, pkto ** (1. - m[..., None] * x ** 2), pkto ** (1. - n[..., None] * x ** 2))
        self.pknow_dd = self.pk_dd
        self.f = self.f_fid * df
        self.f0 = self.f0_fid * df
        self.kto = kto
        qiso = (self.qpar * self.qper ** 2) ** (1. / 3.)
        qap = self.qpar / self.qper
        self.DV_times_kTO = qiso * self.DV_times_kTO_fid
        self.DH_over_DM = qap * self.DH_over_DM_fid


class DirectWiggleSplitPowerSpectrumTemplate(DirectPowerSpectrumTemplate):
    r"""Direct template with the wiggly part dilated by qbao and damped by
    sigmabao (arXiv:2112.10749): base cosmological parameters while
    marginalizing over the sound-horizon scale. Each chain's wiggles are
    fitted to a series (per-row coefficients) and looked up at its k/qbao."""

    @staticmethod
    def _params(init):
        return {
            'qbao': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(limits=[0.99, 1.01]), delta=0.008,
                         latex=r'q_{\rm BAO}'),
            'sigmabao': dict(value=0., prior=dict(limits=[0., 20.]), ref=dict(limits=[0., 1.]),
                             latex=r'\Sigma_{\rm BAO}'),
        }

    def initialize(self, **kwargs):
        kwargs.setdefault('with_now', 'peakaverage')
        super().initialize(**kwargs)
        self._wiggle_cheb = ChebyshevLogInterp(self.k, log_values=False)

    def calculate(self, qbao=1., sigmabao=0., **params):
        super().calculate(**params)
        k = self.const('k')
        coeffs = self._wiggle_cheb.coeffs(self.pk_dd - self.pknow_dd)
        moved = self._wiggle_cheb.evaluate(coeffs, k / qbao[..., None])
        moved = moved * torch.exp(-(k * sigmabao[..., None]) ** 2)
        self.pk_dd = self.pknow_dd + moved
        if self.only_now:
            self.pk_dd = self.pknow_dd


class ExtractedBandVelocityPowerSpectrumTemplate(BandVelocityPowerSpectrumTemplate):
    r"""Band-power template whose band amplitudes dptt{i}, growth df and AP
    qap are computed by a :class:`BandVelocityPowerSpectrumExtractor` on a
    direct cosmology, instead of being sampled: the building block of
    :func:`BandVelocityPowerSpectrumCalculator`."""

    @staticmethod
    def _params(init):
        return {}

    def initialize(self, extractor=None, kp=None, eta=1. / 3., cosmo=None, fiducial=None, **kwargs):
        if extractor is None:
            from .extractors import BandVelocityPowerSpectrumExtractor
            extractor = BandVelocityPowerSpectrumExtractor(kp=kp, z=kwargs.get('z', 1.), eta=eta, cosmo=cosmo,
                                                           fiducial=fiducial)
        self.extractor = extractor
        self.eta = float(eta)
        kwargs.setdefault('apmode', 'qap')
        super().initialize(kp=kp, fiducial=fiducial, eta=eta, **kwargs)
        # the AP effect comes from the extractor, not a sampled qap
        self.apeffect.init.params = {'qap': dict(value=1., fixed=True)}
        self.apeffect.runtime_info.initialized = False

    @property
    def qpar(self):
        return self.extractor.qap ** (1. - self.eta)

    @property
    def qper(self):
        return self.extractor.qap ** (-self.eta)

    def calculate(self, **params):
        BasePowerSpectrumTemplate.calculate(self)
        self._set_bands(self.extractor.dptt, self.extractor.df)
        self.fsigma8 = self.fsigma8_fid * self.extractor.df


def BandVelocityPowerSpectrumCalculator(calculator=None, extractor=None, **kwargs):
    r"""Rewire ``calculator`` (a tracer theory built on
    :class:`BandVelocityPowerSpectrumTemplate`) so that its band amplitudes,
    growth and AP distortion are computed from a direct cosmology by a
    :class:`BandVelocityPowerSpectrumExtractor`, by a swap of its template.
    Returns the same calculator. Pass ``cosmo=Cosmology(fixed=False)`` to
    vary the cosmology (the default is fixed at the fiducial)."""
    calculator.runtime_info.initialize()
    template = calculator.template
    new_template = ExtractedBandVelocityPowerSpectrumTemplate(extractor=extractor, kp=template.kp, z=template.z,
                                                              **kwargs)
    calculator.init.update(template=new_template)
    return calculator
