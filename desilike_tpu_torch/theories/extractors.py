"""Extractors: compressed parameters from a varied cosmology, per chain.

Counterpart of ``desilike_tpu/theories/extractors.py``: (qpar, qper, df,
dm, ...) computed from the base cosmological parameters of a
:class:`~.cosmology.Cosmology` node, for compression and for
template-to-direct consistency. The fiducial values are computed once, on
the host in float64; per evaluation every quantity is a ``(B,)`` tensor.
Where a pivot moves with the chain (ShapeFit's kp / (rd / rd_fid), the band
pivots kp / qiso), the linear pk is evaluated at one row of k a chain
(:func:`~..cosmology.background.per_chain`).
"""

import numpy as np
import torch

from ..core import Calculator
from ..cosmology import background as bg
from ..cosmology import linear as lin
from ..ops.legendre import trapz_weights
from .cosmology import Cosmology, TNCDM_NEFF


class BAOExtractor(Calculator):
    """BAO distance ratios from the cosmology. Derived: DH_over_rd,
    DM_over_rd, DV_over_rd, DH_over_DM, and the q-parameters relative to the
    fiducial."""

    _params = {name: dict(derived=True) for name in
               ('DH_over_rd', 'DM_over_rd', 'DV_over_rd', 'DH_over_DM', 'qpar', 'qper', 'qiso', 'qap')}

    def initialize(self, z=1., eta=1. / 3., cosmo=None, fiducial=None):
        self.z = float(np.asarray(z))
        self.eta = float(eta)
        fiducial = fiducial if isinstance(fiducial, dict) else None
        fid = bg.resolve(fiducial)
        self.fiducial = fid
        self.cosmo = cosmo if cosmo is not None else Cosmology(fiducial=fiducial)
        DH = float(bg.hubble_distance(fid, self.z))
        DM = float(bg.comoving_angular_distance(fid, self.z))
        rd = float(bg.rs_drag(fid))
        self.DH_over_rd_fid = DH / rd
        self.DM_over_rd_fid = DM / rd
        self.DH_over_DM_fid = DH / DM
        self.DV_over_rd_fid = (DH ** self.eta * DM ** (1. - self.eta) * self.z ** (1. / 3.)) / rd

    def calculate(self, **params):
        DH = self.cosmo.hubble_distance(self.z)
        DM = self.cosmo.comoving_angular_distance(self.z)
        rd = self.cosmo.rs_drag()
        self.DH_over_rd = DH / rd
        self.DM_over_rd = DM / rd
        self.DH_over_DM = DH / DM
        self.DV_over_rd = (DH ** self.eta * DM ** (1. - self.eta) * self.z ** (1. / 3.)) / rd
        self.qpar = self.DH_over_rd / self.DH_over_rd_fid
        self.qper = self.DM_over_rd / self.DM_over_rd_fid
        self.qiso = self.DV_over_rd / self.DV_over_rd_fid
        self.qap = self.DH_over_DM / self.DH_over_DM_fid


_EXTRACT_K = np.geomspace(1e-4, 10., 512)
_EXTRACT_W = trapz_weights(_EXTRACT_K)


def _tophat_window_derivative(x):
    """dW/dx of the spherical tophat W = 3 (sin x - x cos x) / x^3: -3 j2(x) / x,
    and -x / 5 (the derivative of the small-x series 1 - x^2 / 10) below 1e-3."""
    xs = torch.clamp(x, min=1e-3)
    j2 = (3. / xs ** 3 - 1. / xs) * torch.sin(xs) - 3. * torch.cos(xs) / xs ** 2
    return torch.where(x < 1e-3, -x / 5., -3. * j2 / xs)


def _sigma_r2_and_slope(p, pk_func, r, kernel='gauss'):
    r"""(sigma_r^2, d sigma_r^2 / d ln r) on the static extractor k grid, per
    chain: sigma_r^2 = 1/(2 pi^2) \int k^2 P(k) K(kr) dk, with the ln-r
    derivative of the kernel analytic (gauss: K = e^{-x^2}, K' = -2 x^2
    e^{-x^2}; tophat: K = W^2(x), K' = 2 x W W'); ``r`` a number or per
    chain."""
    k = bg.as_grid(_EXTRACT_K, p)
    pk = pk_func(k)
    x = k * bg.over(r, k)
    if kernel == 'gauss':
        K = torch.exp(-x ** 2)
        Kp = -2. * x ** 2 * K
    elif kernel == 'tophat':
        w = lin.tophat_window(x)
        K = w ** 2
        Kp = 2. * x * w * _tophat_window_derivative(x)
    else:
        raise ValueError(kernel)
    wk = bg.as_grid(_EXTRACT_W, p)
    norm = 1. / (2. * np.pi ** 2)
    return norm * torch.sum(wk * k ** 2 * pk * K, dim=-1), norm * torch.sum(wk * k ** 2 * pk * Kp, dim=-1)


def _parabolic_logmax(k, pk):
    """Turn-over (k_TO, P_TO), per chain, by parabolic refinement of the
    log-log maximum of pk (..., nk) on the static grid k (a tensor)."""
    lk = torch.log10(k)
    lp = torch.log10(pk)
    i = torch.clamp(torch.argmax(lp, dim=-1, keepdim=True), 1, k.shape[-1] - 2)
    x0, x1, x2 = (lk[i[..., 0] + shift] for shift in (-1, 0, 1))
    y0, y1, y2 = (torch.gather(lp, -1, i + shift)[..., 0] for shift in (-1, 0, 1))
    c0 = y0 / ((x0 - x1) * (x0 - x2))
    c1 = y1 / ((x1 - x0) * (x1 - x2))
    c2 = y2 / ((x2 - x0) * (x2 - x1))
    a = c0 + c1 + c2
    lk0 = (c0 * (x1 + x2) + c1 * (x0 + x2) + c2 * (x0 + x1)) / (2. * a)
    lp0 = c0 * (lk0 - x1) * (lk0 - x2) + c1 * (lk0 - x0) * (lk0 - x2) + c2 * (lk0 - x0) * (lk0 - x1)
    return 10. ** lk0, 10. ** lp0


class StandardPowerSpectrumExtractor(BAOExtractor):
    """(qpar, qper, df) with df = f sigma_r / f sigma_r_fid, r = 8 qiso."""

    _params = dict(BAOExtractor._params)
    _params.update({'df': dict(derived=True), 'fsigmar': dict(derived=True)})

    def initialize(self, *args, r=8., **kwargs):
        self.r = float(r)
        super().initialize(*args, **kwargs)
        p = self.fiducial
        self.fsigmar_fid = float(bg.growth_rate(p, self.z)) * float(lin.sigma_r(p, self.r, self.z))

    def calculate(self, **params):
        super().calculate(**params)
        p = self.cosmo.p
        self.fsigmar = bg.growth_rate(p, self.z) * lin.sigma_r(p, self.r * self.qiso, self.z)
        self.df = self.fsigmar / self.fsigmar_fid


class ShapeFitPowerSpectrumExtractor(BAOExtractor):
    r"""ShapeFit (dm, dn, df) extraction (arXiv:2106.07641): m the slope of
    ln(pknow) at the rd-scaled pivot; df from f sqrt(Ap), Ap the no-wiggle
    amplitude at the pivot."""

    _params = dict(BAOExtractor._params)
    _params.update({name: dict(derived=True) for name in ('dm', 'dn', 'df', 'm', 'n', 'f_sqrt_Ap')})

    def initialize(self, *args, kp=0.03, a=0.6, n_varied=False, **kwargs):
        self.kp = float(kp)
        self.a = float(a)
        self.n_varied = bool(n_varied)
        super().initialize(*args, **kwargs)
        p = self.fiducial
        self.rd_fid_mpc = float(bg.rs_drag(p))
        self.n_fid = float(p['n_s'])
        self.m_fid, self.Ap_fid, self.f_fid = [float(v) for v in self._shape_values(bg.host_tensors(p), 1.)]
        self.f_sqrt_Ap_fid = self.f_fid * self.Ap_fid ** 0.5

    def _shape_values(self, p, s):
        """(m, Ap, f) at the pivot kp / s, with s = rd / rd_fid a number or per
        chain. The pk at the pivot is computed in float64 and m, Ap returned in
        ``p``'s dtype: m is a difference of two values of ln pk 2% apart in k,
        which float32 rounding put 1.5e-5 (0.4%) from the JAX package's x64
        value."""
        dtype, p64 = bg.ref(p).dtype, bg.float64(p)
        dk = 1e-2
        kk = bg.as_grid(np.array([1. - dk, 1. + dk, 1.]) * self.kp, p64)
        if isinstance(s, torch.Tensor):
            s = s.double()
            kk = kk / s[..., None]
            pknow = bg.per_chain(lambda q, k: lin.pk_lin(q, k, self.z, nowiggle=True), p64, kk)
        else:
            kk = kk / s
            pknow = lin.pk_lin(p64, kk, self.z, nowiggle=True)
        if self.n_varied:
            prim = kk[..., :2] * bg.per_chain(lin.primordial_curvature, p64, kk[..., :2]) \
                if isinstance(s, torch.Tensor) else kk[..., :2] * lin.primordial_curvature(p64, kk[..., :2])
            ratio = pknow[..., 1] / prim[..., 1] * prim[..., 0] / pknow[..., 0]
        else:
            ratio = pknow[..., 1] / pknow[..., 0]
        m = torch.log(ratio) / np.log((1. + dk) / (1. - dk))
        Ap = pknow[..., 2] / s ** 3
        return m.to(dtype), Ap.to(dtype), bg.growth_rate(p, self.z)

    def calculate(self, **params):
        super().calculate(**params)
        p = self.cosmo.p
        s = self.cosmo.rs_drag() / self.rd_fid_mpc
        self.m, Ap, f = self._shape_values(p, s)
        self.n = p['n_s']
        self.dm = self.m - self.m_fid
        self.dn = self.n - self.n_fid
        self.f_sqrt_Ap = f * Ap ** 0.5
        self.df = self.f_sqrt_Ap / self.f_sqrt_Ap_fid


class WiggleSplitPowerSpectrumExtractor(BAOExtractor):
    r"""Wiggle-split (qbao, qap, df, dm) extraction: amplitude and ln-r slope
    of the velocity spectrum smoothed at r = 8 (DV / DV_fid) Mpc/h, and the
    BAO dilation; through any cosmology engine (pk from ``cosmo.pk_dd``,
    velocities as f^2 pk in linear theory)."""

    _params = dict(BAOExtractor._params)
    _params.update({name: dict(derived=True) for name in ('qbao', 'df', 'dm', 'm', 'fsigmar')})

    def initialize(self, *args, r=8., kernel='gauss', **kwargs):
        self.r = float(r)
        self.kernel = str(kernel)
        super().initialize(*args, **kwargs)
        p = self.fiducial
        DH = float(bg.hubble_distance(p, self.z))
        DM = float(bg.comoving_angular_distance(p, self.z))
        self.DV_fid = DH ** self.eta * DM ** (1. - self.eta) * self.z ** (1. / 3.)
        f_fid = float(bg.growth_rate(p, self.z))
        pt = bg.host_tensors(p)
        s2, ds2 = _sigma_r2_and_slope(pt, lambda k: f_fid ** 2 * lin.pk_lin(pt, k, self.z), self.r, self.kernel)
        self.fsigmar_fid = float(torch.sqrt(s2))
        self.m_fid = float(-ds2 / s2 - 3.)

    def calculate(self, **params):
        super().calculate(**params)
        f = self.cosmo.growth_rate(self.z)
        DV = self.DV_over_rd * self.cosmo.rs_drag()
        r = self.r * DV / self.DV_fid
        s2, ds2 = _sigma_r2_and_slope(self.cosmo.p, lambda k: f[..., None] ** 2 * self.cosmo.pk_dd(k, self.z), r,
                                      self.kernel)
        self.fsigmar = torch.sqrt(s2)
        self.m = -ds2 / s2 - 3.
        self.qbao = self.qiso
        self.df = self.fsigmar / self.fsigmar_fid
        self.dm = self.m - self.m_fid


class BandVelocityPowerSpectrumExtractor(BAOExtractor):
    r"""Band velocity power (dptt_i, df, qap) extraction: the velocity power
    spectrum at the pivots kp / qiso (volume-rescaled by qiso^3) relative to
    the fiducial, and the growth amplitude at r = 8 qiso."""

    @staticmethod
    def _params(init):
        kp = init.get('kp', None)
        n = len(kp) if kp is not None else 0
        params = {name: dict(derived=True) for name in BAOExtractor._params}
        params.update({name: dict(derived=True) for name in ('df', 'fsigmar')})
        for i in range(n):
            params['dptt{:d}'.format(i)] = dict(derived=True, latex=r'\Delta P_{{\theta\theta,{:d}}}'.format(i))
        return params

    def initialize(self, *args, kp=None, **kwargs):
        if kp is None:
            raise ValueError('provide band pivots kp')
        self.kp = np.asarray(kp, dtype='f8')
        super().initialize(*args, **kwargs)
        p = self.fiducial
        f_fid = float(bg.growth_rate(p, self.z))
        self.pk_tt_fid = f_fid ** 2 * lin.pk_lin(p, self.kp, self.z)
        self.fsigmar_fid = f_fid * float(lin.sigma_r(p, 8., self.z))

    def calculate(self, **params):
        super().calculate(**params)
        f = self.cosmo.growth_rate(self.z)
        qiso = self.qiso
        kq = self.const('kp') / qiso[..., None]
        pk_tt = (f ** 2 / qiso ** 3)[..., None] * self.cosmo.pk_dd_rows(kq, self.z)
        self.dptt = pk_tt / self.const('pk_tt_fid')
        for i in range(len(self.kp)):
            setattr(self, 'dptt{:d}'.format(i), self.dptt[..., i])
        self.fsigmar = f * self.cosmo.sigma_r(8. * qiso, self.z)
        self.df = self.fsigmar / self.fsigmar_fid


class TurnOverPowerSpectrumExtractor(BAOExtractor):
    r"""Turn-over (DV_times_kTO, DM_over_DH, qto, qap) extraction
    (arXiv:2302.07484): the maximum of the matter power spectrum, located per
    chain by parabolic log-log refinement on a static k grid."""

    _params = dict(BAOExtractor._params)
    _params.update({name: dict(derived=True) for name in ('kTO', 'DV_times_kTO', 'DM_over_DH', 'qto')})

    _KTO_GRID = np.geomspace(2e-3, 0.1, 160)

    def initialize(self, *args, **kwargs):
        super().initialize(*args, **kwargs)
        p = self.fiducial
        k = torch.as_tensor(self._KTO_GRID)
        kto_fid, _ = _parabolic_logmax(k, lin.pk_lin(bg.host_tensors(p), k, self.z))
        self.kTO_fid = float(kto_fid)
        DH = float(bg.hubble_distance(p, self.z))
        DM = float(bg.comoving_angular_distance(p, self.z))
        self.DV_fid = DH ** self.eta * DM ** (1. - self.eta) * self.z ** (1. / 3.)
        self.DV_times_kTO_fid = self.DV_fid * self.kTO_fid

    def calculate(self, **params):
        super().calculate(**params)
        # in float64: the parabola through three near-equal values of log pk at the maximum, in float32, put kTO 3e-3
        # from the JAX package's x64 value
        k = self.const('_KTO_GRID', torch.float64)
        kto, _ = _parabolic_logmax(k, self.cosmo._pk(bg.float64(self.cosmo.p), k, self.z))
        self.kTO = kto.to(self.dtype)
        DH = self.cosmo.hubble_distance(self.z)
        DM = self.cosmo.comoving_angular_distance(self.z)
        DV = DH ** self.eta * DM ** (1. - self.eta) * self.z ** (1. / 3.)
        self.DV_times_kTO = DV * self.kTO
        self.DM_over_DH = DM / DH
        self.qto = self.DV_times_kTO / self.DV_times_kTO_fid


class BAOPhaseShiftExtractor(BAOExtractor):
    r"""BAO + neutrino-phase-shift extraction (arXiv:1803.10741): baoshift
    measures N_eff through the phase-shift amplitude relative to the
    fiducial."""

    _params = dict(BAOExtractor._params)
    _params.update({'baoshift': dict(derived=True, latex=r'\beta_\phi')})

    A_NU = 8. / 7. * (11. / 4.) ** (4. / 3.)

    def initialize(self, *args, **kwargs):
        super().initialize(*args, **kwargs)
        p = self.fiducial
        self.N_eff_fid = float(p['N_ur']) + float(p.get('N_ncdm', 1)) * TNCDM_NEFF

    def calculate(self, **params):
        super().calculate(**params)
        neff = self.cosmo.N_eff
        self.baoshift = (neff * (self.N_eff_fid + self.A_NU)) / (self.N_eff_fid * (neff + self.A_NU))
