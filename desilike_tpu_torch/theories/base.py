"""Base theory classes: multipole grids, mu-wedge projection, AP effect,
and pk -> xi by FFTLog.

Counterpart of ``desilike_tpu/theories/base.py``: the AP effect in the
direct-parameter modes ('qiso', 'qap', 'qisoqap', 'qparqper') and in the
'geometry' and 'bao' modes, which read the distances of a
:class:`~.cosmology.Cosmology` node per chain against the fiducial ones.
"""

import numpy as np
import torch

from ..core import Calculator
from ..ops.chebyshev import _static_cubic_interp_matrix
from ..ops.fftlog import PowerToCorrelation
from ..ops.legendre import weights_mu, multipole_weights, to_poles
from ..observables.window import matrix_lininterp
from ..cosmology import background as bg
from .cosmology import Cosmology


def _col(value):
    """(B,) parameter -> (B, 1, 1), to broadcast against (B, nk, nmu) grids;
    a plain number, and a value already on such a grid (a scale-dependent
    growth rate at the AP-remapped k), stay as they are."""
    if isinstance(value, torch.Tensor) and value.ndim < 2:
        return value[..., None, None]
    return value


def ap_k_mu(k, mu, qpar=1., qper=1.):
    """Alcock-Paczynski remap of (k, mu), Beutler 2016 eqs. 44-45.

    k: (nk,) and mu: (nmu,) tensors; qpar, qper: scalars or (B,) tensors.
    Returns jac (B,), kap (B, nk, nmu) and muap (B, 1, nmu); without a batch
    dimension, jac is 0-d, kap (nk, nmu) and muap (1, nmu).
    """
    qpar = torch.as_tensor(qpar, dtype=k.dtype, device=k.device)
    qper = torch.as_tensor(qper, dtype=k.dtype, device=k.device)
    jac = 1. / (qpar * qper ** 2)
    qap = (qpar / qper)[..., None, None]
    factorap = torch.sqrt(1. + mu ** 2 * (1. / qap ** 2 - 1.))
    kap = k[:, None] / qper[..., None, None] * factorap
    muap = mu / qap / factorap
    return jac, kap, muap


def ap_s_mu(s, mu, qpar=1., qper=1.):
    """AP remap in configuration space (qpar -> 1/qpar etc.).

    s: (ns,) and mu: (nmu,) tensors; qpar, qper: scalars or (B,) tensors.
    Returns 1., sap (B, ns, nmu) and muap (B, 1, nmu), without a batch
    dimension sap (ns, nmu) and muap (1, nmu).
    """
    qpar = torch.as_tensor(qpar, dtype=s.dtype, device=s.device)
    qper = torch.as_tensor(qper, dtype=s.dtype, device=s.device)
    qap = (qpar / qper)[..., None, None]
    factorap = torch.sqrt(1. + mu ** 2 * (qap ** 2 - 1.))
    sap = s[:, None] * qper[..., None, None] * factorap
    muap = mu * qap / factorap
    return 1., sap, muap


class BaseTheoryPowerSpectrumMultipoles(Calculator):
    """Base for theory P_l(k); output attribute ``power`` of shape (B, nell, nk)."""

    _state_attrs = ['power']

    def initialize(self, k=None, ells=(0, 2, 4), **kwargs):
        if k is None:
            k = np.linspace(0.01, 0.2, 101)
        self.k = np.asarray(k, dtype='f8')
        self.ells = tuple(ells)

    def get(self):
        return self.power


class BaseTheoryCorrelationFunctionMultipoles(Calculator):
    """Base for theory xi_l(s); output attribute ``corr`` of shape (B, nell, ns)."""

    _state_attrs = ['corr']

    def initialize(self, s=None, ells=(0, 2, 4), **kwargs):
        if s is None:
            s = np.linspace(20., 200., 101)
        self.s = np.asarray(s, dtype='f8')
        self.ells = tuple(ells)

    def get(self):
        return self.corr


class WedgesMixin(object):
    """mu-wedge -> multipole projection."""

    def set_k_mu(self, k, mu=20, method='leggauss', ells=(0, 2, 4)):
        self.k = np.asarray(k, dtype='f8')
        self.mu, wmu = weights_mu(mu, method=method)
        self.wmu = multipole_weights(ells, self.mu, wmu)   # (nell, nmu)

    def to_poles(self, pkmu):
        """pkmu (..., nk, nmu) -> (..., nell, nk)."""
        return to_poles(pkmu, self.const('wmu'))


class APEffect(Calculator):
    r"""Alcock-Paczynski scaling.

    modes: 'qiso', 'qap', 'qisoqap', 'qparqper' (direct scaling parameters),
    'geometry' / 'bao' (the distances of ``cosmo``, per chain, against the
    fiducial ones, computed on the host; 'bao' in units of rs_drag).
    """

    @staticmethod
    def _params(init):
        mode = init.get('mode', 'geometry')
        specs = {
            'qiso': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_{\rm iso}'),
            'qap': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_{\rm AP}'),
            'qpar': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_\parallel'),
            'qper': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_\perp'),
        }
        varied = {'qiso': ['qiso'], 'qap': ['qap'], 'qisoqap': ['qiso', 'qap'],
                  'qparqper': ['qpar', 'qper'], 'geometry': [], 'bao': []}[mode]
        return {name: specs[name] for name in varied}

    def initialize(self, z=1., mode='geometry', fiducial=None, eta=1. / 3., cosmo=None):
        self.z = float(np.asarray(z))
        self.mode = str(mode)
        self.eta = float(eta)
        fiducial = fiducial if isinstance(fiducial, dict) else None
        fid = bg.resolve(fiducial)
        self.fiducial = fid
        self.DH_fid = float(bg.hubble_distance(fid, self.z))
        self.DM_fid = float(bg.comoving_angular_distance(fid, self.z))
        self.DV_fid = float((self.DH_fid * self.DM_fid ** 2 * self.z) ** (1. / 3.)) if self.z > 0 else self.DH_fid
        self.rd_fid = float(bg.rs_drag(fid))
        if self.mode in ('geometry', 'bao'):
            self.cosmo = cosmo if cosmo is not None else Cosmology(fiducial=fiducial)

    def calculate(self, **params):
        if self.mode in ('geometry', 'bao'):
            self.DH = self.cosmo.hubble_distance(self.z)
            self.DM = self.cosmo.comoving_angular_distance(self.z)
            self.DV = (self.DH * self.DM ** 2 * self.z) ** (1. / 3.) if self.z > 0 else self.DH
            if self.mode == 'bao':
                rd = self.cosmo.rs_drag()
                qpar = (self.DH / rd) / (self.DH_fid / self.rd_fid)
                qper = (self.DM / rd) / (self.DM_fid / self.rd_fid) if self.z > 0 else qpar
            else:
                qpar = self.DH / self.DH_fid
                qper = self.DM / self.DM_fid if self.z > 0 else qpar
        elif self.mode == 'qiso':
            qpar = qper = params['qiso']
        elif self.mode == 'qap':
            qap = params['qap']
            qpar, qper = qap ** (1. - self.eta), qap ** (-self.eta)
        elif self.mode == 'qisoqap':
            qiso, qap = params['qiso'], params['qap']
            qpar, qper = qiso * qap ** (1. - self.eta), qiso * qap ** (-self.eta)
        else:  # qparqper
            qpar, qper = params['qpar'], params['qper']
        self.qpar, self.qper = qpar, qper
        self.qap = qpar / qper
        self.qiso = qpar ** self.eta * qper ** (1. - self.eta)

    def ap_k_mu(self, k, mu):
        return ap_k_mu(k, mu, qpar=self.qpar, qper=self.qper)

    def ap_s_mu(self, s, mu):
        return ap_s_mu(s, mu, qpar=self.qpar, qper=self.qper)


class BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles(BaseTheoryCorrelationFunctionMultipoles):
    """xi_l(s) from the P_l(k) of the calculator ``power`` by FFTLog, with a
    log-slope extrapolation and a Gaussian damping of the high-k tail.

    Every step between the power node's (B, nell, nkin) multipoles and xi on
    ``s`` is linear in pk with static queries, so it is built once as host
    float64 matrices: the cubic landing of pk from ``kin`` onto the FFTLog
    grid up to kin[-1] (:attr:`landing_mid`), the log-slope tail beyond it
    from the last sample and the last difference (:attr:`landing_high`), and
    the linear interpolation from each multipole's FFTLog output grid onto
    ``s`` (:attr:`interp_s`). The Hankel transform's static factors are
    folded into them: the landing carries k^3 / (2 pi^2) k^-1.5 and the flip
    of :meth:`SphericalBesselTransform.transform_flipped`, the interpolation
    s^-1.5 and the sign of i^l. The tail is a static function of each
    multipole's last two samples, so its xi on s is too (:attr:`_corr_tail`).
    Per evaluation: one matrix product onto the grid up to kin[-1] (1105 of
    its 2048 points for the default kin), one rfft/irfft pair over the whole
    grid, one batched product onto s, and the tail's rank-2 term. The JAX package loops over the multipoles; here they are
    one batch.

    The landing and the transform run in float64: at s of 50-150 Mpc/h, xi
    is a small remainder of the transform, and the float32 rounding of its
    input and of the FFTs spread over every s (at config xi's 16 frozen
    points, in float32 the log-posterior is 5.9e-4 and the gradient 2.9e-4 of
    its norm from the JAX package's x64 values on the CPU, 5.0e-4 of the
    gradient on an H100; in float64 1.0e-4 and 8.5e-5 on the CPU).
    """

    def initialize(self, s=None, power=None, ells=None, **kwargs):
        if s is None:
            s = np.linspace(20., 200., 101)
        self.s = np.asarray(s, dtype='f8')
        if power is None:
            from .full_shape import KaiserTracerPowerSpectrumMultipoles
            power = KaiserTracerPowerSpectrumMultipoles()
        self.power = power
        self.k = np.logspace(-4., 3., 2048)
        kw = dict(kwargs)
        if ells is not None:
            kw['ells'] = tuple(ells)
        kin = self.power.init.get('k', None)
        if kin is None:
            self.kin = np.geomspace(self.k[0], 0.6, 300)
            kw['k'] = self.kin
        else:
            self.kin = np.asarray(kin, dtype='f8')
        self.power.init.update(**kw)
        self.ells = tuple(self.power.init.get('ells', (0, 2, 4)))
        self.fftlog = PowerToCorrelation(self.k, ells=self.ells, q=0, lowring=True)
        mask = self.k > self.kin[-1]
        nmid = int((~mask).sum())
        # pk on the FFTLog grid up to kin[-1]: cubic in log10 k
        self.landing_mid = _static_cubic_interp_matrix(np.log10(self.k[~mask]), np.log10(self.kin))  # (nmid, nkin)
        # beyond: (pk[-1] + slope log10(k / kin[-1])) damped, the slope from the last two samples, on
        # (pk[-1], pk[-1] - pk[-2])
        logk_high = np.log10(self.k[mask] / self.kin[-1])
        damp_high = np.exp(-(self.k[mask] / self.kin[-1] - 1.) ** 2 / (2. * 10. ** 2))
        step = logk_high / np.log10(self.kin[-1] / self.kin[-2])
        self.landing_high = np.stack([damp_high, step * damp_high], axis=-1)  # (nhigh, 2)
        self.interp_s = np.stack([matrix_lininterp(self.s, s) for s in self.fftlog.s])      # (nell, ns, nk)
        self._landing_t = np.ascontiguousarray((self.landing_mid * self.fftlog.pre[:nmid, None])[::-1].T)  # (nkin, nmid)
        self._interp_s_t = np.swapaxes(self.interp_s * self.fftlog.post[:, None, :], -1, -2)  # (nell, nk, ns)
        # xi on s of the tail, on (pk[-2], pk[-1]): (nell, 2, ns)
        tail = np.zeros((2, self.k.size))
        tail[:, nmid:] = (self.landing_high @ np.array([[0., 1.], [-1., 1.]])).T * self.fftlog.pre[nmid:]
        tail = self.fftlog._sbt.transform(torch.as_tensor(np.repeat(tail[:, None], len(self.ells), axis=1)))
        self._corr_tail = np.einsum('jlk,lks->ljs', tail.numpy(), self._interp_s_t)

    def get_corr(self, power):
        """power: (..., nell, nkin) -> (..., nell, ns) on self.s."""
        landed = (power.to(torch.float64).reshape(-1, self.kin.size) @ self.const('_landing_t', torch.float64)).reshape(
            power.shape[:-1] + (-1,))
        corr = self.fftlog._sbt.transform_flipped(landed).to(power.dtype)
        return (torch.einsum('...lk,lks->...ls', corr, self.const('_interp_s_t'))
                + torch.einsum('...lj,ljs->...ls', power[..., -2:], self.const('_corr_tail')))

    def calculate(self, **params):
        self.corr = self.get_corr(self.power.power)

    @property
    def template(self):
        return self.power.template
