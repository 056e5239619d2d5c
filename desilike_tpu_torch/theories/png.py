"""Primordial non-Gaussianity: the scale-dependent bias of tracer power
spectra.

Counterpart of ``desilike_tpu/theories/png.py``. Local-type fNL adds
Delta-b(k) = b_phi fNL / alpha(k), with alpha(k) = sqrt(P_lin(k, z) /
P_R(k)) the matter-to-curvature transfer (b_phi = 2 dc (b1 - p), dc =
1.686), at each chain's AP-remapped k: P_R from the primordial spectrum of
the template's cosmology (each chain's, for a direct template; the
fiducial one otherwise).
"""

import numpy as np
import torch

from ..cosmology import background as bg
from ..cosmology import linear as lin
from .base import BaseTheoryPowerSpectrumMultipoles, WedgesMixin, _col
from .power_template import DirectPowerSpectrumTemplate


def _primordial_power(template, k):
    """(2 pi^2 / k^3) Delta_R^2(k) at the AP-remapped k (B, nk, nmu): the
    primordial spectrum of the template's cosmology, each chain's (a direct
    template's node), or the fiducial one."""
    cosmo = getattr(template, 'cosmo', None)
    if cosmo is None:
        curvature = lin.primordial_curvature(bg.tensors(template.fiducial, k), k)
    else:
        curvature = bg.per_chain(lin.primordial_curvature, cosmo.p, k.reshape(k.shape[0], -1)).reshape(k.shape)
    return (2. * np.pi ** 2) / k ** 3 * curvature


def _bfnl(mode, delta_c, b1, fnl_loc, p, bphi, bfnl_loc):
    if mode == 'bfnl':
        return bfnl_loc
    if mode == 'bphi':
        return bphi * fnl_loc
    return 2. * delta_c * (b1 - p) * fnl_loc


class PNGTracerPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles, WedgesMixin):
    r"""fNL tracer P_l(k): (b1 + Delta b(k) + f mu^2)^2 P(k) + sn0/nd.

    Parameters
    ----------
    mode : 'b-p' (vary fnl_loc and p with b_phi = 2 dc (b1 - p)), 'bphi'
        (vary fnl_loc and bphi directly), or 'bfnl' (vary the product
        bfnl_loc = b_phi f_NL directly).
    """

    @staticmethod
    def _params(init):
        mode = str(init.get('mode', 'b-p'))
        params = {
            'b1': dict(value=2., prior=dict(limits=[0., 4.]), ref=dict(dist='norm', loc=2., scale=0.1), latex='b_1'),
            'fnl_loc': dict(value=0., prior=dict(limits=[-300., 300.]), ref=dict(dist='norm', loc=0., scale=5.), latex=r'f_\mathrm{NL}^\mathrm{loc}'),
            'p': dict(value=1., fixed=True, prior=dict(limits=[0., 3.]), latex='p'),
            'bphi': dict(value=2., fixed=True, prior=dict(limits=[-10., 10.]), latex=r'b_\phi'),
            'bfnl_loc': dict(value=0., prior=dict(limits=[-1e3, 1e3]), ref=dict(limits=[-50., 50.]), latex=r'b_\phi f_\mathrm{NL}^\mathrm{loc}'),
            'sn0': dict(value=0., prior=dict(dist='norm', loc=0., scale=2.), latex='s_{n,0}'),
            'sigmas': dict(value=0., fixed=True, prior=dict(limits=[0., 10.]), latex=r'\Sigma_s'),
        }
        drop = {'b-p': ('bphi', 'bfnl_loc'), 'bphi': ('p', 'bfnl_loc'),
                'bfnl': ('fnl_loc', 'bphi', 'p')}.get(mode, ())
        for name in drop:
            params.pop(name, None)
        return params

    def initialize(self, k=None, ells=(0, 2, 4), template=None, mode='b-p', mu=8,
                   method='leggauss', shotnoise=1e4):
        super().initialize(k=k, ells=ells)
        self.mode = str(mode)
        if template is None:
            template = DirectPowerSpectrumTemplate()
        self.template = template
        kin = np.geomspace(min(1e-4, self.k[0] / 2), max(1., self.k[-1] * 2), 700)
        self.template.init.update(k=kin)
        self.set_k_mu(k=self.k, mu=mu, method=method, ells=self.ells)
        self.nd = 1. / float(shotnoise)
        self.delta_c = 1.686

    def calculate(self, b1=2., fnl_loc=0., p=1., bphi=2., bfnl_loc=0., sn0=0., sigmas=0., **kw):
        k, mu = self.const('k'), self.const('mu')
        jac, kap, muap = self.template.ap_k_mu(k, mu)
        f = _col(self.template.f_of_k(kap))
        pk = self.template.pk_dd_interp(kap)
        alpha = torch.sqrt(pk / _primordial_power(self.template, kap))
        b1 = _col(b1)
        delta_b = _bfnl(self.mode, self.delta_c, b1, _col(fnl_loc), _col(p), _col(bphi), _col(bfnl_loc)) / alpha
        fog = 1. / (1. + (_col(sigmas) * k[:, None] * mu) ** 2 / 2.) ** 2
        pkmu = _col(jac) * fog * (b1 + delta_b + f * muap ** 2) ** 2 * pk + _col(sn0) / self.nd
        self.power = self.to_poles(pkmu)

    @property
    def z(self):
        return self.template.z

    def get(self):
        return self.power


class PNGTracerVelocityPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles, WedgesMixin):
    r"""Tracer density-velocity cross power spectrum multipoles with local
    PNG scale-dependent bias: -i P_{gv,l}(k), the velocity contributing
    bv f mu 100 E(z) / (1 + z) / k (odd in mu: ells (1, 3)), the density
    (b1 + Delta b(k) + f mu^2); a Lorentzian in (sigmas k mu) times
    sinc(sigmau k) damps it. Full-sphere trapezoidal mu quadrature."""

    @staticmethod
    def _params(init):
        params = dict(PNGTracerPowerSpectrumMultipoles._params(init))
        del params['sn0']
        params['bv'] = dict(value=1., prior=dict(limits=[0., 4.]), ref=dict(dist='norm', loc=1., scale=0.1), latex='b_v')
        params['sigmau'] = dict(value=0., fixed=True, prior=dict(limits=[0., 10.]), latex=r'\Sigma_u')
        return params

    def initialize(self, k=None, ells=(1, 3), template=None, mode='b-p', mu=81):
        super().initialize(k=k, ells=ells)
        self.mode = str(mode)
        if template is None:
            template = DirectPowerSpectrumTemplate()
        self.template = template
        kin = np.geomspace(min(1e-4, self.k[0] / 2), max(1., self.k[-1] * 2), 700)
        self.template.init.update(k=kin)
        # full-sphere mu quadrature for the odd multipoles; the weights are for [0, 1], so halved for [-1, 1]
        self.set_k_mu(k=self.k, mu=np.linspace(-1., 1., int(mu)), ells=self.ells)
        self.wmu = self.wmu / 2.
        self.delta_c = 1.686

    def calculate(self, b1=2., bv=1., fnl_loc=0., p=1., bphi=2., bfnl_loc=0., sigmas=0., sigmau=0., **kw):
        k, mu = self.const('k'), self.const('mu')
        jac, kap, muap = self.template.ap_k_mu(k, mu)
        f = _col(self.template.f_of_k(kap))
        pk = self.template.pk_dd_interp(kap)
        alpha = torch.sqrt(pk / _primordial_power(self.template, kap))
        b1 = _col(b1)
        delta_b = _bfnl(self.mode, self.delta_c, b1, _col(fnl_loc), _col(p), _col(bphi), _col(bfnl_loc)) / alpha
        # velocity kernel: v ~ f aH delta / k, aH/h = 100 E(z)/(1+z) km/s/(Mpc/h)
        cosmo = getattr(self.template, 'cosmo', None)
        ez = cosmo.efunc(self.z) if cosmo is not None else float(bg.efunc(self.template.fiducial, self.z))
        vel = _col(bv) * f * muap * 100. * _col(ez) / (1. + self.z) / kap
        # sin(sigmau k)/(sigmau k): torch.sinc is sin(pi x)/(pi x)
        fog = 1. / (1. + (_col(sigmas) * kap * muap) ** 2 / 2.) * torch.sinc(_col(sigmau) * kap / np.pi)
        pkmu = _col(jac) * fog * (b1 + delta_b + f * muap ** 2) * vel * pk
        self.power = self.to_poles(pkmu)

    @property
    def z(self):
        return self.template.z

    def get(self):
        return self.power
