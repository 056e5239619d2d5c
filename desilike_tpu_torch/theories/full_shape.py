"""Full-shape RSD models: Kaiser + EFT-like counterterms.

Counterpart of ``desilike_tpu/theories/full_shape.py`` for the Kaiser PT
tables and the Kaiser and EFT-like Kaiser tracer multipoles. Per evaluation:
AP-remap (k, mu) over the chain batch -> Chebyshev lookup of the template's
pk at the remapped k (the Clenshaw kernel; one coefficient row per chain
with a ShapeFit template) -> Legendre projection of pk_dd, pk_dt, pk_tt ->
bias combination -> counterterms ``(B, nct) x (nell, nk, nct)`` times pk11
and stochastic terms. The bias/counterterm structure stays explicitly
linear, which is what the analytic marginalization uses. The
correlation-function classes are the FFTLog transforms of these P(k)
multipoles (:class:`BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles`).
``SimpleTracerPowerSpectrumMultipoles`` is the damped Kaiser model on a
template's pk, without PT tables.
"""

import re

import numpy as np
import torch

from .power_template import DirectPowerSpectrumTemplate, StandardPowerSpectrumTemplate
from .base import BaseTheoryPowerSpectrumMultipoles, BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles, \
    WedgesMixin, _col


class BasePTPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles, WedgesMixin):
    """Base PT multipoles: template wiring with AP margin."""

    _klim = (1e-3, 1., 500)

    def initialize(self, k=None, ells=(0, 2, 4), template=None, mu=8, method='leggauss', **kwargs):
        super().initialize(k=k, ells=ells)
        if template is None:
            template = DirectPowerSpectrumTemplate()
        self.template = template
        kin = np.geomspace(min(self._klim[0], self.k[0] / 2), max(self._klim[1], self.k[-1] * 2), self._klim[2])
        self.template.init.update(k=kin)
        self.set_k_mu(k=self.k, mu=mu, method=method, ells=self.ells)

    @property
    def z(self):
        return self.template.z


class KaiserPowerSpectrumMultipoles(BasePTPowerSpectrumMultipoles):
    r"""Kaiser PT tables: pk_dd/dt/tt multipoles (B, nell, nk) on the
    AP-remapped grid, with optional Gaussian damping."""

    _params = {'sigmapar': dict(value=0., fixed=True), 'sigmaper': dict(value=0., fixed=True)}
    _state_attrs = ['power', 'pktable']

    def calculate(self, sigmapar=0., sigmaper=0., **kw):
        jac, kap, muap = self.template.ap_k_mu(self.const('k'), self.const('mu'))
        f = _col(self.template.f_of_k(kap))
        mu2 = muap ** 2
        sigmanl2 = kap ** 2 * (_col(sigmapar) ** 2 * mu2 + _col(sigmaper) ** 2 * (1. - mu2))
        pkmu = _col(jac) * torch.exp(-sigmanl2 / 2.) * self.template.pk_dd_interp(kap)
        self.pktable = {
            'pk_dd': self.to_poles(pkmu),
            'pk_dt': self.to_poles(f * mu2 * pkmu),
            'pk_tt': self.to_poles(f ** 2 * mu2 ** 2 * pkmu),
        }
        self.pktable['pk11'] = self.pktable['pk_dd']
        self.power = self.pktable['pk_dd']


class BaseTracerPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles):
    """Tracer-level wrapper: combines PT tables with bias parameters."""

    _pt_cls = KaiserPowerSpectrumMultipoles

    def initialize(self, k=None, ells=(0, 2, 4), pt=None, template=None, shotnoise=1e4, **kwargs):
        super().initialize(k=k, ells=ells)
        if pt is None:
            pt = self._pt_cls()
        self.pt = pt
        if template is not None:
            self.pt.init.update(template=template)
        self.pt.init.update(k=self.k, ells=self.ells, **kwargs)
        self.nd = 1. / float(shotnoise)
        self.monopole = np.array([float(ell == 0) for ell in self.ells])[:, None]  # (nell, 1)

    @property
    def template(self):
        return self.pt.template


class KaiserTracerPowerSpectrumMultipoles(BaseTracerPowerSpectrumMultipoles):
    r"""Kaiser tracer P_l(k): b1^2 pk_dd + 2 b1 pk_dt + pk_tt + sn0/nd."""

    _params = {
        'b1': dict(value=1.5, prior=dict(limits=[0., 4.]), ref=dict(dist='norm', loc=1.5, scale=0.1), delta=0.05, latex='b_1'),
        'sn0': dict(value=0., prior=dict(dist='norm', loc=0., scale=2.), ref=dict(dist='norm', loc=0., scale=0.01), delta=0.05, latex='s_{n,0}'),
    }

    def calculate(self, b1=1., sn0=0., **kw):
        b1 = _col(b1)
        t = self.pt.pktable
        self.power = (b1 ** 2 * t['pk_dd'] + 2. * b1 * t['pk_dt'] + t['pk_tt']
                      + self.const('monopole') * _col(sn0) / self.nd)


class EFTLikeKaiserTracerPowerSpectrumMultipoles(KaiserTracerPowerSpectrumMultipoles):
    r"""Kaiser + EFT counter/stochastic terms:
    power += ct-matrix . ct * pk11(ell=0) + sn-matrix . sn / nd.
    Exactly marginalizable over ct*/sn*: the stochastic terms have a static
    design matrix, the counterterms multiply the per-chain pk11 and expose
    their basis through :meth:`solved_power_basis`."""

    _static_linear_solved = ('sn*',)

    @staticmethod
    def _params(init):
        params = dict(KaiserTracerPowerSpectrumMultipoles._params)
        ells = tuple(init.get('ells', (0, 2, 4)))
        for ell in ells:
            params['ct{:d}_2'.format(ell)] = dict(
                value=0., prior=dict(dist='norm', loc=0., scale=100.),
                ref=dict(dist='norm', loc=0., scale=1.), delta=0.5,
                latex='c_{{t,{:d}}}'.format(ell))
            params['sn{:d}_2'.format(ell)] = dict(
                value=0., prior=dict(dist='norm', loc=0., scale=10.),
                ref=dict(dist='norm', loc=0., scale=0.1), delta=0.1,
                latex='s_{{n,{:d}}}'.format(ell))
        return params

    def initialize(self, *args, **kwargs):
        super().initialize(*args, **kwargs)
        self.kp = 1.
        self._set_eft_matrices()

    def _set_eft_matrices(self):
        def build(base):
            names, rows = [], {}
            for param in list(self.params):
                match = re.match(base + r'(\d+)_(-?\d+)', param.basename)
                if match:
                    ell, pow = int(match.group(1)), int(match.group(2))
                    if ell in self.ells:
                        names.append(param.basename)
                        rows[param.basename] = (ell, (self.k / self.kp) ** pow)
                    else:
                        del self.params[param.name]
            matrix = np.zeros((len(names), len(self.ells), len(self.k)))
            for i, name in enumerate(names):
                ell, kvec = rows[name]
                matrix[i, self.ells.index(ell)] = kvec
            return names, matrix

        # (nparam, nell, nk): one (nell, nk) basis per parameter
        self.counterterm_params, self.counterterm_matrix = build('ct')
        self.stochastic_params, self.stochastic_matrix = build('sn')
        # counterterms are exactly linear with a per-chain basis (x pk11):
        # the analytic marginalization reads it in the primal run
        self.solved_basis_names = tuple(self.counterterm_params)

    def _pk11_monopole(self):
        return self.pt.pktable['pk11'][..., self.pt.ells.index(0), :][..., None, :]  # (B, 1, nk)

    def solved_power_basis(self, basename):
        """d power / d ct_name (B, nell, nk), evaluated after calculate."""
        i = self.counterterm_params.index(basename)
        return self.const('counterterm_matrix')[i] * self._pk11_monopole()

    def calculate(self, b1=1., sn0=0., **params):
        super().calculate(b1=b1, sn0=sn0)
        if self.counterterm_params:
            ct = torch.stack([params[name] for name in self.counterterm_params], dim=-1)
            self.power = self.power + torch.einsum('bc,clk->blk', ct, self.const('counterterm_matrix')) \
                * self._pk11_monopole()
        if self.stochastic_params:
            sn = torch.stack([params[name] for name in self.stochastic_params], dim=-1)
            self.power = self.power + torch.einsum('bc,clk->blk', sn, self.const('stochastic_matrix')) / self.nd


class BaseTracerCorrelationFunctionMultipoles(BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles):
    """Tracer xi_l(s) from the matching tracer P_l(k) ``_power_cls``, which
    holds the parameters; ``template=`` and the other options go to it."""

    _power_cls = KaiserTracerPowerSpectrumMultipoles

    def initialize(self, s=None, ells=(0, 2, 4), **kwargs):
        super().initialize(s=s, power=self._power_cls(), ells=ells, **kwargs)


class KaiserTracerCorrelationFunctionMultipoles(BaseTracerCorrelationFunctionMultipoles):
    _power_cls = KaiserTracerPowerSpectrumMultipoles


class EFTLikeKaiserTracerCorrelationFunctionMultipoles(BaseTracerCorrelationFunctionMultipoles):
    _power_cls = EFTLikeKaiserTracerPowerSpectrumMultipoles


class SimpleTracerPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles, WedgesMixin):
    r"""Minimal damped-Kaiser tracer model:
    pkmu = jac exp(-k^2 (sigmapar^2 mu^2 + sigmaper^2 (1 - mu^2)) / 2)
           (b1 + f muap^2)^2 P(kap) + sn0 / nd."""

    _params = {
        'b1': dict(value=1.5, prior=dict(limits=[0., 4.]), ref=dict(dist='norm', loc=1.5, scale=0.1), latex='b_1'),
        'sn0': dict(value=0., prior=dict(dist='norm', loc=0., scale=2.), latex='s_{n,0}'),
        'sigmapar': dict(value=0., fixed=True, prior=dict(limits=[0., 10.]), latex=r'\Sigma_\parallel'),
        'sigmaper': dict(value=0., fixed=True, prior=dict(limits=[0., 10.]), latex=r'\Sigma_\perp'),
    }

    def initialize(self, k=None, ells=(0, 2, 4), template=None, mu=8, method='leggauss', shotnoise=1e4):
        super().initialize(k=k, ells=ells)
        if template is None:
            template = StandardPowerSpectrumTemplate()
        self.template = template
        kin = np.geomspace(min(1e-3, self.k[0] / 2), max(1., self.k[-1] * 2), 500)
        self.template.init.update(k=kin)
        self.set_k_mu(k=self.k, mu=mu, method=method, ells=self.ells)
        self.nd = 1. / float(shotnoise)

    def calculate(self, b1=1.5, sn0=0., sigmapar=0., sigmaper=0., **kw):
        k, mu = self.const('k'), self.const('mu')
        jac, kap, muap = self.template.ap_k_mu(k, mu)
        f = _col(self.template.f_of_k(kap))
        mu2 = mu ** 2
        damping = torch.exp(-k[:, None] ** 2 * (_col(sigmapar) ** 2 * mu2 + _col(sigmaper) ** 2 * (1. - mu2)) / 2.)
        pkmu = (_col(jac) * damping * (_col(b1) + f * muap ** 2) ** 2 * self.template.pk_dd_interp(kap)
                + _col(sn0) / self.nd)
        self.power = self.to_poles(pkmu)

    @property
    def z(self):
        return self.template.z

    def get(self):
        return self.power
