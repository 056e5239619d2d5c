"""BAO theory models: damped wiggles + broadband, power spectrum and
correlation function multipoles.

Counterpart of ``desilike_tpu/theories/bao.py`` for the damped-wiggle model
(the 'standard' propagator form and the Howlett et al. 2023 family) and its
tracer wrappers: in P(k) with the 'power'/'power3' broadband, in xi(s) with
the s^-2, s^-1, s^0 broadband. Per evaluation: AP-remap (k, mu) over the
chain batch -> Chebyshev lookups of the fiducial pk and no-wiggle pk (the
Clenshaw kernel) -> damped wiggle combination -> Legendre projection ->
(xi only: the static landing, the FFTLog transform and the interpolation
onto s) -> broadband ``(B, nb) @ (nb, nell * n)``. The simple, resummed and
flexible models and the spline broadband kernels wait for ROADMAP A11.
"""

import re

import numpy as np
import torch

from .base import BaseTheoryPowerSpectrumMultipoles, BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles, \
    WedgesMixin, _col
from .power_template import BAOPowerSpectrumTemplate


class BaseBAOWigglesPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles, WedgesMixin):
    """BAO P_l(k) without broadband."""

    _klim = (1e-4, 1., 2000)

    def initialize(self, k=None, ells=(0, 2), template=None, mode='', smoothing_radius=15.,
                   mu=10, method='leggauss', model='standard', **kwargs):
        super().initialize(k=k, ells=ells)
        self.mode = str(mode)
        if self.mode not in ('', 'recsym', 'reciso'):
            raise ValueError('reconstruction mode must be one of "", "recsym", "reciso"')
        self.smoothing_radius = float(smoothing_radius)
        self.model = str(model)
        if template is None:
            template = BAOPowerSpectrumTemplate()
        self.template = template
        kin = np.geomspace(min(self._klim[0], self.k[0] / 2), max(self._klim[1], self.k[-1] * 2), self._klim[2])
        self.template.init.update(k=kin)
        self.set_k_mu(k=self.k, mu=mu, method=method, ells=self.ells)

    @property
    def rs_drag_fid(self):
        return self.template.rs_drag_fid


class DampedBAOWigglesPowerSpectrumMultipoles(BaseBAOWigglesPowerSpectrumMultipoles):
    r"""Damped BAO wiggles P_l(k) (BOSS DR12 Beutler et al. 2017 style).

    Built from four factors, each at the observed coordinates (k, mu) or the
    AP-dilated ones (k', mu'): ``Kaiser`` = (b1 + f mu^2 (1 - S(k)))^2 with
    S the 'reciso' smoothing kernel; ``FoG`` = [1 + (k mu sigma_s)^2 / 2]^-2;
    ``D`` = exp(-k^2 (sigma_par^2 mu^2 + sigma_per^2 (1-mu^2)) / 2); and the
    wiggles ``Pw = P - Pnw`` (or ``O = P/Pnw - 1``) at the AP coordinates.

    models: 'standard', ``P = Kaiser(k,mu) FoG(k,mu) Pnw(k) +
    Kaiser(k',mu') D(k',mu') Pw(k')``; the Howlett et al. 2023 family,
    ``P = Kaiser Pnw x combine(FoG, D O)``, where 'fog-damping' multiplies,
    ``FoG (1 + D O)``, and otherwise it adds, ``FoG + D O``; 'fix-damping'
    pins D at observed coordinates; 'move-all' dilates the smooth factors too.
    """

    def _recon_smoothing(self, k):
        if self.mode == 'reciso':
            return torch.exp(-0.5 * (k * self.smoothing_radius) ** 2)
        return 0.

    def _kaiser(self, b1, f, k, mu):
        return (b1 + f * mu ** 2 * (1. - self._recon_smoothing(k))) ** 2

    @staticmethod
    def _fog(sigmas, k, mu):
        return (1. + 0.5 * (sigmas * k * mu) ** 2) ** -2

    @staticmethod
    def _damping(sigmapar, sigmaper, k, mu):
        mu2 = mu ** 2
        return torch.exp(-0.5 * k ** 2 * (sigmapar ** 2 * mu2 + sigmaper ** 2 * (1. - mu2)))

    def calculate(self, b1=1., dbeta=1., sigmas=0., sigmapar=9., sigmaper=6., **kw):
        b1, sigmas, sigmapar, sigmaper = _col(b1), _col(sigmas), _col(sigmapar), _col(sigmaper)
        f = _col(dbeta * self.template.f)
        k, muobs = self.const('k'), self.const('mu')
        kobs = k[:, None]
        _, kap, muap = self.template.ap_k_mu(k, muobs)
        pnw = self.template.pknow_dd_interp
        wiggle = self.template.pk_dd_interp(kap) - pnw(kap)

        if self.model == 'standard':
            smooth = (self._kaiser(b1, f, kobs, muobs) * self._fog(sigmas, kobs, muobs)
                      * pnw(kobs))
            # wiggle propagator: everything AP-dilated except S(k), taken at
            # fiducial coordinates
            sk = self._recon_smoothing(kobs)
            propagator = ((b1 + f * muap ** 2 * (1. - sk)) ** 2
                          * self._damping(sigmapar, sigmaper, kap, muap))
            pkmu = smooth + propagator * wiggle
        else:
            fix_damping = 'fix-damping' in self.model
            move_all = 'move-all' in self.model
            kd, mud = (kobs, muobs) if fix_damping else (kap, muap)
            ks, mus = (kap, muap) if move_all else (kobs, muobs)
            damped_ratio = wiggle / pnw(kap) * self._damping(sigmapar, sigmaper, kd, mud)
            smooth = self._kaiser(b1, f, ks, mus) * pnw(ks)
            fog = self._fog(sigmas, ks, mus)
            if 'fog-damping' in self.model:
                pkmu = smooth * fog * (1. + damped_ratio)
            else:
                pkmu = smooth * (fog + damped_ratio)
        self.power = self.to_poles(pkmu)


class BaseBAOWigglesTracerPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles):
    r"""BAO P_l(k) with broadband terms: broadband='power' (powers k^-3..k^1
    scaled by kp = 2 pi / rd) or 'power3' (3 powers)."""

    _pt_cls = DampedBAOWigglesPowerSpectrumMultipoles
    # broadband coefficients enter linearly with a static basis: their
    # marginalization design matrix is a build-time constant
    _static_linear_solved = ('al*',)

    @classmethod
    def _params(cls, init):
        params = {
            'b1': dict(value=1.5, prior=dict(limits=[0.2, 4.]), ref=dict(limits=[1.5, 2.5]), proposal=0.1, latex='b'),
            'dbeta': dict(value=1., prior=dict(limits=[0.7, 1.3]), ref=dict(limits=[0.8, 1.2]), delta=0.02, proposal=0.1, latex=r'd\beta'),
            'sigmas': dict(value=0., prior=dict(limits=[0., 10.]), ref=dict(limits=[0., 1.]), latex=r'\Sigma_s', fixed=True),
            'sigmapar': dict(value=9., prior=dict(limits=[0.1, 10.]), latex=r'\Sigma_\parallel', fixed=True),
            'sigmaper': dict(value=6., prior=dict(limits=[0.1, 10.]), latex=r'\Sigma_\perp', fixed=True),
        }
        broadband = str(init.get('broadband', 'power'))
        ells = tuple(init.get('ells', (0, 2)))
        if 'power' in broadband:
            for ell in ells:
                for pow in range(-3, 2):
                    cfg = dict(value=0., ref=dict(limits=[-1e2, 1e2]), delta=0.005,
                               latex='a_{{{:d},{:d}}}'.format(ell, pow), fixed=False)
                    if broadband == 'power3' and pow not in (-2, -1, 0):
                        cfg['fixed'] = True
                    params['al{:d}_{:d}'.format(ell, pow)] = cfg
        return params

    def initialize(self, k=None, ells=(0, 2), broadband='power', kp=None, pt=None, **kwargs):
        super().initialize(k=k, ells=ells)
        self.broadband = str(broadband)
        if self.broadband not in ('power', 'power3'):
            raise NotImplementedError('broadband {!r}: the spline-kernel broadbands are ported with the '
                                      'remaining BAO models (ROADMAP A11)'.format(self.broadband))
        if pt is None:
            pt = self._pt_cls()
        self.pt = pt
        self.pt.init.update(k=self.k, ells=self.ells, **kwargs)
        self.pt.runtime_info.initialize()
        self.kp = 2. * np.pi / self.pt.rs_drag_fid if kp is None else float(kp)
        self._set_broadband()
        # forward non-broadband params to the pt node: the tracer keeps only
        # the broadband coefficients
        for param in list(self.params):
            if param.basename not in self._broadband_names and param.derived is not True:
                self.pt.init.params.set(param)
                del self.params[param.name]
        self.pt.runtime_info.initialized = False

    def _set_broadband(self):
        """Classify al{ell}_{n} params per multipole and stack their static
        basis into one (nb, nell * nk) design matrix."""
        self.broadband_orders = {ell: {} for ell in self.ells}
        for param in list(self.params):
            match = re.match(r'al(\d+)_(-?\d+)', param.basename)
            if match:
                ell, ind = int(match.group(1)), int(match.group(2))
                if ell in self.ells:
                    self.broadband_orders[ell][param.basename] = ind
                else:
                    del self.params[param.name]
        self._broadband_names, rows = [], []
        nk = len(self.k)
        for ill, ell in enumerate(self.ells):
            for name, pow in self.broadband_orders[ell].items():
                row = np.zeros((len(self.ells), nk))
                row[ill] = (self.k / self.kp) ** pow
                rows.append(row.ravel())
                self._broadband_names.append(name)
        self.broadband_design = np.array(rows).reshape(len(rows), len(self.ells) * nk)

    def get_broadband(self, **params):
        """(B, nell, nk) broadband from the (B,) coefficient tensors."""
        shape = (len(self.ells), len(self.k))
        if not self._broadband_names:
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        coeffs = torch.stack([params[name] for name in self._broadband_names], dim=-1)
        return (coeffs @ self.const('broadband_design')).reshape(coeffs.shape[:-1] + shape)

    def calculate(self, **params):
        # pt is a requirement: its calculate already ran with its own params
        self.power = self.pt.power + self.get_broadband(**params)

    @property
    def template(self):
        return self.pt.template

    def get(self):
        return self.power


class DampedBAOWigglesTracerPowerSpectrumMultipoles(BaseBAOWigglesTracerPowerSpectrumMultipoles):
    _pt_cls = DampedBAOWigglesPowerSpectrumMultipoles


class BaseBAOWigglesCorrelationFunctionMultipoles(BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles):
    """Wiggle-only BAO xi_l(s), no broadband: the FFTLog transform of the
    wiggle P_l(k) model ``_pt_power_cls``, which holds the model parameters."""

    _pt_power_cls = None  # set by subclasses

    @classmethod
    def _params(cls, init):
        params = BaseBAOWigglesTracerPowerSpectrumMultipoles._params(init)
        return {name: cfg for name, cfg in params.items() if not name.startswith('al')}

    def initialize(self, s=None, ells=(0, 2), **kwargs):
        super().initialize(s=s, power=self._pt_power_cls(), ells=ells, **kwargs)
        self._set_broadband()
        # the model parameters move to the power node: this node keeps the broadband
        for param in list(self.params):
            if param.basename not in self._broadband_names and param.derived is not True:
                self.power.init.params.set(param)
                del self.params[param.name]
        self.power.runtime_info.initialized = False

    def _set_broadband(self):
        self._broadband_names = []


class DampedBAOWigglesCorrelationFunctionMultipoles(BaseBAOWigglesCorrelationFunctionMultipoles):
    """xi counterpart of :class:`DampedBAOWigglesPowerSpectrumMultipoles`."""

    _pt_power_cls = DampedBAOWigglesPowerSpectrumMultipoles


class BaseBAOWigglesTracerCorrelationFunctionMultipoles(BaseBAOWigglesCorrelationFunctionMultipoles):
    """BAO xi_l(s) with the broadband al{ell}_{n} s^n, n in (-2, -1, 0), per
    multipole: the broadband coefficients enter linearly with a static basis."""

    _pt_power_cls = DampedBAOWigglesPowerSpectrumMultipoles
    _static_linear_solved = ('al*',)

    @classmethod
    def _params(cls, init):
        params = super()._params(init)
        for ell in tuple(init.get('ells', (0, 2))):
            for pow in range(-2, 1):
                params['al{:d}_{:d}'.format(ell, pow)] = dict(
                    value=0., ref=dict(limits=[-1e-2, 1e-2]), delta=0.002,
                    latex='a_{{{:d},{:d}}}'.format(ell, pow))
        return params

    def _set_broadband(self):
        """Classify the al{ell}_{n} parameters per multipole and stack their
        static basis into one (nb, nell * ns) design matrix."""
        self.broadband_orders = {}
        for param in list(self.params):
            match = re.match(r'al(\d+)_(-?\d+)', param.basename)
            if match:
                ell, pow = int(match.group(1)), int(match.group(2))
                if ell in self.ells:
                    self.broadband_orders.setdefault(ell, {})[param.basename] = pow
                else:
                    del self.params[param.name]
        self._broadband_names, rows = [], []
        for ill, ell in enumerate(self.ells):
            for name, pow in self.broadband_orders.get(ell, {}).items():
                row = np.zeros((len(self.ells), len(self.s)))
                row[ill] = self.s ** pow
                rows.append(row.ravel())
                self._broadband_names.append(name)
        self.broadband_design = np.array(rows).reshape(len(rows), len(self.ells) * len(self.s))

    def calculate(self, **params):
        corr = self.get_corr(self.power.power)
        if self._broadband_names:
            coeffs = torch.stack([params[name] for name in self._broadband_names], dim=-1)
            corr = corr + (coeffs @ self.const('broadband_design')).reshape(corr.shape)
        self.corr = corr


class DampedBAOWigglesTracerCorrelationFunctionMultipoles(BaseBAOWigglesTracerCorrelationFunctionMultipoles):
    _pt_power_cls = DampedBAOWigglesPowerSpectrumMultipoles


class _RemainingBAOModel(object):
    """The simple, resummed and flexible BAO models, in P(k) and xi(s), are
    ported with the remaining theories."""

    _params = None

    def initialize(self, *args, **kwargs):
        raise NotImplementedError('{}: the simple, resummed and flexible BAO models are ROADMAP A11'.format(
            type(self).__name__))


class SimpleBAOWigglesCorrelationFunctionMultipoles(_RemainingBAOModel, BaseBAOWigglesCorrelationFunctionMultipoles):
    pass


class ResummedBAOWigglesCorrelationFunctionMultipoles(_RemainingBAOModel, BaseBAOWigglesCorrelationFunctionMultipoles):
    pass


class FlexibleBAOWigglesCorrelationFunctionMultipoles(_RemainingBAOModel, BaseBAOWigglesCorrelationFunctionMultipoles):
    pass


class SimpleBAOWigglesTracerCorrelationFunctionMultipoles(_RemainingBAOModel,
                                                          BaseBAOWigglesTracerCorrelationFunctionMultipoles):
    pass


class ResummedBAOWigglesTracerCorrelationFunctionMultipoles(_RemainingBAOModel,
                                                            BaseBAOWigglesTracerCorrelationFunctionMultipoles):
    pass


class FlexibleBAOWigglesTracerCorrelationFunctionMultipoles(_RemainingBAOModel,
                                                            BaseBAOWigglesTracerCorrelationFunctionMultipoles):
    pass
