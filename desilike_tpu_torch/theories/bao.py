"""BAO theory models: damped wiggles + broadband, power spectrum and
correlation function multipoles.

Counterpart of ``desilike_tpu/theories/bao.py`` for the damped-wiggle model
(the 'standard' propagator form and the Howlett et al. 2023 family) and its
tracer wrappers: in P(k) with the 'power'/'power3' broadband, in xi(s) with
the s^-2, s^-1, s^0 broadband. Per evaluation: AP-remap (k, mu) over the
chain batch -> Chebyshev lookups of the fiducial pk and no-wiggle pk (the
Clenshaw kernel) -> damped wiggle combination -> Legendre projection ->
(xi only: the static landing, the FFTLog transform and the interpolation
onto s) -> broadband ``(B, nb) @ (nb, nell * n)``. The simple model is the
damped one with ``model='fix-damping'``; the resummed model damps the
wiggles with (1 - j0) integrals of the fiducial no-wiggle pk, computed on
the host in float64 at initialization; the flexible model modulates the
wiggles per multipole with spline kernels of k, a static (nnode, nk) basis,
so that its amplitudes enter through one product. The spline broadbands
('ngp', 'cic', 'tsc', 'pcs') are static too: each kernel row is scaled by
the fiducial no-wiggle pk at its node.
"""

import re

import numpy as np
import torch

from .base import BaseTheoryPowerSpectrumMultipoles, BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles, \
    WedgesMixin, _col
from .power_template import BAOPowerSpectrumTemplate


def _kernel_func(x, kernel='tsc'):
    """Particle-assignment kernel shapes, the spline broadband and
    modulation bases (host float64 numpy)."""
    x = np.abs(np.asarray(x, dtype='f8'))
    out = np.zeros_like(x)
    if kernel == 'ngp':
        out[x < 0.5] = 1.
    elif kernel == 'cic':
        m = x < 1.
        out[m] = 1. - x[m]
    elif kernel == 'tsc':
        m = x < 0.5
        out[m] = 0.75 - x[m] ** 2
        m = (x >= 0.5) & (x < 1.5)
        out[m] = 0.5 * (1.5 - x[m]) ** 2
    elif kernel == 'pcs':
        m = x < 1.
        out[m] = (4. - 6. * x[m] ** 2 + 3. * x[m] ** 3) / 6.
        m = (x >= 1.) & (x < 2.)
        out[m] = (2. - x[m]) ** 3 / 6.
    else:
        raise ValueError('unknown kernel {}'.format(kernel))
    return out


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


class SimpleBAOWigglesPowerSpectrumMultipoles(DampedBAOWigglesPowerSpectrumMultipoles):
    """Moves only the BAO wiggles with the scaling parameters: the damped
    model with ``model='fix-damping'``."""

    def initialize(self, *args, model='fix-damping', **kwargs):
        super().initialize(*args, model=model, **kwargs)


class ResummedBAOWigglesPowerSpectrumMultipoles(BaseBAOWigglesPowerSpectrumMultipoles):
    r"""IR-resummed BAO wiggles (arXiv:1907.00043): the damping scales come
    from (1 - j0) integrals of the fiducial no-wiggle pk, static, computed
    on the host in float64 at initialization (the template is initialized
    first, for its fiducial tables)."""

    def initialize(self, *args, shotnoise=0., **kwargs):
        super().initialize(*args, **kwargs)
        self.shotnoise = float(shotnoise)
        from scipy.integrate import simpson
        from scipy.special import spherical_jn
        k = np.asarray(self.template.init.get('k'))
        self.template.runtime_info.initialize()
        pklin = np.asarray(self.template.pknow_dd_fid, dtype='f8')
        j0 = spherical_jn(0, self.template.rs_drag_fid * k)
        sk = np.exp(-0.5 * (k * self.smoothing_radius) ** 2) if self.mode else 0.
        skc = 1. - sk
        self.sigma_sn2 = 1. / self.smoothing_radius / 6. / np.pi ** 1.5
        self.sigma_nl2 = simpson((1. - j0) * pklin, x=k) / (3. * np.pi ** 2)
        self.sigma_dd2 = simpson((1. - j0) * skc ** 2 * pklin, x=k) / (3. * np.pi ** 2)
        if self.mode == 'reciso':
            self.sigma_x2 = simpson((1. - j0) * skc * pklin, x=k) / (3. * np.pi ** 2)

    def wiggles(self, k, mu, b1=1., f=0., d=1.):
        """The damped wiggles at (k, mu), (B, nk, nmu); b1, f, d (B, 1, 1)."""
        wig = self.template.pk_dd_interp(k) - self.template.pknow_dd_interp(k)
        ksq = (1. + f * (f + 2.) * mu ** 2) * k ** 2
        d2 = d ** 2
        sigma_dd2 = self.sigma_dd2 + self.shotnoise * self.sigma_sn2 / b1 ** 2
        if self.mode == 'reciso':
            sk = torch.exp(-0.5 * (k * self.smoothing_radius) ** 2)
            skc = 1. - sk
            res = (b1 + f * mu ** 2 * skc - sk) ** 2 * torch.exp(-0.5 * ksq * d2 * sigma_dd2)
            sigma_ds2 = (1. + f * mu ** 2) * sigma_dd2 + f * (1. + f) * mu ** 2 * self.sigma_x2
            res = res + 2. * (b1 + f * mu ** 2 * skc - sk) * (1. + f * mu ** 2) * sk * torch.exp(-0.5 * ksq * d2 * sigma_ds2)
            sigma_ss2 = sigma_dd2 + f ** 2 * mu ** 2 * self.sigma_nl2 + 2. * f * mu ** 2 * self.sigma_x2
            res = res + (1. + f * mu ** 2) ** 2 * sk ** 2 * torch.exp(-0.5 * ksq * d2 * sigma_ss2)
        else:  # '' and 'recsym'
            res = (b1 + f * mu ** 2) ** 2 * torch.exp(-0.5 * ksq * d2 * sigma_dd2)
        return res * wig

    def calculate(self, b1=1., dbeta=1., sigmas=0., d=1., **kw):
        b1, sigmas, d = _col(b1), _col(sigmas), _col(d)
        f = _col(dbeta * self.template.f)
        k, mu = self.const('k'), self.const('mu')
        _, kap, muap = self.template.ap_k_mu(k, mu)
        kobs = k[:, None]
        pknow = self.template.pknow_dd_interp(kobs)
        fog = 1. / (1. + (sigmas * kobs * mu) ** 2 / 2.) ** 2
        sk = torch.exp(-0.5 * (kobs * self.smoothing_radius) ** 2) if self.mode == 'reciso' else 0.
        pksmooth = (b1 + f * mu ** 2 * (1. - sk)) ** 2 * pknow * fog
        damped_wiggles = self.wiggles(kap, muap, b1=b1, f=f, d=d) / self.template.pknow_dd_interp(kap)
        self.power = self.to_poles(pksmooth * (1. + damped_wiggles))


class FlexibleBAOWigglesPowerSpectrumMultipoles(BaseBAOWigglesPowerSpectrumMultipoles):
    """Wiggles modulated by spline kernels of k: the wiggle amplitude of
    each (ell, node), ``ml{ell}_{n}``, is a free linear parameter. The
    kernels are static, so the per-multipole modulation is one product
    ``(B, nml) @ (nml, nell * nk)``; it depends on k only, so it multiplies
    the wiggles' multipoles after the projection."""

    @staticmethod
    def _params(init):
        params = {}
        ells = tuple(init.get('ells', (0, 2)))
        kp = init.get('kp', 0.06283)
        k = init.get('k')
        kmax = float(np.max(k)) if k is not None else 0.3
        nmax = int(np.ceil(kmax / kp)) + 2
        for ell in ells:
            for n in range(-2, nmax):
                params['ml{:d}_{:d}'.format(ell, n)] = dict(
                    value=1. if (ell == ells[0] and n == 0) else 0.,
                    prior=dict(dist='norm', loc=0., scale=10.),
                    ref=dict(limits=[-1e-3, 1e-3]), delta=0.005,
                    latex='m_{{{:d},{:d}}}'.format(ell, n))
        params['b1'] = dict(value=1.5, prior=dict(limits=[0.2, 4.]), ref=dict(limits=[1.5, 2.5]), latex='b')
        return params

    def initialize(self, *args, kp=None, kernel='tsc', **kwargs):
        super().initialize(*args, **kwargs)
        self.kernel = str(kernel)
        if kp is None:  # rs_drag_fid is set by the template's initialize
            self.template.runtime_info.initialize()
        self.kp = 2. * np.pi / self.rs_drag_fid if kp is None else float(kp)
        pattern = re.compile(r'ml(\d+)_(-?\d+)')
        matches = [(p.basename, pattern.match(p.basename)) for p in self.params]
        self._wiggle_orders = {ell: {name: int(m.group(2)) for name, m in matches if m and int(m.group(1)) == ell}
                               for ell in self.ells}
        self._wiggle_names, rows = [], []
        nk = len(self.k)
        for ill, ell in enumerate(self.ells):
            for name, n in self._wiggle_orders[ell].items():
                row = np.zeros((len(self.ells), nk))
                row[ill] = _kernel_func(self.k / self.kp - n, self.kernel)
                rows.append(row.ravel())
                self._wiggle_names.append(name)
        self.modulation_design = np.array(rows).reshape(len(rows), len(self.ells) * nk)

    def calculate(self, b1=1., **params):
        b1, f = _col(b1), _col(self.template.f)
        k, mu = self.const('k'), self.const('mu')
        _, kap, muap = self.template.ap_k_mu(k, mu)
        pknowap = self.template.pknow_dd_interp(kap)
        wig = (self.template.pk_dd_interp(kap) - pknowap) / pknowap
        smooth = (b1 + f * mu ** 2) ** 2 * self.template.pknow_dd_interp(k[:, None])
        shape = (len(self.ells), len(self.k))
        power = self.to_poles(smooth)
        if self._wiggle_names:
            amps = torch.stack([params[name] for name in self._wiggle_names], dim=-1)
            modulation = (amps @ self.const('modulation_design')).reshape(amps.shape[:-1] + shape)
            power = power + modulation * self.to_poles(smooth * wig)
        self.power = power


def _adjust_model_params(pt_cls, params):
    """The resummed model has no Gaussian Sigma_par/perp damping (its
    damping comes from the (1 - j0) integrals) and carries the fixed
    growth-scaling parameter ``d``."""
    if pt_cls is not None and issubclass(pt_cls, ResummedBAOWigglesPowerSpectrumMultipoles):
        params.pop('sigmapar', None)
        params.pop('sigmaper', None)
        params['d'] = dict(value=1., prior=dict(limits=[0., 4.]), ref=dict(limits=[0.8, 1.2]), latex='d', fixed=True)


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
        _adjust_model_params(getattr(cls, '_pt_cls', None), params)
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
        else:
            for ell in ells:
                for ik in range(-2, 10):
                    params['al{:d}_{:d}'.format(ell, ik)] = dict(
                        value=0., prior=dict(dist='norm', loc=0., scale=1e4),
                        ref=dict(limits=[-1e-2, 1e-2]), delta=0.005,
                        latex='a_{{{:d},{:d}}}'.format(ell, ik))
        return params

    def initialize(self, k=None, ells=(0, 2), broadband='power', kp=None, pt=None, **kwargs):
        super().initialize(k=k, ells=ells)
        self.broadband = str(broadband)
        if 'power' not in self.broadband and self.broadband not in ('ngp', 'cic', 'tsc', 'pcs'):
            raise ValueError('unknown broadband {}'.format(self.broadband))
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
        basis into one (nb, nell * nk) design matrix: powers of k / kp, or
        spline kernels of k / kp - n scaled by the fiducial no-wiggle pk at
        their node (a parameter whose kernel is zero on every k is fixed)."""
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
        if 'power' not in self.broadband:
            pknow_fid = self.pt.template.pknow_dd_fid
            ktab = np.asarray(self.pt.template.k)
        for ill, ell in enumerate(self.ells):
            for name, ind in list(self.broadband_orders[ell].items()):
                row = np.zeros((len(self.ells), nk))
                if 'power' in self.broadband:
                    row[ill] = (self.k / self.kp) ** ind
                else:
                    kernel = _kernel_func(self.k / self.kp - ind, self.broadband)
                    if np.allclose(kernel, 0., atol=1e-8):
                        self.params[self.params.select(basename=name)[0].name].update(fixed=True)
                        del self.broadband_orders[ell][name]
                        continue
                    row[ill] = kernel * np.interp(np.clip(ind * self.kp, ktab[0], ktab[-1]), ktab, pknow_fid)
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


class SimpleBAOWigglesTracerPowerSpectrumMultipoles(BaseBAOWigglesTracerPowerSpectrumMultipoles):
    _pt_cls = SimpleBAOWigglesPowerSpectrumMultipoles


class ResummedBAOWigglesTracerPowerSpectrumMultipoles(BaseBAOWigglesTracerPowerSpectrumMultipoles):
    _pt_cls = ResummedBAOWigglesPowerSpectrumMultipoles


class FlexibleBAOWigglesTracerPowerSpectrumMultipoles(BaseBAOWigglesTracerPowerSpectrumMultipoles):
    _pt_cls = FlexibleBAOWigglesPowerSpectrumMultipoles


class BaseBAOWigglesCorrelationFunctionMultipoles(BaseTheoryCorrelationFunctionFromPowerSpectrumMultipoles):
    """Wiggle-only BAO xi_l(s), no broadband: the FFTLog transform of the
    wiggle P_l(k) model ``_pt_power_cls``, which holds the model parameters."""

    _pt_power_cls = None  # set by subclasses

    @classmethod
    def _params(cls, init):
        params = BaseBAOWigglesTracerPowerSpectrumMultipoles._params(init)
        params = {name: cfg for name, cfg in params.items() if not name.startswith('al')}
        _adjust_model_params(cls._pt_power_cls, params)
        return params

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


class SimpleBAOWigglesCorrelationFunctionMultipoles(BaseBAOWigglesCorrelationFunctionMultipoles):
    """xi counterpart of :class:`SimpleBAOWigglesPowerSpectrumMultipoles`."""

    _pt_power_cls = SimpleBAOWigglesPowerSpectrumMultipoles


class ResummedBAOWigglesCorrelationFunctionMultipoles(BaseBAOWigglesCorrelationFunctionMultipoles):
    """xi counterpart of :class:`ResummedBAOWigglesPowerSpectrumMultipoles`."""

    _pt_power_cls = ResummedBAOWigglesPowerSpectrumMultipoles


class FlexibleBAOWigglesCorrelationFunctionMultipoles(BaseBAOWigglesCorrelationFunctionMultipoles):
    """xi counterpart of :class:`FlexibleBAOWigglesPowerSpectrumMultipoles`."""

    _pt_power_cls = FlexibleBAOWigglesPowerSpectrumMultipoles


class SimpleBAOWigglesTracerCorrelationFunctionMultipoles(BaseBAOWigglesTracerCorrelationFunctionMultipoles):
    _pt_power_cls = SimpleBAOWigglesPowerSpectrumMultipoles


class ResummedBAOWigglesTracerCorrelationFunctionMultipoles(BaseBAOWigglesTracerCorrelationFunctionMultipoles):
    _pt_power_cls = ResummedBAOWigglesPowerSpectrumMultipoles


class FlexibleBAOWigglesTracerCorrelationFunctionMultipoles(BaseBAOWigglesTracerCorrelationFunctionMultipoles):
    _pt_power_cls = FlexibleBAOWigglesPowerSpectrumMultipoles
