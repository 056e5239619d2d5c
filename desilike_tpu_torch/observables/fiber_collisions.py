"""Fiber collisions and additive systematic templates.

Counterpart of ``desilike_tpu/observables/fiber_collisions.py``.
Fiber-collision corrections are static (nell_out, nell_in, nk_out, nk_in)
kernels built on the host in float64 (Hahn et al. 2016, arXiv:1609.01714);
the per-evaluation path is one batched contraction. Systematic templates are
per-ell additive vectors with linear amplitude parameters (exactly
marginalizable). A window folds a fiber-collision kernel into its matrix
once, on the host (``window.py``), so that these calculators run per
evaluation only when used on their own.
"""

import numpy as np
import torch
from scipy import special

from ..core import Calculator
from ..ops.legendre import trapz_weights
from .window import matrix_lininterp


def _legendre_poly(ell):
    c = np.zeros(ell + 1)
    c[ell] = 1.
    return np.polynomial.legendre.Legendre(c)


def _wrap_theory(theory, default, updates):
    """Instantiate the wrapped multipole theory (``default`` is a lazy factory
    for the Kaiser tracer model), push config updates into it, and force its
    static initialization so its grids/multipoles are readable."""
    if theory is None:
        theory = default()
    updates = {key: value for key, value in updates.items() if value is not None}
    if updates:
        theory.init.update(**updates)
    theory.runtime_info.initialize()
    return theory


class BaseFiberCollisionsPowerSpectrumMultipoles(Calculator):
    """P_l(k) corrected for fiber collisions: correlated (mode-mixing kernel)
    + uncorrelated (shot-noise-like) contributions.

    The per-evaluation cost is one (nell_out*nk_out) x (nell_in*nk_in)
    contraction of static kernels, batched over chains."""

    _state_attrs = ['power']

    def initialize(self, k=None, ells=(0, 2, 4), theory=None, with_uncorrelated=True, **kwargs):
        # output grid is ours; the input grid/multipoles come from the theory
        self.k = np.linspace(0.01, 0.2, 101) if k is None else np.asarray(k, dtype='f8')
        self.ells = tuple(ells)
        self.with_uncorrelated = bool(with_uncorrelated)

        def default():
            from ..theories.full_shape import KaiserTracerPowerSpectrumMultipoles
            return KaiserTracerPowerSpectrumMultipoles()

        self.theory = _wrap_theory(theory, default, kwargs)
        self.kin = np.asarray(self.theory.k, dtype='f8')
        self.ellsin = tuple(self.theory.ells)

    def calculate(self, **params):
        power = self.theory.power
        self.power = torch.einsum('abij,...bj->...ai', self.const('kernel_correlated'), power)
        if self.with_uncorrelated:
            self.power = self.power + self.const('kernel_uncorrelated')

    def get(self):
        return self.power


class TopHatFiberCollisionsPowerSpectrumMultipoles(BaseFiberCollisionsPowerSpectrumMultipoles):
    r"""Hahn et al. 2016 top-hat fiber-collision correction.

    Parameters
    ----------
    fs : float
        Fraction of pairs lost below the collision scale.
    Dfc : float
        Fiber collision transverse scale [Mpc/h].
    """

    def initialize(self, *args, fs=1., Dfc=0., **kwargs):
        super().initialize(*args, **kwargs)
        self.fs = float(fs)
        self.Dfc = float(Dfc)

        def W2D(x):
            out = np.ones_like(x)
            nz = x != 0
            out[nz] = 2. * special.j1(x[nz]) / x[nz]
            return out

        # Hahn et al. 2016 appendix H_{l l'} polynomials
        H = {(2, 0): lambda x: x ** 2 - 1.,
             (4, 0): lambda x: 7. / 4. * x ** 4 - 5. / 2. * x ** 2 + 3. / 4.,
             (4, 2): lambda x: x ** 4 - x ** 2,
             (6, 0): lambda x: 33. / 8. * x ** 6 - 63. / 8. * x ** 4 + 35. / 8. * x ** 2 - 5. / 8.,
             (6, 2): lambda x: 11. / 4. * x ** 6 - 9. / 2. * x ** 4 + 7. / 4. * x ** 2,
             (6, 4): lambda x: x ** 6 - x ** 4}

        self.kernel_uncorrelated = -np.array(
            [(2 * ell + 1.) * _legendre_poly(ell)(0.) for ell in self.ells])[:, None] \
            * self.fs * (np.pi * self.Dfc) ** 2 / self.k * W2D(self.k * self.Dfc)

        kk, qq = np.meshgrid(self.k, self.kin, indexing='ij')
        wq = trapz_weights(self.kin)
        ident = matrix_lininterp(self.k, self.kin)
        kernel = np.zeros((len(self.ells), len(self.ellsin), len(self.k), len(self.kin)))
        ratio = np.minimum(kk, qq) / np.maximum(kk, qq)
        qoverk = np.clip(qq / kk, None, 1.)
        for io, ellout in enumerate(self.ells):
            for ii, ellin in enumerate(self.ellsin):
                if ellin == ellout:
                    fll = qoverk * W2D(qq * self.Dfc) * ratio ** ellout
                else:
                    tmp = qoverk * W2D(qq * self.Dfc) * (2. * ellout + 1.) / 2. \
                        * H[(max(ellout, ellin), min(ellout, ellin))](ratio)
                    fll = np.where(((ellout >= ellin) & (kk >= qq)) | ((ellout <= ellin) & (kk <= qq)),
                                   tmp, 0.)
                kernel[io, ii] = (ellin == ellout) * ident - self.fs * self.Dfc ** 2 / 2. * fll * self.kin * wq
        self.kernel_correlated = kernel


class FiberCollisionsPowerSpectrumMultipoles(BaseFiberCollisionsPowerSpectrumMultipoles):
    r"""General-kernel fiber collisions (sum of top-hats, no kDfc << 1
    approximation).

    Parameters
    ----------
    sep : array
        Transverse separations for ``kernel``.
    kernel : array
        Fraction of pairs lost at each separation.
    """

    def initialize(self, *args, sep=None, kernel=None, **kwargs):
        super().initialize(*args, **kwargs)
        sep = np.asarray(sep, dtype='f8')
        kernel = np.asarray(kernel, dtype='f8')
        if kernel.size == 1:
            kernel = np.full_like(sep, kernel.flat[0])
        if sep[0] > 0.:
            sep = np.insert(sep, 0, 0.)
            kernel = np.insert(kernel, 0, kernel[0])
        self.sep, self.kernel = sep, kernel

        def kernel_fourier(k):
            k = np.asarray(k, dtype='f8')
            out = np.zeros_like(k)
            for isep in range(len(sep) - 1):
                x = sep[isep:isep + 2]
                yc = kernel[isep:isep + 2].mean()
                nz = k > 0
                tmp = np.zeros_like(k)
                tmp[nz] = yc / k[nz] * (x[1] * special.j1(k[nz] * x[1]) - x[0] * special.j1(k[nz] * x[0]))
                tmp[~nz] = yc * (x[1] ** 2 - x[0] ** 2) / 2.
                out += 2. * np.pi * tmp
            return out

        self.kernel_uncorrelated = -np.array(
            [np.pi * (2 * ell + 1.) * _legendre_poly(ell)(0.) for ell in self.ells])[:, None] \
            * kernel_fourier(self.k) / self.k

        # 2D angular integral of the kernel over phi
        phi = np.linspace(0., np.pi, 100)
        wphi = trapz_weights(phi) / (2. * np.pi)
        k_perp = np.linspace(0., self.k[-1], len(self.k))
        q_perp = np.linspace(0., self.kin[-1], len(self.kin))
        kk_, qq_ = np.meshgrid(k_perp, q_perp, indexing='ij')
        integral = 0.
        for pp, ww in zip(phi, wphi):
            kq = np.sqrt(np.clip(kk_ ** 2 - 2. * kk_ * qq_ * np.cos(pp) + qq_ ** 2, 0., None))
            integral += 2. * ww * kernel_fourier(kq)
        from scipy.interpolate import RectBivariateSpline
        interp_kernel = RectBivariateSpline(k_perp, q_perp, integral, kx=3, ky=3, s=0)

        wq = trapz_weights(self.kin)
        ident = matrix_lininterp(self.k, self.kin)
        kernel_corr = np.zeros((len(self.ells), len(self.ellsin), len(self.k), len(self.kin)))
        for io, ellout in enumerate(self.ells):
            legout = _legendre_poly(ellout)
            for ii, ellin in enumerate(self.ellsin):
                legin = _legendre_poly(ellin)
                fll = np.zeros((len(self.k), len(self.kin)))
                for ik, kv in enumerate(self.k):
                    mu = np.linspace(0., 1., 50)[:, None] * np.clip(self.kin / kv, None, 1.)
                    if (ellout + ellin) % 2 == 0:
                        wmu = 2. * np.stack([trapz_weights(mu[:, j]) for j in range(mu.shape[1])], axis=1)
                    else:
                        mu = np.concatenate([-mu[::-1], mu[1:]], axis=0)
                        wmu = np.stack([trapz_weights(mu[:, j]) for j in range(mu.shape[1])], axis=1)
                    kp = np.sqrt(np.clip(1. - mu ** 2, 0., None)) * kv
                    qp = np.sqrt(np.clip(self.kin ** 2 - (kv * mu) ** 2, 0., None))
                    fll[ik] = np.sum(legout(mu) * legin(np.clip(kv / self.kin * mu, -1, 1))
                                     * interp_kernel(kp, qp, grid=False) * wmu, axis=0)
                kernel_corr[io, ii] = (ellin == ellout) * ident \
                    - (2. * ellout + 1.) / (4. * np.pi) * fll * self.kin * wq
        self.kernel_correlated = kernel_corr


def _legendre_product_integral(ellout, ellin, mu_min):
    r"""\int_{mu_min < |mu| < 1} P_ellout(mu) P_ellin(mu) dmu, vectorized over
    an array of lower bounds (the mu region excised by a transverse-separation
    cut s_perp < Dfc at pair separation s)."""
    integ = (_legendre_poly(ellout) * _legendre_poly(ellin)).integ()
    mu_min = np.asarray(mu_min, dtype='f8')
    return (integ(1.) - integ(mu_min)) + (integ(-mu_min) - integ(-1.))


class BaseFiberCollisionsCorrelationFunctionMultipoles(Calculator):
    r"""xi_l(s) corrected for fiber collisions.

    Configuration space is where the correction is cheapest: the collision
    cut s_perp = s sqrt(1-mu^2) < Dfc is local in s, so the correlated kernel
    is diagonal — (nell_out, nell_in, ns) weights, one einsum per eval."""

    _state_attrs = ['corr']

    def initialize(self, s=None, ells=(0, 2, 4), theory=None, with_uncorrelated=True, **kwargs):
        self.ells = tuple(ells)
        self.with_uncorrelated = bool(with_uncorrelated)

        def default():
            from ..theories.full_shape import KaiserTracerCorrelationFunctionMultipoles
            return KaiserTracerCorrelationFunctionMultipoles()

        self.theory = _wrap_theory(theory, default, dict(kwargs, s=s))
        # s-diagonal correction: the theory's separation grid is also ours
        self.s = self.sin = np.asarray(self.theory.s, dtype='f8')
        self.ellsin = tuple(self.theory.ells)

    def calculate(self, **params):
        corr = self.theory.corr
        self.corr = torch.einsum('abj,...bj->...aj', self.const('kernel_correlated'), corr)
        if self.with_uncorrelated:
            self.corr = self.corr + self.const('kernel_uncorrelated')

    def get(self):
        return self.corr


class TopHatFiberCollisionsCorrelationFunctionMultipoles(BaseFiberCollisionsCorrelationFunctionMultipoles):
    r"""Hahn et al. 2016 (arXiv:1609.01714) top-hat fiber collisions on xi_l(s):
    pairs with transverse separation below ``Dfc``
    are lost with probability ``fs``.

    Parameters
    ----------
    fs : float
        Fraction of pairs lost below the collision scale.
    Dfc : float
        Fiber collision transverse scale [Mpc/h].
    mu_range_cut : bool
        Normalize the Legendre projection by the surviving mu range (for
        estimators whose R1R2 counts are also cut by the top-hat).
    """

    def initialize(self, *args, fs=1., Dfc=0., mu_range_cut=False, **kwargs):
        super().initialize(*args, **kwargs)
        self.fs, self.Dfc = float(fs), float(Dfc)
        self.mu_range_cut = bool(mu_range_cut)
        # |mu| above which the pair falls inside the collision cylinder
        mu_min = np.sqrt(np.clip(1. - (self.Dfc / self.s) ** 2, 0., None))
        self.kernel_uncorrelated = -np.array(
            [(2 * ell + 1.) / 2. * self.fs * _legendre_product_integral(ell, 0, mu_min)
             for ell in self.ells])
        kernel = np.zeros((len(self.ells), len(self.ellsin), len(self.s)))
        for io, ellout in enumerate(self.ells):
            for ii, ellin in enumerate(self.ellsin):
                fll = (2 * ellout + 1.) / 2. * self.fs * _legendre_product_integral(ellout, ellin, mu_min)
                diag = (ellin == ellout) * 1. - fll
                if self.mu_range_cut:
                    diag = np.where(mu_min > 0., diag / np.where(mu_min > 0., mu_min, 1.), diag)
                kernel[io, ii] = diag
        self.kernel_correlated = kernel


class FiberCollisionsCorrelationFunctionMultipoles(BaseFiberCollisionsCorrelationFunctionMultipoles):
    r"""General-kernel (sum of top-hats) fiber collisions on xi_l(s).

    Parameters
    ----------
    sep : array
        Transverse separations for ``kernel``.
    kernel : array
        Fraction of pairs lost at each separation.
    """

    def initialize(self, *args, sep=None, kernel=None, **kwargs):
        super().initialize(*args, **kwargs)
        sep = np.asarray(sep, dtype='f8')
        kernel = np.asarray(kernel, dtype='f8')
        if kernel.size == 1:
            kernel = np.full_like(sep, kernel.flat[0])
        if sep[0] > 0.:
            sep = np.insert(sep, 0, 0.)
            kernel = np.insert(kernel, 0, kernel[0])
        self.sep, self.kernel = sep, kernel

        def cut_integral(ellout, ellin):
            # piecewise-constant kernel: each segment [x0, x1] removes the
            # mu band mu_min(x1) < |mu| < mu_min(x0) at separation s
            total = 0.
            for iseg in range(len(sep) - 1):
                x0, x1 = sep[iseg], sep[iseg + 1]
                yc = 0.5 * (kernel[iseg] + kernel[iseg + 1])
                m0 = np.sqrt(np.clip(1. - (x0 / self.s) ** 2, 0., None))
                m1 = np.sqrt(np.clip(1. - (x1 / self.s) ** 2, 0., None))
                total = total + yc * (_legendre_product_integral(ellout, ellin, m1)
                                      - _legendre_product_integral(ellout, ellin, m0))
            return total

        self.kernel_uncorrelated = -np.array(
            [(2 * ell + 1.) / 2. * cut_integral(ell, 0) for ell in self.ells])
        kern = np.zeros((len(self.ells), len(self.ellsin), len(self.s)))
        for io, ellout in enumerate(self.ells):
            for ii, ellin in enumerate(self.ellsin):
                kern[io, ii] = (ellin == ellout) * 1. - (2 * ellout + 1.) / 2. * cut_integral(ellout, ellin)
        self.kernel_correlated = kern

    def to_tophat(self):
        """Effective (fs, Dfc) top-hat equivalent, by moment matching: Dfc = 2 <x>_K and fs = (integral of K) / Dfc, which
        recover (fs, Dfc) exactly when the kernel IS a top-hat."""
        Dfc = 2. * np.trapezoid(self.sep * self.kernel, x=self.sep) / np.trapezoid(self.kernel, x=self.sep)
        fs = np.trapezoid(self.kernel, x=self.sep) / Dfc
        tophat = TopHatFiberCollisionsCorrelationFunctionMultipoles(
            s=self.s, ells=self.ells, theory=self.theory, fs=fs, Dfc=Dfc)
        tophat.runtime_info.initialize()
        return tophat


class SystematicTemplatePowerSpectrumMultipoles(Calculator):
    """Additive systematic templates with linear amplitudes:
    power += sum_i a_i T_i(ell, k).
    Exactly marginalizable ('.marg' the s* parameters)."""

    _static_linear_solved = ('syst_*',)
    _state_attrs = ['power']

    @staticmethod
    def _params(init):
        templates = init.get('templates', {})
        n = len(templates) if hasattr(templates, '__len__') else 0
        return {'syst_{:d}'.format(i): dict(value=0., prior=dict(dist='norm', loc=0., scale=10.),
                                            ref=dict(limits=[-1e-3, 1e-3]),
                                            latex='s_{{{:d}}}'.format(i))
                for i in range(n)}

    def initialize(self, templates=None, theory=None, k=None, ells=(0, 2, 4)):
        if theory is None:
            from ..theories.full_shape import KaiserTracerPowerSpectrumMultipoles
            theory = KaiserTracerPowerSpectrumMultipoles()
        self.theory = theory
        if k is not None:
            self.theory.init.update(k=k, ells=ells)
        self.theory.runtime_info.initialize()
        self.k = np.asarray(self.theory.k)
        self.ells = tuple(self.theory.ells)
        # templates: list of (nell, nk) arrays
        self.templates = np.array([np.asarray(t, dtype='f8') for t in (templates or [])])

    def calculate(self, **params):
        power = self.theory.power
        if len(self.templates):
            amps = torch.stack([params['syst_{:d}'.format(i)] for i in range(len(self.templates))], dim=-1)
            power = power + torch.einsum('...i,ilk->...lk', amps, self.const('templates'))
        self.power = power

    def get(self):
        return self.power


class SystematicTemplateCorrelationFunctionMultipoles(Calculator):
    """Additive systematic templates on xi_l(s) with linear amplitudes:
    corr += sum_i a_i T_i(ell, s).
    Exactly marginalizable ('.marg' the s* parameters)."""

    _static_linear_solved = ('syst_*',)
    _state_attrs = ['corr']

    @staticmethod
    def _params(init):
        templates = init.get('templates', {})
        n = len(templates) if hasattr(templates, '__len__') else 0
        return {'syst_{:d}'.format(i): dict(value=0., prior=dict(dist='norm', loc=0., scale=10.),
                                            ref=dict(limits=[-1e-3, 1e-3]),
                                            latex='s_{{{:d}}}'.format(i))
                for i in range(n)}

    def initialize(self, templates=None, theory=None, s=None, ells=(0, 2)):
        if theory is None:
            from ..theories.full_shape import KaiserTracerCorrelationFunctionMultipoles
            theory = KaiserTracerCorrelationFunctionMultipoles()
        self.theory = theory
        if s is not None:
            self.theory.init.update(s=s, ells=ells)
        self.theory.runtime_info.initialize()
        self.s = np.asarray(self.theory.s)
        self.ells = tuple(self.theory.ells)
        self.templates = np.array([np.asarray(t, dtype='f8') for t in (templates or [])])

    def calculate(self, **params):
        corr = self.theory.corr
        if len(self.templates):
            amps = torch.stack([params['syst_{:d}'.format(i)] for i in range(len(self.templates))], dim=-1)
            corr = corr + torch.einsum('...i,ils->...ls', amps, self.const('templates'))
        self.corr = corr

    def get(self):
        return self.corr
