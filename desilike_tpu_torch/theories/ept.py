"""1-loop Eulerian PT full-shape model (velocileptors/FOLPS-class physics).

Counterpart of ``desilike_tpu/theories/ept.py``. The 1-loop spectra are
computed in the port on static grids: by default the FFTLog-matrix engine
(:mod:`desilike_tpu_torch.ops.spt_fftlog`), fed by one static Chebyshev
design-matrix product from the template's coefficients to every loop grid
(the decomposition grid, the working grid, the (k, r) radial product grid
and the sigma_v2 quadrature), built once at initialization; or the direct
quadrature (``loop_method='quadrature'``, :mod:`desilike_tpu_torch.ops.spt`).
Everything runs over the chain batch: (B, order) coefficients land on
(B, 25056) points with one float32 GEMM (the no-wiggle table stacked
beside the full one with IR resummation), the FFTLog quadratic forms take
one GEMM a bias group, and the tables on the working grid are fitted to a
Chebyshev series of order ~105 a chain and looked up at the AP-remapped
(k, mu) by the Clenshaw kernel, as is the template's pk.

Model: EFT-like Kaiser at one loop,
  P_g(k, mu) = Pgg_dd + 2 f mu^2 Pgg_dt + f^2 mu^4 P_tt
             + (ct0 + ct2 mu^2 + ct4 mu^4) k^2 P_lin + (sn0 + sn2 k^2 mu^2)/nd
with the McDonald-Roy quadratic bias basis (b1, b2, bs2), or the DESI-2024
physical basis, and all counter/stochastic terms exactly marginalizable.

IR resummation (default resum='full'): wiggle/no-wiggle split of the
linear input, damping scales Sigma^2/deltaSigma^2 from (1 - j0 + 2 j2)/j2
integrals of P_nw against the fiducial sound horizon, loops run on the
LO-resummed input, and the tree term carries the full mu-dependent damping
with the leading-order wiggle correction (1 + k^2 Sigma_tot^2).

The correlation-function multipoles are the FFTLog transform of these.
The default template is ``DirectPowerSpectrumTemplate`` (its cosmology
evaluated per chain).
"""

import re

import numpy as np
import torch

from ..ops.spt import OneLoopIntegrals
from ..ops.spt_fftlog import FFTLogOneLoop, SIGMA_V2_Q
from ..ops.chebyshev import ChebyshevLogInterp
from .base import BaseTheoryPowerSpectrumMultipoles, WedgesMixin, _col
from .full_shape import BaseTracerCorrelationFunctionMultipoles
from .power_template import DirectPowerSpectrumTemplate


def physical_stochastic_settings(tracer=None):
    """Per-tracer satellite fraction and virial-velocity scale entering the
    physical stochastic priors (the published DESI-2024 convention, Maus et
    al. / Zhao et al.): sigv is the halo virial velocity 150 km/s (M /
    1e10 Msun)^(1/3) sqrt(1+z) / H0 in Mpc/h units, evaluated at each
    tracer's host-halo mass and redshift."""
    if tracer is None:
        return {'fsat': 0.1, 'sigv': 5.}
    settings = {
        'BGS': {'fsat': 0.15, 'sigv': 150. * 10. ** (1. / 3.) * (1. + 0.2) ** 0.5 / 70.},
        'LRG': {'fsat': 0.15, 'sigv': 150. * 10. ** (1. / 3.) * (1. + 0.8) ** 0.5 / 70.},
        'ELG': {'fsat': 0.10, 'sigv': 150. * 2.1 ** 0.5 / 70.},
        'QSO': {'fsat': 0.03, 'sigv': 150. * 10. ** (0.7 / 3.) * 2.4 ** 0.5 / 70.},
    }
    tracer = str(tracer).upper()
    if tracer not in settings:
        raise ValueError('unknown tracer {!r}; expected one of {}'.format(
            tracer, sorted(settings)))
    return settings[tracer]


class EPTTracerPowerSpectrumMultipoles(BaseTheoryPowerSpectrumMultipoles, WedgesMixin):
    """1-loop EPT biased-tracer multipoles with AP and exactly marginalizable
    counter/stochastic terms.

    Two parameter bases:

    - ``prior_basis='eulerian'`` (default): b1/b2/bs/b3nl McDonald-Roy
      biases, per-multipole counterterms ct{l}_2, shot-noise sn0/sn2_2/sn4_2;
    - ``prior_basis='physical'``: the DESI-2024 convention — sigma8-scaled
      b1p/b2p/bsp/b3p, dimensionless alpha{0,2,4}p counterterm amplitudes in
      the velocileptors growth/bias combinations, sn{0,2,4}p stochastic
      terms normalized by the shot noise with per-tracer ``fsat``/``sigv``
      presets (``tracer='LRG'|'ELG'|'QSO'|'BGS'``, or explicit overrides).

    ``freedom='min'|'max'`` applies the parameter-freedom presets in either
    basis.
    """

    _static_linear_solved = ('sn*',)
    _klim_template = (1e-4, 20., 1200)
    _loop_dtype = None  # the dtype of the FFTLog loop tables (their landing and forms); None: the compute dtype

    @staticmethod
    def _params(init):
        ells = tuple(init.get('ells', (0, 2, 4)))
        prior_basis = init.get('prior_basis', 'eulerian') or 'eulerian'
        freedom = init.get('freedom', None)
        if prior_basis == 'physical':
            # DESI-2024 physical prior basis: sigma8-scaled biases, dimensionless
            # counterterm amplitudes "50% at k = 0.2 h/Mpc", shot-noise-normalized
            # stochastic terms
            params = {
                'b1p': dict(value=1.2, prior=dict(dist='uniform', limits=[0., 3.]),
                            ref=dict(dist='norm', loc=1., scale=0.1), delta=0.05,
                            latex=r'b_{1}\sigma_8'),
                'b2p': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.),
                            ref=dict(dist='norm', loc=0., scale=1.), delta=0.5,
                            latex=r'b_{2}\sigma_8^2'),
                'bsp': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.),
                            ref=dict(dist='norm', loc=0., scale=1.), delta=0.5,
                            latex=r'b_{s}\sigma_8^2'),
                'b3p': dict(value=0., fixed=True, prior=dict(dist='norm', loc=0., scale=5.),
                            latex=r'b_{3}\sigma_8^3'),
            }
            for n, need in (('0', True), ('2', 2 in ells), ('4', 4 in ells)):
                params['alpha{}p'.format(n)] = dict(
                    value=0., fixed=not need,
                    prior=dict(dist='norm', loc=0., scale=12.5),
                    ref=dict(dist='norm', loc=0., scale=1.), delta=0.5,
                    latex=r'\alpha_{{{}}}'.format(n))
            params['sn0p'] = dict(value=0., prior=dict(dist='norm', loc=0., scale=2.),
                                  ref=dict(dist='norm', loc=0., scale=1.),
                                  latex=r'\mathrm{SN}_0')
            params['sn2p'] = dict(value=0., fixed=2 not in ells,
                                  prior=dict(dist='norm', loc=0., scale=5.),
                                  ref=dict(dist='norm', loc=0., scale=1.),
                                  latex=r'\mathrm{SN}_2')
            params['sn4p'] = dict(value=0., fixed=True,  # sn4 fixed by default
                                  prior=dict(dist='norm', loc=0., scale=5.),
                                  ref=dict(dist='norm', loc=0., scale=1.),
                                  latex=r'\mathrm{SN}_4')
            if freedom == 'min':
                for name in ('bsp', 'b3p'):
                    params[name].update(value=0., fixed=True)
                params['b2p']['prior'] = dict(dist='norm', loc=0., scale=10.)
            elif freedom == 'max':
                for name in ('b2p', 'bsp', 'b3p'):
                    params[name].update(fixed=False, prior=dict(limits=[-15., 15.]))
            return params
        params = {
            'b1': dict(value=1.7, prior=dict(limits=[0., 4.]), ref=dict(dist='norm', loc=1.7, scale=0.1), delta=0.05, latex='b_1'),
            'b2': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.), ref=dict(dist='norm', loc=0., scale=0.5), delta=0.5, latex='b_2'),
            'bs': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.), ref=dict(dist='norm', loc=0., scale=0.5), delta=0.5, latex='b_s'),
            'b3nl': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.), ref=dict(dist='norm', loc=0., scale=0.5), delta=0.5, latex='b_{3nl}'),
            'sn0': dict(value=0., prior=dict(dist='norm', loc=0., scale=2.), ref=dict(dist='norm', loc=0., scale=0.1), latex='s_{n,0}'),
        }
        for ell in ells:
            params['ct{:d}_2'.format(ell)] = dict(
                value=0., prior=dict(dist='norm', loc=0., scale=100.),
                ref=dict(dist='norm', loc=0., scale=1.), delta=0.5, latex='c_{{t,{:d}}}'.format(ell))
        params['sn2_2'] = dict(value=0., prior=dict(dist='norm', loc=0., scale=10.),
                               ref=dict(dist='norm', loc=0., scale=0.1), latex='s_{n,2}')
        params['sn4_2'] = dict(value=0., fixed=True,  # sn4 fixed by default
                               prior=dict(dist='norm', loc=0., scale=10.),
                               ref=dict(dist='norm', loc=0., scale=0.1), latex='s_{n,4}')
        # freedom presets in the Eulerian basis: 'min' fixes the quadratic-and-up
        # bias freedom, 'max' opens it with wide flat priors (ct/sn keep their
        # Gaussian priors: they are analytically marginalized)
        if freedom == 'min':
            for name in ('bs', 'b3nl'):
                params[name].update(value=0., fixed=True)
            params['b2']['prior'] = dict(dist='norm', loc=0., scale=10.)
        elif freedom == 'max':
            for name in ('b2', 'bs', 'b3nl'):
                params[name].update(fixed=False, prior=dict(limits=[-15., 15.]))
        return params

    def initialize(self, k=None, ells=(0, 2, 4), template=None, mu=8, method='leggauss',
                   shotnoise=1e4, nr=128, nx=64, nk_loop=96, nk_template=None,
                   loop_method='fftlog', resum='full', resum_ks=0.4,
                   prior_basis='eulerian', freedom=None, tracer=None,
                   fsat=None, sigv=None, **kwargs):
        if resum not in (None, False, 'full'):
            raise ValueError("resum must be 'full' or None (got {!r})".format(resum))
        self.resum = 'full' if resum == 'full' else None
        if prior_basis not in ('eulerian', 'physical', None):
            raise ValueError("prior_basis must be 'eulerian' or 'physical' "
                             '(got {!r})'.format(prior_basis))
        self.physical = (prior_basis == 'physical')
        if self.physical:
            settings = physical_stochastic_settings(tracer=tracer)
            self.fsat = float(fsat if fsat is not None else settings['fsat'])
            self.sigv = float(sigv if sigv is not None else settings['sigv'])
        super().initialize(k=k, ells=ells)
        if template is None:
            template = DirectPowerSpectrumTemplate()
        self.template = template
        lo, hi, nk_tmpl = self._klim_template
        if nk_template is not None:
            nk_tmpl = int(nk_template)
        self.template.init.update(k=np.geomspace(lo, hi, nk_tmpl))
        self.template.runtime_info.initialize()  # its Chebyshev basis, rs_drag_fid
        self.set_k_mu(k=self.k, mu=mu, method=method, ells=self.ells)
        self.nd = 1. / float(shotnoise)
        # loop working grid: covers the AP-shifted output range, clamped to
        # the template limits
        lo_t, hi_t = self.template.k[0], self.template.k[-1]
        klo = max(self.k[0] * 0.6, lo_t * (1. + 1e-6))
        khi = min(self.k[-1] * 1.7, hi_t * (1. - 1e-6))
        if klo >= khi:
            raise ValueError(
                'requested output k-range [{:.4g}, {:.4g}] h/Mpc is incompatible with '
                'the template k-grid [{:.4g}, {:.4g}]: the loop working range is empty. '
                'Widen the template k limits (nk_template / template k=) or move the '
                'output range inside them.'.format(self.k[0], self.k[-1], lo_t, hi_t))
        self.k_work = np.geomspace(klo, khi, int(nk_loop))
        if str(loop_method) == 'fftlog':
            self.loop = FFTLogOneLoop(self.k_work)
        else:
            self.loop = OneLoopIntegrals(self.k_work, nr=int(nr), nx=int(nx))
        self._work_cheb = ChebyshevLogInterp(self.k_work, log_values=False)
        self._tmpl_lims = (lo_t, hi_t)
        if self.resum:
            self._resum_static_setup(float(resum_ks))
        if isinstance(self.loop, FFTLogOneLoop):
            self._loop_static_setup()
        self._set_eft_matrices()
        # stochastic terms: (k mu)^2 on the output grid
        self.k2mu2 = self.k[:, None] ** 2 * self.mu ** 2

    def _resum_static_setup(self, ks):
        r"""Static quadrature for the IR-damping scales (arXiv:1605.02149 /
        FOLPS conventions):

          Sigma^2      = 1/(6 pi^2) \int_0^{ks} dq P_nw(q) [1 - j0(q l) + 2 j2(q l)]
          deltaSigma^2 = 1/(2 pi^2) \int_0^{ks} dq P_nw(q) j2(q l)

        with l the fiducial sound horizon (the BAO wiggle wavelength) and
        ks the IR separation scale. P_nw varies per evaluation, so only the q
        grid, trapezoid weights and Bessel factors are static."""
        from scipy.special import spherical_jn
        l_bao = float(getattr(self.template, 'rs_drag_fid', 104.))
        qs = np.geomspace(max(1e-4, self._tmpl_lims[0] * (1. + 1e-6)), ks, 192)
        w = np.zeros_like(qs)
        d = np.diff(qs)
        w[:-1] += d / 2.
        w[1:] += d / 2.
        j0 = spherical_jn(0, qs * l_bao)
        j2 = spherical_jn(2, qs * l_bao)
        self._resum_q = qs
        self._resum_w_sigma = w * (1. - j0 + 2. * j2) / (6. * np.pi ** 2)
        self._resum_w_dsigma = w * j2 / (2. * np.pi ** 2)

    def _resum_scales(self, pknw_rq):
        """(Sigma^2, deltaSigma^2, f0, Sigma^2_iso) from P_nw on the static
        damping grid, (...,) each; Sigma^2_iso is the angle average of
        Sigma^2_tot(mu), which damps the loop input."""
        sigma2 = pknw_rq @ self.const('_resum_w_sigma', pknw_rq.dtype)
        dsigma2 = pknw_rq @ self.const('_resum_w_dsigma', pknw_rq.dtype)
        f0 = self.template.f  # scalar growth rate (scale-dependence is subleading here)
        s2_iso = (1. + f0 * (2. + f0) / 3.) * sigma2 - (2. / 15.) * f0 ** 2 * dsigma2
        return sigma2, dsigma2, f0, s2_iso

    def _loop_static_setup(self):
        """Static Chebyshev design matrix from the template basis to all the
        loop-path grids (decomposition samples, k_work, the (k, r) radial
        product grid, the sigma_v2 quadrature): per evaluation the linear pk
        lands on every loop grid with one (B, order) x (order, npts) product.
        Built host-side in float64; cast to the evaluation's dtype and device
        once (:meth:`Calculator.const`)."""
        loop = self.loop
        kq = np.outer(loop.k, loop.r).ravel()
        pts = np.concatenate([loop.x_grid, loop.k, kq, SIGMA_V2_Q])
        cheb = self.template._cheb
        self._loop_eval_mat = cheb.evaluation_matrix(pts)
        lo, hi = self._tmpl_lims
        self._loop_mask = ((pts > lo) & (pts < hi)).astype('f8')
        self._loop_sizes = (len(loop.x_grid), len(loop.k), kq.size, len(SIGMA_V2_Q))
        self._loop_pts2 = pts ** 2  # for the IR damping of the loop input
        if self.resum:
            self._resum_mat = cheb.evaluation_matrix(self._resum_q)
        # k_work must sit inside the template range for pk_lin to be exact
        n1, n2 = self._loop_sizes[:2]
        assert self._loop_mask[n1:n1 + n2].all(), 'k_work outside the template k range'

    def _set_eft_matrices(self):
        if self.physical:
            # physical basis: dimensionless alpha_n amplitudes; still exactly
            # linear given (b1p, f), so in-primal marginalization bases are
            # exposed for them (rows built in calculate)
            self.ct_names, self.ct_ells = [], {}
            self.solved_basis_names = ('alpha0p', 'alpha2p', 'alpha4p')
            return
        names, rows = [], {}
        for param in list(self.params):
            match = re.match(r'ct(\d+)_2$', param.basename)
            if match:
                ell = int(match.group(1))
                if ell in self.ells:
                    names.append(param.basename)
                    rows[param.basename] = ell
                else:
                    del self.params[param.name]
        self.ct_names, self.ct_ells = names, rows
        # exact linear counterterms: expose analytic marginalization bases
        self.solved_basis_names = tuple(self.ct_names)

    def _lookup(self, interp, kq, per_row):
        """``interp`` (a template lookup) at the static points ``kq``, zero
        outside the template table's range; with per-row coefficients the
        points are repeated for each chain."""
        lo, hi = self._tmpl_lims
        mask = (kq > lo) & (kq < hi)
        if per_row is not None:
            kq = kq.expand((per_row,) + tuple(kq.shape))
        return interp(kq) * mask

    def _fftlog_tables(self, resum=True):
        """The loop tables from the template's coefficients through the
        static design matrix, on the IR-resummed input if the theory
        resums and ``resum``; returns (tables, pk on k_work, resummation
        scales or None)."""
        tmpl = self.template
        cheb = tmpl._cheb
        n1, n2, n3, n4 = self._loop_sizes
        dtype = self._loop_dtype or self.dtype
        mat, mask = self.const('_loop_eval_mat', dtype), self.const('_loop_mask', dtype)
        coeffs = tmpl.pk_dd_coeffs().to(dtype)
        scales = None
        if self.resum and resum:
            # IR resummation: the loops run on the LO-resummed input
            # P_nw + exp(-k^2 Sigma^2_iso) P_w; full and no-wiggle tables land on
            # every loop grid through one stacked product
            coeffs_nw = tmpl.pknow_dd_coeffs().to(dtype)
            both = cheb.evaluate_static(torch.stack([coeffs, coeffs_nw]), mat)
            scales = self._resum_scales(cheb.evaluate_static(coeffs_nw, self.const('_resum_mat', dtype)))
            damp = torch.exp(-self.const('_loop_pts2', dtype) * scales[3][..., None])
            vals = torch.lerp(both[1], both[0], damp) * mask
            scales = tuple(scale.to(self.dtype) if isinstance(scale, torch.Tensor) else scale for scale in scales)
        else:
            vals = cheb.evaluate_static(coeffs, mat) * mask
        pk_k = vals[..., n1:n1 + n2]
        pk_kq = vals[..., n1 + n2:n1 + n2 + n3].reshape(vals.shape[:-1] + (n2, -1))
        tables = self.loop.tables_from_arrays(vals[..., :n1], pk_k, pk_kq, vals[..., -n4:])
        return {name: table.to(self.dtype) for name, table in tables.items()}, pk_k.to(self.dtype), scales

    def _quadrature_tables(self, resum=True):
        tmpl = self.template
        rows = tmpl.pk_dd_coeffs()
        per_row = rows.shape[0] if rows.ndim == 2 else None
        scales = None
        if self.resum and resum:
            scales = self._resum_scales(self._lookup(tmpl.pknow_dd_interp, self.const('_resum_q'), per_row))
            s2_iso = scales[3]

            def fn(kq):
                pnw = self._lookup(tmpl.pknow_dd_interp, kq, per_row)
                damp = torch.exp(-kq ** 2 * s2_iso.reshape(s2_iso.shape + (1,) * kq.ndim))
                return torch.lerp(pnw, self._lookup(tmpl.pk_dd_interp, kq, per_row), damp)
        else:
            def fn(kq):
                return self._lookup(tmpl.pk_dd_interp, kq, per_row)
        tables = self.loop.tables(fn, dtype=self.dtype, device=self.device)
        return tables, fn(self.const('k_work')), scales

    def calculate(self, b1=1.7, b2=0., bs=0., b3nl=0., sn0=0., **params):
        tmpl = self.template
        if self.physical:
            # physical -> Eulerian conversion: sigma8-scaled biases; b1p = b1 sigma8
            sigma8 = getattr(tmpl, 'sigma8', None)
            if sigma8 is None:
                sigma8 = tmpl.fsigma8 / tmpl.f
            b1 = params.get('b1p', 1.2) / sigma8
            b2 = params.get('b2p', 0.) / sigma8 ** 2
            bs = params.get('bsp', 0.) / sigma8 ** 2
            b3nl = params.get('b3p', 0.) / sigma8 ** 3
            sn0 = params.get('sn0p', 0.)
        if isinstance(self.loop, FFTLogOneLoop):
            t, pk_lin_w, scales = self._fftlog_tables()
        else:
            t, pk_lin_w, scales = self._quadrature_tables()
        # assemble on the working grid (McDonald-Roy basis); with resummation
        # the linear (tree) term is added at the output stage instead, where its
        # mu-dependent damping + leading-order wiggle correction live

        def row(value):
            return value[..., None] if isinstance(value, torch.Tensor) else value

        b1w, b2w, bsw, b3w = (row(v) for v in (b1, b2, bs, b3nl))
        lin_w = 0. if self.resum else pk_lin_w
        pgg_dd = (b1w ** 2 * (lin_w + t['p22_dd'] + t['p13_dd'])
                  + 2. * b1w * b2w * t['pb2_d'] + 2. * b1w * bsw * t['pbs2_d']
                  + 2. * b1w * b3w * t['p_sig3sq']
                  + b2w ** 2 * t['pb22'] + 2. * b2w * bsw * t['pb2s2'] + bsw ** 2 * t['pbs22'])
        pgg_dt = (b1w * (lin_w + t['p22_dt'] + t['p13_dt'])
                  + b2w * t['pb2_t'] + bsw * t['pbs2_t'] + b3w * t['p_sig3sq'])
        p_tt = lin_w + t['p22_tt'] + t['p13_tt']

        jac, kap, muap = tmpl.ap_k_mu(self.const('k'), self.const('mu'))
        jac = _col(jac)
        f = _col(tmpl.f_of_k(kap))
        cheb = self._work_cheb
        dd_ap = cheb.evaluate(cheb.coeffs(pgg_dd), kap)
        dt_ap = cheb.evaluate(cheb.coeffs(pgg_dt), kap)
        tt_ap = cheb.evaluate(cheb.coeffs(p_tt), kap)
        plin_ap = tmpl.pk_dd_interp(kap)
        mu2 = muap ** 2
        pkmu = jac * (dd_ap + 2. * f * mu2 * dt_ap + f ** 2 * mu2 ** 2 * tt_ap)
        if self.resum:
            # tree level, exactly: P_nw + e^{-k^2 Sigma_tot^2(mu)} (1 + k^2
            # Sigma_tot^2(mu)) P_w; the (1 + ...) term cancels the damped tree
            # wiggle double-counted by the loops at one-loop order
            sigma2, dsigma2, f0, _ = (_col(v) for v in scales)
            pnw_ap = tmpl.pknow_dd_interp(kap)
            pw_ap = plin_ap - pnw_ap
            s2tot = (1. + f0 * (f0 + 2.) * mu2) * sigma2 + f0 ** 2 * mu2 * (mu2 - 1.) * dsigma2
            damp = torch.exp(-kap ** 2 * s2tot)
            ptree = pnw_ap + damp * (1. + kap ** 2 * s2tot) * pw_ap
            plin_ct = pnw_ap + damp * pw_ap
            pkmu = pkmu + jac * (_col(b1) + f * mu2) ** 2 * ptree
        else:
            plin_ct = plin_ap
        # EFT counterterms: (ct_l mu^l pattern) k^2 P_lin
        base = kap ** 2 * plin_ct * jac
        mu_pows = {0: 1., 2: mu2, 4: mu2 ** 2, 6: mu2 ** 3}
        self._ct_bases = {}
        if self.physical:
            # dimensionless alpha_n with the velocileptors-convention growth/
            # bias combinations: the counterterm P(k, mu) is b1^2 a0 mu^0
            # + f b1 (a0 + a2) mu^2 + f (f a2 + b1 a4) mu^4 + f^2 a4 mu^6, all
            # x k^2 P_lin: linear in the alphas given (b1, f)
            f0, b1c = _col(tmpl.f), _col(b1)
            bases = {n: mu_pows[n] * base for n in (0, 2, 4, 6)}
            rows = {'alpha0p': b1c ** 2 * bases[0] + f0 * b1c * bases[2],
                    'alpha2p': f0 * b1c * bases[2] + f0 ** 2 * bases[4],
                    'alpha4p': f0 * b1c * bases[4] + f0 ** 2 * bases[6]}
            for name, basis in rows.items():
                self._ct_bases[name] = self.to_poles(basis.expand(pkmu.shape))
                pkmu = pkmu + _col(params.get(name, 0.)) * basis
            # stochastic: SN_n x fsat sigv^n, shot-noise units
            sn2 = params.get('sn2p', 0.) * self.fsat * self.sigv ** 2
            sn4 = params.get('sn4p', 0.) * self.fsat * self.sigv ** 4
        else:
            for name in self.ct_names:
                basis = mu_pows[self.ct_ells[name]] * base
                self._ct_bases[name] = self.to_poles(basis.expand(pkmu.shape))
                pkmu = pkmu + _col(params.get(name, 0.)) * basis
            sn2, sn4 = params.get('sn2_2', 0.), params.get('sn4_2', 0.)
        k2mu2 = self.const('k2mu2')
        pkmu = pkmu + (_col(sn0) + _col(sn2) * k2mu2 + _col(sn4) * k2mu2 ** 2) / self.nd
        self.power = self.to_poles(pkmu)
        # linear poles for diagnostics / pk11 consumers
        self.pktable = {'pk11': self.to_poles(plin_ct.expand(pkmu.shape))}

    def solved_power_basis(self, basename):
        """d power / d (counterterm), (B, nell, nk), evaluated after calculate."""
        return self._ct_bases[basename]

    @property
    def z(self):
        return self.template.z

    def get(self):
        return self.power


class EPTTracerCorrelationFunctionMultipoles(BaseTracerCorrelationFunctionMultipoles):
    """1-loop EPT tracer xi_l(s): the FFTLog transform of the EPT P_l(k)
    multipoles on k = geomspace(1e-4, 0.6, 300), resummed or not."""

    _power_cls = EPTTracerPowerSpectrumMultipoles

    def initialize(self, s=None, ells=(0, 2, 4), **kwargs):
        super().initialize(s=s, ells=ells, **kwargs)
        # the power node's loop tables in float64: in float32 their rounding, through the transform, reaches the
        # gradient of config 3xi's log-posterior at up to 8e-4 of its norm (2e-4 in float64; measured on the CPU)
        self.power._loop_dtype = torch.float64
