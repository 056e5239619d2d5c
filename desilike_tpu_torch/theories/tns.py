"""TNS (Taruya-Nishimichi-Saito 2010) redshift-space full-shape model.

Counterpart of ``desilike_tpu/theories/tns.py``: 1-loop P_dd/P_dt/P_tt
with McDonald-Roy biasing (with the third-order b3nl sigma3^2 term), the A
and B RSD correction terms of arXiv:1006.0699, and a Lorentzian or
Gaussian finger-of-god damping with free sigmav, on the EPT node's
machinery (the FFTLog or quadrature 1-loop tables, the Chebyshev AP
lookups, the exactly marginalizable counter and stochastic terms). The
loop tables and the A/B tables take the plain masked linear pk (no IR
resummation), as in the JAX package.

Per evaluation, over the chain batch: the template's pk lands on the loop
grids (one static product), the TNS tables (:mod:`..ops.tns`) take pk at
|k - q| on their (nk, nq, nmu) grid through the Clenshaw kernel, with one
row of 460800 points (at the defaults) read by every chain's coefficients,
and pk at q through one static product; the 20 working-grid tables (dd,
dt, tt, the 5 A and the 12 B components) are fitted to Chebyshev series in
one product and looked up at the AP-remapped (k, mu) in one launch over
20 B coefficient rows.
"""

import numpy as np
import torch

from ..ops.tns import TNSCorrections
from ..ops.spt_fftlog import FFTLogOneLoop
from .base import _col
from .ept import EPTTracerPowerSpectrumMultipoles
from .full_shape import BaseTracerCorrelationFunctionMultipoles


class EFTLikeTNSTracerPowerSpectrumMultipoles(EPTTracerPowerSpectrumMultipoles):
    """TNS tracer multipoles with EFT-like counter and stochastic terms."""

    @staticmethod
    def _params(init):
        params = EPTTracerPowerSpectrumMultipoles._params(init)
        params['b3'] = dict(value=0., prior=dict(dist='norm', loc=0., scale=5.),
                            ref=dict(dist='norm', loc=0., scale=0.5), delta=0.5, latex='b_3')
        params['sigmav'] = dict(value=4., prior=dict(limits=[0., 15.]),
                                ref=dict(dist='norm', loc=4., scale=0.5), delta=0.5,
                                latex=r'\sigma_v')
        return params

    def initialize(self, *args, fog='lorentzian', nq_tns=300, nmu_tns=16, **kwargs):
        super().initialize(*args, **kwargs)
        if fog not in ('lorentzian', 'gaussian'):
            raise ValueError("fog must be 'lorentzian' or 'gaussian'")
        self.fog = str(fog)
        lo, hi = self._tmpl_lims
        self.tns = TNSCorrections(self.k_work, qrange=(max(lo, 1e-4), min(hi, 10.)), nq=int(nq_tns),
                                  nmu=int(nmu_tns), prange=(lo, hi))
        cheb = self.template._cheb
        self._tns_x = cheb.static_x(self.tns.y)            # pk at |k - q|: the kernel's shared queries
        self._tns_q_mat = cheb.evaluation_matrix(self.tns.q)
        self._tns_kernels, self._tns_q_kernels = self.tns.kernels, self.tns.q_kernels

    def _tns_tables(self, pk_k):
        tmpl = self.template
        coeffs = tmpl.pk_dd_coeffs()
        pk_y = tmpl._cheb.evaluate_shared(coeffs, self.const('_tns_x'))
        pk_q = tmpl._cheb.evaluate_static(coeffs, self.const('_tns_q_mat'))
        return self.tns.tables(pk_q, pk_k, pk_y, self.const('_tns_kernels'), self.const('_tns_q_kernels'))

    def calculate(self, b1=1.7, b2=0., bs=0., b3=0., sigmav=4., sn0=0., **params):
        tmpl = self.template
        if isinstance(self.loop, FFTLogOneLoop):
            t, pk_lin_w, _ = self._fftlog_tables(resum=False)
        else:
            t, pk_lin_w, _ = self._quadrature_tables(resum=False)
        c = self._tns_tables(pk_lin_w)

        def row(value):
            return value[..., None] if isinstance(value, torch.Tensor) else value

        b1w, b2w, bsw, b3w = (row(v) for v in (b1, b2, bs, b3))
        # coevolution-shifted quadratic and cubic biases (McDonald-Roy)
        bs2 = bsw - 4. / 7. * (b1w - 1.)
        b3nl = b3w + 32. / 315. * (b1w - 1.)
        sig3_pk = c['sig3sq'] * pk_lin_w
        pgg_dd = (b1w ** 2 * (pk_lin_w + t['p22_dd'] + t['p13_dd'])
                  + 2. * b1w * b2w * t['pb2_d'] + 2. * b1w * bs2 * t['pbs2_d']
                  + 2. * b1w * b3nl * sig3_pk
                  + b2w ** 2 * t['pb22'] + 2. * b2w * bs2 * t['pb2s2'] + bs2 ** 2 * t['pbs22'])
        pgg_dt = (b1w * (pk_lin_w + t['p22_dt'] + t['p13_dt'])
                  + b2w * t['pb2_t'] + bs2 * t['pbs2_t'] + b3nl * sig3_pk)
        p_tt = pk_lin_w + t['p22_tt'] + t['p13_tt']

        jac, kap, muap = tmpl.ap_k_mu(self.const('k'), self.const('mu'))
        jac = _col(jac)
        # scale-dependent under the eh99 engine; the A/B loop corrections keep the standard EdS kernels
        f = _col(tmpl.f_of_k(kap))
        # the 20 working-grid tables: one fit, one lookup at each chain's (k', mu') over 20 B rows
        batch = kap.shape[0]
        nk = len(self.k_work)
        stacked = torch.cat([table.expand(batch, nk)[:, None] for table in (pgg_dd, pgg_dt, p_tt)]
                            + [c['A'].expand(batch, 5, nk), c['B'].expand(batch, 12, nk)], dim=1)
        cheb = self._work_cheb
        coeffs = cheb.coeffs(stacked).reshape(batch * 20, -1)
        kap20 = kap[:, None].expand((batch, 20) + kap.shape[1:]).reshape((batch * 20,) + kap.shape[1:])
        ap = cheb.evaluate(coeffs, kap20).reshape((batch, 20) + kap.shape[1:]).unbind(1)
        dd_ap, dt_ap, tt_ap, A, B = ap[0], ap[1], ap[2], ap[3:8], ap[8:]
        plin_ap = tmpl.pk_dd_interp(kap)

        b1c = _col(b1)
        mu2 = muap ** 2
        mu4, mu6, mu8 = mu2 ** 2, mu2 ** 3, mu2 ** 4
        # Taruya 2010 assembly grouped by powers of b1
        a_term = (b1c ** 2 * f * A[0] * mu2
                  + b1c * f ** 2 * (A[1] * mu2 + A[2] * mu4)
                  + f ** 3 * (A[3] * mu4 + A[4] * mu6))
        b_term = (b1c ** 2 * f ** 2 * (B[0] * mu2 + B[4] * mu4)
                  - b1c * f ** 3 * ((B[1] + B[2]) * mu2 + (B[5] + B[6]) * mu4 + (B[8] + B[9]) * mu6)
                  + f ** 4 * (B[3] * mu2 + B[7] * mu4 + B[10] * mu6 + B[11] * mu8))
        pkmu_pt = dd_ap + 2. * f * mu2 * dt_ap + f ** 2 * mu4 * tt_ap + a_term + b_term
        if self.fog == 'lorentzian':
            damping = 1. / (1. + (_col(sigmav) * kap * muap) ** 2 / 2.) ** 2
        else:
            damping = torch.exp(-(_col(sigmav) * kap * muap) ** 2)
        pkmu = jac * damping * pkmu_pt

        # EFT counterterms and stochastic terms, as the EPT node's
        mu_pows = {0: 1., 2: mu2, 4: mu4}
        self._ct_bases = {}
        for name in self.ct_names:
            basis = mu_pows[self.ct_ells[name]] * kap ** 2 * plin_ap * jac
            self._ct_bases[name] = self.to_poles(basis.expand(pkmu.shape))
            pkmu = pkmu + _col(params.get(name, 0.)) * basis
        pkmu = pkmu + (_col(sn0) + _col(params.get('sn2_2', 0.)) * self.const('k2mu2')) / self.nd
        self.power = self.to_poles(pkmu)
        self.pktable = {'pk11': self.to_poles(plin_ap.expand(pkmu.shape))}


class TNSTracerPowerSpectrumMultipoles(EFTLikeTNSTracerPowerSpectrumMultipoles):
    """Plain TNS (no EFT counterterms)."""

    @staticmethod
    def _params(init):
        params = EFTLikeTNSTracerPowerSpectrumMultipoles._params(init)
        for name in list(params):
            if name.startswith('ct') or name == 'sn2_2':
                del params[name]
        return params


class EFTLikeTNSTracerCorrelationFunctionMultipoles(BaseTracerCorrelationFunctionMultipoles):
    """TNS + EFT-like terms xi_l(s): the FFTLog transform of the P(k) model."""

    _power_cls = EFTLikeTNSTracerPowerSpectrumMultipoles


class TNSTracerCorrelationFunctionMultipoles(BaseTracerCorrelationFunctionMultipoles):
    """Plain TNS xi_l(s)."""

    _power_cls = TNSTracerPowerSpectrumMultipoles
