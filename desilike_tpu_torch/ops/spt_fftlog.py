"""FFTLog-matrix evaluation of the 1-loop SPT integrals.

Counterpart of ``desilike_tpu/ops/spt_fftlog.py``. The linear pk is
decomposed as P(x) = sum_m c_m x^{nu + i eta_m} on a log grid; every
P22-type integral then factorizes as

  P22_K(k) = sum_{m1,m2} c_{m1} c_{m2} k^{3 + nu_{m1} + nu_{m2}} M_K(m1, m2)

with kernel matrices M_K = (1/2 pi^2) int r^{2+nu1} dr int dx K(r, x) y^{nu2}
that do not depend on pk or k. They are computed once, host-side in float64
numpy, by the same (r, x) quadrature as :mod:`desilike_tpu_torch.ops.spt`,
and written as real quadratic forms over the half spectrum.

Per evaluation, over a chain batch (:meth:`FFTLogOneLoop.tables_from_arrays`):
one ``torch.fft.rfft`` of pk x^-nu on the log grid, a phase, then all the
quadratic forms of one bias group as one matrix product (B nk, N+2) x
(N+2, s (N+2)) followed by a batched multiply-and-sum; and the radial P13
and P(kr)^2 pieces as products with static (nr, 4) and (nr,) weights.
"""

import numpy as np
import torch

from .spt import p13_radial_kernels, sigma3sq_radial_kernel, sigma_v2_grid

SIGMA_V2_Q, SIGMA_V2_W = sigma_v2_grid()


class FFTLogOneLoop:
    """1-loop EPT tables via FFTLog decomposition + precomputed matrices.

    Parameters
    ----------
    k_out : array
        Output wavenumbers.
    krange : (float, float)
        Decomposition range (log-uniform); pk is treated as zero outside.
    nfft : int
        Number of log-grid samples (nfft//2+1 frequencies).
    bias : float
        Power-law bias nu of the decomposition.
    nr, nx : int
        Quadrature orders for the (one-time) kernel-matrix integrals.
    """

    def __init__(self, k_out, krange=(5e-5, 1e2), nfft=128, bias=-0.6, bias_b22=-1.7,
                 nr=256, nx=96, rlim=(1e-4, 1e3)):
        self.k = np.asarray(k_out, dtype='f8')
        self.nfft = int(nfft)
        self.bias = float(bias)
        self.bias_b22 = float(bias_b22)  # constant-kernel (b22-type) integrals need a steeper
        # bias for the large-r convergence of the matrix integrals
        k0, k1 = krange
        self.x_grid = np.geomspace(k0, k1, self.nfft)
        self.delta = np.log(k1 / k0) / (self.nfft - 1)
        m = np.arange(self.nfft // 2 + 1)
        self.eta = 2. * np.pi * m / (self.nfft * self.delta)
        # quadrature grids (log-r GL + GL in x), same construction as spt.py
        xg, wg = np.polynomial.legendre.leggauss(nr)
        lnr = (np.log(rlim[1]) - np.log(rlim[0])) / 2. * (xg + 1.) + np.log(rlim[0])
        r = np.exp(lnr)
        wr = wg * (np.log(rlim[1]) - np.log(rlim[0])) / 2. * r
        xg2, wx = np.polynomial.legendre.leggauss(nx)
        y = np.sqrt(np.clip(1. + r[:, None] ** 2 - 2. * r[:, None] * xg2[None, :], 1e-30, None))
        mu12 = (xg2[None, :] - r[:, None]) / y
        F2 = 5. / 7. + (mu12 / 2.) * (r[:, None] / y + y / r[:, None]) + (2. / 7.) * mu12 ** 2
        G2 = 3. / 7. + (mu12 / 2.) * (r[:, None] / y + y / r[:, None]) + (4. / 7.) * mu12 ** 2
        S2 = mu12 ** 2 - 1. / 3.
        kernels = {'p22_dd': F2 ** 2, 'p22_dt': F2 * G2, 'p22_tt': G2 ** 2,
                   'pb2_d': F2 / 2., 'pb2_t': G2 / 2.,
                   'pbs2_d': F2 * S2 / 2., 'pbs2_t': G2 * S2 / 2.}
        kernels_b22 = {'pb22_y': np.ones_like(S2) / 4., 'pb2s2_y': S2 / 4.,
                       'pbs22_y': S2 ** 2 / 4.}
        lny = np.log(y)

        def build_matrices(bias, kernel_dict):
            # complex exponents nu_m = bias + i eta_m, full-spectrum indexing
            nu = bias + 1j * self._full_eta()
            nfreq = len(nu)
            r_pow_w = np.exp(np.outer(lnr, (2. + nu))) * wr[:, None]  # (nr, nfreq)
            out = {}
            for name, K in kernel_dict.items():
                Mk = np.empty((nfreq, nfreq), dtype=complex)
                for j2 in range(nfreq):
                    ypow = np.exp(nu[j2] * lny)                       # (nr, nx)
                    inner = np.einsum('rx,x->r', K * ypow, wx)        # (nr,)
                    Mk[:, j2] = np.einsum('rm,r->m', r_pow_w, inner)
                out[name] = Mk / (2. * np.pi ** 2)
            return out

        self.M = build_matrices(self.bias, kernels)
        self.M_b22 = build_matrices(self.bias_b22, kernels_b22)

        # Real half-spectrum form of the quadratic forms: for a real pk the
        # full-spectrum coefficients are Hermitian (d_{-m} = conj(d_m)), so with
        # u = [Re d_h, Im d_h] (h = 0..N/2) the form d^T M d has
        # Re(d^T M d) = u^T Re(S^T M S) u, S the fixed (N, N+2) complex map d_full = S u
        def real_form(M_dict):
            N = self.nfft
            half = N // 2
            freqs = np.fft.fftfreq(N, d=1. / N).astype(int)  # integer frequencies
            S = np.zeros((N, 2 * (half + 1)), dtype=complex)
            for p, f in enumerate(freqs):
                h = abs(f)
                S[p, h] = 1.                                     # a_h = Re d_h
                S[p, half + 1 + h] = 1j * (-1. if f < 0 else 1.)  # b_h = Im d_h
            names = list(M_dict)
            return names, np.stack([np.real(S.T @ M_dict[name] @ S) for name in names])

        self._names_M, self._Mr = real_form(self.M)
        self._names_b22, self._Mr_b22 = real_form(self.M_b22)
        self._nu_half = self.bias + 1j * self.eta
        self._nu_half_b22 = self.bias_b22 + 1j * self.eta
        # P13 and the subtracted P(kr)^2 pieces are 1D radial integrals, evaluated
        # directly per evaluation: more accurate than the decomposition through
        # slowly-converging radial kernels
        self.K13 = dict(zip(('p13_dd', 'p13_dt', 'p13_tt'), p13_radial_kernels(r)))
        self.K13['p_sig3sq'] = sigma3sq_radial_kernel(r)
        self.r = r
        self.wr2 = wr * r ** 2
        self._tensors = {}

    def _full_eta(self):
        n = self.nfft
        m = np.fft.fftfreq(n, d=1. / n)  # integer frequencies, negative included
        return 2. * np.pi * m / (n * self.delta)

    def _const(self, dtype, device):
        """Per-evaluation constants as tensors of ``dtype`` on ``device``, cast
        once: for each bias group the factor x^-nu on the grid, the phase
        of each (k, h) (x_0^{-i eta_h} k^{nu_h}, real and imaginary parts,
        with 1/N), the stacked real forms as one (N+2, s (N+2)) matrix; the
        radial weights (nr, 4) and r^2 dr, k^3 and the sigma_v2 weights."""
        key = (dtype, device)
        if key in self._tensors:
            return self._tensors[key]

        def tensor(array):
            return torch.as_tensor(np.ascontiguousarray(array), dtype=dtype, device=device)

        groups = []
        for bias, nu_half, Mr, names in ((self.bias, self._nu_half, self._Mr, self._names_M),
                                         (self.bias_b22, self._nu_half_b22, self._Mr_b22, self._names_b22)):
            phase = np.exp(-1j * self.eta * np.log(self.x_grid[0]))[None, :] * np.exp(np.outer(np.log(self.k), nu_half))
            phase = phase / self.nfft
            s, n = Mr.shape[:2]
            groups.append(dict(names=names, weight=tensor(self.x_grid ** (-bias)), phase_re=tensor(phase.real),
                               phase_im=tensor(phase.imag),
                               forms=tensor(np.transpose(Mr, (1, 0, 2)).reshape(n, s * n))))
        names = list(self.K13)
        out = self._tensors[key] = dict(
            groups=groups, radial_names=names, radial=tensor(np.stack([self.K13[name] * self.wr2 for name in names],
                                                                       axis=-1)),
            wr2=tensor(self.wr2), k3=tensor(self.k ** 3), sigma_w=tensor(SIGMA_V2_W / (6. * np.pi ** 2)))
        return out

    def _quad_real(self, pk_x, group):
        """All quadratic forms of one bias group, (..., s, nk), from pk (...,
        nfft) on the decomposition grid: u (..., nk, N+2) = [Re d, Im d] of
        the phased half-spectrum coefficients, then u^T Mr_s u for every s
        as one matrix product and a batched multiply-and-sum."""
        ch = torch.fft.rfft(pk_x * group['weight'], dim=-1)[..., None, :]     # (..., 1, N/2+1)
        re, im = ch.real, ch.imag
        # d = c * phase, complex, as real arithmetic: real autograd from here on
        u = torch.cat([re * group['phase_re'] - im * group['phase_im'],
                       re * group['phase_im'] + im * group['phase_re']], dim=-1)  # (..., nk, N+2)
        lead, n = u.shape[:-1], u.shape[-1]
        flat = u.reshape(-1, n)
        projected = (flat @ group['forms']).reshape(flat.shape[0], -1, n)        # (P, s, N+2)
        quad = torch.matmul(projected, flat[..., None])[..., 0]                 # (P, s)
        quad = quad.reshape(lead + (-1,)).movedim(-1, -2)                        # (..., s, nk)
        return dict(zip(group['names'], quad.unbind(-2)))

    def tables_from_arrays(self, pk_x, pk_k, pk_kq, pk_sig):
        """Tables, (..., nk) each (``sigma_v2`` (...,)), from pk sampled on the
        engine's static grids, with an optional leading chain batch:

        pk_x : (..., nfft) on ``x_grid``; pk_k : (..., nk) on ``k``;
        pk_kq : (..., nk, nr) on ``k[:, None] * r``; pk_sig : (..., 256) on
        ``SIGMA_V2_Q``.
        """
        c = self._const(pk_x.dtype, pk_x.device)
        k3 = c['k3']
        out = {}
        for group in c['groups']:
            for name, quad in self._quad_real(pk_x, group).items():
                out[name] = quad * k3
        # 1D radial pieces: P13 and the P(kr)^2 subtractions
        pref = k3 / (2. * np.pi ** 2)
        radial = pref[:, None] * pk_k[..., None] * (pk_kq @ c['radial'])      # (..., nk, 4)
        for name, table in zip(c['radial_names'], radial.unbind(-1)):
            out[name] = table
        sub2 = pref / 4. * ((pk_kq ** 2) @ c['wr2'])  # int r^2 dr P(kr)^2 / (8 pi^2) * 2
        out['pb22'] = out.pop('pb22_y') - 2. * sub2
        out['pb2s2'] = out.pop('pb2s2_y') - (2. / 3.) * 2. * sub2
        out['pbs22'] = out.pop('pbs22_y') - (4. / 9.) * 2. * sub2
        out['sigma_v2'] = pk_sig @ c['sigma_w']
        return out

    def tables(self, pk_fn, dtype=torch.float32, device='cpu'):
        """Same contract as :meth:`OneLoopIntegrals.tables` (quadrature engine)."""
        def grid(array):
            return pk_fn(torch.as_tensor(array, dtype=dtype, device=device))
        return self.tables_from_arrays(grid(self.x_grid), grid(self.k), grid(self.k[:, None] * self.r[None, :]),
                                       grid(SIGMA_V2_Q))
