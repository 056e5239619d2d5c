"""Standard perturbation theory kernels and 1-loop integrals.

Counterpart of ``desilike_tpu/ops/spt.py``. The P13 radial kernels K_ab(r)
are generated numerically at initialization, host-side in float64 numpy,
from the SPT recursion relations (Bernardeau et al. 2002, eqs. 43-45) with
epsilon-regularization of the q2 -> -q1 configuration and Richardson
extrapolation, and checked against the analytic delta-delta kernel. P22-type
and quadratic-bias integrals use direct (r, x) Gauss quadrature with F2, G2
and S2 evaluated from their exact vector forms.

The per-evaluation path (:meth:`OneLoopIntegrals.tables`) is elementwise
work and contractions over the static grids, in torch, over a leading chain
batch when the linear pk has one.
"""

import itertools

import numpy as np
import torch

from .. import config


# --- exact 2nd-order kernels in (r, x) variables: q1 = k r (angle x), q2 = k - q1 ---

def _rx_geometry(r, x):
    """y = |k - q|/k and mu12 = cos(q1, k-q1) for q1 = k r with cos(k,q1)=x."""
    y2 = 1. + r ** 2 - 2. * r * x
    y = torch.sqrt(torch.clamp(y2, min=1e-30))
    mu12 = (x - r) / y
    return y, mu12


def F2_rx(r, x):
    y, mu = _rx_geometry(r, x)
    return 5. / 7. + (mu / 2.) * (r / y + y / r) + (2. / 7.) * mu ** 2


def G2_rx(r, x):
    y, mu = _rx_geometry(r, x)
    return 3. / 7. + (mu / 2.) * (r / y + y / r) + (4. / 7.) * mu ** 2


def S2_rx(r, x):
    y, mu = _rx_geometry(r, x)
    return mu ** 2 - 1. / 3.


# --- P13 radial kernels from the SPT recursion (host-side numpy float64) ---

def _dot(a, b):
    return np.einsum('...i,...i->...', a, b)


def _alpha(k1, k2):
    return _dot(k1 + k2, k1) / _dot(k1, k1)


def _beta(k1, k2):
    k12 = k1 + k2
    return _dot(k12, k12) * _dot(k1, k2) / (2. * _dot(k1, k1) * _dot(k2, k2))


def _F2_vec(q1, q2):
    dot, q1sq, q2sq = _dot(q1, q2), _dot(q1, q1), _dot(q2, q2)
    mu2 = dot ** 2 / (q1sq * q2sq)
    return 5. / 7. + 0.5 * dot * (1. / q1sq + 1. / q2sq) + 2. / 7. * mu2


def _G2_vec(q1, q2):
    dot, q1sq, q2sq = _dot(q1, q2), _dot(q1, q1), _dot(q2, q2)
    mu2 = dot ** 2 / (q1sq * q2sq)
    return 3. / 7. + 0.5 * dot * (1. / q1sq + 1. / q2sq) + 4. / 7. * mu2


def _F3_G3_unsym(q1, q2, q3):
    """Unsymmetrized F3, G3 via the recursion (n=3)."""
    n = 3
    denom = (2 * n + 3) * (n - 1)  # 18
    # m = 1: G1(q1) * [ (2n+1) a(q1, q2+q3) F2(q2,q3) + 2 b G2(q2,q3) ]
    a, b = _alpha(q1, q2 + q3), _beta(q1, q2 + q3)
    f2, g2 = _F2_vec(q2, q3), _G2_vec(q2, q3)
    F3 = (7. * a * f2 + 2. * b * g2) / denom
    G3 = (3. * a * f2 + 6. * b * g2) / denom
    # m = 2: G2(q1,q2) * [ (2n+1) a(q1+q2, q3) F1 + 2 b G1 ]
    a, b = _alpha(q1 + q2, q3), _beta(q1 + q2, q3)
    g2 = _G2_vec(q1, q2)
    F3 = F3 + g2 * (7. * a + 2. * b) / denom
    G3 = G3 + g2 * (3. * a + 6. * b) / denom
    return F3, G3


def _F3_G3_sym(q1, q2, q3):
    F3 = 0.
    G3 = 0.
    for perm in itertools.permutations((q1, q2, q3)):
        f, g = _F3_G3_unsym(*perm)
        F3 = F3 + f
        G3 = G3 + g
    return F3 / 6., G3 / 6.


def p13_radial_kernels(r, nx=200, eps=1e-3):
    r"""K_dd(r), K_dt(r), K_tt(r) such that

      P13_ab(k) = (k^3 P(k) / (2 pi^2)) \int r^2 dr P(k r) K_ab(r),

    the angle integral done here: delta-delta uses 3 F3s, delta-theta
    (F3s + G3s) * 3/2 (the cross gets both orderings), theta-theta 3 G3s, with
    F3s, G3s the symmetrized kernels at (q, -q, k). epsilon-regularized at
    q2 = -q1, then Richardson-extrapolated in eps.
    """
    r = np.asarray(r, dtype='f8')
    xg, wg = np.polynomial.legendre.leggauss(nx)

    def kernels(eps_val):
        # vectors: k = z-hat; q = r(sin, 0, cos); config (q, -q(1-eps), k - eps q)
        sin = np.sqrt(np.clip(1. - xg ** 2, 0., None))
        q = np.stack([r[:, None] * sin[None, :], np.zeros((r.size, nx)),
                      r[:, None] * xg[None, :]], axis=-1)       # (nr, nx, 3)
        k = np.zeros_like(q)
        k[..., 2] = 1.
        q1 = q
        q2 = -(1. - eps_val) * q
        q3 = k - q1 - q2
        F3, G3 = _F3_G3_sym(q1, q2, q3)
        Kdd = 3. * np.einsum('rx,x->r', F3, wg)
        Ktt = 3. * np.einsum('rx,x->r', G3, wg)
        Kdt = 1.5 * np.einsum('rx,x->r', F3 + G3, wg)
        return Kdd, Kdt, Ktt

    k1 = kernels(eps)
    k2 = kernels(eps / 2.)
    # Richardson: f(eps) = f0 + c eps -> f0 = 2 f(eps/2) - f(eps)
    return tuple(2. * b - a for a, b in zip(k1, k2))


def sigma3sq_radial_kernel(r, nmu=400):
    r"""Radial kernel of the third-order bias spectrum (McDonald & Roy 2009,
    arXiv:0902.0991; the b3nl sigma_3^2 term):

      P_sig3sq(k) = (k^3 P(k) / (2 pi^2)) \int r^2 dr P(k r) K(r),
      K(r) = (105/16) (1/2) \int_{-1}^{1} dmu [ D(mu) S(r, mu) + 8/63 ],

    with D = (2/7)(mu^2 - 1) and the tidal kernel between the loop momenta
    S = (mu - r)^2/(1 - 2 r mu + r^2) - 1/3 at q = k r, mu over the full
    sphere. The 8/63 constant cancels the UV (r -> inf) limit: K(inf) = 0,
    K(0) = 1."""
    r = np.asarray(r, dtype='f8')[:, None]
    mu, wmu = np.polynomial.legendre.leggauss(int(nmu))
    mu = mu[None, :]
    kq2 = np.clip(1. - 2. * r * mu + r ** 2, 1e-30, None)  # |k-q|^2 / k^2
    S = (mu - r) ** 2 / kq2 - 1. / 3.
    D = 2. / 7. * (mu ** 2 - 1.)
    integrand = D * S + 8. / 63.
    return (105. / 16.) * 0.5 * np.einsum('rm,m->r', integrand, wmu)


def p13_kernel_dd_analytic(r):
    """Closed form of the delta-delta P13 radial kernel, with the
    normalization P13_dd = (k^3 P(k)/(2 pi^2)) int r^2 dr P(kr) K(r):
    K(r) = [12/r^2 - 158 + 100 r^2 - 42 r^4
            + (3/r^3)(r^2-1)^3 (7r^2+2) ln((1+r)/|1-r|)] / (504 r^2).
    Checks the recursion-generated kernels."""
    r = np.asarray(r, dtype='f8')
    with np.errstate(divide='ignore', invalid='ignore'):
        log = np.log(np.abs((1. + r) / (1. - r)))
        poly = (12. / r ** 2 - 158. + 100. * r ** 2 - 42. * r ** 4
                + 3. / r ** 3 * (r ** 2 - 1.) ** 3 * (7. * r ** 2 + 2.) * log)
        out = poly / (504. * r ** 2)
    out = np.where(np.abs(r - 1.) < 1e-8, (12. - 158. + 100. - 42.) / 504., out)
    return out


def sigma_v2_grid():
    """Static grid and trapezoid weights of the velocity dispersion
    sigma_v^2 = (1 / 6 pi^2) int P(q) dq: 256 points from 1e-4 to 20."""
    qs = np.geomspace(1e-4, 20., 256)
    wq = np.zeros_like(qs)
    dq = np.diff(qs)
    wq[:-1] += dq / 2.
    wq[1:] += dq / 2.
    return qs, wq


class OneLoopIntegrals:
    """Static quadrature engine for 1-loop EPT tables.

    Parameters
    ----------
    k_out : array
        Output wavenumbers (static).
    nr, nx : int
        Radial (log-spaced Gauss-Legendre in ln r) and angular quadrature sizes.
    rlim : (float, float)
        Integration range in r = q/k.
    """

    def __init__(self, k_out, nr=128, nx=64, rlim=(1e-4, 1e3)):
        self.k = np.asarray(k_out, dtype='f8')
        # log-r Gauss-Legendre
        xg, wg = np.polynomial.legendre.leggauss(nr)
        lnr = (np.log(rlim[1]) - np.log(rlim[0])) / 2. * (xg + 1.) + np.log(rlim[0])
        self.r = np.exp(lnr)                                      # (nr,)
        self.wr = wg * (np.log(rlim[1]) - np.log(rlim[0])) / 2. * self.r  # includes dr = r dlnr
        self.x, self.wx = np.polynomial.legendre.leggauss(nx)
        Kdd, Kdt, Ktt = p13_radial_kernels(self.r)
        self.K13 = {'dd': Kdd, 'dt': Kdt, 'tt': Ktt}
        self.Ksig3 = sigma3sq_radial_kernel(self.r)
        # static geometry for the (k_out, r, x) grid
        r_ = self.r[None, :, None]
        x_ = self.x[None, None, :]
        self.y = np.sqrt(np.clip(1. + r_ ** 2 - 2. * r_ * x_, 1e-30, None))  # (1, nr, nx)
        self.kq = self.k[:, None] * self.r[None, :]               # (nk, nr): |q|
        self.ky = self.k[:, None, None] * self.y                   # (nk, nr, nx): |k-q|
        # 2nd-order kernels on the grid (static f8)
        rr = np.broadcast_to(self.r[None, :, None], self.y.shape)
        xx = np.broadcast_to(self.x[None, None, :], self.y.shape)
        mu12 = (xx - rr) / self.y
        self.F2 = 5. / 7. + (mu12 / 2.) * (rr / self.y + self.y / rr) + (2. / 7.) * mu12 ** 2
        self.G2 = 3. / 7. + (mu12 / 2.) * (rr / self.y + self.y / rr) + (4. / 7.) * mu12 ** 2
        self.S2 = mu12 ** 2 - 1. / 3.
        self._tensors = {}

    def _const(self, dtype, device):
        """The static grids and weights as tensors of ``dtype`` on ``device``, cast once."""
        key = (dtype, device)
        if key not in self._tensors:
            qs, wq = sigma_v2_grid()
            arrays = dict(k=self.k, kq=self.kq, ky=self.ky, wx=self.wx, wr2=self.r ** 2 * self.wr,
                          F2=self.F2, G2=self.G2, S2=self.S2, qs=qs, wq=wq, Ksig3=self.Ksig3,
                          **{'K13_' + ab: K for ab, K in self.K13.items()})
            self._tensors[key] = {name: torch.as_tensor(np.asarray(value), dtype=dtype, device=device)
                                  for name, value in arrays.items()}
        return self._tensors[key]

    def tables(self, pk_fn, dtype=torch.float32, device=None):
        """All 1-loop tables on self.k, (..., nk) each, given the linear pk,
        in ``dtype`` on ``device`` (the card when None).

        pk_fn : callable, k tensor of any shape S -> P_lin(k) of shape S or,
        with a chain batch, (B,) + S (e.g. a template's Chebyshev lookup).

        Normalizations (q = k r, y = |k-q|/k):
          P22_ab(k)  = (k^3/(2 pi^2)) int r^2 dr P(kr) int dx K_a K_b P(ky)
          Pb2_a(k)   = same with single kernel, / 2
          P13_ab(k)  = (k^3/(2 pi^2)) P(k) int r^2 dr P(kr) K13_ab(r)
          Pb22(k)    = (k^3/(8 pi^2)) int r^2 dr P(kr) int dx [P(ky) - P(kr)]
          Pb2s2(k)   = (k^3/(8 pi^2)) int ... [S2 P(ky) - (2/3) P(kr)]
          Pbs22(k)   = (k^3/(8 pi^2)) int ... [S2^2 P(ky) - (4/9) P(kr)]
        """
        c = self._const(dtype, config.resolve(device))
        k = c['k']
        pk_k = pk_fn(k)                         # (..., nk)
        pk_q = pk_fn(c['kq'])                   # (..., nk, nr)
        pk_y = pk_fn(c['ky'])                   # (..., nk, nr, nx)
        pref = k ** 3 / (2. * np.pi ** 2)
        wr2 = c['wr2']

        def quad(kernel):
            inner = (pk_y * kernel) @ c['wx']
            return pref * ((pk_q * inner) @ wr2)

        def quad_sub(kernel_y, const_sub):
            """int dx [kernel * P(ky) - const_sub * P(kr)] with the full dx measure."""
            inner = (pk_y if kernel_y is None else pk_y * kernel_y) @ c['wx'] - 2. * const_sub * pk_q
            return pref / 4. * ((pk_q * inner) @ wr2)

        F2, G2, S2 = c['F2'], c['G2'], c['S2']
        tables = {}
        tables['p22_dd'] = quad(F2 ** 2)
        tables['p22_dt'] = quad(F2 * G2)
        tables['p22_tt'] = quad(G2 ** 2)
        # quadratic bias spectra (McDonald & Roy 2009 basis; low-k constants
        # subtracted so they are absorbed by shot noise)
        tables['pb2_d'] = quad(F2) / 2.
        tables['pb2_t'] = quad(G2) / 2.
        tables['pbs2_d'] = quad(F2 * S2) / 2.
        tables['pbs2_t'] = quad(G2 * S2) / 2.
        tables['pb22'] = quad_sub(None, 1.)
        tables['pb2s2'] = quad_sub(S2, 2. / 3.)
        tables['pbs22'] = quad_sub(S2 ** 2, 4. / 9.)
        # P13 via the recursion-generated radial kernels
        for ab in ('dd', 'dt', 'tt'):
            tables['p13_' + ab] = pref * pk_k * (pk_q @ (c['K13_' + ab] * wr2))
        # third-order bias (b3nl sigma_3^2 P_lin) term: the same radial form
        tables['p_sig3sq'] = pref * pk_k * (pk_q @ (c['Ksig3'] * wr2))
        tables['sigma_v2'] = (pk_fn(c['qs']) @ c['wq']) / (6. * np.pi ** 2)
        return tables
