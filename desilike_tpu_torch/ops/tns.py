"""TNS (Taruya-Nishimichi-Saito 2010) RSD correction terms A and B.

Counterpart of ``desilike_tpu/ops/tns.py``: arXiv:1006.0699 eqs. A3 (A
term) and A4 / the B kernels (B term), on a static (nk, nq, nmu) grid of
(k, q, mu), and the third-order-bias sigma3^2 table.

The host part (float64 numpy, once at initialization) is a copy of the JAX
package's: the five 1D radial a-kernels of the A term in closed form, with
their small- and large-x series derived at import time by exact
``Fraction`` arithmetic. Beyond that, every static factor is folded into
static kernels, built in float64 and cast once:

- K1_m = w_mu j_q kA_m / (x^2 y2^2) and K2_m = w_mu j_q ktA_m / (x^2 y2^2)
  (A term, m < 5), K3_j = w_mu j_q kB_j / (x^2 y2) (B term, j < 12), each
  times the mask of |k - q| inside the template's range, stacked as one
  (nk, nq nmu, 22) array;
- the 1D a-term and the sigma3^2 kernel over q, one (nq, 6 nk) matrix.

Per evaluation the linear pk enters through U = pk(|k - q|) on the
(nk, nq, nmu) grid (one Chebyshev lookup of the template, the Clenshaw
kernel with one row of x shared by every chain), pk(q) and pk(k); with
V = U pk(q):

    A_m = pk(k) (<U, K1_m> + pk(q) . a_m) + <V, K2_m>,   B_j = <V, K3_j>,
    sigma3^2 = pk(q) . s3,

where <., .> sums over (q, mu) for each k: one batched product of U, and
one of V, with the static kernels. At most two (B, nk nq nmu) tensors are
alive.
"""

from fractions import Fraction

import numpy as np
import torch


# --------------------------------------------------------------------------
# A-term 1D radial kernels (Taruya, Nishimichi & Saito 2010, arXiv:1006.0699
# eq. A3). Each has the closed form
#
#     a_m(x) = c_m x^{-p_m} [ 2 x D_m(x^2) + G_m(x^2) log|(x+1)/(x-1)| ]
#
# which suffers catastrophic cancellation between the rational and the log
# pieces as x -> 0 and x -> inf. The patches are derived at import time by
# exact Fraction arithmetic from the same (c, p, D, G) data: substitute the
# series log|(x+1)/(x-1)| = 2 sum_j t^{2j+1}/(2j+1) with t = x (inner
# branch) or t = 1/x (outer branch), expand, and check that all singular
# powers cancel identically.

def _poly_mul(a, b):
    out = {}
    for da, ca in a.items():
        for db, cb in b.items():
            out[da + db] = out.get(da + db, Fraction(0)) + ca * cb
    return out


def _u_poly(coeffs):
    """Polynomial in u = x^2, given ascending coefficients -> poly in x."""
    return {2 * i: Fraction(c) for i, c in enumerate(coeffs)}


def _u_poly_pow(coeffs, n):
    out = {0: Fraction(1)}
    base = _u_poly(coeffs)
    for _ in range(n):
        out = _poly_mul(out, base)
    return out


# (prefactor, inverse power p, D_m coefficients in u, G_m as poly in x)
_A_KERNEL_FORMS = (
    (Fraction(-1, 84), 1, (19, -24, 9), _poly_mul(_u_poly([-9]), _u_poly_pow((-1, 1), 3))),
    (Fraction(1, 112), 3, (3, -11, -11, 3), _poly_mul(_u_poly([-3]), _u_poly_pow((-1, 1), 4))),
    (Fraction(1, 336), 3, (9, -185, 159, -63), _poly_mul(_u_poly([9, 63]), _u_poly_pow((-1, 1), 3))),
    None,  # m=3 is identical to m=1
    (Fraction(1, 336), 3, (9, -109, 63, -27), _poly_mul(_u_poly([9, 27]), _u_poly_pow((-1, 1), 3))),
)


def _expand_a_kernel(c, p, D, G, branch, order=8):
    """Exact series of a_m around x=0 (branch=+1) or x=inf (branch=-1),
    as {power-of-x: float} with |power| <= order. Raises if any power that
    should cancel survives — a structural check on the closed forms."""
    # log|(x+1)/(x-1)| = 2 sum_{j>=0} t^(2j+1)/(2j+1), t = x or 1/x
    max_deg = max(G) + p + order + 2
    log_series = {branch * (2 * j + 1): Fraction(2, 2 * j + 1)
                  for j in range(max_deg // 2 + 1)}
    series = _poly_mul(G, log_series)
    direct = _poly_mul({1: Fraction(2)}, _u_poly(D))
    for deg, coeff in direct.items():
        series[deg] = series.get(deg, Fraction(0)) + coeff
    out = {}
    for deg, coeff in series.items():
        deg, coeff = deg - p, c * coeff
        if coeff == 0:
            continue
        if branch * deg > order:
            continue  # truncation tail
        if branch * deg < 0:
            raise AssertionError('singular x^{} survives in A-kernel series'.format(deg))
        out[deg] = float(coeff)
    return out


def _build_a_patches(order=8):
    inner, outer = [], []
    for form in _A_KERNEL_FORMS:
        if form is None:
            inner.append(None)
            outer.append(None)
            continue
        c, p, D, G = form
        inner.append(_expand_a_kernel(c, p, D, G, +1, order))
        outer.append(_expand_a_kernel(c, p, D, G, -1, order))
    return inner, outer


_A_PATCH_INNER, _A_PATCH_OUTER = _build_a_patches()


def _eval_patch(patch, x):
    out = np.zeros_like(x)
    for deg, coeff in patch.items():
        out += coeff * x ** deg
    return out


def a_correction_kernels(x, x_lo=0.05, x_hi=20.):
    """The five 1D radial kernels of the A-term correction
    (Taruya 2010 eq. A3, second piece ~ P(k) int dq kernel(q/k) P(q)).
    float64 numpy, static; the x^-2 jacobian factor is included.

    Outside [x_lo, x_hi] the closed form is replaced by the import-time
    series (see _expand_a_kernel): the rational and log pieces cancel like
    x^{2} relative (x^{-2} outer) against terms growing like x^{-p}, so the
    closed form is noise-dominated well before the kernels' small-x zeros —
    the cutoffs sit where both representations agree to ~1e-12 absolute.
    At x = 1 the log coefficient G_m has a (x^2-1)^3 zero, so masking the
    log there yields the exact limit 2 c_m D_m(1) — no bridging needed.

    Returns (5, *x.shape).
    """
    x = np.asarray(x, dtype='f8')
    with np.errstate(divide='ignore', invalid='ignore'):
        L = np.log(np.abs((x + 1.) / (x - 1.)))
    L = np.where(np.isfinite(L), L, 0.)
    lo, hi = x < x_lo, x > x_hi
    out = np.zeros((5,) + x.shape)
    for m, form in enumerate(_A_KERNEL_FORMS):
        if form is None:
            out[m] = out[1]
            continue
        c, p, D, G = form
        poly_d = sum(2. * float(d) * x ** (2 * i + 1) for i, d in enumerate(D))
        poly_g = sum(float(coeff) * x ** deg for deg, coeff in sorted(G.items()))
        with np.errstate(divide='ignore', invalid='ignore'):
            exact = float(c) * (poly_d + poly_g * L) / x ** p
        out[m] = np.where(lo, _eval_patch(_A_PATCH_INNER[m], x),
                          np.where(hi, _eval_patch(_A_PATCH_OUTER[m], x), exact))
    return out / x ** 2


def _static_kernels(x, mu, wmu, jq, y2):
    """The 22 (q, mu) kernels of the A and B terms on the (nk, nq, nmu) grid
    (float64 numpy): K1 (5), K2 (5), K3 (12), with the quadrature weights
    w_mu j_q and the 1/(x^2 y2^2) or 1/(x^2 y2) factors folded in.
    Returns (22, nk, nq, nmu)."""
    mu2 = mu * mu
    kA = [
        -x ** 3 / 7. * (mu + 6. * mu ** 3 + x ** 2 * mu * (-3. + 10. * mu2) + x * (-3. + mu2 - 12. * mu2 ** 2)),
        x ** 4 / 14. * (mu2 - 1.) * (-1. + 7. * x * mu - 6. * mu2),
        x ** 3 / 14. * (x ** 2 * mu * (13. - 41. * mu2) - 4. * (mu + 6. * mu ** 3) + x * (5. + 9. * mu2 + 42. * mu2 ** 2)),
        None,  # = kA[1]
        x ** 3 / 14. * (1. - 7. * x * mu + 6. * mu2) * (-2. * mu + x * (-1. + 3. * mu2)),
    ]
    kA[3] = kA[1]
    ktA = [
        1. / 7. * (mu + x - 2. * x * mu2) * (3. * x + 7. * mu - 10. * x * mu2),
        x / 14. * (mu2 - 1.) * (3. * x + 7. * mu - 10. * x * mu2),
        1. / 14. * (28. * mu2 + x * mu * (25. - 81. * mu2) + x ** 2 * (1. - 27. * mu2 + 54. * mu2 ** 2)),
        x / 14. * (1. - mu2) * (x - 7. * mu + 6. * x * mu2),
        1. / 14. * (x - 7. * mu + 6. * x * mu2) * (-2. * mu - x + 3. * x * mu2),
    ]
    xmu_ = y2
    m2m1 = mu2 - 1.
    kB = [
        x ** 2 * m2m1 / 2.,
        3. * x ** 2 * m2m1 ** 2 / 8.,
        3. * x ** 4 * m2m1 ** 2 / xmu_ / 8.,
        5. * x ** 4 * m2m1 ** 3 / xmu_ / 16.,
        x * (x + 2. * mu - 3. * x * mu2) / 2.,
        -3. * x * m2m1 * (-x - 2. * mu + 5. * x * mu2) / 4.,
        3. * x ** 2 * m2m1 * (-2. + x ** 2 + 6. * x * mu - 5. * x ** 2 * mu2) / xmu_ / 4.,
        -3. * x ** 2 * m2m1 ** 2 * (6. - 5. * x ** 2 - 30. * x * mu + 35. * x ** 2 * mu2) / xmu_ / 16.,
        x * (4. * mu * (3. - 5. * mu2) + x * (3. - 30. * mu2 + 35. * mu2 ** 2)) / 8.,
        x * (-8. * mu + x * (-12. + 36. * mu2 + 12. * x * mu * (3. - 5. * mu2) + x ** 2 * (3. - 30. * mu2 + 35. * mu2 ** 2))) / xmu_ / 8.,
        3. * x * m2m1 * (-8. * mu + x * (-12. + 60. * mu2 + 20. * x * mu * (3. - 7. * mu2) + 5. * x ** 2 * (1. - 14. * mu2 + 21. * mu2 ** 2))) / xmu_ / 16.,
        x * (8. * mu * (-3. + 5. * mu2) - 6. * x * (3. - 30. * mu2 + 35. * mu2 ** 2) + 6. * x ** 2 * mu * (15. - 70. * mu2 + 63. * mu2 ** 2) + x ** 3 * (5. - 21. * mu2 * (5. - 15. * mu2 + 11. * mu2 ** 2))) / xmu_ / 16.,
    ]
    weight = wmu * jq[None, :, None] / x ** 2
    shape = np.broadcast_shapes(x.shape, mu.shape)
    kernels = [weight * ka / y2 ** 2 for ka in kA] + [weight * kta / y2 ** 2 for kta in ktA] \
        + [weight * kb / y2 for kb in kB]
    return np.stack([np.broadcast_to(kernel, shape) for kernel in kernels])


class TNSCorrections:
    """A (5 components) and B (12 components) correction k-tables, plus the
    third-order-bias sigma3^2 table, over a chain batch.

    Parameters
    ----------
    k : (nk,) the working grid.
    qrange, nq : the q grid, geomspace, trapezoid in ln q.
    nmu : Gauss-Legendre nodes in mu.
    prange : (lo, hi), the range outside which the linear pk is zero (the
        template table's): its mask is folded into the static kernels.

    The linear pk is needed at :attr:`y` (the (nk, nq, nmu) grid of |k - q|,
    flattened), :attr:`q` and :attr:`k`; :meth:`tables` takes it there.
    """

    def __init__(self, k, qrange=(1e-4, 10.), nq=300, nmu=16, prange=(0., np.inf)):
        self.k = np.asarray(k, dtype='f8')
        q = np.geomspace(qrange[0], qrange[1], int(nq))
        self.q = q
        self.jq = q ** 3 * np.gradient(np.log(q)) / (4. * np.pi ** 2)   # q^2 dq -> q^3 dlnq
        xmu, wmu = np.polynomial.legendre.leggauss(int(nmu))
        self.mu, self.wmu = xmu, wmu
        lo, hi = prange
        self.mask_q = ((q > lo) & (q < hi)).astype('f8')
        x = (q[None, :] / self.k[:, None])[:, :, None]                 # (nk, nq, 1)
        mu = xmu[None, None, :]
        y2 = np.maximum(1. + x ** 2 - 2. * x * mu, 1e-12)             # |k-q|^2 / k^2
        self.y = (self.k[:, None, None] * np.sqrt(y2)).ravel()          # (nk nq nmu,)
        mask_y = ((self.y > lo) & (self.y < hi)).reshape(y2.shape)
        nk, nrest = len(self.k), q.size * xmu.size
        kernels = _static_kernels(x, mu, wmu, self.jq, y2) * mask_y     # (22, nk, nq, nmu)
        kernels[5:] *= self.mask_q[:, None]                             # V's pk(q) is masked too
        self.kernels = np.ascontiguousarray(np.moveaxis(kernels.reshape(22, nk, nrest), 0, -1))  # (nk, nq nmu, 22)
        # 1D pieces over q: the A term's a_m(q/k) j_q (its pk(q) mask folded in), then sigma3^2
        # 105/16 int jq pk(q) (D S + 8/63), D = 2/7 (mu^2-1), S = (q.(k-q))^2 / (q^2 |k-q|^2) - 1/3
        a_kern = a_correction_kernels(x[..., 0]) * self.jq                # (5, nk, nq)
        S = (mu - x) ** 2 / y2 - 1. / 3.
        D = 2. / 7. * (mu * mu - 1.)
        sig3 = 105. / 16. * np.sum(wmu * self.jq[None, :, None] * (D * S + 8. / 63.), axis=-1)  # (nk, nq)
        self.q_kernels = np.concatenate([a_kern.reshape(5 * nk, -1), sig3], axis=0).T * self.mask_q[:, None]

    def tables(self, pk_q, pk_k, pk_y, kernels, q_kernels):
        """The tables from the linear pk, with a leading chain batch (or
        none): ``pk_q`` (..., nq) at :attr:`q` (unmasked: the mask is
        folded in), ``pk_k`` (..., nk) at :attr:`k`, ``pk_y`` (..., nk nq
        nmu) at :attr:`y` (rows of one, for a pk shared by every chain,
        broadcast). ``kernels`` and ``q_kernels`` are :attr:`kernels` and
        :attr:`q_kernels` as tensors of pk's dtype and device, made once by
        the caller (a calculator's constants). Returns 'A' (..., 5, nk), 'B'
        (..., 12, nk) and 'sig3sq' (..., nk) (to be multiplied by pk(k)
        downstream)."""
        nk = len(self.k)
        lead = pk_q.shape[:-1]
        rows = pk_q.reshape(-1, pk_q.shape[-1])
        u = pk_y.reshape(-1, nk, self.q.size, self.mu.size)
        v = u * rows[:, None, :, None]                                  # U pk(q)
        # <., .> over (q, mu) for each k: batched over k, the chains as the rows
        uk = torch.bmm(u.reshape(u.shape[0], nk, -1).transpose(0, 1), kernels[..., :5])     # (nk, B, 5)
        vk = torch.bmm(v.reshape(v.shape[0], nk, -1).transpose(0, 1), kernels[..., 5:])     # (nk, B, 17)
        one_d = (rows @ q_kernels).reshape(rows.shape[0], 6, nk)        # a_m(q/k) (5), then sigma3^2
        pk_k = pk_k.reshape(-1, nk)
        A = pk_k[:, None, :] * (uk.permute(1, 2, 0) + one_d[:, :5]) + vk[..., :5].permute(1, 2, 0)
        B = vk[..., 5:].permute(1, 2, 0)
        return {'A': A.reshape(lead + A.shape[1:]), 'B': B.reshape(lead + B.shape[1:]),
                'sig3sq': one_d[:, 5].reshape(lead + (nk,))}
