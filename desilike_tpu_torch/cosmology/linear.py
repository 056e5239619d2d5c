"""Linear power spectrum in torch, for one cosmology or a batch of chains.

Counterpart of ``desilike_tpu/cosmology/linear.py``: the primordial
spectrum, pk_lin from the EH98 transfer, sigma_r by a static quadrature,
the wiggle/no-wiggle split (one product with a static smoothing matrix),
and the injected-table engine (:func:`pk_lin_table`). Parameters and grids
as in :mod:`.background`: a host dict of numbers returns float64 numpy, a
dict of ``(B,)`` tensors returns ``(B, nk)`` tensors.
"""

import numpy as np
import torch

from . import background as bg
from . import eh
from .background import host, as_grid, over


KPIVOT_MPC = 0.05  # primordial pivot, 1/Mpc


@host
def primordial_curvature(p, k):
    """Dimensionless curvature power
    Delta_R^2(k) = A_s (k/kp)^(n_s - 1 + alpha_s/2 ln(k/kp)); k in h/Mpc."""
    k = as_grid(k, p)
    kp = over(KPIVOT_MPC / p['h'], k)
    lnkr = torch.log(k / kp)
    tilt = over(p['n_s'] - 1., k) + 0.5 * over(p.get('alpha_s', 0.), k) * lnkr
    return over(p['A_s'], k) * torch.exp(tilt * lnkr)


@host
def pk_lin(p, k, z=0., nowiggle=False):
    """Linear matter power spectrum P(k, z) in (Mpc/h)^3:
    P(k,z) = (8 pi^2 / 25) A_s (k/kp)^{ns-1} k T^2(k) D^2(z) / (Om^2 (H0/c)^4);
    ``z`` static."""
    k = as_grid(k, p)
    T = eh.transfer_nowiggle(p, k) if nowiggle else eh.transfer(p, k)
    D = bg.growth_factor(p, z, normalize='md')
    om = bg.Omega_m(p)
    h0_c = 1. / bg.DH_100  # h/Mpc
    amp = (8. * np.pi ** 2 / 25.) * primordial_curvature(p, k) / over(om ** 2 * h0_c ** 4, k)
    return amp * k * T ** 2 * over(D, k) ** 2


_SIGMA_K = np.geomspace(1e-5, 50., 1024)
_SIGMA_LNK_W = np.zeros_like(_SIGMA_K)
_SIGMA_LNK_W[:-1] += np.diff(np.log(_SIGMA_K)) / 2.
_SIGMA_LNK_W[1:] += np.diff(np.log(_SIGMA_K)) / 2.


def tophat_window(x):
    """Fourier transform of the spherical tophat: 3 (sin x - x cos x)/x^3 (a tensor)."""
    xs = torch.clamp(x, min=1e-3)
    w = 3. * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    return torch.where(x < 1e-3, 1. - x * x / 10., w)


@host
def sigma_r(p, r, z=0., pk_func=None):
    """sigma(R, z): rms of matter fluctuations in spheres of radius R Mpc/h;
    ``r`` a number or per chain; ``pk_func(k)`` in place of pk_lin."""
    k = as_grid(_SIGMA_K, p)
    pk = pk_lin(p, k, z) if pk_func is None else pk_func(k)
    w = tophat_window(k * over(r, k))
    integ = torch.sum(as_grid(_SIGMA_LNK_W, p) * k ** 3 * pk * w ** 2, dim=-1)
    return torch.sqrt(integ / (2. * np.pi ** 2))


@host
def sigma8(p, z=0.):
    return sigma_r(p, 8., z)


def smoothing_matrix(lnk, sigma=0.25):
    """Gaussian smoothing matrix over ln k (static, row-normalized)."""
    lnk = np.asarray(lnk, dtype='f8')
    d = lnk[:, None] - lnk[None, :]
    w = np.exp(-0.5 * (d / sigma) ** 2)
    w /= w.sum(axis=1, keepdims=True)
    return w


class NoWiggleFilter:
    """BAO wiggle/no-wiggle split: divide pk by the analytic EH98 no-wiggle
    shape, smooth the ratio in ln k with a fixed Gaussian kernel matrix, and
    multiply back. On tensors (per-chain tables, (B, nk)) the smoothing is
    one matrix product with the matrix on the tables' device."""

    def __init__(self, k, sigma=0.25):
        self.k = np.asarray(k, dtype='f8')
        self._smooth = smoothing_matrix(np.log(self.k), sigma=sigma)
        self._matrices = {}

    def __call__(self, pk, pk_nw_ref):
        """pk: (..., nk) wiggly spectrum; pk_nw_ref: (..., nk) smooth reference
        shape (any normalization). Returns pknow."""
        if isinstance(pk, torch.Tensor):
            key = (pk.dtype, pk.device)
            if key not in self._matrices:
                self._matrices[key] = torch.as_tensor(np.ascontiguousarray(self._smooth.T), dtype=pk.dtype,
                                                      device=pk.device)
            return (pk / pk_nw_ref) @ self._matrices[key] * pk_nw_ref
        ratio = np.asarray(pk, dtype='f8') / pk_nw_ref
        return np.einsum('ij,...j->...i', self._smooth, ratio) * pk_nw_ref


def interp(x, xp, fp):
    """``np.interp`` on tensors: x a tensor, xp (increasing) and fp tensors
    of the same length; clamped at the ends."""
    idx = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True) - 1, 0, xp.shape[-1] - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    t = torch.clamp((x - x0) / (x1 - x0), 0., 1.)
    return torch.lerp(fp[idx], fp[idx + 1], t)


@host
def pk_lin_table(p, p_fid, lnk_tab, lnpk_tab, k, z=0.):
    """Linear pk from an injected high-accuracy table, ratio-corrected:

        P(k, z; p) = P_tab(k) [D(z; p) / D(0; p_fid)]^2
                     Delta_R^2(k; p) / Delta_R^2(k; p_fid) [Om_m(p_fid) / Om_m(p)]^2
                     [T_eh(k; p) / T_eh(k; p_fid)]^2

    exact at p == p_fid, EH98 only in the response. ``p_fid`` as ``p``
    (the ``Cosmology`` node passes it as tensors on the evaluation's device,
    made once); lnk_tab, lnpk_tab: ln k (h/Mpc), ln P in (Mpc/h)^3 at z=0."""
    k = as_grid(k, p)
    p_fid = bg.tensors(p_fid, bg.ref(p))
    base = torch.exp(interp(torch.log(k), as_grid(lnk_tab, p), as_grid(lnpk_tab, p)))
    growth = bg.growth_factor(p, z, normalize='md') / bg.growth_factor(p_fid, 0., normalize='md')
    prim = primordial_curvature(p, k) / primordial_curvature(p_fid, k)
    om = bg.Omega_m(p_fid) / bg.Omega_m(p)
    t_ratio = eh.transfer(p, k) / eh.transfer(p_fid, k)
    return base * over(growth ** 2 * om ** 2, k) * prim * t_ratio ** 2


def table_nowiggle_amplitude(p_fid, lnk_tab, lnpk_tab):
    """Scalar matching the EH98 amplitude to an injected table (host): the
    no-wiggle companion of :func:`pk_lin_table` is alpha * pk_lin(p, k, z,
    nowiggle=True)."""
    k = np.exp(np.asarray(lnk_tab))
    sel = (k > 5e-3) & (k < 0.5)
    ln_eh = np.log(pk_lin(p_fid, k[sel], 0.))
    return float(np.exp(np.mean(np.asarray(lnpk_tab)[sel] - ln_eh)))
