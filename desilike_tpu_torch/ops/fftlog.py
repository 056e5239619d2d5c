"""FFTLog spherical-Bessel (Hankel) transforms: P(k) <-> xi(s).

Counterpart of ``desilike_tpu/ops/fftlog.py``. The Mellin kernel
coefficients u_m = U_l(q + i eta_m) depend only on the static log grid, the
multipole l and the bias q: they are computed once, host-side in float64
(``scipy.special.loggamma``), and cast to the evaluation's dtype and device
on first use. Per evaluation, batched over multipoles and any leading
(chain) dimensions: one ``torch.fft.rfft``, one product with the kernel,
one ``torch.fft.irfft``. The reference's ``irfft(conj(rfft(f) u))`` is
computed as ``irfft(rfft(f[-n mod N]) conj(u))``: for a real f the two are
equal. The index reversal is taken as a flip and a circular shift, the
shift folded into the kernel, so a caller with static matrices folds the
flip into them, and may leave out a zero tail of f
(:meth:`SphericalBesselTransform.transform_flipped`): no conjugate is taken
per evaluation, and autograd, forward mode and double backward meet a
product with a constant between two FFTs.

Math (Hamilton 2000 / mcfit conventions):
  G(y) = int_0^inf F(x) j_l(x y) dx / x  on log-uniform grids;
  with F(x) = x^q sum_m c_m (x/x_0)^{i eta_m}, eta_m = 2 pi m / (N delta),
  G(y_j) = y_j^{-q} Re DFT^{-1}[ c_m U_l(q + i eta_m) (x_0 y_0)^{-i eta_m} ]
  where U_l(z) = 2^{z-2} sqrt(pi) Gamma((l+z)/2) / Gamma((3+l-z)/2).
"""

import numpy as np
import torch
from scipy.special import loggamma


def _on_device(cache, arrays, dtype, device):
    """Host float64 ``arrays`` as tensors of ``dtype`` on ``device``, cast
    once and kept in ``cache``."""
    key = (dtype, device)
    if key not in cache:
        cache[key] = tuple(torch.as_tensor(np.ascontiguousarray(array), dtype=dtype, device=device)
                           for array in arrays)
    return cache[key]


def _u_ell(ell, z):
    """Mellin transform of j_ell: int_0^inf t^{z-1} j_ell(t) dt (complex z)."""
    return np.exp((z - 2.) * np.log(2.) + 0.5 * np.log(np.pi)
                  + loggamma((ell + z) / 2.) - loggamma((3. + ell - z) / 2.))


class SphericalBesselTransform:
    r"""Batched FFTLog transform G_l(y) = \int_0^inf F(x) j_l(xy) dx/x.

    Parameters
    ----------
    x : array (n,)
        Log-uniform input grid (static).
    ells : tuple of int
        Multipole orders (one output row per ell).
    q : float, default=1.5
        Bias exponent; 1.5 is a good default for P(k) ~ k^{n} inputs.
    lowring : bool, default=True
        Adjust the output grid offset so the Nyquist kernel coefficient is
        real, minimizing ringing.
    """

    def __init__(self, x, ells=(0,), q=1.5, lowring=True):
        x = np.asarray(x, dtype='f8')
        n = x.size
        delta = np.log(x[-1] / x[0]) / (n - 1)
        if not np.allclose(np.diff(np.log(x)), delta, rtol=1e-6):
            raise ValueError('fftlog requires a log-uniform grid')
        self.x = x
        self.ells = tuple(int(ell) for ell in ells)
        self.q = float(q)
        self.n = n
        eta = 2. * np.pi * np.arange(n // 2 + 1) / (n * delta)
        ys, kernels = [], []
        for ell in self.ells:
            # lowring: choose ln(x_0 y_0) so that the Nyquist-mode kernel phase vanishes (mod pi)
            lnxy = 0.
            if lowring and n % 2 == 0:
                lnxy = delta / np.pi * np.angle(_u_ell(ell, self.q + 1j * np.pi / delta))
            # the output grid mirrors the input one: y_0 = e^{lnxy} / (x_0 e^{(n-1) delta})
            y0 = np.exp(lnxy) / (x[0] * np.exp((n - 1) * delta))
            ys.append(y0 * np.exp(np.arange(n) * delta))
            u = _u_ell(ell, self.q + 1j * eta) * np.exp(-1j * eta * np.log(x[0] * y0))
            if n % 2 == 0:
                u[-1] = u[-1].real  # hermitian consistency at Nyquist
            kernels.append(u)
        self.y = np.array(ys)                  # (nell, n)
        self._kernels = np.array(kernels)      # (nell, n//2+1) complex
        self._xq = x ** (-self.q)              # (n,)
        self._yq = self.y ** (-self.q)         # (nell, n)
        self._tensors = {}

    def _device_tensors(self, dtype, device):
        """x^-q and y^-q on the device."""
        return _on_device(self._tensors, (self._xq, self._yq), dtype, device)

    def _flipped_kernel(self, m, dtype, device):
        """conj(u_k) exp(2 pi i k (m - 1) / n) / n on the device (the inverse
        FFT's 1/n folded in): for f zero from its m-th sample on, the rfft of
        f[-p mod n] is exp(2 pi i k (m - 1) / n) times that of f[:m] flipped
        and zero-padded to n."""
        key = (m, dtype, device)
        if key not in self._tensors:
            shift = np.exp(2j * np.pi * np.arange(self.n // 2 + 1) * (m - 1) / self.n)
            self._tensors[key] = torch.as_tensor(np.conj(self._kernels) * shift / self.n,
                                                 dtype=dtype.to_complex(), device=device)
        return self._tensors[key]

    def transform_flipped(self, g):
        """:meth:`transform` of f given as g = f[..., :m].flip(-1), where f
        is zero from its m-th sample on (m = g.shape[-1] <= n)."""
        kernel = self._flipped_kernel(g.shape[-1], g.dtype, g.device)
        return torch.fft.irfft(torch.fft.rfft(g, n=self.n, dim=-1) * kernel, n=self.n, dim=-1, norm='forward')

    def transform(self, f):
        """The bare transform of f (..., nell, n), already multiplied by
        x^-q; returns (..., nell, n), still to multiply by y^-q: the part of
        :meth:`__call__` that is not a static factor."""
        return self.transform_flipped(f.flip(-1))

    def __call__(self, f):
        """Transform F sampled on x.

        Parameters
        ----------
        f : tensor (..., nell, n) or (n,)
            One input row per ell (broadcast if 1D).

        Returns
        -------
        y : (nell, n) output grids, one per ell (numpy)
        g : tensor (..., nell, n)
        """
        if f.ndim == 1:
            f = f.expand((len(self.ells),) + tuple(f.shape))
        xq, yq = self._device_tensors(f.dtype, f.device)
        return self.y, self.transform(f * xq) * yq


class PowerToCorrelation:
    r"""xi_l(s) = i^l / (2 pi^2) \int dk k^2 P_l(k) j_l(ks).

    Call with P_l sampled on the log-uniform k grid; returns (s, xi) with s
    ascending, one row per ell. :attr:`pre` and :attr:`post` are the static
    factors around the bare transform: xi = post * _sbt.transform(pre * pk).
    """

    def __init__(self, k, ells=(0, 2, 4), q=0, lowring=True):
        # transform of F(x) = x^3 P(x) / (2 pi^2), kernel j_l, measure dx/x; q biases the
        # internal decomposition: effective exponent 1.5 - q
        self.ells = tuple(int(ell) for ell in ells)
        self._sbt = SphericalBesselTransform(k, ells=self.ells, q=1.5 - q, lowring=lowring)
        self.k = self._sbt.x
        self.s = self._sbt.y
        signs = np.array([(-1.) ** (ell // 2) for ell in self.ells])
        self.pre = self.k ** 3 / (2. * np.pi ** 2) * self._sbt._xq        # (n,)
        self.post = self._sbt._yq * signs[:, None]                        # (nell, n)
        self._tensors = {}

    def __call__(self, pk):
        """pk: (..., nell, nk) or (nk,) -> (s (nell, ns), xi (..., nell, ns))."""
        if pk.ndim == 1:
            pk = pk.expand((len(self.ells),) + tuple(pk.shape))
        pre, post = _on_device(self._tensors, (self.pre, self.post), pk.dtype, pk.device)
        return self.s, self._sbt.transform(pk * pre) * post


class CorrelationToPower:
    r"""P_l(k) = 4 pi (-i)^l \int ds s^2 xi_l(s) j_l(ks)."""

    def __init__(self, s, ells=(0, 2, 4), q=0, lowring=True):
        self.ells = tuple(int(ell) for ell in ells)
        self._sbt = SphericalBesselTransform(s, ells=self.ells, q=1.5 - q, lowring=lowring)
        self.s = self._sbt.x
        self.k = self._sbt.y
        signs = np.array([(-1.) ** (ell // 2) for ell in self.ells])
        self.pre = self.s ** 3 * (4. * np.pi) * self._sbt._xq              # (n,)
        self.post = self._sbt._yq * signs[:, None]                        # (nell, n)
        self._tensors = {}

    def __call__(self, xi):
        """xi: (..., nell, ns) or (ns,) -> (k (nell, nk), pk (..., nell, nk))."""
        if xi.ndim == 1:
            xi = xi.expand((len(self.ells),) + tuple(xi.shape))
        pre, post = _on_device(self._tensors, (self.pre, self.post), xi.dtype, xi.device)
        return self.k, self._sbt.transform(xi * pre) * post
