"""Chebyshev spectral tables: the template's pk lookups at AP-remapped k.

Counterpart of ``desilike_tpu/ops/chebyshev.py`` (``ChebyshevLogInterp``).
A smooth-plus-oscillatory table y(k) is represented by a Chebyshev series
in normalized ln k. The fit (table grid -> cubic node values -> ln ->
static DCT matrix) runs host-side in float64 numpy for fiducial tables,
once at initialization, and as two ``torch.matmul`` on the evaluation's
device for tables that change with the chain (ShapeFit), differentiable.
Queries are evaluated by the Clenshaw recurrence through
:func:`desilike_tpu_torch.ops.cuda_kernels.clenshaw` (the hand-written
kernel on the card, the plain recurrence on the CPU). Fixed evaluation
points (the 1-loop integrands' grids) take the static design matrix
instead: ``evaluation_matrix`` builds T_j(x(k)) host-side in float64 and
``evaluate_static`` is one ``torch.matmul`` on the device.
"""

import numpy as np
import torch

from .cuda_kernels import clenshaw


def _static_cubic_interp_matrix(xq, x):
    """(nq, nx) matrix: cubic Hermite interpolation weights from samples at x
    to query points xq (host-side float64; both static)."""
    x = np.asarray(x, dtype='f8')
    xq = np.asarray(xq, dtype='f8')
    nx = x.size
    M = np.zeros((xq.size, nx))
    # slopes as linear operator: m = D @ y
    D = np.zeros((nx, nx))
    dx = np.diff(x)
    D[0, 0], D[0, 1] = -1. / dx[0], 1. / dx[0]
    D[-1, -2], D[-1, -1] = -1. / dx[-1], 1. / dx[-1]
    for i in range(1, nx - 1):
        w_lo = dx[i] / (dx[i - 1] + dx[i])
        # m_i = w_lo * d_{i-1} + (1-w_lo) * d_i
        D[i, i - 1] += -w_lo / dx[i - 1]
        D[i, i] += w_lo / dx[i - 1]
        D[i, i] += -(1 - w_lo) / dx[i]
        D[i, i + 1] += (1 - w_lo) / dx[i]
    idx = np.clip(np.searchsorted(x, xq, side='right') - 1, 0, nx - 2)
    xc = np.clip(xq, x[0], x[-1])
    h = x[idx + 1] - x[idx]
    t = (xc - x[idx]) / h
    h00 = 2 * t ** 3 - 3 * t ** 2 + 1
    h10 = t ** 3 - 2 * t ** 2 + t
    h01 = -2 * t ** 3 + 3 * t ** 2
    h11 = t ** 3 - t ** 2
    for q in range(xq.size):
        i = idx[q]
        M[q, i] += h00[q]
        M[q, i + 1] += h01[q]
        M[q] += (h10[q] * h[q]) * D[i]
        M[q] += (h11[q] * h[q]) * D[i + 1]
    return M


class ChebyshevLogInterp:
    """Chebyshev representation of a positive table y(k) on a static k grid.

    Parameters
    ----------
    k : array (nk,)
        Static table grid (the template's k).
    order : int or None
        Series order; default scales with the number of BAO periods in range.
    log_values : bool
        Fit ln(y) (requires y > 0); evaluation returns exp(series).
    """

    def __init__(self, k, order=None, log_values=True):
        k = np.asarray(k, dtype='f8')
        self.lo, self.hi = np.log(k[0]), np.log(k[-1])
        if order is None:
            periods = (k[-1] - k[0]) / 0.0633  # BAO wavelength 2 pi / rd
            order = int(min(320, max(96, 60 + 9 * periods)))
        self.order = int(order)
        self.log_values = bool(log_values)
        theta = (np.arange(self.order) + 0.5) * np.pi / self.order
        xc = np.cos(theta)[::-1]
        lnk_nodes = (xc + 1.) / 2. * (self.hi - self.lo) + self.lo
        # static: table grid -> node values (cubic), then values -> coefficients
        self._A = _static_cubic_interp_matrix(lnk_nodes, np.log(k))    # (order, nk)
        C = 2. / self.order * np.cos(np.outer(np.arange(self.order), theta[::-1]))
        C[0] /= 2.
        self._C = C
        self._matrices = {}

    def coeffs(self, values):
        """values (..., nk) on the table grid -> coefficients (..., order).

        A numpy array is fitted host-side in float64. A tensor (per-chain
        tables, (B, nk)) is fitted in its own dtype on its own device by two
        matrix products, and the fit is differentiable."""
        if isinstance(values, torch.Tensor):
            key = (values.dtype, values.device)
            if key not in self._matrices:  # transposed once: (nk, order) and (order, order)
                self._matrices[key] = tuple(torch.as_tensor(np.ascontiguousarray(m.T), dtype=key[0], device=key[1])
                                            for m in (self._A, self._C))
            At, Ct = self._matrices[key]
            nodes = values @ At
            if self.log_values:
                nodes = torch.log(nodes)
            return nodes @ Ct
        nodes = np.einsum('on,...n->...o', self._A, np.asarray(values, dtype='f8'))
        if self.log_values:
            nodes = np.log(nodes)
        return np.einsum('co,...o->...c', self._C, nodes)

    def evaluate(self, coeffs, k):
        """coeffs (order,) or (B, order) tensor, k tensor -> y(k), shape of k.

        x = normalized ln k, clamped to [-1, 1], is passed to the kernel as
        (rows, Q): k's leading dimension is the row dimension (the chain
        batch for (B, nk, nmu) queries), one row for a 1D k; per-row
        coefficients need as many rows.
        """
        lnk = torch.log(k)
        x = torch.clamp((lnk - self.lo) / (self.hi - self.lo) * 2. - 1., -1., 1.)
        if coeffs.ndim == 2:
            if x.ndim < 2 or x.shape[0] != coeffs.shape[0]:
                raise ValueError('per-row coefficients {} need k with as many rows, got {}'.format(
                    tuple(coeffs.shape), tuple(x.shape)))
            x2 = x.reshape(coeffs.shape[0], -1)
        else:
            x2 = x.reshape(x.shape[0], -1) if x.ndim > 1 else x.reshape(1, -1)
        return clenshaw(x2.contiguous(), coeffs, self.log_values).reshape(x.shape)

    def static_x(self, k):
        """Normalized ln k of fixed points k, clamped to [-1, 1], flattened
        (host-side float64 numpy): the queries of :meth:`evaluate_shared`."""
        lnk = np.log(np.asarray(k, dtype='f8')).ravel()
        return np.clip((lnk - self.lo) / (self.hi - self.lo) * 2. - 1., -1., 1.)

    def evaluate_shared(self, coeffs, x):
        """coeffs (order,) or (B, order), x (Q,) a tensor of :meth:`static_x`
        -> y (1, Q) or (B, Q): the kernel with one row of x read by every
        coefficient row (no (B, Q) copy of the fixed points)."""
        return clenshaw(x.reshape(1, -1), coeffs, self.log_values)

    def evaluation_matrix(self, k):
        """Static (npts, order) design matrix T_j(x(k)) for fixed evaluation
        points k (host-side float64 numpy), for :meth:`evaluate_static`."""
        theta = np.arccos(self.static_x(k))
        return np.cos(np.outer(theta, np.arange(self.order)))

    def evaluate_static(self, coeffs, matrix):
        """coeffs (..., order), matrix (npts, order), tensors of one dtype on
        one device, the matrix from :meth:`evaluation_matrix` (a calculator
        keeps it as a device constant, :meth:`Calculator.const`) -> y (...,
        npts) at the matrix's points: one matrix product, exp'd if
        ``log_values``."""
        out = torch.matmul(coeffs, matrix.mT)
        if self.log_values:
            out = torch.exp(out)
        return out
