"""1D interpolation on tensors, batched and differentiable.

Counterpart of ``desilike_tpu/ops/interp.py``. The cubic method is the
same local C1 cubic Hermite with non-uniform centered-difference slopes
(no global spline solve: each query is a few gathers and fused
arithmetic); the interval of each query comes from ``torch.searchsorted``.
Arrays and numbers take the dtype and device of the tensor arguments (y
first), so a static float64 numpy table serves float32 queries on the card.
"""

import numpy as np
import torch


def _hermite_slopes(x, y):
    """Centered-difference slopes on a non-uniform grid; one-sided at ends.

    x: (n,), y: (..., n). Returns (..., n).
    """
    dx = x[1:] - x[:-1]                      # (n-1,)
    d = (y[..., 1:] - y[..., :-1]) / dx      # secants, (..., n-1)
    # interior: the weighted average that is exact for quadratics
    w_lo = dx[1:] / (dx[:-1] + dx[1:])
    m_int = w_lo * d[..., :-1] + (1. - w_lo) * d[..., 1:]
    return torch.cat([d[..., :1], m_int, d[..., -1:]], dim=-1)


def _tensors(*values):
    """``values`` as tensors; those that are not tensors take the dtype and
    device of the first floating tensor among them."""
    ref = next((v for v in values if isinstance(v, torch.Tensor) and v.is_floating_point()), None)
    kwargs = {} if ref is None else dict(dtype=ref.dtype, device=ref.device)
    return [v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v), **kwargs) for v in values]


def interp1d(xq, x, y, method='cubic', extrap='clip'):
    """Interpolate y(x) at the query points xq.

    Parameters
    ----------
    xq : tensor, any shape
        Query points.
    x : tensor (n,)
        Sample points, strictly increasing.
    y : tensor (..., n)
        Values, interpolated along the last axis; the leading axes are kept
        (output shape: y.shape[:-1] + xq.shape).
    method : 'linear' or 'cubic'
    extrap : 'clip' clamps the queries to [x_0, x_n]; anything else
        extends the edge intervals' polynomials.

    Returns
    -------
    tensor of shape y.shape[:-1] + xq.shape, differentiable in y and xq.
    """
    y, xq, x = _tensors(y, xq, x)
    dtype = torch.promote_types(y.dtype, xq.dtype)
    xq = xq.to(dtype)
    x = x.to(dtype=dtype, device=xq.device).contiguous()
    qshape = xq.shape
    xqf = xq.reshape(-1)
    if extrap == 'clip':
        xqf = torch.clamp(xqf, x[0], x[-1])
    n = x.shape[0]
    i = torch.clamp(torch.searchsorted(x, xqf.detach(), right=True) - 1, 0, n - 2)
    x0, x1 = x[i], x[i + 1]
    h = x1 - x0
    t = (xqf - x0) / h
    y0, y1 = y[..., i], y[..., i + 1]
    if method == 'linear':
        out = y0 + (y1 - y0) * t
    elif method == 'cubic':
        m = _hermite_slopes(x, y)
        m0, m1 = m[..., i] * h, m[..., i + 1] * h
        t2 = t * t
        t3 = t2 * t
        out = ((2 * t3 - 3 * t2 + 1) * y0 + (t3 - 2 * t2 + t) * m0
               + (-2 * t3 + 3 * t2) * y1 + (t3 - t2) * m1)
    else:
        raise ValueError('unknown method {}'.format(method))
    return out.reshape(y.shape[:-1] + qshape)


def loglog_interp(kq, k, pk, method='cubic'):
    """Interpolate a power spectrum against log10 k: pk itself (not log pk,
    which fails for a spectrum that changes sign) at log10 kq."""
    pk, kq, k = _tensors(pk, kq, k)
    return interp1d(torch.log10(kq), torch.log10(k), pk, method=method)


class Interpolator1D(object):
    """Interpolator of a table (x, y) fixed at initialization, kept in
    float64 numpy; a call takes the dtype and device of its query tensor."""

    def __init__(self, x, y, method='cubic', extrap='clip'):
        self.x = np.asarray(x, dtype='f8')
        self.y = np.asarray(y, dtype='f8')
        self.method = method
        self.extrap = extrap

    def __call__(self, xq):
        return interp1d(xq, self.x, self.y, method=self.method, extrap=self.extrap)
