"""mu-quadrature and multipole projection.

Counterpart of ``desilike_tpu/ops/legendre.py``: the quadrature and the
projection weights are host-side float64 numpy; the projection is one
batched contraction on the device.
"""

import numpy as np
import torch


def legendre(ell, x):
    """Legendre polynomial P_ell(x) by the stable recurrence, on the tensor x
    (an array or a number is taken as a tensor), differentiable."""
    x = torch.as_tensor(x)
    if ell == 0:
        return torch.ones_like(x)
    if ell == 1:
        return x
    p0, p1 = torch.ones_like(x), x
    for n in range(1, ell):
        p0, p1 = p1, ((2 * n + 1) * x * p1 - n * p0) / (n + 1)
    return p1


def weights_mu(mu=20, method='leggauss'):
    """Return (mu nodes, weights) for integration over mu in [0, 1].

    method='leggauss': Gauss-Legendre; 'trapz': trapezoidal on a uniform grid.
    """
    if np.ndim(mu) == 1:
        mu = np.asarray(mu, dtype='f8')
        return mu, trapz_weights(mu)
    nmu = int(mu)
    if method == 'leggauss':
        x, w = np.polynomial.legendre.leggauss(nmu)
        mu = (x + 1.) / 2.
        w = w / 2.
    elif method == 'trapz':
        mu = np.linspace(0., 1., nmu)
        w = trapz_weights(mu)
    else:
        raise ValueError('unknown mu-integration method {}'.format(method))
    return mu, w


def trapz_weights(x):
    """Trapezoidal integration weights for an arbitrary 1D grid (host-side)."""
    x = np.asarray(x, dtype='f8')
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2.
    w[1:] += dx / 2.
    return w


def multipole_weights(ells, mu, wmu):
    """(nell, nmu) projection weights: wmu * (2l+1) * P_l(mu), so that for
    pkmu symmetric in mu, P_l(k) = (2l+1) int_0^1 dmu P(k, mu) L_l(mu)."""
    mu = np.asarray(mu, dtype='f8')
    wmu = np.asarray(wmu, dtype='f8')
    from numpy.polynomial import legendre as npleg
    rows = []
    for ell in ells:
        c = np.zeros(ell + 1)
        c[ell] = 1.
        rows.append(wmu * (2 * ell + 1) * npleg.legval(mu, c))
    return np.array(rows)


def to_poles(pkmu, weights):
    """Project pkmu (..., nk, nmu) onto multipoles -> (..., nell, nk).

    weights: (nell, nmu) from :func:`multipole_weights` (array or tensor).
    """
    weights = torch.as_tensor(weights, dtype=pkmu.dtype, device=pkmu.device)
    return torch.einsum('...km,lm->...lk', pkmu, weights)
