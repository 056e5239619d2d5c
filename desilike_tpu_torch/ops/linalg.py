"""Linear-algebra helpers: whitening and checked Cholesky factorizations.

Counterpart of ``desilike_tpu/ops/linalg.py``. The unrolled small-matrix
Cholesky there (``chol_small``, ``chol_solve_small``, ``chol_logdet_small``)
was a TPU workaround for LAPACK custom calls under ``vmap``; here
``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve`` take its place,
batched over the chains, and a matrix that is not positive definite is
reported (``info``) or raises instead of being clipped.
"""

import numpy as np
import torch


def is_diagonal(matrix):
    """Whether the square ``matrix`` has nothing off its diagonal."""
    return not np.count_nonzero(matrix - np.diag(np.diagonal(matrix)))


def whiten_factor(covariance):
    """Return L such that chi2(d) = ||L d||^2, i.e. L^T L = C^{-1}.

    Host-side float64; L = inv(cholesky(C)) so that L C L^T = I. A diagonal
    C gives diag(1 / sqrt(C_ii)) at once (the same numbers: an 11086 x 11086
    one, the CamSpec fixture's, took 25 s through the general path on an
    8-core CPU).
    """
    cov = np.atleast_2d(np.asarray(covariance, dtype='f8'))
    if is_diagonal(cov):
        return np.diag(1. / np.sqrt(np.diagonal(cov)))
    chol = np.linalg.cholesky(cov)
    return np.linalg.solve(chol, np.eye(cov.shape[0]))


def inverse(matrix):
    """The inverse of a square float64 host matrix; a diagonal one at once."""
    matrix = np.atleast_2d(np.asarray(matrix, dtype='f8'))
    if is_diagonal(matrix):
        return np.diag(1. / np.diagonal(matrix))
    return np.linalg.inv(matrix)


def cholesky(matrix):
    """Lower Cholesky factor of a (batch of) symmetric positive-definite
    matrix; raises ValueError if any matrix is not positive definite."""
    factor, info = torch.linalg.cholesky_ex(matrix)
    if bool((info != 0).any()):
        raise ValueError('matrix is not positive definite (cholesky_ex info {})'.format(info.tolist()))
    return factor


def cholesky_equilibrated(matrix):
    """Jacobi-equilibrated Cholesky of a batch (..., n, n) of symmetric
    positive-definite matrices M: with s = 1 / sqrt(diag M), factors
    diag(s) M diag(s), whose condition number is that of the correlation
    matrix. Returns (L, s, info): M^-1 b = s * cholesky_solve(s * b, L),
    logdet M = 2 sum(log diag L) - 2 sum(log s), and ``info`` (..., int) is
    nonzero where a matrix is not positive definite. Nothing here
    synchronises with the host: the caller reads ``info`` where it can
    afford to."""
    scale = torch.rsqrt(torch.diagonal(matrix, dim1=-2, dim2=-1))
    factor, info = torch.linalg.cholesky_ex(matrix * scale[..., :, None] * scale[..., None, :])
    return factor, scale, info
