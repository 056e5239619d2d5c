"""Linear-algebra helpers: chi2, inverses, whitening and Cholesky
factorizations.

Counterpart of ``desilike_tpu/ops/linalg.py``. The unrolled small-matrix
Cholesky there (``chol_small``, ``chol_solve_small``, ``chol_logdet_small``)
was a TPU workaround for LAPACK custom calls under ``vmap``; here the same
names are ``torch.linalg.cholesky_ex`` and :func:`cholesky_solve` (two
triangular solves), batched over the chains. ``chol_small`` keeps the JAX function's answer for a
matrix that does not factor (each pivot clipped at 1e-30); the port's own
paths use :func:`cholesky` (raises) or :func:`cholesky_equilibrated`
(reports ``info``) instead.
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


def cholesky_solve(rhs, factor):
    """M^-1 rhs for rhs (..., n, m), given the lower Cholesky factor L (...,
    n, n) of M, by two triangular solves: on the card they do not wait for
    the host, so that a call that uses them can be captured in a CUDA graph,
    where ``torch.cholesky_solve`` of a batch (MAGMA) synchronises and
    cannot be captured. A single factor (n, n) solves every right-hand side
    of the batch at once, as columns."""
    if factor.ndim == 2 and rhs.ndim > 2:
        n = factor.shape[-1]
        columns = rhs.movedim(-2, 0).reshape(n, -1)
        return cholesky_solve(columns, factor).reshape((n,) + rhs.shape[:-2] + rhs.shape[-1:]).movedim(0, -2)
    y = torch.linalg.solve_triangular(factor, rhs, upper=False)
    return torch.linalg.solve_triangular(factor.mT, y, upper=True)


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


def chi2(flatdiff, precision):
    """Quadratic form d^T P d over the last axis of the tensor ``flatdiff``;
    ``precision`` (a tensor or an array) may be 1D (diagonal) or 2D."""
    if not isinstance(precision, torch.Tensor):
        precision = torch.tensor(np.asarray(precision))
    precision = precision.to(dtype=flatdiff.dtype, device=flatdiff.device)
    if precision.ndim == 1:
        return torch.sum(flatdiff * precision * flatdiff, dim=-1)
    return torch.einsum('...i,ij,...j->...', flatdiff, precision, flatdiff)


def inv(mat, check_valid='raise'):
    """Inverse of a square matrix: a host array through :func:`inverse`
    (float64 numpy), a tensor (batched over its leading axes) by
    ``torch.linalg.inv_ex``. A singular matrix raises, or with any other
    ``check_valid`` takes the pseudo-inverse."""
    if not isinstance(mat, torch.Tensor):
        mat = np.asarray(mat, dtype='f8')
        if mat.ndim == 1 or (mat.ndim == 2 and mat.shape[0] != mat.shape[1]):
            raise ValueError('expected square matrix')
        try:
            return inverse(mat)
        except np.linalg.LinAlgError:
            if check_valid == 'raise':
                raise
            return np.linalg.pinv(mat)
    if mat.ndim < 2 or mat.shape[-1] != mat.shape[-2]:
        raise ValueError('expected square matrix')
    out, info = torch.linalg.inv_ex(mat)
    if bool((info != 0).any()):
        if check_valid == 'raise':
            raise ValueError('singular matrix (inv_ex info {})'.format(info.tolist()))
        return torch.linalg.pinv(mat)
    return out


def blockinv(blocks, inv=inv):
    """Inverse of a matrix given as a nested list of blocks, by the block
    decomposition (numerically stabler for ill-conditioned
    multi-observable covariances). Host arrays give float64 numpy; with any
    tensor block the blocks are tensors and so is the result."""
    ref = next((b for row in blocks for b in row if isinstance(b, torch.Tensor)), None)
    host = ref is None
    kwargs = dict(dtype=torch.float64) if host else dict(dtype=ref.dtype, device=ref.device)
    blocks = [[torch.atleast_2d(torch.as_tensor(b, **kwargs)) for b in row] for row in blocks]

    def _inv(mat):
        A = mat[0][0]
        if len(mat) == 1:
            return inv(A)
        B = torch.cat(mat[0][1:], dim=-1)
        C = torch.cat([row[0] for row in mat[1:]], dim=0)
        invD = _inv([row[1:] for row in mat[1:]])
        invD_C = invD @ C
        schur = inv(A - B @ invD_C)
        return torch.cat([torch.cat([schur, -schur @ B @ invD], dim=-1),
                          torch.cat([-invD_C @ schur, invD + invD_C @ schur @ B @ invD], dim=-1)], dim=0)

    out = _inv(blocks)
    return out.numpy() if host else out


def logdet(mat):
    """log|det| of a (batch of) square matrix, sign-safe."""
    return torch.linalg.slogdet(mat)[1]


def _chol_clipped(A):
    """Column-by-column Cholesky with each pivot clipped at 1e-30: the JAX
    package's ``chol_small``, for the matrices ``cholesky_ex`` cannot factor."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        c = A[..., :, j]
        for k in range(j):
            c = c - cols[k] * cols[k][..., j][..., None]
        d = torch.sqrt(torch.clamp(c[..., j], min=1e-30))
        mask = torch.arange(n, device=A.device) >= j
        cols.append(torch.where(mask, c / d[..., None], torch.zeros_like(c)))
    return torch.stack(cols, dim=-1)


def chol_small(A):
    """Lower Cholesky factor L (L L^T = A) of a batch (..., n, n) of
    symmetric positive-definite matrices, differentiable; a matrix that
    does not factor gets the clipped-pivot factor of the JAX package (one
    host read of ``info`` a call)."""
    factor, info = torch.linalg.cholesky_ex(A)
    failed = info != 0
    if bool(failed.any()):
        factor = torch.where(failed[..., None, None], _chol_clipped(A), factor)
    return factor


def chol_solve_small(L, b):
    """Solve A x = b, b (..., n), given L = chol_small(A)."""
    return cholesky_solve(b[..., None], L)[..., 0]


def chol_logdet_small(L):
    """log det A from L = chol_small(A)."""
    return 2. * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
