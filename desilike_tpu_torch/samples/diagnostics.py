"""Convergence diagnostics: Gelman-Rubin, autocorrelation/ESS, Geweke.

A copy of ``desilike_tpu/samples/diagnostics.py`` (numpy and scipy only),
the counterpart of the reference's samples/diagnostics.py:13,145,295.
Host-side, on chains gathered from the device between sampling batches.
"""

import numpy as np


def gelman_rubin(chains, method='diag', check_valid='ignore'):
    r"""Potential scale reduction R-hat.

    chains: (nchains, nsteps, ndim) or list of (nsteps, ndim).
    method: 'diag' -> per-dimension R; 'eigen' -> multivariate eigenvalue
    criterion (Brooks & Gelman 1998), as in the reference.
    """
    chains = np.asarray([np.atleast_2d(c) for c in chains], dtype='f8')
    nchains, nsteps, ndim = chains.shape
    if nchains < 2:
        raise ValueError('need >= 2 chains for Gelman-Rubin')
    means = chains.mean(axis=1)                      # (nchains, ndim)
    W = np.mean([np.cov(c, rowvar=False, ddof=1) for c in chains], axis=0)
    B_over_n = np.cov(means, rowvar=False, ddof=1)   # between-chain / nsteps
    W = np.atleast_2d(W)
    B_over_n = np.atleast_2d(B_over_n)
    V = (nsteps - 1.) / nsteps * W + B_over_n * (1. + 1. / nchains)
    if method == 'diag':
        return np.sqrt(np.diag(V) / np.diag(W))
    if method == 'eigen':
        Winv = np.linalg.inv(W)
        eig = np.linalg.eigvalsh(Winv @ B_over_n)
        return np.sqrt((nsteps - 1.) / nsteps + eig.max() * (1. + 1. / nchains))
    raise ValueError(method)


def gelman_rubin_statistic(chains, statistic):
    """R-hat-style criterion for an arbitrary per-chain statistic (e.g.
    confidence-interval edges), with the within-chain sample variance as the
    dispersion proxy — the reference's ``statistic=`` Gelman-Rubin path
    (reference diagnostics.py:13, used by check()'s CL-interval test).

    chains: (nchains, nsteps, ndim); statistic: (nsteps, ndim) -> (ndim,).
    Returns per-dimension sqrt(1 + (m+1)/m * B/W).
    """
    chains = np.asarray([np.atleast_2d(c) for c in chains], dtype='f8')
    nchains = chains.shape[0]
    if nchains < 2:
        raise ValueError('need >= 2 chains')
    stats = np.asarray([statistic(c) for c in chains])   # (nchains, ndim)
    W = np.mean([np.var(c, axis=0, ddof=1) for c in chains], axis=0)
    B = np.var(stats, axis=0, ddof=1)
    return np.sqrt(1. + (nchains + 1.) / nchains * B / np.maximum(W, 1e-300))


def geweke_pvalue(zscores):
    """Normality p-value of a set of Geweke z-scores (converged chains give
    z ~ N(0,1); reference samplers/base.py:616 normaltest)."""
    from scipy import stats
    z = np.ravel(np.asarray(zscores, dtype='f8'))
    try:
        return float(stats.normaltest(z).pvalue)
    except ValueError:
        return np.nan


def autocorrelation(x):
    """Normalized autocorrelation function via FFT; x: (nsteps,) or (nchains, nsteps)."""
    x = np.atleast_2d(np.asarray(x, dtype='f8'))
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=nfft, axis=-1)
    acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=-1)[..., :n].real
    acf /= acf[..., :1]
    return np.squeeze(acf)


def integrated_autocorrelation_time(x, c=5, min_corr=None, reliable=50):
    """IAT with Sokal's automated windowing (reference diagnostics.py:145).

    x: (nsteps,) or (nchains, nsteps); chains are averaged (emcee convention).
    """
    x = np.atleast_2d(np.asarray(x, dtype='f8'))
    acf = np.atleast_2d(autocorrelation(x)).mean(axis=0)
    taus = 2. * np.cumsum(acf) - 1.
    if min_corr is not None:
        mask = acf > min_corr
        window = int(np.argmin(mask)) if not mask.all() else len(acf)
        return taus[max(window - 1, 0)]
    window = _auto_window(taus, c)
    return taus[window]


def _auto_window(taus, c):
    m = np.arange(len(taus)) < c * taus
    if np.any(~m):
        return int(np.argmin(m))
    return len(taus) - 1


def effective_sample_size(x, **kwargs):
    """ESS = total samples / IAT."""
    x = np.atleast_2d(np.asarray(x, dtype='f8'))
    tau = integrated_autocorrelation_time(x, **kwargs)
    return x.size / max(tau, 1.)


def geweke(x, first=0.25, last=0.75):
    """Geweke z-score comparing the first and last fractions of each chain
    (reference diagnostics.py:295). x: (nsteps,) or (nchains, nsteps)."""
    x = np.atleast_2d(np.asarray(x, dtype='f8'))
    n = x.shape[-1]
    a = x[..., :int(first * n)]
    b = x[..., int(last * n):]
    za = (a.mean(axis=-1) - b.mean(axis=-1))
    denom = np.sqrt(a.var(axis=-1, ddof=1) / a.shape[-1] + b.var(axis=-1, ddof=1) / b.shape[-1])
    return np.squeeze(za / denom)
