"""Window-matrix convolution of theory multipoles.

Counterpart of ``desilike_tpu/observables/window.py`` on the continuous
bin-integration path (``wmatrix=None`` or ``{'resolution': n}``): the
matrix is assembled host-side in float64, and the per-evaluation path is
one batched matmul, flat theory (B, nell * nkin) -> (B, nflat). Output
grids given as k centers, shot-noise subtraction, external window formats,
explicit (kin, matrix) windows, fiber collisions and systematic templates
wait for ROADMAP A12.
"""

import numpy as np

from ..core import Calculator


def matrix_lininterp(xout, xin):
    """(nout, nin) linear-interpolation matrix: f(xout) ~= M @ f(xin)."""
    xout = np.asarray(xout, dtype='f8')
    xin = np.asarray(xin, dtype='f8')
    M = np.zeros((xout.size, xin.size), dtype='f8')
    idx = np.clip(np.searchsorted(xin, xout, side='right') - 1, 0, xin.size - 2)
    x0 = xin[idx]
    x1 = xin[idx + 1]
    t = np.clip((xout - x0) / (x1 - x0), 0., 1.)
    M[np.arange(xout.size), idx] = 1. - t
    M[np.arange(xout.size), idx + 1] = t
    return M


def window_matrix_bininteg(list_edges, resolution=1):
    r"""Bin-integration window in the continuous limit: each output bin is
    \int dx x^2 f(x) / \int dx x^2 over the bin, evaluated at ``resolution``
    volume-weighted points per bin and referred back to a common fine input
    grid by linear interpolation.

    Returns (xin, full_matrix with shape (sum_l nbins_l, nells * nin)).
    """
    resolution = int(resolution)
    if resolution <= 0:
        raise ValueError('resolution must be positive')
    if np.ndim(list_edges[0]) == 0:
        list_edges = [list_edges]
    list_edges = [np.asarray(e, dtype='f8') for e in list_edges]
    # edges given as (nbins, 2) pairs or 1D array of edges
    list_edges = [np.column_stack([e[:-1], e[1:]]) if e.ndim == 1 else e for e in list_edges]

    step = min((e[:, 1] - e[:, 0]).min() for e in list_edges) / resolution
    start = min(e.min() for e in list_edges)
    stop = max(e.max() for e in list_edges)
    edgesin = np.arange(start, stop + step / 2., step)
    # volume-weighted centers: 3/4 (x1^4 - x0^4)/(x1^3 - x0^3)
    xin = 0.75 * (edgesin[1:] ** 4 - edgesin[:-1] ** 4) / (edgesin[1:] ** 3 - edgesin[:-1] ** 3)

    mats = []
    for edges in list_edges:
        xs, ws = [], []
        nbins = len(edges)
        for ibin, (lo, hi) in enumerate(edges):
            sub = np.linspace(lo, hi, resolution + 1)
            xs.append(0.75 * (sub[1:] ** 4 - sub[:-1] ** 4) / (sub[1:] ** 3 - sub[:-1] ** 3))
            vol = sub[1:] ** 3 - sub[:-1] ** 3
            line = np.zeros(nbins * resolution)
            line[ibin * resolution:(ibin + 1) * resolution] = vol / vol.sum()
            ws.append(line)
        mats.append(np.stack(ws) @ matrix_lininterp(np.concatenate(xs), xin))
    nells = len(mats)
    rows = [[mat if j == i else np.zeros_like(mats[j]) for j in range(nells)] for i, mat in enumerate(mats)]
    return xin, np.block(rows)  # (sum nbins, nells * nin)


class WindowedPowerSpectrumMultipoles(Calculator):
    """Window-convolved theory P_l(k).

    Parameters
    ----------
    klim : dict ell -> (kmin, kmax[, step])
        Output limits/binning per multipole.
    wmatrix : None or {'resolution': n}
        None = evaluate theory at volume-weighted bin centers; resolution =
        continuous bin-integration with n points per bin.
    theory : theory multipoles calculator
    """

    def initialize(self, klim=None, wmatrix=None, theory=None, **kwargs):
        unsupported = sorted(name for name, value in kwargs.items() if value)
        if unsupported:
            raise NotImplementedError('window options {} (output grids given as k, shot noise, external '
                                      'windows, fiber collisions, systematic templates) are ROADMAP A12'.format(unsupported))
        if klim is None or theory is None:
            raise NotImplementedError('pass klim= and theory=: the default grids and the default theory '
                                      'are ROADMAP A12')
        self.theory = theory
        self.ells = tuple(sorted(klim.keys()))
        self.kedges, self.k = [], []
        for ell in self.ells:
            lim = klim[ell]
            step = lim[2] if len(lim) > 2 else 0.005
            edges = np.arange(lim[0], lim[1] + step / 2., step)
            self.kedges.append(np.column_stack([edges[:-1], edges[1:]]))
            self.k.append((edges[:-1] + edges[1:]) / 2.)
        if wmatrix is None:
            resolution = 1
        elif isinstance(wmatrix, dict) and 'resolution' in wmatrix:
            resolution = int(wmatrix['resolution'])
        else:
            raise NotImplementedError('window matrix {!r}: external and explicit windows are ROADMAP A12'.format(
                type(wmatrix)))
        self.kin, self.wmatrix = window_matrix_bininteg(self.kedges, resolution=resolution)
        self.theory.init.update(k=self.kin, ells=self.ells)

    def calculate(self, **params):
        theory = self.theory.power
        flat = theory.reshape(theory.shape[:-2] + (-1,))
        self.flatpower = flat @ self.const('wmatrix').T

    def get(self):
        return self.flatpower
