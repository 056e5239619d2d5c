"""Window-matrix convolution of theory multipoles.

Counterpart of ``desilike_tpu/observables/window.py`` on the continuous
bin-integration path (P(k): ``wmatrix=None`` or ``{'resolution': n}``;
xi(s): resolution 3, or the window of measured RR(s, mu) pair counts): the
matrix is assembled host-side in float64, and the per-evaluation path is
one batched matmul, flat theory (B, nell * nin) -> (B, nflat). Output
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


def window_matrix_RR(soutedges, sedges, muedges, wcounts, ellsin=(0, 2, 4), resolution=1):
    r"""xi window matrix from measured RR(s, mu) pair counts: incomplete or
    non-uniform mu coverage of the random pairs weights the Legendre
    projection, mixing input multipoles.

    Parameters
    ----------
    soutedges : dict ell -> (nout, 2) output bin edges
    sedges : RR s-edges, (ns+1,) or (ns, 2)
    muedges : mu-edges, (nmu+1,)
    wcounts : (ns, nmu) RR weighted pair counts
    ellsin : input theory multipoles
    resolution : bin-integration points per fine RR bin

    Returns (sin, matrix with shape (sum_l nout_l, nellsin * nsin)).
    """
    from numpy.polynomial.legendre import Legendre
    sedges = np.asarray(sedges, dtype='f8')
    if sedges.ndim == 1:
        sedges = np.column_stack([sedges[:-1], sedges[1:]])
    muedges = np.asarray(muedges, dtype='f8')
    wcounts = np.asarray(wcounts, dtype='f8')
    ns = len(sedges)
    sin, binm = window_matrix_bininteg([sedges], resolution=resolution)  # (ns, nsin)
    blocks = []
    for ellout, edges_out in soutedges.items():
        edges_out = np.asarray(edges_out, dtype='f8')
        if edges_out.ndim == 1:
            edges_out = np.column_stack([edges_out[:-1], edges_out[1:]])
        start = np.flatnonzero(np.isclose(sedges[:, 0], edges_out[0, 0]))
        if not start.size:
            raise ValueError('output edges start {} not found in RR s-edges'.format(edges_out[0, 0]))
        start = int(start[0])
        factor = int(np.rint((edges_out[0, 1] - edges_out[0, 0]) / (sedges[start, 1] - sedges[start, 0])))
        if factor < 1:
            raise ValueError('RR s-resolution is coarser than the requested output binning')
        nout = len(edges_out)
        row = []
        for ellin in ellsin:
            integ = (Legendre.basis(ellout) * Legendre.basis(ellin)).integ()
            legint = integ(muedges[1:]) - integ(muedges[:-1])       # per mu bin
            # per-fine-bin mu-average coefficient, grouped by output bin: the
            # shares wc_f / sum_f wc_f carry the RR s-profile within an output
            # bin as the fine-bin weight (volumetric for uniform randoms)
            M = np.zeros((ns, nout))
            for iout in range(nout):
                iin = start + factor * iout
                wc = wcounts[iin:iin + factor]                       # (factor, nmu)
                wcmu = wc.sum(axis=0)
                nonzero = wcmu != 0.
                frac = wc / np.where(nonzero, wcmu, 1.)
                covered = np.sum(nonzero * np.diff(muedges))
                M[iin:iin + factor, iout] = (2. * ellout + 1.) * np.einsum('fm,m->f', frac, nonzero * legint) \
                    / (covered if covered > 0. else 1.)
            row.append(M.T @ binm)                                   # (nout, nsin)
        blocks.append(row)
    return sin, np.block(blocks)


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


class WindowedCorrelationFunctionMultipoles(Calculator):
    """Window-convolved (binned) theory xi_l(s).

    Parameters
    ----------
    slim : dict ell -> (smin, smax[, step])
        Output limits and binning per multipole (step 4 by default).
    s, ells : output s centers and multipoles, instead of ``slim``.
    wmatrix : {'sedges', 'muedges', 'wcounts'[, 'ellsin', 'resolution']}, optional
        The window of measured RR(s, mu) pair counts (:func:`window_matrix_RR`);
        otherwise bin integration at resolution 3.
    theory : theory xi multipoles calculator
    """

    def initialize(self, slim=None, s=None, ells=None, theory=None, wmatrix=None, fiber_collisions=None,
                   systematic_templates=None):
        if fiber_collisions is not None or systematic_templates is not None:
            raise NotImplementedError('window options fiber_collisions= and systematic_templates= are ROADMAP A12')
        if theory is None:
            from ..theories.bao import DampedBAOWigglesTracerCorrelationFunctionMultipoles
            theory = DampedBAOWigglesTracerCorrelationFunctionMultipoles()
        self.theory = theory
        if slim is not None:
            self.ells = tuple(sorted(slim.keys()))
            self.sedges, self.s = [], []
            for ell in self.ells:
                lim = slim[ell]
                step = lim[2] if len(lim) > 2 else 4.
                edges = np.arange(lim[0], lim[1] + step / 2., step)
                self.sedges.append(np.column_stack([edges[:-1], edges[1:]]))
                self.s.append((edges[:-1] + edges[1:]) / 2.)
        else:
            if s is None:
                s = np.linspace(20., 150., 33)
            self.ells = tuple(ells) if ells is not None else (0, 2)
            self.s = [np.asarray(s, dtype='f8')] * len(self.ells)
            self.sedges = []
            for ss in self.s:
                edges = np.concatenate([[ss[0] - (ss[1] - ss[0]) / 2.], (ss[1:] + ss[:-1]) / 2.,
                                        [ss[-1] + (ss[-1] - ss[-2]) / 2.]])
                self.sedges.append(np.column_stack([edges[:-1], edges[1:]]))
        if isinstance(wmatrix, dict) and 'wcounts' in wmatrix:
            self.ellsin = tuple(wmatrix.get('ellsin', (0, 2, 4)))
            self.sin, self.wmatrix = window_matrix_RR(dict(zip(self.ells, self.sedges)), wmatrix['sedges'],
                                                      wmatrix['muedges'], wmatrix['wcounts'], ellsin=self.ellsin,
                                                      resolution=int(wmatrix.get('resolution', 1)))
        else:
            self.ellsin = self.ells
            self.sin, self.wmatrix = window_matrix_bininteg(self.sedges, resolution=3)
        self.theory.init.update(s=self.sin, ells=self.ellsin)

    def calculate(self, **params):
        corr = self.theory.corr
        self.flatcorr = corr.reshape(corr.shape[:-2] + (-1,)) @ self.const('wmatrix').T

    def get(self):
        return self.flatcorr
