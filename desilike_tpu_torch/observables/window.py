"""Window-matrix convolution of theory multipoles.

Counterpart of ``desilike_tpu/observables/window.py``. The matrix is
assembled host-side in float64 from (a) bin integration in the continuous
limit (P(k): ``wmatrix=None`` or ``{'resolution': n}``; xi(s): resolution
3, or the window of measured RR(s, mu) pair counts), (b) an explicit
``(kin, matrix)`` pair, or (c) a measured window file (pypower-style
objects, their ``.npy`` state dicts, or the canonical dict; read by
:func:`~..interop.read_window_matrix`). A fiber-collision kernel is folded
into it and every constant term (the kernel's uncorrelated part, the shot
noise and the window's response to it) into one host offset, so that the
per-evaluation path is one batched matmul plus a constant: flat theory (B,
nell * nin) -> (B, nflat). Systematic templates add ``amplitudes @
templates``, their amplitudes ``syst_*`` solved with a static design
matrix.
"""

from collections.abc import Mapping

import numpy as np
import torch

from ..core import Calculator


def _template_names(spec):
    """Parameter names for a systematic-templates spec (dict keys, or
    generated syst_i for sequences / a single template)."""
    if spec is None:
        return []
    if isinstance(spec, Mapping):
        return [str(name) for name in spec.keys()]
    if callable(spec) or getattr(spec, 'ndim', None) is not None:
        spec = [spec]
    return ['syst_{:d}'.format(i) for i in range(len(spec))]


def _template_params(init):
    """_params hook shared by the windowed observables: one linear amplitude
    per template, added after the window."""
    names = _template_names(init.get('systematic_templates', None))
    return {name: dict(value=0., prior=dict(dist='norm', loc=0., scale=10.),
                       ref=dict(limits=[-1e-3, 1e-3]),
                       latex='s_{{{}}}'.format(i))
            for i, name in enumerate(names)}


def _flat_templates(spec, x_list):
    """Evaluate a templates spec to a static (ntemplates, nflat) matrix on
    the flat output data vector: callables are evaluated per multipole grid
    and concatenated; arrays are flat vectors or per-ell stacks."""
    nflat = sum(len(x) for x in x_list)
    if isinstance(spec, Mapping):
        values = list(spec.values())
    elif callable(spec) or getattr(spec, 'ndim', None) is not None:
        values = [spec]
    else:
        values = list(spec)
    rows = []
    for t in values:
        if callable(t):
            flat = np.concatenate([np.asarray(t(np.asarray(x)), dtype='f8') for x in x_list])
        else:
            t = np.asarray(t, dtype='f8')
            if t.ndim == 1 and t.size == nflat:
                flat = t
            elif t.ndim == 2 and t.shape[0] == len(x_list):
                flat = np.concatenate([np.asarray(row)[:len(x)] for row, x in zip(t, x_list)])
            else:
                raise ValueError('template shape {} does not match flat data size {} '
                                 '(per-ell sizes {})'.format(t.shape, nflat, [len(x) for x in x_list]))
        if flat.size != nflat:
            raise ValueError('template size {} != flat data size {}'.format(flat.size, nflat))
        rows.append(flat)
    return np.stack(rows)


def _centre_edges(x):
    """(n, 2) bin edges halfway between the centres ``x``, the outer ones as far out as the inner ones."""
    edges = np.concatenate([[x[0] - (x[1] - x[0]) / 2.], (x[1:] + x[:-1]) / 2., [x[-1] + (x[-1] - x[-2]) / 2.]])
    return np.column_stack([edges[:-1], edges[1:]])


class _WindowedMultipoles(Calculator):
    """What the P(k) and xi windows share: the systematic templates'
    parameters, the fold of a fiber-collision kernel into the matrix, and
    the per-evaluation GEMM plus the constant offset and the templates."""

    _static_linear_solved = ('syst_*',)

    @staticmethod
    def _params(init):
        return _template_params(init)

    def _fold(self, fiber_collisions, diagonal):
        """Fold ``fiber_collisions``'s static kernel into the window (host
        float64, once): W -> W K, and its uncorrelated term into the offset,
        W k_unc. ``diagonal``: a configuration-space kernel, (nell_out,
        nell_in, ns), diagonal in s."""
        grid = 's' if diagonal else 'k'
        fiber_collisions.init.update(**{grid: self._xin, 'ells': self.ellsin, 'theory': self.theory})
        fiber_collisions.runtime_info.initialize()
        kernel = fiber_collisions.kernel_correlated
        K = np.block([[np.diag(kernel[io, ii]) if diagonal else kernel[io, ii]
                       for ii in range(len(fiber_collisions.ellsin))] for io in range(len(fiber_collisions.ells))])
        if fiber_collisions.with_uncorrelated:
            self.offset = self.offset + self.wmatrix @ fiber_collisions.kernel_uncorrelated.reshape(-1)
        self.wmatrix = self.wmatrix @ K
        xin = np.asarray(fiber_collisions.sin if diagonal else fiber_collisions.kin)
        ellsin = tuple(fiber_collisions.ellsin)
        if not (np.array_equal(xin, self._xin) and ellsin == self.ellsin):
            self._xin, self.ellsin = xin, ellsin
            self.theory.init.update(**{grid: xin, 'ells': ellsin})

    def _set_templates(self, systematic_templates, x_list):
        self._template_param_names = _template_names(systematic_templates)
        self.templates = _flat_templates(systematic_templates, x_list) if self._template_param_names else None

    def _set_offset(self, offset):
        self.offset = offset if np.any(offset) else None

    def _windowed(self, theory, params):
        """(B, nell_in, nin) theory -> (B, nflat): one GEMM, the constant
        offset, and the templates' amplitudes (in ``params``) times the
        templates."""
        flat = theory.reshape(theory.shape[:-2] + (-1,)) @ self.const('wmatrix').T
        if self.offset is not None:
            flat = flat + self.const('offset')
        if self.templates is not None:
            amplitudes = torch.stack([params[name] for name in self._template_param_names], dim=-1)
            flat = flat + amplitudes @ self.const('templates')
        return flat


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


class WindowedPowerSpectrumMultipoles(_WindowedMultipoles):
    """Window-convolved theory P_l(k).

    Parameters
    ----------
    klim : dict ell -> (kmin, kmax[, step]) or None
        Output limits/binning per multipole.
    k, ells : output k centers (an array, or one per multipole) and
        multipoles, instead of ``klim`` (default: 39 centers over 0.01-0.2
        h/Mpc, ells (0, 2, 4)).
    wmatrix : None, {'resolution': n}, (kin, matrix), or a window file
        None: the theory at volume-weighted bin centers; resolution:
        continuous bin integration with n points per bin; an explicit matrix
        with its input theory grid (``kinlim`` cuts the grid); a measured
        window (pypower-style object, its ``.npy`` state dict or a path to
        it, or the canonical dict; ``kin``, ``kinrebin``, ``kinlim``,
        ``ellsin`` select and re-grid its input side, see
        :func:`~..interop.read_window_matrix`), whose output rows are
        rebinned to ``k`` (the measured data's grid) or ``klim``.
    theory : theory multipoles calculator (default: the Kaiser tracer)
    shotnoise : float
        Shot noise of the measurement: added to the theory monopole before
        the window and subtracted after it, or, where the window file holds
        its response to a constant (``wshotnoise``), subtracted as
        ``shotnoise * (delta_l0 - wshotnoise)``.
    fiber_collisions : fiber-collision calculator, optional
        Its static kernel is folded into the window matrix at
        initialization, so the per-evaluation cost is unchanged.
    systematic_templates : templates spec, optional
        Additive post-window templates with linear amplitude parameters
        (dict name -> template, sequence, callable(k), flat or per-ell
        arrays), solved with a static design matrix when marked solved.
    """

    def initialize(self, klim=None, k=None, ells=None, wmatrix=None, theory=None,
                   kin=None, kinrebin=None, ellsin=None,
                   kinlim=None, shotnoise=0., fiber_collisions=None, systematic_templates=None):
        if theory is None:
            from ..theories.full_shape import KaiserTracerPowerSpectrumMultipoles
            theory = KaiserTracerPowerSpectrumMultipoles()
        self.theory = theory
        self.shotnoise = float(shotnoise)
        wshotnoise = None
        from ..interop import is_path, read_window_matrix
        external = wmatrix is not None and (
            is_path(wmatrix)
            or (isinstance(wmatrix, dict) and ('matrix' in wmatrix or 'value' in wmatrix))
            or (not isinstance(wmatrix, (dict, tuple, list)) and hasattr(wmatrix, 'value')))
        if external:
            # the matrix defines the output k grids (rebinned/sliced to the
            # data's k or to klim) and the input theory grid
            if klim is not None:
                self.ells = tuple(sorted(klim.keys()))
            elif ells is not None:
                self.ells = tuple(ells)
            else:
                raise ValueError('pass klim= or ells= with an external window matrix')
            kout = None
            if k is not None:
                kout = [np.asarray(kk, dtype='f8') for kk in (k if np.ndim(k[0]) else [k] * len(self.ells))]
            self.kin, self.wmatrix, self.k, self.ellsin, wshotnoise = read_window_matrix(
                wmatrix, ells=self.ells, klim=klim, kout=kout, kin=kin, kinrebin=kinrebin, kinlim=kinlim, ellsin=ellsin)
            self.kedges = [_centre_edges(kk) for kk in self.k]
        else:
            if klim is not None:
                self.ells = tuple(sorted(klim.keys()))
                self.kedges, self.k = [], []
                for ell in self.ells:
                    lim = klim[ell]
                    step = lim[2] if len(lim) > 2 else 0.005
                    edges = np.arange(lim[0], lim[1] + step / 2., step)
                    self.kedges.append(np.column_stack([edges[:-1], edges[1:]]))
                    self.k.append((edges[:-1] + edges[1:]) / 2.)
            else:
                if k is None:
                    k = np.linspace(0.01, 0.2, 39)
                self.ells = tuple(ells) if ells is not None else (0, 2, 4)
                self.k = [np.asarray(k, dtype='f8')] * len(self.ells) if np.ndim(k[0]) == 0 \
                    else [np.asarray(kk) for kk in k]
                self.kedges = [_centre_edges(kk) for kk in self.k]
            self._set_matrix(wmatrix, kinlim)
            self.ellsin = self.ells
        self._xin = self.kin
        self.theory.init.update(k=self.kin, ells=self.ellsin)
        self.offset = np.zeros(self.wmatrix.shape[0])
        if fiber_collisions is not None:
            self._fold(fiber_collisions, diagonal=False)
            self.kin = self._xin
        self._set_offset(self.offset + self._shotnoise_offset(wshotnoise))
        self._set_templates(systematic_templates, self.k)

    def _shotnoise_offset(self, wshotnoise):
        """The shot noise's constant contribution to the windowed flat vector
        (the JAX package adds it per evaluation, in this order: the window's
        response, then the fiber collisions' offset and the templates)."""
        monopole = np.concatenate([np.full(len(kk), float(ell == 0)) for ell, kk in zip(self.ells, self.k)])
        if not self.shotnoise:
            return np.zeros_like(monopole)
        if wshotnoise is not None:
            # measured window response to a constant (shot-noise) input: the
            # bare theory is convolved, then sn * (delta_l0 - Wsn) subtracted
            return -self.shotnoise * (monopole - wshotnoise)
        offset = -self.shotnoise * monopole
        if 0 in self.ellsin:
            # the shot noise added to the theory monopole (ells may come in any order:
            # the monopole's row is not assumed first), through the window
            nin, i0 = len(self.kin), self.ellsin.index(0)
            offset = offset + self.shotnoise * self.wmatrix[:, i0 * nin:(i0 + 1) * nin].sum(axis=1)
        return offset

    def _set_matrix(self, wmatrix, kinlim):
        if wmatrix is None:
            # direct evaluation on volume-weighted bin centers
            self.kin, self.wmatrix = window_matrix_bininteg(self.kedges, resolution=1)
        elif isinstance(wmatrix, dict) and 'resolution' in wmatrix:
            self.kin, self.wmatrix = window_matrix_bininteg(self.kedges, resolution=int(wmatrix['resolution']))
        elif isinstance(wmatrix, (tuple, list)) and len(wmatrix) == 2:
            kin, matrix = wmatrix
            self.kin = np.asarray(kin, dtype='f8')
            matrix = np.asarray(matrix, dtype='f8')
            nout = sum(len(kk) for kk in self.k)
            if matrix.shape[0] != nout:
                raise ValueError('window matrix rows {} != data size {}'.format(matrix.shape[0], nout))
            self.wmatrix = matrix
            if kinlim is not None:
                mask = (self.kin >= kinlim[0]) & (self.kin <= kinlim[1])
                self.kin = self.kin[mask]
                self.wmatrix = matrix[:, np.tile(mask, matrix.shape[1] // mask.size)]
        else:
            raise ValueError('unsupported wmatrix specification: {}'.format(type(wmatrix)))

    def calculate(self, **params):
        self.flatpower = self._windowed(self.theory.power, params)

    @property
    def power(self):
        """Windowed multipoles, a list of (B, nk_ell) tensors."""
        return list(torch.split(self.flatpower, [len(kk) for kk in self.k], dim=-1))

    def get(self):
        return self.flatpower


class WindowedCorrelationFunctionMultipoles(_WindowedMultipoles):
    """Window-convolved (binned) theory xi_l(s).

    Parameters
    ----------
    slim : dict ell -> (smin, smax[, step])
        Output limits and binning per multipole (step 4 by default).
    s, ells : output s centers and multipoles, instead of ``slim``.
    wmatrix : {'sedges', 'muedges', 'wcounts'[, 'ellsin', 'resolution']}, optional
        The window of measured RR(s, mu) pair counts (:func:`window_matrix_RR`);
        otherwise bin integration at resolution 3.
    theory : theory xi multipoles calculator (default: damped BAO wiggles)
    fiber_collisions : a xi fiber-collision calculator, optional
        Its s-diagonal kernel is folded into the matrix at initialization.
    systematic_templates : templates spec, optional
        Additive templates with linear amplitudes (see the P(k) window).
    """

    def initialize(self, slim=None, s=None, ells=None, theory=None, wmatrix=None, fiber_collisions=None,
                   systematic_templates=None):
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
            self.sedges = [_centre_edges(ss) for ss in self.s]
        if isinstance(wmatrix, dict) and 'wcounts' in wmatrix:
            self.ellsin = tuple(wmatrix.get('ellsin', (0, 2, 4)))
            self.sin, self.wmatrix = window_matrix_RR(dict(zip(self.ells, self.sedges)), wmatrix['sedges'],
                                                      wmatrix['muedges'], wmatrix['wcounts'], ellsin=self.ellsin,
                                                      resolution=int(wmatrix.get('resolution', 1)))
        else:
            self.ellsin = self.ells
            self.sin, self.wmatrix = window_matrix_bininteg(self.sedges, resolution=3)
        self._xin = self.sin
        self.theory.init.update(s=self.sin, ells=self.ellsin)
        self.offset = np.zeros(self.wmatrix.shape[0])
        if fiber_collisions is not None:
            self._fold(fiber_collisions, diagonal=True)
        self._set_offset(self.offset)
        self._set_templates(systematic_templates, self.s)

    def calculate(self, **params):
        self.flatcorr = self._windowed(self.theory.corr, params)

    @property
    def corr(self):
        """Windowed multipoles, a list of (B, ns_ell) tensors."""
        return list(torch.split(self.flatcorr, [len(ss) for ss in self.s], dim=-1))

    def get(self):
        return self.flatcorr
