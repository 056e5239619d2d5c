"""Observable containers: projection-structured data vectors and covariances.

Counterpart of ``desilike_tpu/observables/types.py``, host-side numpy: a
flat value vector organized by projections (e.g. multipoles) with
per-projection coordinates, weighted ``slice``/``select``/``rebin``,
coordinate matching (``xmatch``), flat views, mock-covariance estimation
(``from_observations`` and the Hartlap/Percival factors), template
marginalization, and the same npz files as the JAX package writes (a file
written by either loads in the other). Per projection: ``x``/``value``/
``weights`` vectors and an ``(n, 2)`` bin-edge array. ``plot`` draws with
matplotlib, imported there.
"""

import json

import numpy as np

from ..utils import BaseClass, is_sequence, find_names


def _as_slice(sl, size):
    """Normalize ``sl`` (slice or None) to (start, stop, step) with stop>=0."""
    if sl is None:
        sl = slice(None)
    start, stop, step = sl.indices(size)
    if step <= 0:
        raise IndexError('slice step must be positive, got {}'.format(step))
    return start, stop, step


def _default_edges(x):
    x = np.asarray(x, dtype='f8')
    if len(x) > 1:
        mid = (x[1:] + x[:-1]) / 2.
        e = np.concatenate([[x[0] - (mid[0] - x[0])], mid, [x[-1] + (x[-1] - mid[-1])]])
    else:
        e = np.array([x[0] * 0.9, x[0] * 1.1])
    return np.column_stack([e[:-1], e[1:]])


class ObservableArray(BaseClass):
    """Projection-structured observable vector.

    Parameters
    ----------
    x : list of arrays
        Coordinates per projection (e.g. k per multipole).
    value : list of arrays, optional
        Values per projection (NaN if unset).
    projs : list, optional
        Projection labels (e.g. ells (0, 2, 4)).
    edges : list of (n, 2) arrays, optional
        Bin edges; derived from midpoints when omitted.
    weights : list of arrays, optional
        Per-bin weights used for weighted rebinning (default 1).
    name : str, optional
        Observable name (used by ObservableCovariance lookups).
    """

    def __init__(self, x=None, value=None, projs=None, edges=None, weights=None,
                 name=None, attrs=None):
        if isinstance(x, ObservableArray):
            self.__dict__.update(x.__dict__)
            return
        if projs is None:
            projs = list(range(len(x)))
        self.name = str(name or '')
        self.projs = list(projs)
        self.x = [np.asarray(xx, dtype='f8') for xx in x]
        if value is not None:
            self.value = [np.asarray(v, dtype='f8') for v in value]
        else:
            self.value = [np.full(len(xx), np.nan) for xx in self.x]
        if edges is None:
            edges = [_default_edges(xx) for xx in self.x]
        self.edges = [np.asarray(e, dtype='f8').reshape(-1, 2) for e in edges]
        if weights is None:
            weights = [None] * len(self.x)
        self.weights = [np.ones(len(xx)) if ww is None else np.asarray(ww, dtype='f8')
                        for xx, ww in zip(self.x, weights)]
        for xx, vv, ee, ww in zip(self.x, self.value, self.edges, self.weights):
            if not (len(xx) == len(vv) == len(ee) == len(ww)):
                raise ValueError('inconsistent projection sizes: x={}, value={}, '
                                 'edges={}, weights={}'.format(len(xx), len(vv), len(ee), len(ww)))
        self.attrs = dict(attrs or {})

    # --- basic views ---

    @property
    def flatx(self):
        return np.concatenate(self.x)

    @property
    def flatvalue(self):
        return np.concatenate(self.value)

    @property
    def size(self):
        return sum(len(v) for v in self.value)

    def __array__(self, *args, **kwargs):
        return np.asarray(self.flatvalue, *args, **kwargs)

    def index(self, proj):
        return self.projs.index(proj)

    def _index_projs(self, projs=Ellipsis):
        if projs is Ellipsis or projs is None:
            return list(range(len(self.projs)))
        if not is_sequence(projs):
            projs = [projs]
        return [self.index(p) for p in projs]

    def _proj_slices(self):
        out, start = {}, 0
        for proj, v in zip(self.projs, self.value):
            out[proj] = slice(start, start + len(v))
            start += len(v)
        return out

    def xavg(self, projs=Ellipsis, method='mid'):
        """Bin centers ('mid', from edges) or stored coordinates ('x')."""
        idx = self._index_projs(projs)
        if method == 'mid':
            out = [self.edges[i].mean(axis=1) for i in idx]
        else:
            out = [self.x[i] for i in idx]
        return out if len(idx) != 1 or is_sequence(projs) or projs in (Ellipsis, None) else out[0]

    # --- selection / rebinning ---

    def slice(self, sl=None, projs=Ellipsis, select_projs=False):
        """Slice each projection; a step > 1 weight-averages groups of bins.

        The weighted group-average is done directly on the per-projection
        vectors; :meth:`slice_matrix` is the same map as a matrix.
        """
        idx = self._index_projs(projs)
        x, value, edges, weights = (list(self.x), list(self.value),
                                    list(self.edges), list(self.weights))
        for i in idx:
            start, stop, step = _as_slice(sl, len(self.x[i]))
            n = ((stop - start) // step) * step
            take = slice(start, start + n)
            ww = weights[i][take].reshape(-1, step)
            wsum = ww.sum(axis=1)
            x[i] = (self.x[i][take].reshape(-1, step) * ww).sum(axis=1) / wsum
            value[i] = (self.value[i][take].reshape(-1, step) * ww).sum(axis=1) / wsum
            edges[i] = np.column_stack([self.edges[i][take][0::step, 0],
                                        self.edges[i][take][step - 1::step, 1]])
            weights[i] = wsum
        if select_projs:
            x, value, edges, weights = ([lst[i] for i in idx] for lst in (x, value, edges, weights))
            projs_out = [self.projs[i] for i in idx]
        else:
            projs_out = self.projs
        return ObservableArray(x=x, value=value, projs=projs_out, edges=edges,
                               weights=weights, name=self.name, attrs=self.attrs)

    def slice_matrix(self, sl=None, projs=Ellipsis, select_projs=False):
        """(new flat size, old flat size) aggregation matrix of :meth:`slice`
        — the weighted group-average as an explicit linear map, used to
        transform covariances consistently (C' = B C B^T)."""
        idx = self._index_projs(projs)
        flat_slices = self._proj_slices()
        rows = []
        nold = self.size
        for i in range(len(self.projs)):
            off = flat_slices[self.projs[i]].start
            if i in idx:
                start, stop, step = _as_slice(sl, len(self.x[i]))
                n = ((stop - start) // step) * step
                ww = self.weights[i][start:start + n].reshape(-1, step)
                wsum = ww.sum(axis=1)
                for g in range(ww.shape[0]):
                    row = np.zeros(nold)
                    cols = off + start + g * step + np.arange(step)
                    row[cols] = ww[g] / wsum[g]
                    rows.append(row)
            elif not select_projs:
                for j in range(len(self.x[i])):
                    row = np.zeros(nold)
                    row[off + j] = 1.
                    rows.append(row)
        return np.array(rows) if rows else np.zeros((0, nold))

    def _mask(self, i, xlim, method='mid'):
        xx = self.edges[i].mean(axis=1) if method == 'mid' else self.x[i]
        m = np.ones(len(xx), dtype=bool)
        if xlim is not None:
            m &= (xx >= xlim[0]) & (xx <= xlim[1])
        return m

    def select(self, xlim=None, rebin=1, projs=Ellipsis, select_projs=False, method='mid'):
        """Rebinning, then x-cuts on the merged-bin centers, restricted to
        given projections."""
        idx = self._index_projs(projs)
        new = self
        if rebin != 1:
            new = new.slice(slice(0, None, rebin), projs=projs)
        x, value, edges, weights = (list(new.x), list(new.value),
                                    list(new.edges), list(new.weights))
        for i in idx:
            m = new._mask(i, xlim, method=method)
            x[i], value[i], edges[i], weights[i] = (x[i][m], value[i][m],
                                                    edges[i][m], weights[i][m])
        if select_projs:
            x, value, edges, weights = ([lst[i] for i in idx] for lst in (x, value, edges, weights))
            projs_out = [self.projs[i] for i in idx]
        else:
            projs_out = self.projs
        return ObservableArray(x=x, value=value, projs=projs_out, edges=edges,
                               weights=weights, name=self.name, attrs=self.attrs)

    def rebin(self, factor=2):
        """Weight-average ``factor`` adjacent bins (all projections)."""
        return self.slice(slice(0, None, factor))

    def _slice_xmatch(self, x, projs=Ellipsis, method='mid'):
        """(proj, coarse-slice, offset-slice) pairs matching target coords.

        Searches rebinning steps, then offsets.
        """
        idx = self._index_projs(projs)
        if not isinstance(x, list):
            x = [x] * len(idx)
        out = []
        for xx, i in zip(x, idx):
            xx = np.asarray(xx, dtype='f8')
            proj = self.projs[i]
            n = len(self.x[i])
            found = None
            for step in range(1, n // max(len(xx), 1) + 1):
                sl1 = slice(0, (n // step) * step, step)
                cand = self.slice(sl1, projs=[proj])
                j = cand.index(proj)
                cx = cand.edges[j].mean(axis=1) if method == 'mid' else cand.x[j]
                hits = np.flatnonzero(np.isclose(xx[0], cx))
                for h in hits:
                    if h + len(xx) <= len(cx) and np.allclose(xx, cx[h:h + len(xx)]):
                        found = (proj, sl1, slice(h, h + len(xx), 1))
                        break
                if found:
                    break
            if found is None:
                raise ValueError('could not match x-coordinates {} for proj {}'.format(xx, proj))
            out.append(found)
        return out

    def xmatch(self, x, projs=Ellipsis, select_projs=False, method='mid'):
        """Rebinned/sliced array whose coordinates equal the target ``x``."""
        new = self
        for proj, sl1, sl2 in self._slice_xmatch(x, projs=projs, method=method):
            new = new.slice(sl1, projs=[proj]).slice(sl2, projs=[proj])
        if select_projs:
            new = new.select(projs=projs, select_projs=True)
        return new

    def view(self, xlim=None, projs=Ellipsis, method='mid', return_type='nparray'):
        """Flat value vector (or sub-array) for the selection."""
        out = self.select(xlim=xlim, projs=projs, select_projs=True, method=method)
        if return_type is None:
            return out
        return out.flatvalue

    def flat_mask(self, projs=None, xlim=None, method='mid'):
        """Boolean mask into the flat vector for a selection."""
        mask = np.zeros(self.size, dtype=bool)
        slices = self._proj_slices()
        for i in self._index_projs(Ellipsis if projs is None else projs):
            mask[slices[self.projs[i]]] = self._mask(i, xlim, method=method)
        return mask

    # --- IO ---

    def __getstate__(self):
        return {'x': self.x, 'value': self.value, 'projs': self.projs,
                'edges': self.edges, 'weights': self.weights,
                'name': self.name, 'attrs': self.attrs}

    def __setstate__(self, state):
        self.__init__(**state)

    def deepcopy(self):
        import copy
        return copy.deepcopy(self)

    def save(self, filename):
        state = self.__getstate__()
        arrays = {}
        for key in ('x', 'value', 'edges', 'weights'):
            for i, arr in enumerate(state[key]):
                arrays['{}_{:d}'.format(key, i)] = arr
        meta = {'projs': [str(p) for p in state['projs']],
                'projs_repr': json.dumps(state['projs'], default=str),
                'name': state['name'], 'nprojs': len(state['projs']),
                'attrs': {k: v for k, v in state['attrs'].items()
                          if isinstance(v, (int, float, str, bool, list, tuple))}}
        np.savez(str(filename), __meta__=np.array(json.dumps(meta, default=float)), **arrays)

    @classmethod
    def load(cls, filename):
        loaded = np.load(str(filename), allow_pickle=False)
        meta = json.loads(str(loaded['__meta__']))
        nprojs = meta['nprojs']
        try:
            projs = json.loads(meta['projs_repr'])
        except (KeyError, ValueError):
            projs = meta['projs']
        kw = {key: [loaded['{}_{:d}'.format(key, i)] for i in range(nprojs)]
              for key in ('x', 'value', 'edges', 'weights')}
        return cls(projs=projs, name=meta.get('name'), attrs=meta.get('attrs'), **kw)

    def plot(self, xlabel=None, ylabel=None, fn=None, show=False, fig=None):
        from matplotlib import pyplot as plt
        if fig is None:
            fig, ax = plt.subplots()
        else:
            ax = fig.axes[0]
        for proj, xx, vv in zip(self.projs, self.x, self.value):
            ax.plot(xx, vv, marker='.', label=str(proj))
        ax.legend()
        if xlabel:
            ax.set_xlabel(xlabel)
        if ylabel:
            ax.set_ylabel(ylabel)
        if fn:
            fig.savefig(fn, bbox_inches='tight')
        if show:
            plt.show()
        return fig

    def __repr__(self):
        return 'ObservableArray(name={}, projs={}, sizes={})'.format(
            self.name, self.projs, [len(v) for v in self.value])

    def __eq__(self, other):
        return (isinstance(other, ObservableArray) and self.projs == other.projs
                and all(np.array_equal(a, b) for a, b in zip(self.x, other.x))
                and all(np.array_equal(a, b, equal_nan=True) for a, b in zip(self.value, other.value)))


class ObservableCovariance(BaseClass):
    """Covariance matched to a list of ObservableArray layouts.

    Parameters
    ----------
    value : (n, n) array
    observables : (list of) ObservableArray (or their init dicts)
    nobs : int, optional
        Number of observations if estimated from mocks (drives the
        Hartlap 2007 / Percival 2014 factors).
    """

    def __init__(self, value, observables, nobs=None, attrs=None):
        self.value = np.atleast_2d(np.asarray(value, dtype='f8'))
        if not is_sequence(observables):
            observables = [observables]
        self.observables = [o if isinstance(o, ObservableArray) else ObservableArray(**o)
                            for o in observables]
        sizes = sum(o.size for o in self.observables)
        if self.value.shape != (sizes, sizes):
            raise ValueError('covariance shape {} != total observable size {}'.format(
                self.value.shape, sizes))
        self.nobs = int(nobs) if nobs is not None else None
        self.attrs = dict(attrs or {})

    @classmethod
    def from_observations(cls, observations, name=None):
        """Sample covariance from a list of observations.

        Each observation is an ObservableArray, an init dict, or a list of
        those (several observables per observation). Records ``nobs`` for
        the Hartlap/Percival corrections.
        """
        if hasattr(observations, 'items'):
            per_name = list(observations.items())
            nobs = len(per_name[0][1])
            # the dict key is the authoritative observable name (an
            # ObservableArray state always carries a name, possibly '')
            observations = [[{**(obs[i] if isinstance(obs[i], dict)
                                 else obs[i].__getstate__()), 'name': nm}
                             for nm, obs in per_name] for i in range(nobs)]
        obsarrays = []
        for observation in observations:
            if not is_sequence(observation):
                observation = [observation]
            obsarrays.append([o if isinstance(o, ObservableArray) else ObservableArray(**o)
                              for o in observation])
        nobs = len(obsarrays)
        if not nobs:
            raise ValueError('no observations given')
        nobservables = len(obsarrays[0])
        # mean observable layout across observations
        observables = []
        for i in range(nobservables):
            first = obsarrays[0][i]
            value = [np.mean([oa[i].value[j] for oa in obsarrays], axis=0)
                     for j in range(len(first.projs))]
            observables.append(ObservableArray(
                x=first.x, value=value, projs=first.projs, edges=first.edges,
                weights=first.weights, name=first.name, attrs=first.attrs))
        vectors = np.array([np.concatenate([o.flatvalue for o in oa]) for oa in obsarrays])
        cov = np.atleast_2d(np.cov(vectors, rowvar=False, ddof=1))
        return cls(cov, observables=observables, nobs=nobs)

    # --- mock-estimation corrections ---

    def hartlap2007_factor(self):
        """Factor (< 1) to apply to the precision matrix (arXiv:astro-ph/0608064)."""
        if self.nobs is None:
            return 1.
        nbins = self.shape[0]
        if self.nobs <= nbins + 2:
            raise ValueError(
                'Hartlap factor undefined: nobs={:d} <= nbins + 2 = {:d} '
                '(sample covariance of {:d} bins from {:d} mocks is singular '
                'or the correction diverges)'.format(self.nobs, nbins + 2, nbins, self.nobs))
        return (self.nobs - nbins - 2.) / (self.nobs - 1.)

    def percival2014_factor(self, nparams):
        """Factor on the parameter covariance (arXiv:1312.4841)."""
        if self.nobs is None:
            return 1.
        nbins = self.shape[0]
        if self.nobs <= nbins + 4:
            raise ValueError(
                'Percival factor undefined: nobs={:d} <= nbins + 4 = {:d} '
                '(arXiv:1312.4841 eq. 18 diverges in this regime)'.format(
                    self.nobs, nbins + 4))
        a = 2. / (self.nobs - nbins - 1.) / (self.nobs - nbins - 4.)
        b = (self.nobs - nbins - 2.) / (self.nobs - nbins - 1.) / (self.nobs - nbins - 4.)
        return (1 + b * (nbins - nparams)) / (1 + a + b * (nparams + 1))

    # --- indexing ---

    @property
    def shape(self):
        return self.value.shape

    def __array__(self, *args, **kwargs):
        return np.asarray(self.value, *args, **kwargs)

    def _observable_index(self, observables=None):
        """Indices of observables given ints, names (wildcards ok), or arrays."""
        if observables is None:
            return list(range(len(self.observables)))
        if not is_sequence(observables):
            observables = [observables]
        names = [o.name for o in self.observables]
        out = []
        for obs in observables:
            if isinstance(obs, ObservableArray):
                out.append(self.observables.index(obs))
            elif isinstance(obs, str):
                matches = find_names(names, obs)
                if not matches:
                    raise ValueError('observable {} not found in {}'.format(obs, names))
                out += [names.index(m) for m in matches]
            else:
                out.append(int(obs))
        return out

    def _obs_offsets(self):
        offsets, start = [], 0
        for o in self.observables:
            offsets.append(start)
            start += o.size
        return offsets

    def _full_mask(self, observables=None, projs=None, xlim=None, method='mid'):
        idx = self._observable_index(observables)
        mask = np.zeros(self.shape[0], dtype=bool)
        offsets = self._obs_offsets()
        for i in idx:
            o = self.observables[i]
            mask[offsets[i]:offsets[i] + o.size] = o.flat_mask(projs=projs, xlim=xlim, method=method)
        return mask

    def _index(self, observables=None, projs=None, xlim=None, method='mid', concatenate=True):
        mask = self._full_mask(observables=observables, projs=projs, xlim=xlim, method=method)
        idx = np.flatnonzero(mask)
        return idx if concatenate else mask

    # --- transforms ---

    def select(self, xlim=None, projs=None, observables=None, select_observables=False,
               method='mid'):
        """Row/column-dropped covariance for a selection.

        ``xlim``/``projs`` apply to the observables named in ``observables``
        (all by default); other observables are kept whole unless
        ``select_observables`` drops them.
        """
        idx_obs = self._observable_index(observables)
        offsets = self._obs_offsets()
        keep, new_obs = [], []
        for i, o in enumerate(self.observables):
            if i in idx_obs:
                m = o.flat_mask(projs=projs, xlim=xlim, method=method)
                new_obs.append(o.select(xlim=xlim, projs=Ellipsis if projs is None else projs,
                                        select_projs=projs is not None, method=method))
                if projs is not None:
                    m &= o.flat_mask(projs=projs)
            elif select_observables:
                continue
            else:
                m = np.ones(o.size, dtype=bool)
                new_obs.append(o)
            keep.append(np.flatnonzero(m) + offsets[i])
        keep = np.concatenate(keep)
        return ObservableCovariance(self.value[np.ix_(keep, keep)], new_obs,
                                    nobs=self.nobs, attrs=self.attrs)

    def slice(self, slice=None, observables=None, projs=Ellipsis,
              select_observables=False, select_projs=False):
        """Slice/rebin the covariance along given observables/projections:
        each selected observable's bins go through
        :meth:`ObservableArray.slice` and the covariance transforms with the
        matching block-diagonal aggregation matrix, C' = B C B^T."""
        from scipy.linalg import block_diag
        idx_obs = self._observable_index(observables)
        blocks, new_obs = [], []
        for i, o in enumerate(self.observables):
            if i in idx_obs:
                new_obs.append(o.slice(slice, projs=projs, select_projs=select_projs))
                blocks.append(o.slice_matrix(slice, projs=projs, select_projs=select_projs))
            elif select_observables:
                continue
            else:
                new_obs.append(o)
                blocks.append(np.eye(o.size))
        B = block_diag(*blocks)
        return ObservableCovariance(B @ self.value @ B.T, new_obs,
                                    nobs=self.nobs, attrs=self.attrs)

    def xmatch(self, x, observables=None, projs=Ellipsis, method='mid'):
        """Covariance rebinned/sliced so observable coords match target ``x``.

        Only exact masks (offset slices with step 1) are supported for the
        covariance itself when rebinning is needed; rebinning aggregates
        via the weighted slice matrix per observable.
        """
        idx_obs = self._observable_index(observables)
        offsets = self._obs_offsets()
        # Build a block-diagonal aggregation matrix from per-observable slices
        blocks, new_obs = [], []
        for i, o in enumerate(self.observables):
            if i in idx_obs:
                matched = o.xmatch(x, projs=projs, method=method)
                # per-projection mapping from old flat to new flat indices
                block = np.zeros((matched.size, o.size))
                col0 = 0
                row0 = 0
                for j, proj in enumerate(o.projs):
                    xx_old, ww_old = o.x[j], o.weights[j]
                    xx_new, ww_new = matched.x[j], matched.weights[j]
                    # each new bin is the weighted average of old bins whose
                    # edges fall inside the new bin's edges
                    for r in range(len(xx_new)):
                        lo, hi = matched.edges[j][r]
                        sel = (o.edges[j][:, 0] >= lo - 1e-12) & (o.edges[j][:, 1] <= hi + 1e-12)
                        w = ww_old * sel
                        block[row0 + r, col0:col0 + len(xx_old)] = w / w.sum()
                    row0 += len(xx_new)
                    col0 += len(xx_old)
                new_obs.append(matched)
                blocks.append((block, offsets[i], o.size))
            else:
                new_obs.append(o)
                blocks.append((np.eye(o.size), offsets[i], o.size))
        full = np.zeros((sum(b.shape[0] for b, _, _ in blocks), self.shape[0]))
        r0 = 0
        for block, off, size in blocks:
            full[r0:r0 + block.shape[0], off:off + size] = block
            r0 += block.shape[0]
        return ObservableCovariance(full @ self.value @ full.T, new_obs,
                                    nobs=self.nobs, attrs=self.attrs)

    def view(self, observables=None, xlim=None, projs=None, method='mid',
             return_type='nparray'):
        """Sub-matrix for a selection (array or new ObservableCovariance)."""
        out = self.select(xlim=xlim, projs=projs, observables=observables,
                          select_observables=observables is not None, method=method)
        if return_type is None:
            return out
        return out.value

    def marginalize(self, templates, prior=1., observables=None, projs=None, xlim=None):
        """Add ``templates^T prior templates`` to the covariance (analytic
        marginalization over linear template amplitudes)."""
        idx = self._index(observables=observables, projs=projs, xlim=xlim)
        templates = np.atleast_2d(np.asarray(templates, dtype='f8'))
        deriv = np.zeros(templates.shape[:1] + self.shape[:1])
        deriv[..., idx] = templates
        prior = np.asarray(prior, dtype='f8')
        if prior.ndim != 2:
            prior = np.diag(np.broadcast_to(prior, templates.shape[:1]).astype('f8'))
        value = self.value + deriv.T @ prior @ deriv
        return self.clone(value=value)

    def clone(self, value=None, observables=None, attrs=None):
        new = self.copy()
        if value is not None:
            new.value = np.atleast_2d(np.asarray(value, dtype='f8'))
        if observables is not None:
            new.observables = [o if isinstance(o, ObservableArray) else ObservableArray(**o)
                               for o in (observables if is_sequence(observables) else [observables])]
        if attrs is not None:
            new.attrs = dict(attrs)
        return new

    # --- stats ---

    def corrcoef(self):
        d = np.sqrt(np.diag(self.value))
        return self.value / np.outer(d, d)

    def inv(self):
        return np.linalg.inv(self.value)

    def var(self):
        return np.diag(self.value).copy()

    @property
    def std(self):
        return np.sqrt(np.diag(self.value))

    # --- IO ---

    def __getstate__(self):
        return {'value': self.value, 'nobs': self.nobs, 'attrs': self.attrs,
                'observables': [o.__getstate__() for o in self.observables]}

    def __setstate__(self, state):
        self.__init__(state['value'],
                      observables=[ObservableArray(**s) for s in state['observables']],
                      nobs=state.get('nobs'), attrs=state.get('attrs'))

    def deepcopy(self):
        import copy
        return copy.deepcopy(self)

    def save(self, filename):
        arrays = {'value': self.value}
        metas = []
        for iobs, o in enumerate(self.observables):
            state = o.__getstate__()
            for key in ('x', 'value', 'edges', 'weights'):
                for i, arr in enumerate(state[key]):
                    arrays['obs{:d}_{}_{:d}'.format(iobs, key, i)] = arr
            metas.append({'projs_repr': json.dumps(state['projs'], default=str),
                          'name': state['name'], 'nprojs': len(state['projs'])})
        meta = {'nobs': self.nobs, 'observables': metas,
                'attrs': {k: v for k, v in self.attrs.items()
                          if isinstance(v, (int, float, str, bool, list, tuple))}}
        np.savez(str(filename), __meta__=np.array(json.dumps(meta, default=float)), **arrays)

    @classmethod
    def load(cls, filename):
        loaded = np.load(str(filename), allow_pickle=False)
        meta = json.loads(str(loaded['__meta__']))
        observables = []
        for iobs, om in enumerate(meta['observables']):
            kw = {key: [loaded['obs{:d}_{}_{:d}'.format(iobs, key, i)]
                        for i in range(om['nprojs'])]
                  for key in ('x', 'value', 'edges', 'weights')}
            observables.append(ObservableArray(projs=json.loads(om['projs_repr']),
                                               name=om.get('name'), **kw))
        return cls(loaded['value'], observables=observables, nobs=meta.get('nobs'),
                   attrs=meta.get('attrs'))

    def plot(self, corrcoef=True, fn=None, show=False, **kwargs):
        from ..samples.plotting import plot_covariance_matrix
        return plot_covariance_matrix(self.value, corrcoef=corrcoef, fn=fn, show=show, **kwargs)

    def __repr__(self):
        return 'ObservableCovariance(shape={}, observables={})'.format(
            self.value.shape, [o.name or i for i, o in enumerate(self.observables)])

    def __eq__(self, other):
        return (isinstance(other, ObservableCovariance)
                and np.array_equal(self.value, other.value)
                and self.observables == other.observables)
