"""Profiles container: best fits, parabolic errors, intervals, 1D/2D profiles.

Counterpart of ``desilike_tpu/samples/profiles.py`` (the reference's
samples/profiles.py:508), numpy on the host, with files in the JAX
package's ``.npz`` layout. ``to_getdist`` waits for ROADMAP A17.
"""

import numpy as np

from ..utils import BaseClass, is_sequence
from ..parameters import ParameterCollection, Samples


class ParameterBestFit(Samples):
    """Best-fit container: :class:`Samples` with a log-posterior column
    (reference profiles.py:15). One row per optimization start."""

    @property
    def logposterior(self):
        return np.atleast_1d(np.asarray(self['logposterior']))

    def argmax(self):
        return int(np.argmax(self.logposterior))

    def choice(self, index='argmax', params=None, return_type='dict'):
        """Parameter values at the chosen start (default: highest
        log-posterior). return_type 'dict' or 'nparray'."""
        i = self.argmax() if isinstance(index, str) else int(index)
        names = ([getattr(p, 'name', p) for p in params] if params is not None
                 else self.names())
        di = {n: float(np.atleast_1d(np.asarray(self[n]))[i]) for n in names}
        if return_type == 'nparray':
            return np.array(list(di.values()))
        return di


class ParameterProfiles(dict):
    """1D profile scans: name -> (values, chi2) (reference profiles.py:445 —
    there a Samples of (x, logposterior) columns; here the dict of per-name
    scan arrays the profilers produce, with the same ``choice`` access)."""

    def choice(self, params=None, return_type='dict'):
        """Per-parameter profile minimum (the 1D best fit)."""
        names = ([getattr(p, 'name', p) for p in params] if params is not None
                 else list(self))
        di = {}
        for n in names:
            x, chi2 = self[n]
            di[n] = float(np.asarray(x)[int(np.argmin(np.asarray(chi2)))])
        if return_type == 'nparray':
            return np.array(list(di.values()))
        return di

    def interpolate(self, size=100):
        """Densified scans by cubic interpolation (reference
        ParameterContours.interpolate counterpart for 1D profiles)."""
        new = ParameterProfiles()
        for n, (x, chi2) in self.items():
            x, chi2 = np.asarray(x), np.asarray(chi2)
            xs = np.linspace(x[0], x[-1], int(size))
            try:
                from scipy.interpolate import CubicSpline
                new[n] = (xs, CubicSpline(x, chi2)(xs))
            except ImportError:
                new[n] = (xs, np.interp(xs, x, chi2))
        return new


class ParameterGrid(dict):
    """nD chi2 grid scans: name or (names) -> (points, chi2) (reference
    profiles.py:503 ParameterGrid). ``choice`` returns the grid minimum."""

    def choice(self, key=None):
        """(point, chi2) at the grid minimum for ``key`` (default: the sole
        entry)."""
        if key is None:
            if len(self) != 1:
                raise ValueError('specify which grid: {}'.format(list(self)))
            key = next(iter(self))
        pts, chi2 = self[key]
        i = int(np.argmin(np.asarray(chi2).ravel()))
        pts = np.asarray(pts)
        return (pts.reshape(-1, pts.shape[-1])[i] if pts.ndim > 1 else pts.ravel()[i],
                float(np.asarray(chi2).ravel()[i]))


class ParameterContours(dict):
    """2D contour results keyed (name1, name2) (reference profiles.py:368 —
    there keyed by confidence level; here by parameter pair, each entry
    holding {'paths': {cl: [segments]}, 'grid': (g1, g2, chi2)}). ``paths``
    normalizes any stored form; ``levels`` lists the confidence levels."""

    def paths(self, pair):
        """{cl: [(x, y), ...]} contour path segments, whichever of the
        stored forms (flat legacy dict, single-tuple levels, {'paths': ...})
        is present."""
        entry = self[tuple(pair)]
        if isinstance(entry, dict) and ('paths' in entry or 'grid' in entry):
            entry = entry.get('paths', {})
        return {cl: ([segs] if isinstance(segs, tuple) else list(segs))
                for cl, segs in entry.items()}

    def levels(self, pair):
        return sorted(self.paths(pair))


class Profiles(BaseClass):
    """Holds profiling results.

    Attributes
    ----------
    bestfit : Samples
        Best-fit parameter values (+ 'logposterior'), one row per start.
    error : dict name -> float
        Parabolic errors from the inverse hessian.
    covariance : (ndim, ndim) array
    interval : dict name -> (lo, hi)
        Delta-chi2 = 1 likelihood intervals.
    profile : dict name -> (values, chi2)
        1D profile scans.
    contour : dict (name1, name2) -> {'paths': {cl: [(x, y), ...]}, 'grid': (g1, g2, chi2)}
        2D contour results; each confidence level holds a LIST of disjoint
        path segments. The legacy forms (flat dict, single (x, y) tuple per
        level) are accepted on write and normalized by save/load. Use
        :meth:`contour_paths` to read any stored form (always returns the
        list-of-segments form).
    grid : dict name or (names) -> (points, chi2)
        nD chi2 grid scans.
    """

    def __init__(self, params=None, attrs=None):
        self.attrs = dict(attrs or {})
        self.params = ParameterCollection(params)
        self.bestfit = ParameterBestFit()
        self.error = {}
        self.covariance = None
        self.interval = {}
        self.profile = ParameterProfiles()
        self.contour = ParameterContours()
        self.grid = ParameterGrid()

    _container_names = ('bestfit', 'error', 'covariance', 'interval', 'profile',
                        'contour', 'grid')

    def get(self, name, *default):
        """Access a result container by name (reference profiles.py get)."""
        return getattr(self, name, *default)

    def set(self, name, item=None, **kwargs):
        """Set a result container by name (reference profiles.py set);
        ``set(bestfit=...)`` keyword form also accepted."""
        if name is not None and item is not None:
            setattr(self, str(name), item)
        for key, value in kwargs.items():
            setattr(self, key, value)

    def items(self):
        """(name, container) pairs of the populated results (reference
        profiles.py items)."""
        return [(name, getattr(self, name)) for name in self._container_names
                if getattr(self, name, None) is not None]

    def clone(self, **kwargs):
        """Copy with container overrides."""
        import copy
        new = copy.deepcopy(self)
        for key, value in kwargs.items():
            setattr(new, key, value)
        return new

    @property
    def start_size(self):
        return self.bestfit.shape[0] if self.bestfit.shape else 0

    def _bestfit_typed(self):
        """View of ``bestfit`` as :class:`ParameterBestFit` (users may assign
        a plain :class:`Samples`)."""
        bf = self.bestfit
        if isinstance(bf, ParameterBestFit):
            return bf
        return ParameterBestFit(data={name: bf[name] for name in bf.names()},
                                params=bf.params, attrs=bf.attrs)

    def argmax(self):
        return self._bestfit_typed().argmax()

    def choice(self, index='argmax'):
        """Best single start as a dict name -> value."""
        return self._bestfit_typed().choice(index=index)

    def contour_paths(self, pair):
        """{cl: [(x, y), ...]} contour path segments for a parameter pair,
        whichever of the stored forms (flat legacy dict, single-tuple
        levels, or {'paths': ...}) is present."""
        return ParameterContours(self.contour).paths(pair)

    def update(self, other):
        """Merge another Profiles' results (non-empty fields win)."""
        if other.bestfit.names():
            self.bestfit = other.bestfit
        self.error.update(other.error)
        self.interval.update(other.interval)
        self.profile.update(other.profile)
        self.contour.update(other.contour)
        self.grid.update(getattr(other, 'grid', {}))
        if other.covariance is not None:
            self.covariance = other.covariance
        self.attrs.update(other.attrs)
        return self

    @classmethod
    def concatenate(cls, *others):
        """Stack bestfit rows (multi-start runs); other fields from the
        first (reference profiles.py:635)."""
        if len(others) == 1 and is_sequence(others[0]):
            others = list(others[0])
        new = others[0].deepcopy()
        for name in new.bestfit.names():
            new.bestfit[name] = np.concatenate(
                [np.atleast_1d(np.asarray(o.bestfit[name])) for o in others])
        return new

    def extend(self, other):
        """In-place concatenate."""
        self.__dict__.update(self.concatenate(self, other).__dict__)

    def deepcopy(self):
        import copy
        return copy.deepcopy(self)

    def to_fisher(self, params=None):
        """LikelihoodFisher at the best fit from the parabolic covariance
        (reference profiles.py:700)."""
        from ..fisher import LikelihoodFisher
        if self.covariance is None:
            raise ValueError('no covariance stored; run maximize with hessian')
        names = [n for n in self.bestfit.names() if n != 'logposterior']
        best = self.choice()
        center = np.array([best[n] for n in names])
        hessian = -np.linalg.inv(np.atleast_2d(self.covariance))
        # per-name fallback keeps params aligned with center/hessian rows
        # even when bestfit carries names absent from self.params
        plist = [self.params[n] if n in self.params.names() else n for n in names]
        fisher = LikelihoodFisher(center=center, params=plist, hessian=hessian)
        if params is not None:
            keep = [getattr(p, 'name', p) for p in params]
            fisher = fisher.marginalize([n for n in names if n not in keep])
        return fisher

    def to_getdist(self, label=None):
        """getdist export: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    def to_stats(self, tablefmt='plain'):
        """Summary table; tablefmt 'plain' or 'latex' (reference
        profiles.py to_stats tablefmt option)."""
        best = self.choice()
        names = [n for n in self.bestfit.names() if n != 'logposterior']
        if tablefmt == 'latex':
            lines = [r'\begin{tabular}{lccc}',
                     r'parameter & bestfit & error & interval \\ \hline']
            for name in names:
                p = self.params[name] if name in self.params else None
                latex = '$' + p.latex + '$' if p is not None and p.latex else name
                err = self.error.get(name, float('nan'))
                iv = self.interval.get(name)
                ivs = '$[{:.4g}, {:.4g}]$'.format(*iv) if iv else '-'
                lines.append(r'{} & ${:.6g}$ & ${:.4g}$ & {} \\'.format(latex, best[name], err, ivs))
            lines.append(r'\end{tabular}')
            return '\n'.join(lines)
        lines = ['{:<24s} {:>14s} {:>14s} {:>26s}'.format('parameter', 'bestfit', 'error', 'interval')]
        for name in names:
            err = self.error.get(name, float('nan'))
            iv = self.interval.get(name)
            ivs = '[{:.6g}, {:.6g}]'.format(*iv) if iv else '-'
            lines.append('{:<24s} {:>14.6g} {:>14.6g} {:>26s}'.format(name, best[name], err, ivs))
        lines.append('logposterior = {:.6g}'.format(best['logposterior']))
        return '\n'.join(lines)

    # --- IO (npz state, same conventions as Samples.save) ---

    def save(self, filename):
        import json
        arrays = {'bestfit:' + name: np.asarray(self.bestfit[name]) for name in self.bestfit.names()}
        for name, (x, chi2) in self.profile.items():
            arrays['profile:' + name] = np.stack([np.asarray(x), np.asarray(chi2)])
        for (n1, n2), entry in self.contour.items():
            if isinstance(entry, dict) and ('grid' in entry or 'paths' in entry):
                if 'grid' in entry:
                    g1, g2, chi2 = entry['grid']
                    arrays['contourgrid:{}:{}:0'.format(n1, n2)] = np.asarray(g1)
                    arrays['contourgrid:{}:{}:1'.format(n1, n2)] = np.asarray(g2)
                    arrays['contourgrid:{}:{}:chi2'.format(n1, n2)] = np.asarray(chi2)
                entry = entry.get('paths', {})
            for cl, segs in entry.items():
                if isinstance(segs, tuple):  # legacy single-path form
                    segs = [segs]
                for iseg, (x, y) in enumerate(segs):
                    arrays['contour:{}:{}:{}:{}'.format(n1, n2, cl, iseg)] = \
                        np.stack([np.asarray(x), np.asarray(y)])
        for name, (pts, chi2) in self.grid.items():
            key = name if isinstance(name, str) else ':'.join(name)
            arrays['grid:' + key] = np.asarray(pts)
            arrays['gridchi2:' + key] = np.asarray(chi2)
        if self.covariance is not None:
            arrays['covariance'] = np.asarray(self.covariance)
        meta = {'params': self.params.__getstate__(),
                'error': {k: float(v) for k, v in self.error.items()},
                'interval': {k: [float(v[0]), float(v[1])] for k, v in self.interval.items()},
                'attrs': {k: v for k, v in self.attrs.items() if isinstance(v, (int, float, str, bool, list, tuple))}}
        arrays['__meta__'] = np.array(json.dumps(meta, default=float))
        np.savez(str(filename), **arrays)

    @classmethod
    def load(cls, filename):
        import json
        from ..parameters import Parameter
        loaded = np.load(str(filename), allow_pickle=False)
        meta = json.loads(str(loaded['__meta__']))
        new = cls([Parameter(**s) for s in meta['params']['params']])
        new.error = dict(meta.get('error', {}))
        new.interval = {k: tuple(v) for k, v in meta.get('interval', {}).items()}
        new.attrs = meta.get('attrs', {})
        for key in loaded.files:
            if key.startswith('bestfit:'):
                new.bestfit[key[8:]] = loaded[key]
            elif key.startswith('profile:'):
                new.profile[key[8:]] = (loaded[key][0], loaded[key][1])
            elif key.startswith('contour:'):
                parts = key.split(':')
                if len(parts) == 5:
                    _, n1, n2, cl, iseg = parts
                else:  # legacy single-segment key
                    (_, n1, n2, cl), iseg = parts, 0
                entry = new.contour.setdefault((n1, n2), {'paths': {}})
                segs = entry.setdefault('paths', {}).setdefault(float(cl), [])
                segs.insert(min(int(iseg), len(segs)), (loaded[key][0], loaded[key][1]))
            elif key.startswith('contourgrid:'):
                _, n1, n2, part = key.split(':')
                entry = new.contour.setdefault((n1, n2), {'paths': {}})
                g = entry.setdefault('grid', [None, None, None])
                g[{'0': 0, '1': 1, 'chi2': 2}[part]] = loaded[key]
            elif key.startswith('grid:'):
                name = key[5:]
                name = name if ':' not in name else tuple(name.split(':'))
                new.grid[name] = (loaded[key], loaded['gridchi2:' + (name if isinstance(name, str) else ':'.join(name))])
            elif key.startswith('gridchi2:'):
                pass
            elif key == 'covariance':
                new.covariance = loaded[key]
        return new
