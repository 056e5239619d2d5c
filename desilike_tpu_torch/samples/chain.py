"""Chain container: weighted posterior samples with statistics.

Counterpart of ``desilike_tpu/samples/chain.py`` (the reference's
samples/chain.py:79), numpy on the host. Shape convention: (nsteps,
nchains) leading axes (or flat (nsamples,)). The getdist readers and
writers wait for ROADMAP A17.
"""

import numpy as np

from ..parameters import Samples, Parameter
from . import diagnostics


class Chain(Samples):
    """Weighted samples. Reserved columns: 'logposterior', 'loglikelihood',
    'logprior', 'aweight' (importance weight), 'fweight' (integer repeats)."""

    _reserved = ('logposterior', 'loglikelihood', 'logprior', 'aweight', 'fweight')

    def __init__(self, data=None, params=None, logposterior=None, loglikelihood=None,
                 logprior=None, aweight=None, fweight=None, weight=None, attrs=None):
        """``logposterior``/``loglikelihood``/``logprior``/``aweight``/``fweight``
        optionally give the NAMES those columns carry in ``data`` (reference
        chain.py:99 convention); they are renamed to the canonical reserved
        names here. ``weight`` names a total-weight column, mapped to
        ``aweight`` (weight = aweight * fweight, fweight defaulting to 1)."""
        super().__init__(data=data, params=params, attrs=attrs)
        renames = {'logposterior': logposterior, 'loglikelihood': loglikelihood,
                   'logprior': logprior, 'aweight': aweight, 'fweight': fweight}
        if weight is not None:
            renames.setdefault('aweight', None)
            if str(weight) in self.data and 'aweight' not in self.data:
                renames['aweight'] = str(weight)
        for canonical, given in renames.items():
            if given is not None and str(given) != canonical and str(given) in self.data:
                self[canonical] = self.data.pop(str(given))
                if str(given) in self.params:
                    del self.params[str(given)]

    @property
    def weight(self):
        w = np.ones(self.shape)
        if 'aweight' in self:
            w = w * np.asarray(self['aweight'])
        if 'fweight' in self:
            w = w * np.asarray(self['fweight'])
        return w

    # reserved-column accessors (reference chain.py:154-192): reading creates
    # the default column so downstream code can rely on its presence
    @property
    def aweight(self):
        if 'aweight' not in self.data:
            self['aweight'] = np.ones(self.shape, dtype='f8')
        return self.data['aweight']

    @aweight.setter
    def aweight(self, item):
        self['aweight'] = np.asarray(item, dtype='f8')

    @property
    def fweight(self):
        if 'fweight' not in self.data:
            self['fweight'] = np.ones(self.shape, dtype='i8')
        return self.data['fweight']

    @fweight.setter
    def fweight(self, item):
        self['fweight'] = np.asarray(item)

    @property
    def logposterior(self):
        if 'logposterior' not in self.data:
            self['logposterior'] = np.zeros(self.shape, dtype='f8')
        return self.data['logposterior']

    @logposterior.setter
    def logposterior(self, item):
        self['logposterior'] = np.asarray(item, dtype='f8')

    def set_derived(self, basename, array, **kwargs):
        """Add a derived-parameter column (reference chain.py:194)."""
        self[Parameter(basename=str(basename), derived=True, **kwargs)] = np.asarray(array)

    def points(self, params=None):
        """(nsamples, ndim) array of flattened samples for given params."""
        params = params or [p.name for p in self.params if p.name not in self._reserved]
        names = [getattr(p, 'name', p) for p in params]
        return np.column_stack([np.asarray(self[n]).reshape(-1) for n in names]), names

    def remove_burnin(self, burnin=0.5):
        """Drop the first fraction (if <1) or number of steps (reference chain.py:210)."""
        nsteps = self.shape[0]
        start = int(burnin * nsteps) if burnin < 1 else int(burnin)
        new = self.copy()
        new.data = {}
        for name, value in self.data.items():
            new.data[name] = np.asarray(value)[start:]
        return new

    def _param_list(self, params):
        if params is None:
            return [p.name for p in self.params if p.name not in self._reserved]
        return list(params)

    def mean(self, param=None):
        """Weighted mean; a single name returns a scalar, None/a list returns
        an array over params (reference chain.py:746)."""
        if param is None or isinstance(param, (list, tuple)):
            return np.array([self.mean(p) for p in self._param_list(param)])
        x = np.asarray(self[param]).reshape(-1)
        return np.average(x, weights=self.weight.reshape(-1))

    def std(self, param=None, ddof=1):
        """Weighted standard deviation (reference chain.py:737; defaults to
        ddof=1 like the reference, the numpy.cov fweights/aweights
        convention)."""
        return np.sqrt(self.var(param, ddof=ddof))

    def var(self, param=None, ddof=1):
        """Weighted variance (reference chain.py:726). ``ddof`` is honored
        through the same np.cov path as :meth:`covariance`."""
        if param is None or isinstance(param, (list, tuple)):
            return np.array([self.var(p, ddof=ddof) for p in self._param_list(param)])
        return float(self.covariance([param], ddof=ddof)[0, 0])

    def median(self, param=None):
        """Weighted median (reference chain.py:761)."""
        if param is None or isinstance(param, (list, tuple)):
            return np.array([self.median(p) for p in self._param_list(param)])
        return float(self.quantile(param, q=0.5)[0])

    def argmax(self, param=None):
        """Parameter value(s) at the maximum log-posterior sample
        (reference chain.py:754)."""
        idx = int(np.argmax(np.asarray(self.logposterior).reshape(-1)))
        if param is None or isinstance(param, (list, tuple)):
            return np.array([np.asarray(self[p]).reshape(-1)[idx] for p in self._param_list(param)])
        return np.asarray(self[param]).reshape(-1)[idx]

    def choice(self, index='mean', params=None, return_type='dict'):
        """Mean ('mean') or max-posterior ('argmax') point
        (reference chain.py:618)."""
        names = self._param_list(params)
        if index == 'mean':
            values = [self.mean(p) for p in names]
        elif index == 'argmax':
            values = list(self.argmax(names))
        else:
            values = [np.asarray(self[p]).reshape(-1)[index] for p in names]
        if return_type == 'dict':
            return dict(zip([getattr(p, 'name', p) for p in names], values))
        return np.array(values)

    def covariance(self, params=None, ddof=1):
        pts, names = self.points(params)
        return np.atleast_2d(np.cov(pts, rowvar=False, aweights=self.weight.reshape(-1), ddof=ddof))

    def corrcoef(self, params=None):
        """Correlation matrix of the weighted samples (reference chain.py:722)."""
        cov = np.atleast_2d(self.covariance(params))
        std = np.sqrt(np.diag(cov))
        return cov / std[:, None] / std[None, :]

    def precision(self, params=None):
        """Inverse covariance of the weighted samples (reference chain.py:699)."""
        return np.linalg.inv(np.atleast_2d(self.covariance(params)))

    def quantile(self, param, q=(0.16, 0.84)):
        x = np.asarray(self[param]).reshape(-1)
        w = self.weight.reshape(-1)
        order = np.argsort(x)
        cdf = np.cumsum(w[order])
        cdf = cdf / cdf[-1]
        return np.interp(np.atleast_1d(q), cdf, x[order])

    def interval(self, param, cl=0.68):
        """Highest-density interval via the shortest window on sorted samples."""
        x = np.sort(np.asarray(self[param]).reshape(-1))
        n = len(x)
        m = max(int(np.floor(cl * n)), 1)
        widths = x[m:] - x[:n - m]
        i = int(np.argmin(widths))
        return x[i], x[i + m]

    # --- multi-chain diagnostics (axis 1 = chain) ---

    def _per_chain(self, name):
        arr = np.asarray(self[name])
        if arr.ndim == 1:
            return arr[None, :]
        return np.moveaxis(arr, 1, 0).reshape(arr.shape[1], -1)

    def gelman_rubin(self, params=None, method='diag'):
        params = params or [p.name for p in self.params if p.name not in self._reserved]
        chains = np.stack([self._per_chain(getattr(p, 'name', p)) for p in params], axis=-1)
        chains = np.moveaxis(chains, 0, 0)  # (nchains, nsteps, ndim)
        return diagnostics.gelman_rubin(chains, method=method)

    def effective_sample_size(self, param):
        return diagnostics.effective_sample_size(self._per_chain(getattr(param, 'name', param)))

    def geweke(self, param):
        return diagnostics.geweke(self._per_chain(getattr(param, 'name', param)))

    # --- sample_solved: re-draw analytically-marginalized params ---

    def sample_solved(self, seed=42):
        """Draw solved ('.marg') parameters back into the chain using the
        stored posterior hessian (reference chain.py:229): for each sample,
        x_solved ~ N(x_best, (-H)^{-1})."""
        if 'solved_hessian' not in self.attrs:
            return self
        H = np.asarray(self.attrs['solved_hessian'])
        names = list(self.attrs.get('solved_names', []))
        if not names:
            return self
        rng = np.random.default_rng(seed)
        new = self.copy()
        flatshape = (-1,)
        nsamp = int(np.prod(self.shape))
        means = np.column_stack([np.asarray(self[n]).reshape(-1) for n in names])
        if H.ndim == 2:
            cov = np.linalg.inv(-H)
            draws = rng.multivariate_normal(np.zeros(len(names)), cov, size=nsamp)
        else:
            covs = np.linalg.inv(-H.reshape(nsamp, len(names), len(names)))
            chol = np.linalg.cholesky(covs)
            draws = np.einsum('nij,nj->ni', chol, rng.normal(size=(nsamp, len(names))))
        for i, n in enumerate(names):
            new[n] = (means[:, i] + draws[:, i]).reshape(self.shape)
        return new

    def to_fisher(self, params=None):
        """Gaussian approximation of the chain's posterior as a
        LikelihoodFisher: the weighted mean and the inverse of the weighted
        covariance."""
        from ..fisher import LikelihoodFisher
        pts, names = self.points(params)
        w = self.weight.reshape(-1)
        mean = np.average(pts, axis=0, weights=w)
        cov = np.cov(pts, rowvar=False, aweights=w)
        hessian = -np.linalg.inv(np.atleast_2d(cov))
        return LikelihoodFisher(mean, [self.params[n] if n in self.params else n for n in names], hessian)

    @classmethod
    def from_getdist(cls, base_fn):
        """getdist-format reader: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    @classmethod
    def read_getdist(cls, base_fn, ichains=None, concatenate=False):
        """getdist-format reader: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    def to_stats(self, params=None, cl=0.68, **kwargs):
        """Reference chain.py:926 name for the stats table."""
        return self.to_stats_table(params=params, cl=cl)

    # --- export ---

    def to_getdist(self, params=None, label=None):
        """getdist export: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    def write_getdist(self, base_fn, params=None):
        """getdist-format writer: ROADMAP A17."""
        raise NotImplementedError('the getdist readers and writers are ROADMAP A17')

    def to_stats_table(self, params=None, cl=0.68):
        """Simple text stats table: mean +/- std and HDI."""
        params = params or [p.name for p in self.params if p.name not in self._reserved]
        lines = ['{:<20s} {:>12s} {:>12s} {:>24s}'.format('parameter', 'mean', 'std', 'interval')]
        for p in params:
            name = getattr(p, 'name', p)
            lo, hi = self.interval(name, cl=cl)
            lines.append('{:<20s} {:>12.5g} {:>12.5g} {:>24s}'.format(
                name, self.mean(name), self.std(name), '[{:.5g}, {:.5g}]'.format(lo, hi)))
        return '\n'.join(lines)
