"""Prior / reference distributions with batched torch ``logpdf``.

Counterpart of ``desilike_tpu/parameters/prior.py``. Draws come from a
``torch.Generator`` (``sample``); ``ppf``, the percent-point function, is
host numpy (the MLP emulator's quasi-random draws) and ``ppf_torch`` its
batched counterpart on a tensor's device (the nested sampler's prior
transform).
"""

import math

import numpy as np
import torch
from scipy import stats

from ..utils import BaseClass
from .. import config


class Prior(BaseClass):
    """Probability distribution with optional limits (truncation).

    Parameters
    ----------
    dist : str, default='uniform'
        Distribution name: 'uniform', 'norm', 'expon', 'loguniform'.
    limits : tuple, default=(-inf, inf)
        Lower/upper truncation limits. For 'uniform', these define the support.
    loc, scale : float
        Location / scale (for 'norm', 'expon').
    """

    def __init__(self, dist='uniform', limits=None, loc=0., scale=1., **kwargs):
        if 'lower' in kwargs or 'upper' in kwargs:
            limits = (kwargs.pop('lower', -np.inf), kwargs.pop('upper', np.inf))
        if kwargs:
            raise ValueError('unrecognized prior arguments {}'.format(kwargs))
        if limits is None:
            limits = (-np.inf, np.inf)
        self.dist = str(dist)
        self.limits = (float(limits[0]), float(limits[1]))
        if self.limits[0] >= self.limits[1]:
            raise ValueError('prior limits must be (lower, upper) with lower < upper, got {}'.format(limits))
        self.loc, self.scale = float(loc), float(scale)
        if self.dist == 'uniform' and np.isfinite(self.limits).all():
            self.loc = self.limits[0]
            self.scale = self.limits[1] - self.limits[0]
        self._setup()

    def _setup(self):
        lo, hi = self.limits
        if self.dist == 'uniform':
            if not np.isfinite([lo, hi]).all():
                self._lognorm = 0.  # improper flat prior
            else:
                self._lognorm = -np.log(hi - lo)
        elif self.dist == 'norm':
            a, b = (lo - self.loc) / self.scale, (hi - self.loc) / self.scale
            cdf = stats.norm.cdf(b) - stats.norm.cdf(a)
            self._lognorm = -0.5 * np.log(2 * np.pi) - np.log(self.scale) - np.log(cdf)
        elif self.dist == 'expon':
            self._lognorm = -np.log(self.scale)
        elif self.dist == 'loguniform':
            if not (lo > 0 and np.isfinite(hi)):
                raise ValueError('loguniform needs finite positive limits')
            self._lognorm = -np.log(np.log(hi / lo))
        else:
            raise ValueError('unknown distribution {}'.format(self.dist))

    @property
    def is_proper(self):
        """Whether the prior integrates to 1 (finite support or proper dist)."""
        return self.dist != 'uniform' or np.isfinite(self.limits).all()

    @property
    def is_limited(self):
        return np.isfinite(self.limits).any()

    def isin(self, x):
        """Whether x (a tensor, an array or a number) lies within the limits."""
        return (x >= self.limits[0]) & (x <= self.limits[1])

    def affine_transform(self, loc=0., scale=1.):
        """Return the prior of y = loc + scale * x."""
        limits = tuple(loc + scale * lim for lim in self.limits)
        if scale < 0:
            limits = limits[::-1]
        return Prior(dist=self.dist, limits=limits, loc=loc + scale * self.loc,
                     scale=abs(scale) * self.scale)

    def logpdf(self, x):
        """Log density at the tensor x (any shape); -inf outside limits."""
        x = torch.as_tensor(x)
        lo, hi = self.limits
        if self.dist == 'uniform':
            core = torch.zeros_like(x) + self._lognorm
        elif self.dist == 'norm':
            core = -0.5 * ((x - self.loc) / self.scale) ** 2 + self._lognorm
        elif self.dist == 'expon':
            core = -(x - self.loc) / self.scale + self._lognorm
        else:  # loguniform
            core = -torch.log(x) + self._lognorm
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, core, torch.full_like(core, -np.inf))

    def sample(self, generator, shape=(), device=None, dtype=None):
        """Draws of shape ``shape`` from ``generator`` (a ``torch.Generator``,
        whose device the draws are made on unless ``device`` is given), in
        ``dtype`` (default: the compute dtype). A normal truncated at finite
        limits is drawn by the inverse error function within +-10 sigma, as
        ``jax.random.truncated_normal`` does."""
        device = generator.device if device is None else torch.device(device)
        dtype = config.get_dtype() if dtype is None else dtype
        shape = tuple(shape) if isinstance(shape, (tuple, list)) else (int(shape),)
        lo, hi = self.limits

        def uniform():
            return torch.rand(shape, generator=generator, device=device, dtype=dtype)

        if self.dist == 'uniform':
            if not np.isfinite([lo, hi]).all():
                raise ValueError('cannot sample improper uniform prior')
            return lo + (hi - lo) * uniform()
        if self.dist == 'norm':
            if np.isfinite([lo, hi]).any():
                a = max((lo - self.loc) / self.scale, -10.)
                b = min((hi - self.loc) / self.scale, 10.)
                ea, eb = (math.erf(v / math.sqrt(2.)) for v in (a, b))
                z = np.sqrt(2.) * torch.special.erfinv(ea + (eb - ea) * uniform())
                return self.loc + self.scale * z.clamp(a, b)
            return self.loc + self.scale * torch.randn(shape, generator=generator, device=device, dtype=dtype)
        if self.dist == 'expon':
            return self.loc - self.scale * torch.log1p(-uniform())
        if self.dist == 'loguniform':
            return lo * (hi / lo) ** uniform()
        raise ValueError(self.dist)

    def ppf(self, u):
        """Percent-point function at ``u`` in [0, 1], host numpy (float64),
        the distribution truncated at its limits."""
        u = np.asarray(u)
        lo, hi = self.limits
        if self.dist == 'uniform':
            return lo + (hi - lo) * u
        if self.dist == 'norm':
            a, b = (lo - self.loc) / self.scale, (hi - self.loc) / self.scale
            return stats.truncnorm.ppf(u, a, b, loc=self.loc, scale=self.scale)
        if self.dist == 'expon':
            a = stats.expon.cdf(lo, loc=self.loc, scale=self.scale) if np.isfinite(lo) else 0.
            b = stats.expon.cdf(hi, loc=self.loc, scale=self.scale) if np.isfinite(hi) else 1.
            return stats.expon.ppf(a + (b - a) * u, loc=self.loc, scale=self.scale)
        if self.dist == 'loguniform':
            return lo * (hi / lo) ** u
        raise ValueError(self.dist)

    def ppf_torch(self, u):
        """Percent-point function of the tensor ``u``, on its device and in
        its dtype: the nested sampler's prior transform. The truncation
        constants are folded on the host with scipy. In float32 the clip at
        1 - 1e-15 rounds to 1 (as in the JAX package, ``ppf_jax``), where
        ``ndtri`` is inf: u of exactly 1 maps there."""
        lo, hi = self.limits
        if self.dist == 'uniform':
            if not np.isfinite([lo, hi]).all():
                raise ValueError('cannot prior-transform an improper uniform prior')
            return lo + (hi - lo) * u
        if self.dist == 'norm':
            a = stats.norm.cdf((lo - self.loc) / self.scale)
            b = stats.norm.cdf((hi - self.loc) / self.scale)
            up = torch.clamp(a + (b - a) * u, 1e-15, 1. - 1e-15)
            return self.loc + self.scale * torch.special.ndtri(up)
        if self.dist == 'expon':
            a = stats.expon.cdf(lo, loc=self.loc, scale=self.scale) if np.isfinite(lo) else 0.
            b = stats.expon.cdf(hi, loc=self.loc, scale=self.scale) if np.isfinite(hi) else 1.
            up = a + (b - a) * u
            return self.loc - self.scale * torch.log1p(-torch.clamp(up, 0., 1. - 1e-15))
        if self.dist == 'loguniform':
            return lo * (hi / lo) ** u
        raise ValueError(self.dist)

    @property
    def std(self):
        """Standard deviation (used for default proposals / deltas)."""
        if self.dist == 'uniform':
            if np.isfinite(self.limits).all():
                return (self.limits[1] - self.limits[0]) / np.sqrt(12.)
            return np.inf
        if self.dist in ('norm', 'expon'):
            return self.scale
        return float(stats.loguniform(*self.limits).std())

    @property
    def center(self):
        """A central value (loc, or middle of limits)."""
        if self.dist == 'norm' or self.dist == 'expon':
            return self.loc
        if np.isfinite(self.limits).all():
            if self.dist == 'loguniform':
                return float(np.sqrt(self.limits[0] * self.limits[1]))
            return 0.5 * (self.limits[0] + self.limits[1])
        return 0.

    def __repr__(self):
        if self.dist == 'uniform':
            return 'Prior(uniform, limits={})'.format(self.limits)
        base = 'Prior({}, loc={:g}, scale={:g}'.format(self.dist, self.loc, self.scale)
        if self.is_limited:
            base += ', limits={}'.format(self.limits)
        return base + ')'

    def __eq__(self, other):
        return (isinstance(other, Prior) and self.dist == other.dist
                and self.limits == other.limits and self.loc == other.loc
                and self.scale == other.scale)

    def __getstate__(self):
        return {'dist': self.dist, 'limits': self.limits, 'loc': self.loc, 'scale': self.scale}

    def __setstate__(self, state):
        self.__init__(**state)

    @classmethod
    def from_config(cls, config):
        """Build from a dict ({'dist': 'norm', 'loc': 0, ...}), tuple (limits) or Prior."""
        if isinstance(config, Prior):
            return config
        if config is None:
            return cls()
        if isinstance(config, (tuple, list)):
            return cls(limits=tuple(config))
        return cls(**dict(config))
