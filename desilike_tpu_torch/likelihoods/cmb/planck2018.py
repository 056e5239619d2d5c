"""Planck 2018 python likelihoods: plik-lite high-ell + commander/simall low-ell.

Counterpart of ``desilike_tpu/likelihoods/cmb/planck2018.py`` (clik-free
reimplementations), per chain:

- plik-lite binning is a precomputed dense (nbins, ellmax+1) matrix per
  spectrum: one product each per evaluation;
- the commander TT low-ell Gibbs posterior (the per-ell change of variable
  x(C_ell)) and the simall EE probability table are piecewise-linear lookups
  (``jnp.interp`` in the JAX package): one ``searchsorted`` over every
  (chain, ell) pair, then one lerp;
- data come from the real clik distribution files (``data_dir=``, the same
  layout as the JAX package's readers) or as arrays (``data=``).

The calibration parameter A_planck carries the standard Planck prior
N(1, 0.0025). Without ``data=`` or ``data_dir=``, the data directory is
looked up through the installer (:func:`...install.installed_data_dir`).
"""

import os

import numpy as np
import torch

from ...install import installed_data_dir
from ..base import BaseLikelihood, BaseGaussianLikelihood
from .base import request_cls


_CALIB_PARAMS = {'A_planck': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.0025),
                                  ref=dict(dist='norm', loc=1., scale=0.002),
                                  proposal=0.0005, latex=r'y_\mathrm{cal}')}


def interp_rows(x, grid, values, outside=None):
    """``jnp.interp`` of each column of ``x`` (..., n) on its own row of
    ``grid`` and ``values`` (n, ngrid), or on one shared ``grid`` (ngrid,):
    piecewise linear, the edge values outside the grid (or ``outside``
    there, if given)."""
    shared = grid.ndim == 1
    xt = x.movedim(-1, 0).reshape(x.shape[-1], -1)  # (n, batch)
    idx = torch.searchsorted(grid if shared else grid.contiguous(), xt.contiguous(), right=True) - 1
    idx = idx.clamp(0, grid.shape[-1] - 2)
    lo, hi = (grid[idx], grid[idx + 1]) if shared else (grid.gather(1, idx), grid.gather(1, idx + 1))
    t = ((xt - lo) / (hi - lo)).clamp(0., 1.)
    rows = torch.arange(xt.shape[0], device=x.device)[:, None]
    out = torch.lerp(values[rows, idx], values[rows, idx + 1], t)
    if outside is not None:
        out = torch.where((xt < grid[..., :1]) | (xt > grid[..., -1:]), torch.full_like(out, outside), out)
    return out.reshape(x.shape[-1:] + x.shape[:-1]).movedim(0, -1)


class BasePlanck2018Likelihood(BaseLikelihood):
    """Shared machinery: ClTheory wiring in muK^2 units."""

    def _set_theory(self, theory, requested_cls):
        if theory is None:
            raise ValueError('pass theory=ClTheory(tables=...): C_ell tables must be injected '
                             '(no Boltzmann backend in-framework)')
        self.theory = theory
        request_cls(theory, requested_cls)


class TTTEEEHighlPlanck2018LiteLikelihood(BasePlanck2018Likelihood, BaseGaussianLikelihood):
    """plik-lite TTTEEE high-ell likelihood: Gaussian in binned C_ell.

    Parameters
    ----------
    theory : ClTheory
    data : dict, default=None
        Arrays: 'flatdata' (ndata,), 'covariance' (ndata, ndata),
        'ellmin'/'ellmax' (nbins,) bin edges (shared bin layout across
        spectra), 'weights' (>= max ellmax + 1,) per-ell binning weights,
        'nbins' list of bin counts per spectrum [tt, te, ee]. C_ell in muK^2.
    data_dir : str, default=None
        Real plik-lite clik directory (blmin.dat, blmax.dat, bweight.dat,
        c_matrix_plik_v22.dat, cl_cmb_plik_v22.dat).
    elllim : tuple, default=(30, 2508)
    """

    cls = ('tt', 'te', 'ee')
    nbins_full = (215, 199, 199)
    name = 'TTTEEEHighlPlanck2018Lite'
    _params = dict(BaseLikelihood._params)
    _params.update(_CALIB_PARAMS)

    def initialize(self, theory=None, data=None, data_dir=None, elllim=(30, 2508), **kwargs):
        self.elllim = tuple(elllim)
        if data is None:
            if data_dir is None:
                data_dir = installed_data_dir('Planck2018LiteLikelihood')
            if data_dir is None:
                raise ValueError('provide data= arrays or data_dir= with the plik-lite files')
            data = self.load_plik_lite(data_dir)
        ellmin = np.asarray(data['ellmin'], dtype='i8')
        ellmax = np.asarray(data['ellmax'], dtype='i8')
        weights = np.asarray(data['weights'], dtype='f8')
        nbins = list(data.get('nbins', self.nbins_full))
        flatdata = np.asarray(data['flatdata'], dtype='f8')
        covariance = np.asarray(data['covariance'], dtype='f8')
        mask, binnings, requested_cls = [], [], {}
        for cl, nbin in zip(('tt', 'te', 'ee'), nbins):
            emin, emax = ellmin[:nbin], ellmax[:nbin]
            keep = (emin >= self.elllim[0]) & (emax <= self.elllim[1])
            if cl in self.cls:
                emin, emax = emin[keep], emax[keep]
                requested_cls[cl] = int(emax.max())
                binning = np.zeros((len(emax), emax.max() + 1))
                for i, (lo, hi) in enumerate(zip(emin, emax)):
                    binning[i, lo:hi + 1] = weights[lo:hi + 1]
                binnings.append(binning)
            else:
                keep[...] = False
            mask.append(keep)
        mask = np.concatenate(mask)
        for cl, binning in zip(self.cls, binnings):
            setattr(self, '_binning_t_' + cl, np.ascontiguousarray(binning.T))
        self._set_theory(theory, requested_cls)
        BaseGaussianLikelihood.initialize(self, data=flatdata[mask], covariance=covariance[np.ix_(mask, mask)])

    @classmethod
    def load_plik_lite(cls, data_dir, nbins=None):
        """Read the plik-lite '_external' clik files. Needs scipy for the
        Fortran-record covariance. ``nbins``: per-spectrum bin counts [tt,
        te, ee]; defaults to the release sizes (215, 199, 199)."""
        offset = 30
        ellmin = np.loadtxt(os.path.join(data_dir, 'blmin.dat')).astype(int) + offset
        ellmax = np.loadtxt(os.path.join(data_dir, 'blmax.dat')).astype(int) + offset
        weights = np.concatenate([np.zeros(offset), np.loadtxt(os.path.join(data_dir, 'bweight.dat'))])
        from scipy.io import FortranFile
        with FortranFile(os.path.join(data_dir, 'c_matrix_plik_v22.dat'), 'r') as f:
            flat = f.read_reals(dtype=float)
        nb = int(round(np.sqrt(flat.size)))
        cov = flat.reshape(nb, nb)
        cov = np.tril(cov) + np.tril(cov, -1).T
        flatdata = np.loadtxt(os.path.join(data_dir, 'cl_cmb_plik_v22.dat'))[:, 1]
        return dict(flatdata=flatdata, covariance=cov, ellmin=ellmin, ellmax=ellmax,
                    weights=weights, nbins=list(cls.nbins_full if nbins is None else nbins))

    def flattheory(self):
        cal = (self._A_planck ** 2)[..., None]
        binned = []
        for cl in self.cls:
            binning_t = self.const('_binning_t_' + cl)
            binned.append(self.theory.cls[cl][..., :binning_t.shape[0]] @ binning_t / cal)
        return torch.cat(binned, dim=-1)

    def calculate(self, A_planck=1., **kw):
        self._A_planck = A_planck
        BaseGaussianLikelihood.calculate(self)


class TTHighlPlanck2018LiteLikelihood(TTTEEEHighlPlanck2018LiteLikelihood):
    """plik-lite TT-only variant."""

    cls = ('tt',)
    name = 'TTHighlPlanck2018Lite'


class TTLowlPlanck2018Likelihood(BasePlanck2018Likelihood):
    """Commander low-ell TT Gibbs likelihood: Gaussianized by the per-ell
    change of variable x(C_ell).

    data : dict with
        'cl2x' : (nell, ngrid, 2) per-ell (C_ell grid, x) pairs,
        'mu' : (nell,), 'covariance' : (nell, nell), 'mu_sigma' : (nell,).
    """

    name = 'TTLowlPlanck2018'
    _params = dict(BaseLikelihood._params)
    _params.update(_CALIB_PARAMS)

    def initialize(self, theory=None, data=None, data_dir=None, elllim=(2, 29), **kwargs):
        self.elllim = tuple(elllim)
        if data is None:
            if data_dir is None:
                data_dir = installed_data_dir('TTLowlPlanck2018Likelihood')
            if data_dir is None:
                raise ValueError('provide data= arrays or data_dir= with sigma.fits')
            data = self.load_commander(data_dir, self.elllim)
        cl2x = np.asarray(data['cl2x'], dtype='f8')   # (nell, ngrid, 2)
        self._grid = np.ascontiguousarray(cl2x[..., 0])
        self._x = np.ascontiguousarray(cl2x[..., 1])
        self.mu = np.asarray(data['mu'], dtype='f8')
        self.precision = np.linalg.inv(np.asarray(data['covariance'], dtype='f8'))
        # the hard prior range: where the x table saturates at +-5
        nell, ngrid = self._x.shape
        prior = []
        for i in range(nell):
            lo = int(np.argmax(np.abs(self._x[i] + 5.) >= 1e-4))
            hi = ngrid - 1 - int(np.argmax((np.abs(self._x[i] - 5.) >= 1e-4)[::-1]))
            prior.append((self._grid[i, min(lo + 2, ngrid - 1)], self._grid[i, max(hi - 2, 0)]))
        self._prior = np.asarray(prior)
        self._step = 1e-4 * (self._grid[:, -1] - self._grid[:, 0])
        ells = np.arange(self.elllim[0], self.elllim[1] + 1)
        self.factor = ells * (ells + 1) / 2. / np.pi
        self._set_theory(theory, {'tt': self.elllim[1]})
        # normalization: the log-likelihood at mu_sigma, subtracted per evaluation; skipped when mu_sigma is
        # absent or lands outside the prior range
        self._offset = 0.
        mu_sigma = data.get('mu_sigma')
        if mu_sigma is not None:
            self.dtype, self.device = torch.float64, torch.device('cpu')
            off = float(self.loglike_of_theory(torch.as_tensor(np.asarray(mu_sigma, dtype='f8'))))
            if np.isfinite(off):
                self._offset = off

    @classmethod
    def load_commander(cls, data_dir, elllim=(2, 29)):
        """Read the commander 'sigma.fits' clik product: ext 0 image (>=2,
        nell, ngrid) with rows (C_ell grid, x); ext 1 mu; ext 2 covariance;
        ext 3 mu_sigma."""
        from ... import io_fits
        fn = os.path.join(data_dir, 'sigma.fits')
        sl = slice(elllim[0] - 2, elllim[1] - 2 + 1)
        cl2x = np.asarray(io_fits.read(fn, ext=0), dtype='f8')[:, sl, :]
        return dict(cl2x=np.stack([cl2x[0], cl2x[1]], axis=-1),
                    mu=np.asarray(io_fits.read(fn, ext=1), dtype='f8')[sl],
                    covariance=np.asarray(io_fits.read(fn, ext=2), dtype='f8')[sl, sl],
                    mu_sigma=np.asarray(io_fits.read(fn, ext=3), dtype='f8')[sl])

    def loglike_of_theory(self, theory):
        """theory (..., nell) D_ell -> (...,) log-likelihood: the Jacobian of
        x(C_ell) (by central differences of the lookup, step 1e-4 of each
        grid's span), chi2 of x, -inf outside the prior range."""
        grid, xs, prior = self.const('_grid'), self.const('_x'), self.const('_prior')
        out_of_prior = ((theory < prior[:, 0]) | (theory > prior[:, 1])).any(-1)
        step = self.const('_step')
        x = interp_rows(theory, grid, xs)
        dxdcl = (interp_rows(theory + step, grid, xs) - interp_rows(theory - step, grid, xs)) / (2. * step)
        logjac = torch.log(torch.clamp(dxdcl, min=1e-30)).sum(-1)
        diff = x - self.const('mu')
        chi2 = ((diff @ self.const('precision')) * diff).sum(-1)
        value = logjac - 0.5 * chi2
        return torch.where(out_of_prior, torch.full_like(value, -np.inf), value)

    def calculate(self, A_planck=1., **kw):
        theory = self.theory.cls['tt'][..., self.elllim[0]:self.elllim[1] + 1] * self.const('factor') \
            / (A_planck ** 2)[..., None]
        self.loglikelihood = self.loglike_of_theory(theory) - self._offset


class EELowlPlanck2018Likelihood(BasePlanck2018Likelihood):
    """simall low-ell EE likelihood: tabulated per-ell log-probability.

    data : dict with 'prob' (nell, ngrid) log-probability table on the grid
    dcl * (0.5 + arange(ngrid)) in D_ell muK^2.
    """

    name = 'EELowlPlanck2018'
    dcl = 1e-4
    _params = dict(BaseLikelihood._params)
    _params.update(_CALIB_PARAMS)

    def initialize(self, theory=None, data=None, data_dir=None, elllim=(2, 29), **kwargs):
        self.elllim = tuple(elllim)
        if data is None:
            if data_dir is None:
                data_dir = installed_data_dir('EELowlPlanck2018Likelihood')
            if data_dir is None:
                raise ValueError('provide data= arrays or data_dir= with probEE')
            data = self.load_simall(data_dir, self.elllim)
        self._prob = np.asarray(data['prob'], dtype='f8')
        self._bins = self.dcl * (0.5 + np.arange(self._prob.shape[1]))
        ells = np.arange(self.elllim[0], self.elllim[1] + 1)
        self.factor = ells * (ells + 1) / 2. / np.pi
        self._set_theory(theory, {'ee': self.elllim[1]})

    @classmethod
    def load_simall(cls, data_dir, elllim=(2, 29)):
        """Read the simall 'probEE' clik product: per-ell log-probability
        tables on the fixed 3000-point D_ell grid, flat on disk."""
        from ... import io_fits
        prob = np.asarray(io_fits.read(os.path.join(data_dir, 'probEE'), ext=0), dtype='f8')
        prob = prob.reshape(-1, 3000).T[:, slice(elllim[0] - 2, elllim[1] - 2 + 1)]
        return dict(prob=prob.T)

    def calculate(self, A_planck=1., **kw):
        theory = self.theory.cls['ee'][..., self.elllim[0]:self.elllim[1] + 1] * self.const('factor') \
            / (A_planck ** 2)[..., None]
        self.loglikelihood = interp_rows(theory, self.const('_bins'), self.const('_prob'), outside=-np.inf).sum(-1)


# --------------------------------------------------------------------------
# Fixture writers for the real clik file layouts (inverses of the loaders
# above; numpy copies of the JAX package's).

def write_plik_lite_data(data_dir, data):
    """Write the plik-lite '_external' layout read by
    :meth:`TTTEEEHighlPlanck2018LiteLikelihood.load_plik_lite`: blmin/blmax
    (bin edges minus the ell=30 offset), bweight (per-ell weights from
    ell=30), the Fortran-record covariance, and the 3-column binned-Cl
    text file."""
    os.makedirs(data_dir, exist_ok=True)
    offset = 30
    ellmin = np.asarray(data['ellmin'], dtype='i8')
    ellmax = np.asarray(data['ellmax'], dtype='i8')
    weights = np.asarray(data['weights'], dtype='f8')
    np.savetxt(os.path.join(data_dir, 'blmin.dat'), ellmin - offset, fmt='%d')
    np.savetxt(os.path.join(data_dir, 'blmax.dat'), ellmax - offset, fmt='%d')
    np.savetxt(os.path.join(data_dir, 'bweight.dat'), weights[offset:])
    from scipy.io import FortranFile
    cov = np.asarray(data['covariance'], dtype='f8')
    with FortranFile(os.path.join(data_dir, 'c_matrix_plik_v22.dat'), 'w') as f:
        f.write_record(np.ascontiguousarray(cov))
    flatdata = np.asarray(data['flatdata'], dtype='f8')
    np.savetxt(os.path.join(data_dir, 'cl_cmb_plik_v22.dat'),
               np.column_stack([np.arange(1, len(flatdata) + 1), flatdata,
                                np.zeros(len(flatdata))]))


def write_commander_data(data_dir, data):
    """Write the commander 'sigma.fits' layout read by
    :meth:`TTLowlPlanck2018Likelihood.load_commander`: primary image
    (3, nell, ngrid) with rows (C_ell grid, x, unused), then mu /
    covariance / mu_sigma image extensions."""
    from ... import io_fits
    os.makedirs(data_dir, exist_ok=True)
    cl2x = np.asarray(data['cl2x'], dtype='f8')          # (nell, ngrid, 2)
    img = np.stack([cl2x[..., 0], cl2x[..., 1], np.zeros_like(cl2x[..., 0])])
    mu = np.asarray(data['mu'], dtype='f8')
    io_fits.write(os.path.join(data_dir, 'sigma.fits'),
                  [io_fits.Hdu(data=img),
                   io_fits.Hdu(data=mu),
                   io_fits.Hdu(data=np.asarray(data['covariance'], dtype='f8')),
                   io_fits.Hdu(data=np.asarray(data.get('mu_sigma', np.zeros_like(mu)),
                                               dtype='f8'))])


def write_simall_data(data_dir, data):
    """Write the simall 'probEE' layout read by
    :meth:`EELowlPlanck2018Likelihood.load_simall`: the per-ell
    log-probability tables as one image (padded to the fixed 3000-point
    grid with -1e30, matching the real product's dense storage)."""
    from ... import io_fits
    os.makedirs(data_dir, exist_ok=True)
    prob = np.asarray(data['prob'], dtype='f8')
    if prob.shape[1] < 3000:
        prob = np.concatenate([prob, np.full((prob.shape[0], 3000 - prob.shape[1]), -1e30)],
                              axis=1)
    io_fits.write(os.path.join(data_dir, 'probEE'), [io_fits.Hdu(data=prob)])
