"""Planck 2020 (NPIPE) lollipop low-ell polarization likelihood.

Counterpart of ``desilike_tpu/likelihoods/cmb/lollipop.py``: the offset
Hamimeche & Lewis (2008) likelihood on binned EE/BB/EB cross-spectra.

The 2 x 2 matrix functions of the H&L transform (the JAX package's
``eigh2``/``matfunc2`` under ``jax.vmap`` over bins) are one closed-form
elementwise pass over (B, nbins): a symmetric 2 x 2 matrix is its three
entries (a, b, c), its eigendecomposition the rotation angle
0.5 atan2(2b, a - c) and the eigenvalues (a + c)/2 -+ r; no per-bin loop
and no batched ``eigh``. Binning is a precomputed matrix product.
"""

import os

import numpy as np
import torch

from ..base import BaseLikelihood
from .base import request_cls
from .planck2018 import no_installer


_CALIB_PARAMS = {'A_planck': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.0025),
                                  ref=dict(dist='norm', loc=1., scale=0.002),
                                  proposal=0.0005, latex=r'y_\mathrm{cal}')}


def ghl(x):
    """Hamimeche & Lewis g(x) = sign(x-1) sqrt(2 (x - ln x - 1)). Within
    |x - 1| < 0.02, g = y (1 - y/3 + 7y^2/36 - 73y^3/540), y = x - 1, the
    series of the same function (within 1.7e-8 of it there, float64): in
    float32, x - ln x - 1 rounds to 0 or below near x = 1, where the sqrt's
    gradient is then NaN (over B = 4096 chains of the lollipop EB fixture one
    chain came within that of x = 1 on an H100). So the gradient is the
    derivative of g everywhere, 1 at x = 1, where the JAX package's is NaN
    (the sqrt of 0: in float32 for |x - 1| up to ~3e-4; in x64 at x = 1
    only, its x64 derivative tending to 1 on both sides)."""
    y = x - 1.
    small = y.abs() < 0.02
    ys = torch.where(small, y, torch.zeros_like(y))
    series = ys * (1. - ys / 3. + 7. * ys ** 2 / 36. - 73. * ys ** 3 / 540.)
    yl = torch.where(small, torch.ones_like(y), y)  # the closed form away from x = 1 only
    log_x = torch.where(x > 0.5, torch.log1p(yl), torch.log(torch.clamp(x, min=1e-30)))
    exact = torch.sign(yl) * torch.sqrt(2. * torch.clamp(yl - log_x, min=0.))
    return torch.where(small, series, exact)


def eigh2(a, b, c):
    """Closed-form eigendecomposition of the symmetric [[a, b], [b, c]],
    elementwise over the entries' shape: (w0, w1, cos, sin) with eigenvalues
    w0 <= w1 and eigenvectors (-sin, cos) and (cos, sin), smooth in the
    entries (the rotation angle by atan2)."""
    half_tr = 0.5 * (a + c)
    # the JAX package's floor of 1e-300 is 0 in float32; the smallest normal number keeps the gradient at a
    # double eigenvalue finite there too
    floor = 1e-300 if a.dtype == torch.float64 else torch.finfo(a.dtype).tiny
    r = torch.sqrt(torch.clamp((0.5 * (a - c)) ** 2 + b ** 2, min=floor))
    theta = 0.5 * torch.atan2(2. * b, a - c)
    return half_tr - r, half_tr + r, torch.cos(theta), torch.sin(theta)


def matfunc2(a, b, c, fn):
    """f(M) for the symmetric M = [[a, b], [b, c]], as its entries: V diag(f(w)) V^T."""
    w0, w1, cs, sn = eigh2(a, b, c)
    f0, f1 = fn(w0), fn(w1)
    return f0 * sn ** 2 + f1 * cs ** 2, cs * sn * (f1 - f0), f0 * cs ** 2 + f1 * sn ** 2


def sandwich2(outer, inner):
    """A D A for symmetric A (``outer``) and D (``inner``), each as its entries (a, b, c)."""
    a, b, c = outer
    d, e, f = inner
    ad_be, ae_bf, bd_ce, be_cf = a * d + b * e, a * e + b * f, b * d + c * e, b * e + c * f
    return a * ad_be + b * ae_bf, b * ad_be + c * ae_bf, b * bd_ce + c * be_cf


def binning_matrix(lmins, lmaxs, lmax, dl_weight=True):
    """(nbins, lmax+1) averaging matrix; weights l(l+1)/2pi when dl_weight
    (reference lollipop.py:74-103)."""
    ell = np.arange(lmax + 1)
    w = ell * (ell + 1) / (2. * np.pi) if dl_weight else np.ones(lmax + 1)
    P = np.zeros((len(lmins), lmax + 1))
    for b, (lo, hi) in enumerate(zip(lmins, lmaxs)):
        P[b, lo:hi + 1] = w[lo:hi + 1] / (hi - lo + 1)
    return P


def lollipop_bins(lmin=2, lmax=30):
    """The lollipop fixed binning: unit bins below ell=36, delta=10 above
    (reference lollipop.py:128-149)."""
    if lmax <= 35:
        lmins = list(range(lmin, lmax + 1))
        lmaxs = list(range(lmin, lmax + 1))
    elif lmin >= 36:
        lmins = list(range(lmin, lmax - 8, 10))
        lmaxs = [lo + 9 for lo in lmins]
    else:
        lmins = list(range(lmin, 36)) + list(range(36, lmax - 8, 10))
        lmaxs = list(range(lmin, 36)) + [lo + 9 for lo in range(36, lmax - 8, 10)]
    return np.asarray(lmins), np.asarray(lmaxs)


def compute_offsets(lbin, varcl, clref, fsky=0.52, niter=10):
    """Noise offsets from the covariance diagonal (reference
    lollipop.py:111-115)."""
    Nl = np.sqrt(np.abs(varcl - (2. / (2. * lbin + 1) * clref ** 2) / fsky))
    for _ in range(niter):
        Nl = np.sqrt(np.abs(varcl - 2. / (2. * lbin + 1) / fsky * (clref ** 2 + 2. * Nl * clref)))
    return Nl * np.sqrt((2. * lbin + 1) / 2.)


class LollipopLikelihood(BaseLikelihood):
    """Offset-H&L likelihood on low-ell polarization (modes 'lowlE',
    'lowlB', 'lowlEB').

    Parameters
    ----------
    theory : ClTheory
    data : dict
        'cl' : (3, lmax+1) measured D_ell (EE, BB, EB) in muK^2,
        'fiducial' : (3, lmax+1) fiducial D_ell,
        'covariance' : (3 nell, 3 nell) C_ell covariance over
        ell = 2..lmax_cov per block (EE, BB, EB blocks),
        optionally 'fsky' (0.52), 'nsim' (400).
    mode : str
    marginalised_over_covariance : bool, default=True
        Sellentin-Heavens style: chi2 -> Nsim log(1 + chi2/(Nsim-1)).
    """

    name = 'Lollipop'
    lmin, lmax = 2, 30
    _params = dict(BaseLikelihood._params)
    _params.update(_CALIB_PARAMS)

    def initialize(self, theory=None, data=None, data_dir=None, mode='lowlEB', fsky=None,
                   marginalised_over_covariance=True, **kwargs):
        if mode not in ('lowlE', 'lowlB', 'lowlEB'):
            raise ValueError('mode must be lowlE/lowlB/lowlEB')
        self.mode = mode
        self.marginalised_over_covariance = bool(marginalised_over_covariance)
        if data is None and data_dir is None:
            raise no_installer(type(self).__name__)
        if data is None:
            data = read_lollipop_data(data_dir)
        self.nsim = int(data.get('nsim', 400))
        fsky = float(data.get('fsky', 0.52) if fsky is None else fsky)
        lmins, lmaxs = lollipop_bins(self.lmin, self.lmax)
        self._P = binning_matrix(lmins, lmaxs, self.lmax, dl_weight=False)
        self.lbin = (lmins + lmaxs) / 2.
        nbins = len(lmins)
        cl = np.asarray(data['cl'], dtype='f8')[:, :self.lmax + 1]
        fid = np.asarray(data['fiducial'], dtype='f8')[:, :self.lmax + 1]
        self.cldata = cl @ self._P.T          # (3, nbins)
        self.clfid = fid @ self._P.T
        clcov = np.asarray(data['covariance'], dtype='f8')
        nell = clcov.shape[0] // 3
        # bin the (EE, BB, EB) covariance blocks; covariance rows start at ell = 2
        embed = np.zeros((self.lmax + 1, nell))
        embed[2:self.lmax + 1, :self.lmax - 1] = np.eye(self.lmax - 1)
        B = self._P @ embed                   # (nbins, nell)
        if self.mode == 'lowlEB':
            cbcov = np.block([[B @ clcov[i * nell:(i + 1) * nell, j * nell:(j + 1) * nell] @ B.T for j in range(3)]
                              for i in range(3)])
            self.invclcov = np.linalg.pinv(cbcov, rcond=1e-9)
        else:
            i = 0 if self.mode == 'lowlE' else 1
            cbcov = B @ clcov[i * nell:(i + 1) * nell, i * nell:(i + 1) * nell] @ B.T
            self.invclcov = np.linalg.inv(cbcov)
        clvar = np.diag(cbcov).reshape(-1, nbins) if self.mode == 'lowlEB' else np.diag(cbcov)[None, :]
        # offsets; EB forced to zero
        if self.mode == 'lowlEB':
            self.cloff = compute_offsets(self.lbin, clvar, np.asarray(self.clfid), fsky=fsky)
            self.cloff[2:] = 0.
        else:
            i = 0 if self.mode == 'lowlE' else 1
            self.cloff = compute_offsets(self.lbin, clvar[0], np.asarray(self.clfid[i]), fsky=fsky)
            self._data1, self._fid1 = self.cldata[i], self.clfid[i]
        if theory is None:
            raise ValueError('pass theory=ClTheory(tables=...)')
        self.theory = theory
        request_cls(theory, {'ee': self.lmax, 'bb': self.lmax})
        ells = np.arange(self.lmax + 1)
        self.factor = ells * (ells + 1) / 2. / np.pi
        self._P_t = np.ascontiguousarray(self._P.T)

    def _chi2(self, x):
        chi2 = ((x @ self.const('invclcov')) * x).sum(-1)
        if self.marginalised_over_covariance:
            chi2 = self.nsim * torch.log1p(chi2 / (self.nsim - 1.))
        return chi2

    def _chi2_2fields(self, ee, bb, cal):
        """Offset-H&L over [[EE, EB], [EB, BB]] in every (chain, bin) at once;
        ``ee``, ``bb`` (B, nbins) binned model D_ell (EB 0), ``cal`` (B, 1)."""
        off, dat, fid = self.const('cloff'), self.const('cldata'), self.const('clfid')
        O = (off[0], off[2], off[1])
        D = tuple(d * cal + o for d, o in zip((dat[0], dat[2], dat[1]), O))
        M = (ee + O[0], O[1].expand_as(ee), bb + O[2])
        F = tuple(f + o for f, o in zip((fid[0], fid[2], fid[1]), O))
        minv_half = matfunc2(*M, lambda w: 1. / torch.sqrt(torch.clamp(w, min=1e-30)))
        w0, w1, cs, sn = eigh2(*sandwich2(minv_half, D))
        g0, g1 = torch.sign(w0) * ghl(torch.abs(w0)), torch.sign(w1) * ghl(torch.abs(w1))
        G = (g0 * sn ** 2 + g1 * cs ** 2, cs * sn * (g1 - g0), g0 * cs ** 2 + g1 * sn ** 2)
        f_half = matfunc2(*F, lambda w: torch.sqrt(torch.clamp(w, min=0.)))
        X00, X01, X11 = sandwich2(f_half, G)
        return self._chi2(torch.cat([X00, X11, X01], dim=-1))

    def _chi2_1field(self, clth_bin, cal):
        off, dat, fid = self.const('cloff'), self.const('_data1'), self.const('_fid1')
        x = (dat * cal + off) / (clth_bin + off)
        g = torch.sign(x) * ghl(torch.abs(x))
        return self._chi2(torch.sqrt(fid + off) * g * torch.sqrt(fid + off))

    def calculate(self, A_planck=1., **kw):
        dl = {xy: self.theory.cls[xy][..., :self.lmax + 1] * self.const('factor') @ self.const('_P_t')
              for xy in ('ee', 'bb')}
        cal = (A_planck ** 2)[..., None]
        if self.mode == 'lowlEB':
            ee, bb = torch.broadcast_tensors(dl['ee'], dl['bb'], cal)[:2]
            chi2 = self._chi2_2fields(ee, bb, cal)
        else:
            chi2 = self._chi2_1field(dl['ee' if self.mode == 'lowlE' else 'bb'], cal)
        self.loglikelihood = -0.5 * chi2


# --------------------------------------------------------------------------
# Real Planck PR4 (NPIPE) lollipop file layout: reader + writer
#
# The reference reads (ref lollipop.py:230-232, 260-273):
#   cl_lolEB_NPIPE.dat        text columns (ell, EE, BB, EB): measured
#                             cross-spectrum D_ell
#   fiducial_lolEB_planck2018_tensor_lensedCls.dat   same layout, fiducial
#   clcov_lolEB_NPIPE.fits    image: (3 nell, 3 nell) unbinned C_ell
#                             covariance, (EE, BB, EB) blocks from ell=2
# The FITS file goes through the in-repo codec (desilike_tpu_torch/io_fits.py).

CL_FILE = 'cl_lolEB_NPIPE.dat'
FIDUCIAL_FILE = 'fiducial_lolEB_planck2018_tensor_lensedCls.dat'
CL_COV_FILE = 'clcov_lolEB_NPIPE.fits'


def _read_dl_dat(filename):
    """(ell, EE, BB, EB) text -> dense (3, lmax+1) (reference
    lollipop.py:118-125)."""
    data = np.loadtxt(filename).T
    l = np.asarray(data[0], dtype='i8')
    dl = np.zeros((3, int(l.max()) + 1))
    for i in range(3):
        dl[i, l] = data[1 + i]
    return dl


def read_lollipop_data(data_dir, cl_file=CL_FILE, fiducial_file=FIDUCIAL_FILE,
                       cl_cov_file=CL_COV_FILE):
    """Load the real Planck PR4 lollipop products; returns the dict consumed
    by ``LollipopLikelihood(data=...)``."""
    from ... import io_fits
    return dict(cl=_read_dl_dat(os.path.join(data_dir, cl_file)),
                fiducial=_read_dl_dat(os.path.join(data_dir, fiducial_file)),
                covariance=np.asarray(io_fits.read(os.path.join(data_dir, cl_cov_file)),
                                      dtype='f8'))


def write_lollipop_data(data_dir, data, cl_file=CL_FILE, fiducial_file=FIDUCIAL_FILE,
                        cl_cov_file=CL_COV_FILE):
    """Write the Planck PR4 lollipop file layout (inverse of
    :func:`read_lollipop_data`) — fixture generator for exercising the
    real-product readers without network access."""
    from ... import io_fits
    os.makedirs(data_dir, exist_ok=True)
    for key, fn in (('cl', cl_file), ('fiducial', fiducial_file)):
        dl = np.asarray(data[key], dtype='f8')
        ell = np.arange(dl.shape[1])
        np.savetxt(os.path.join(data_dir, fn),
                   np.column_stack([ell, dl[0], dl[1], dl[2]]))
    io_fits.write(os.path.join(data_dir, cl_cov_file),
                  [io_fits.Hdu(data=np.asarray(data['covariance'], dtype='f8'))])


class EELowlPlanck2020LollipopLikelihood(LollipopLikelihood):
    name = 'EELowlPlanck2020lollipop'

    def initialize(self, *args, **kwargs):
        kwargs.setdefault('mode', 'lowlE')
        super().initialize(*args, **kwargs)


class BBLowlPlanck2020LollipopLikelihood(LollipopLikelihood):
    name = 'BBLowlPlanck2020lollipop'

    def initialize(self, *args, **kwargs):
        kwargs.setdefault('mode', 'lowlB')
        super().initialize(*args, **kwargs)


class EBLowlPlanck2020LollipopLikelihood(LollipopLikelihood):
    name = 'EBLowlPlanck2020lollipop'

    def initialize(self, *args, **kwargs):
        kwargs.setdefault('mode', 'lowlEB')
        super().initialize(*args, **kwargs)
