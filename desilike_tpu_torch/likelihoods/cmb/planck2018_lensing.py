"""Planck 2018 CMB lensing likelihood (native reimplementation).

Counterpart of ``desilike_tpu/likelihoods/cmb/planck2018_lensing.py``: a
Gaussian in binned C_L^{phiphi} bandpowers (Planck 2018 VIII,
arXiv:1807.06210, section 2.3) whose prediction carries a first-order
renormalization correction for the dependence of the estimator
normalization (and N1 bias) on the CMB spectra:

    C^pred_i = sum_L B_iL C_L^pp + sum_{x in tt, ee, te} M^x_i . (C^x / A_planck^2 - C^x,fid)
               [+ M^pp_i . (C^pp - C^pp,fid)]

with every correction operator a precomputed matrix: per chain, a handful
of products. The ``CMBmarged`` variant (lensing only, the CMB dependence
marginalized into a broadened covariance) drops the corrections. The data
ship as the documented text/npy directory layout of the JAX package's
reader and writer (numpy copies here).
"""

import os

import numpy as np

from ..base import BaseGaussianLikelihood
from .base import request_cls
from ...install import installed_data_dir

PLANCK_LENSING_VARIANTS = ('consext8', 'CMBmarged')
_CORR_CLS = ('tt', 'ee', 'te')


class Planck2018LensingLikelihood(BaseGaussianLikelihood):
    """Gaussian likelihood in binned, renormalization-corrected C_L^{phiphi}.

    Parameters
    ----------
    theory : ClTheory
        Requesting ``pp`` (+ ``tt``, ``ee``, ``te`` unless ``CMBmarged``).
    data : dict, optional
        'bandpowers' (n,), 'covariance' or 'siginv' (n, n), 'binmat'
        (n, lmax_pp+1), and for the corrected variant 'fiducial_cl_pp' +
        'fiducial_cl_{tt,ee,te}' vectors and 'corr_{tt,ee,te}'
        (n, lmax_cmb+1) matrices, optionally 'corr_pp' (n, lmax_pp+1).
    variant : str, default='consext8'
        'consext8' (8 <= L <= 400 with the CMB renormalization corrections)
        or 'CMBmarged' (lensing only, no corrections).
    data_dir : str, optional
        Directory in the :func:`write_planck2018_lensing_data` layout.

    ``A_planck`` carries the standard Planck prior N(1, 0.0025) and rescales
    the CMB spectra entering the renormalization correction.
    """

    name = 'LensingPlanck2018'
    installer_section = 'LensingPlanck2018Likelihood'
    _params = dict(BaseGaussianLikelihood._params)
    _params.update({'A_planck': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.0025),
                                     ref=dict(dist='norm', loc=1., scale=0.0005),
                                     proposal=0.0005, latex=r'y_\mathrm{cal}')})

    def initialize(self, theory=None, data=None, data_dir=None, variant='consext8', **kwargs):
        if variant not in PLANCK_LENSING_VARIANTS:
            raise ValueError('unknown variant {!r}; expected one of {}'.format(variant, PLANCK_LENSING_VARIANTS))
        self.variant = str(variant)
        self.lens_only = (self.variant == 'CMBmarged')
        if data is None and data_dir is None:
            data_dir = installed_data_dir(self.installer_section)
        if data is None and data_dir is not None:
            data = read_planck2018_lensing_data(data_dir, variant=variant)
        if data is None:
            raise ValueError('provide data= dict or data_dir= (write_planck2018_lensing_data layout)')
        self.data = {k: (np.asarray(v) if isinstance(v, (list, tuple, np.ndarray)) else v) for k, v in data.items()}
        binmat = np.atleast_2d(np.asarray(self.data['binmat'], dtype='f8'))
        self.ellmax_pp = binmat.shape[1] - 1
        self._binmat_t = np.ascontiguousarray(binmat.T)
        requested = {'pp': self.ellmax_pp}
        if not self.lens_only:
            self.ellmax_cmb = int(np.asarray(self.data['corr_tt']).shape[1]) - 1
            requested.update({xy: self.ellmax_cmb for xy in _CORR_CLS})
            for name in ['corr_' + xy for xy in _CORR_CLS] + (['corr_pp'] if 'corr_pp' in self.data else []):
                setattr(self, '_' + name + '_t', np.ascontiguousarray(np.asarray(self.data[name], dtype='f8').T))
            for name in ['fiducial_cl_' + xy for xy in _CORR_CLS + ('pp',)]:
                setattr(self, '_' + name, np.asarray(self.data[name], dtype='f8'))
        if theory is None:
            raise ValueError('pass theory=ClTheory(tables=...)')
        self.theory = theory
        request_cls(theory, requested)
        precision = self.data.get('siginv')
        if precision is None:
            precision = np.linalg.inv(np.atleast_2d(np.asarray(self.data['covariance'], dtype='f8')))
        super().initialize(data=np.asarray(self.data['bandpowers'], dtype='f8'),
                           precision=np.asarray(precision, dtype='f8'))

    def flattheory(self):
        return self._flattheory

    def calculate(self, A_planck=1., **kw):
        clpp = self.theory.cls['pp'][..., :self.ellmax_pp + 1]
        pred = clpp @ self.const('_binmat_t')
        if not self.lens_only:
            cal = (A_planck ** 2)[..., None]
            for xy in _CORR_CLS:
                cldiff = self.theory.cls[xy][..., :self.ellmax_cmb + 1] / cal - self.const('_fiducial_cl_' + xy)
                pred = pred + cldiff @ self.const('_corr_{}_t'.format(xy))
            if 'corr_pp' in self.data:
                pred = pred + (clpp - self.const('_fiducial_cl_pp')) @ self.const('_corr_pp_t')
        self._flattheory = pred.expand(A_planck.shape + pred.shape[-1:])
        super().calculate()


# --- documented directory layout (round-trip-pinned, like the other
# real-product readers in this family) --------------------------------------

def _lensing_paths(data_dir, variant):
    return {
        'bandpowers': os.path.join(data_dir, 'bandpowers_{}.txt'.format(variant)),
        'covariance': os.path.join(data_dir, 'covmat_{}.txt'.format(variant)),
        'binmat': os.path.join(data_dir, 'binning_matrix_{}.txt'.format(variant)),
    }


def read_planck2018_lensing_data(data_dir, variant='consext8'):
    """Load a Planck-2018-lensing-layout directory into the dict consumed by
    ``Planck2018LensingLikelihood(data=...)``."""
    if variant not in PLANCK_LENSING_VARIANTS:
        raise ValueError('unknown variant {!r}; expected one of {}'.format(
            variant, PLANCK_LENSING_VARIANTS))
    paths = _lensing_paths(data_dir, variant)
    data = {'bandpowers': np.loadtxt(paths['bandpowers']),
            'covariance': np.atleast_2d(np.loadtxt(paths['covariance'])),
            'binmat': np.atleast_2d(np.loadtxt(paths['binmat']))}
    if variant != 'CMBmarged':
        data['fiducial_cl_pp'] = np.loadtxt(
            os.path.join(data_dir, 'fiducial_cl_pp.txt'))
        for xy in _CORR_CLS:
            data['fiducial_cl_' + xy] = np.loadtxt(
                os.path.join(data_dir, 'fiducial_cl_{}.txt'.format(xy)))
            data['corr_' + xy] = np.load(
                os.path.join(data_dir, 'corr_{}.npy'.format(xy)))
        corr_pp_fn = os.path.join(data_dir, 'corr_pp.npy')
        if os.path.exists(corr_pp_fn):
            data['corr_pp'] = np.load(corr_pp_fn)
    return data


def write_planck2018_lensing_data(data_dir, data, variant='consext8'):
    """Write the directory layout read by :func:`read_planck2018_lensing_data`
    (fixture generator; exercises the reader without network access)."""
    if variant not in PLANCK_LENSING_VARIANTS:
        raise ValueError('unknown variant {!r}; expected one of {}'.format(
            variant, PLANCK_LENSING_VARIANTS))
    os.makedirs(data_dir, exist_ok=True)
    paths = _lensing_paths(data_dir, variant)
    np.savetxt(paths['bandpowers'], np.asarray(data['bandpowers'], dtype='f8'))
    cov = data.get('covariance')
    if cov is None:
        cov = np.linalg.inv(np.atleast_2d(np.asarray(data['siginv'], dtype='f8')))
    np.savetxt(paths['covariance'], np.atleast_2d(np.asarray(cov, dtype='f8')))
    np.savetxt(paths['binmat'], np.atleast_2d(np.asarray(data['binmat'], dtype='f8')))
    if variant != 'CMBmarged':
        np.savetxt(os.path.join(data_dir, 'fiducial_cl_pp.txt'),
                   np.asarray(data['fiducial_cl_pp'], dtype='f8'))
        for xy in _CORR_CLS:
            np.savetxt(os.path.join(data_dir, 'fiducial_cl_{}.txt'.format(xy)),
                       np.asarray(data['fiducial_cl_' + xy], dtype='f8'))
            np.save(os.path.join(data_dir, 'corr_{}.npy'.format(xy)),
                    np.asarray(data['corr_' + xy], dtype='f8'))
        if 'corr_pp' in data:
            np.save(os.path.join(data_dir, 'corr_pp.npy'),
                    np.asarray(data['corr_pp'], dtype='f8'))


def synthetic_planck2018_lensing_data(variant='consext8', nbins=8,
                                      ellmax_pp=400, ellmax_cmb=2500,
                                      seed=42, cl_tables=None):
    """Self-consistent synthetic fixture: bandpowers = binned fiducial
    C_L^{pp} (corrections vanish at the fiducial point), conservative-style
    L bins, diagonal-dominant covariance, small random correction matrices."""
    from .base import synthetic_cl_tables
    if cl_tables is None:
        cl_tables = synthetic_cl_tables(lmax=max(ellmax_cmb, ellmax_pp))
    rng = np.random.default_rng(seed)
    edges = np.unique(np.geomspace(8, ellmax_pp, nbins + 1).astype(int))
    nbins = len(edges) - 1
    binmat = np.zeros((nbins, ellmax_pp + 1))
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        binmat[i, lo:hi] = 1. / (hi - lo)
    clpp = np.asarray(cl_tables['pp'][:ellmax_pp + 1], dtype='f8')
    bandpowers = binmat @ clpp
    sig = 0.05 * np.abs(bandpowers) + 1e-12
    cov = np.diag(sig ** 2)
    data = {'bandpowers': bandpowers, 'covariance': cov, 'binmat': binmat}
    if variant != 'CMBmarged':
        data['fiducial_cl_pp'] = clpp
        muk2 = (2.7255 * 1e6) ** 2  # likelihood requests unit='muK' CMB cls
        for xy in _CORR_CLS:
            fid = muk2 * np.asarray(cl_tables[xy][:ellmax_cmb + 1], dtype='f8')
            data['fiducial_cl_' + xy] = fid
            # renormalization response ~ percent-level of the bandpower per
            # unit fractional CMB-spectrum shift
            resp = rng.standard_normal((nbins, ellmax_cmb + 1))
            norm = np.sum(np.abs(resp) * np.abs(fid), axis=1, keepdims=True)
            data['corr_' + xy] = (0.01 * bandpowers[:, None] * resp
                                  / np.where(norm > 0, norm, 1.))
    return data
