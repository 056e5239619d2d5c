"""ACT DR6 CMB lensing likelihood.

Counterpart of ``desilike_tpu/likelihoods/cmb/act_dr6_lensing.py``: a
Gaussian in binned C_L^{kk} with linear normalization (N0) and N1
corrections in both C_kk and the CMB spectra. Every correction is a
precomputed matrix: per chain, a handful of products. The directory reader
and fixture writer are numpy copies of the JAX package's.
"""

import os

import numpy as np
import torch

from ..base import BaseGaussianLikelihood
from .base import request_cls
from ...install import installed_data_dir


def pp_to_kk(clpp, ell):
    """C_L^{phiphi} -> C_L^{kappakappa} = [L(L+1)]^2 / 4 C^{pp}."""
    return clpp * (ell * (ell + 1.)) ** 2 / 4.


def corrected_clkk(like, clkk, cls_cmb, suffix='', do_norm_corr=True, do_n1kk_corr=True, do_n1cmb_corr=True):
    """Normalization + N1 corrections of ``clkk`` (..., L): ``like``'s
    correction tables (fiducial_cl_kk, dN1_kk{suffix}, dAL_dC{suffix}
    (4, n, n), fAL{suffix}, fiducial_cl_{tt,ee,bb,te}, dN1_{tt,ee,bb,te}{suffix})
    as tensors of the evaluation through ``like.const``."""
    clkk_fid = like.const('_fiducial_cl_kk')
    out = clkk
    if do_n1kk_corr:
        out = out + (clkk - clkk_fid) @ like.const('_dN1_kk{}_t'.format(suffix))
    norm_corr = 0.
    for i, s in enumerate(('tt', 'ee', 'bb', 'te')):
        cldiff = cls_cmb[s] - like.const('_fiducial_cl_' + s)
        if do_n1cmb_corr:
            out = out + cldiff @ like.const('_dN1_{}{}_t'.format(s, suffix))
        if do_norm_corr:
            norm_corr = norm_corr + cldiff @ like.const('_dAL_dC{}_{}_t'.format(suffix, i))
    return out + norm_corr * clkk_fid


class ACTDR6LensingLikelihood(BaseGaussianLikelihood):
    """Gaussian likelihood in binned, corrected C_L^{kk}.

    Parameters
    ----------
    theory : ClTheory (requesting pp [+ tt, te, ee, bb unless lens_only])
    data : dict
        'data_binned_clkk', 'cinv' (precision), 'binmat_act' and optionally
        'binmat_planck' + '_planck'-suffixed correction matrices,
        'include_planck', 'likelihood_corrections' flags, plus the
        correction arrays listed in :func:`corrected_clkk`.
    lens_only : bool, default=False
        Skip the CMB-spectra corrections.
    """

    name = 'ACTDR6Lensing'
    installer_section = 'ACTDR6LensingLikelihood'
    data_version = 'v1.2'
    trim_ellmax = 2998
    _params = dict(BaseGaussianLikelihood._params)
    _params.update({'Alens': dict(value=1., fixed=True, latex=r'A_\mathrm{lens}')})

    def initialize(self, theory=None, data=None, lens_only=False, data_dir=None, variant='act_baseline', **kwargs):
        if data is None and data_dir is None:
            data_dir = installed_data_dir(self.installer_section)
            if data_dir is not None:
                # the reference installs the product under a version subdirectory (<section>/<version>):
                # prefer it, else the bare section directory
                versioned = os.path.join(data_dir, self.data_version)
                if os.path.isdir(versioned):
                    data_dir = versioned
        if data is None and data_dir is not None:
            data = read_act_dr6_data(data_dir, variant=variant, lens_only=lens_only)
        if data is None:
            raise ValueError('provide data= dict (act_dr6_lenslike load_data layout) or data_dir= '
                             '(act_dr6_lenslike v1.2 file layout)')
        self.data = {k: (np.asarray(v) if isinstance(v, (list, tuple, np.ndarray)) else v) for k, v in data.items()}
        self.lens_only = bool(lens_only)
        self.ellmax = int(data.get('trim_ellmax', self.trim_ellmax)) + 1
        self.ells = np.arange(self.ellmax + 1, dtype='f8')
        self._corrections = bool(self.data.get('likelihood_corrections', not self.lens_only))
        self._include_planck = bool(self.data.get('include_planck'))
        for name in ('binmat_act',) + (('binmat_planck',) if self._include_planck else ()):
            setattr(self, '_{}_t'.format(name), np.ascontiguousarray(np.asarray(self.data[name], dtype='f8').T))
        if self._corrections:
            # the correction matrices transposed for a (..., L) @ (L, L') product; the normalization's -2 dAL_dC
            # rows divided by fAL for L >= 2 (the JAX package's per-evaluation division, folded on the host)
            for suffix in ('',) + (('_planck',) if self._include_planck else ()):
                dnorm = np.asarray(self.data['dAL_dC' + suffix], dtype='f8')
                fid_norm = np.asarray(self.data['fAL' + suffix], dtype='f8')
                ls = np.arange(dnorm.shape[1])
                divisor = np.where(ls >= 2, fid_norm, 1.)
                for i in range(4):
                    setattr(self, '_dAL_dC{}_{}_t'.format(suffix, i),
                            np.ascontiguousarray((-2. * dnorm[i] / divisor[:, None]).T))
                for s in ('kk', 'tt', 'ee', 'bb', 'te'):
                    setattr(self, '_dN1_{}{}_t'.format(s, suffix),
                            np.ascontiguousarray(np.asarray(self.data['dN1_' + s + suffix], dtype='f8').T))
            for s in ('kk', 'tt', 'ee', 'bb', 'te'):
                setattr(self, '_fiducial_cl_' + s, np.asarray(self.data['fiducial_cl_' + s], dtype='f8'))
        requested = {'pp': self.ellmax}
        if not self.lens_only:
            requested.update({xy: self.ellmax for xy in ('tt', 'te', 'ee', 'bb')})
        if theory is None:
            raise ValueError('pass theory=ClTheory(tables=...)')
        self.theory = theory
        request_cls(theory, requested)
        super().initialize(data=np.asarray(self.data['data_binned_clkk'], dtype='f8'),
                           precision=np.asarray(self.data['cinv'], dtype='f8'))

    def flattheory(self):
        return self._flattheory

    def calculate(self, Alens=1., **kw):
        clkk = pp_to_kk(self.theory.cls['pp'][..., :self.ellmax + 1], self.const('ells')) / Alens[..., None]
        cls_cmb = {s: self.theory.cls[s][..., :self.ellmax + 1] for s in ('tt', 'ee', 'bb', 'te')} \
            if self._corrections else None
        clkk_act = corrected_clkk(self, clkk, cls_cmb) if self._corrections else clkk
        bclkk = clkk_act @ self.const('_binmat_act_t')
        if self._include_planck:
            clkk_planck = corrected_clkk(self, clkk, cls_cmb, suffix='_planck') if self._corrections else clkk
            bclkk = torch.cat([bclkk, clkk_planck @ self.const('_binmat_planck_t')], dim=-1)
        self._flattheory = bclkk
        super().calculate()


# --- real-product file layout (act_dr6_lenslike v1.2 directory) -----------
#
# The reference loads this product through the external `act_dr6_lenslike`
# package (ref act_dr6_lensing.py:110, alike.load_data(variant, ddir=...)).
# Here the directory reader lives in-repo: text files for vectors/matrices
# that ship as text upstream, .npy for the large N1/normalization derivative
# stacks. File names follow the act_dr6_lenslike conventions (variant-tagged
# bandpowers/covariance, shared correction matrices); exact upstream name
# parity cannot be byte-checked in-container (zero egress), so both the
# reader and the fixture writer below pin the SAME layout and are validated
# by round-trip tests (tests/test_cmb.py).

ACT_VARIANTS = ('act_baseline', 'act_extended', 'actplanck_baseline',
                'actplanck_extended')
_ACT_CORR_KEYS = ('dN1_kk', 'dAL_dC', 'fAL',
                  'dN1_tt', 'dN1_ee', 'dN1_bb', 'dN1_te')
_ACT_FID_CMB = ('fiducial_cl_kk', 'fiducial_cl_tt', 'fiducial_cl_ee',
                'fiducial_cl_bb', 'fiducial_cl_te')


def _act_corr_path(data_dir, key):
    # vectors as .txt, derivative matrices/stacks as .npy
    ext = '.txt' if key.startswith('fiducial') or key.startswith('fAL') else '.npy'
    return os.path.join(data_dir, key + ext)


def read_act_dr6_data(data_dir, variant='act_baseline', lens_only=False,
                      apply_hartlap=True, nsims_act=792., nsims_planck=400.,
                      scale_cov=None):
    """Load an act_dr6_lenslike-layout directory into the dict consumed by
    ``ACTDR6LensingLikelihood(data=...)`` (the role of act_dr6_lenslike
    ``load_data``, ref act_dr6_lensing.py:110-114).

    The Hartlap factor uses the ACT simulation count for ACT-only variants
    and the smaller (Planck) count for the joint vector — the conservative
    choice for the combined covariance.
    """
    if variant not in ACT_VARIANTS:
        raise ValueError('unknown variant {!r}; expected one of {}'.format(
            variant, ACT_VARIANTS))
    include_planck = variant.startswith('actplanck')
    data = {}
    data['data_binned_clkk'] = np.loadtxt(
        os.path.join(data_dir, 'clkk_bandpowers_{}.txt'.format(variant)))
    cov = np.atleast_2d(np.loadtxt(
        os.path.join(data_dir, 'covmat_{}.txt'.format(variant))))
    if scale_cov is not None:
        cov = cov * float(scale_cov)
    nbin = cov.shape[0]
    data['binmat_act'] = np.atleast_2d(np.loadtxt(
        os.path.join(data_dir, 'binning_matrix_act.txt')))
    if include_planck:
        data['binmat_planck'] = np.atleast_2d(np.loadtxt(
            os.path.join(data_dir, 'binning_matrix_planck.txt')))
    hartlap = 1.
    if apply_hartlap:
        nsims = float(min(nsims_act, nsims_planck) if include_planck else nsims_act)
        hartlap = (nsims - nbin - 2.) / (nsims - 1.)
    data['cinv'] = hartlap * np.linalg.inv(cov)
    data['include_planck'] = include_planck
    data['likelihood_corrections'] = not lens_only
    suffixes = ('',) + (('_planck',) if include_planck else ())
    if not lens_only:
        for key in _ACT_FID_CMB:
            data[key] = np.loadtxt(_act_corr_path(data_dir, key))
        for suffix in suffixes:
            for key in _ACT_CORR_KEYS:
                path = _act_corr_path(data_dir, key + suffix)
                data[key + suffix] = (np.loadtxt(path) if path.endswith('.txt')
                                      else np.load(path))
    # mirror load_data(lens_only=True): no correction arrays loaded at all.
    # ell range: the binning matrix columns span ell = 0..lmax+1
    data['trim_ellmax'] = int(data['binmat_act'].shape[1]) - 2
    return data


def write_act_dr6_data(data_dir, data, variant='act_baseline'):
    """Write the act_dr6_lenslike v1.2 file layout (inverse of
    :func:`read_act_dr6_data`; fixture generator for exercising the real
    directory reader without network access). ``data['covariance']`` (raw,
    pre-Hartlap) is preferred; falls back to inverting ``cinv``."""
    if variant not in ACT_VARIANTS:
        raise ValueError('unknown variant {!r}; expected one of {}'.format(
            variant, ACT_VARIANTS))
    include_planck = variant.startswith('actplanck')
    os.makedirs(data_dir, exist_ok=True)
    np.savetxt(os.path.join(data_dir, 'clkk_bandpowers_{}.txt'.format(variant)),
               np.asarray(data['data_binned_clkk'], dtype='f8'))
    cov = data.get('covariance')
    if cov is None:
        cov = np.linalg.inv(np.asarray(data['cinv'], dtype='f8'))
    np.savetxt(os.path.join(data_dir, 'covmat_{}.txt'.format(variant)),
               np.atleast_2d(np.asarray(cov, dtype='f8')))
    np.savetxt(os.path.join(data_dir, 'binning_matrix_act.txt'),
               np.atleast_2d(np.asarray(data['binmat_act'], dtype='f8')))
    if include_planck:
        np.savetxt(os.path.join(data_dir, 'binning_matrix_planck.txt'),
                   np.atleast_2d(np.asarray(data['binmat_planck'], dtype='f8')))
    suffixes = ('',) + (('_planck',) if include_planck else ())
    for key in _ACT_FID_CMB:
        if key in data:
            np.savetxt(_act_corr_path(data_dir, key), np.asarray(data[key], dtype='f8'))
    for suffix in suffixes:
        for key in _ACT_CORR_KEYS:
            full = key + suffix
            if full not in data:
                continue
            path = _act_corr_path(data_dir, full)
            if path.endswith('.txt'):
                np.savetxt(path, np.asarray(data[full], dtype='f8'))
            else:
                np.save(path, np.asarray(data[full], dtype='f8'))
