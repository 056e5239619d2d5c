"""Planck NPIPE CamSpec high-ell TTTEEE likelihood.

Counterpart of ``desilike_tpu/likelihoods/cmb/camspec.py``:

- the six blocks (100x100/143x143/217x217/143x217 TT, TE, EE) are static
  index selections of the theory C_ell fixed at initialization: one gather
  a spectrum per chain;
- the TT foregrounds are the CamSpec power laws amp (ell/1500)^n in D_ell,
  on each block's selected ells;
- calibration divides the theory blocks by [cal0, 1, cal2, sqrt(cal2),
  calTE, calEE] * A_planck^2;
- chi2 through the whitened residual (one GEMM against the whitening).

Data come from the NPIPE 12.6 distribution layout (``data_dir=``) or from
arrays (``data=``, see ``synthetic_camspec_data``); the reader, writer and
fixture are numpy copies of the JAX package's.
"""

import os

import numpy as np
import torch

from ..base import BaseGaussianLikelihood
from .base import request_cls
from ...install import installed_data_dir
from .planck2018 import _CALIB_PARAMS


ALL_BLOCKS = ('100x100', '143x143', '217x217', '143x217', 'TE', 'EE')
TT_BLOCKS = ALL_BLOCKS[:4]
_FG_PIVOT = 1500.


def _camspec_params():
    params = dict(BaseGaussianLikelihood._params)
    params.update(_CALIB_PARAMS)
    params.update({
        'cal0': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.002), latex=r'c_{100}'),
        'cal2': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.002), latex=r'c_{217}'),
        'calTE': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.01), latex=r'c_{TE}'),
        'calEE': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.01), latex=r'c_{EE}'),
        'amp_100': dict(value=0., latex=r'A^{\rm power}_{100}'),
        'n_100': dict(value=1., latex=r'\gamma^{\rm power}_{100}'),
    })
    for name in ('143', '217', '143x217'):
        params['amp_' + name] = dict(value=10., prior=dict(dist='uniform', limits=[0., 50.]),
                                     ref=dict(dist='norm', loc=10., scale=1.),
                                     latex=r'A^{{\rm power}}_{{{}}}'.format(name))
        params['n_' + name] = dict(value=1., prior=dict(dist='uniform', limits=[0., 5.]),
                                   ref=dict(dist='norm', loc=1., scale=0.2),
                                   latex=r'\gamma^{{\rm power}}_{{{}}}'.format(name))
    return params


class BasePlanckNPIPECamspecLikelihood(BaseGaussianLikelihood):
    """CamSpec NPIPE Gaussian likelihood on per-frequency spectra."""

    _select_blocks = ALL_BLOCKS[1:]
    _params = _camspec_params()

    def initialize(self, theory=None, data=None, data_dir=None, select_blocks=None, **kwargs):
        blocks = tuple(select_blocks if select_blocks is not None else self._select_blocks)
        for block in blocks:
            if block not in ALL_BLOCKS:
                raise ValueError('unknown CamSpec block {}; expected {}'.format(block, ALL_BLOCKS))
        if data is None and data_dir is None:
            data_dir = installed_data_dir('Planck2020CamSpecLikelihood')
        if data is None and data_dir is not None:
            data = read_camspec_data(data_dir)
        if data is None:
            raise ValueError('pass data= (arrays, see synthetic_camspec_data) or data_dir= (real NPIPE 12.6 '
                             'distribution layout)')
        # per-block selected multipoles, flattened in ALL_BLOCKS order; the data covariance spans every block
        # present in the data, so a block subset selects the matching sub-matrix
        data_blocks = [b for b in ALL_BLOCKS if len(data['ells'].get(b, ())) > 0]
        self._blocks = [b for b in data_blocks if b in blocks]
        self._ells = {b: np.asarray(data['ells'][b], dtype='i8') for b in self._blocks}
        flatdata = np.concatenate([np.asarray(data['spectra'][b], dtype='f8') for b in self._blocks])
        keep = np.concatenate([np.full(len(data['ells'][b]), b in blocks, dtype='?') for b in data_blocks])
        covariance = np.asarray(data['covariance'], dtype='f8')
        if covariance.shape[0] == keep.size:
            covariance = covariance[np.ix_(keep, keep)]
        if covariance.shape != (flatdata.size, flatdata.size):
            raise ValueError('covariance shape {} != selected data size {}'.format(covariance.shape, flatdata.size))
        self.ellmax = int(max(e.max() for e in self._ells.values()))
        ell = np.arange(self.ellmax + 1, dtype='f8')
        self._dl_factor = ell * (ell + 1.) / (2. * np.pi)
        for block in self._blocks:
            setattr(self, '_ells_' + block, self._ells[block])
            setattr(self, '_pivot_' + block, self._ells[block] / _FG_PIVOT)
        if theory is None:
            raise ValueError('pass theory=ClTheory(...): C_ell must come from injected tables or the emulated-Cl '
                             'engine')
        self.theory = theory
        request_cls(theory, {xy: self.ellmax for xy in ('tt', 'te', 'ee')})
        super().initialize(data=flatdata, covariance=covariance, **kwargs)

    @staticmethod
    def _calibrations(params):
        """Per-block divisors, (B,) each."""
        a2 = params['A_planck'] ** 2
        cals = {'100x100': params['cal0'], '143x143': 1., '217x217': params['cal2'],
                '143x217': torch.sqrt(params['cal2']), 'TE': params['calTE'], 'EE': params['calEE']}
        return {b: cals[b] * a2 for b in cals}

    def flattheory(self):
        return self._flattheory

    def calculate(self, **params):
        factor = self.const('_dl_factor')
        dl = {xy: factor * self.theory.cls[xy][..., :self.ellmax + 1] for xy in ('tt', 'te', 'ee')}
        cals = self._calibrations(params)
        pieces = []
        for block in self._blocks:
            idx = self.const('_ells_' + block, dtype=torch.long)
            if block in TT_BLOCKS:
                name = block.split('x')[0] if block != '143x217' else '143x217'
                fg = params['amp_' + name][..., None] * self.const('_pivot_' + block) ** params['n_' + name][..., None]
                theory = dl['tt'][..., idx] + fg
            else:
                theory = dl[block.lower()][..., idx]
            pieces.append(theory / cals[block][..., None])
        self._flattheory = torch.cat(pieces, dim=-1)
        super().calculate()


class TTTEEEHighlPlanckNPIPECamspecLikelihood(BasePlanckNPIPECamspecLikelihood):
    """TTTEEE selection."""

    name = 'TTTEEEHighlPlanckNPIPECamspec'
    _select_blocks = ('143x143', '217x217', '143x217', 'TE', 'EE')


class TTHighlPlanckNPIPECamspecLikelihood(BasePlanckNPIPECamspecLikelihood):
    """TT-only selection."""

    name = 'TTHighlPlanckNPIPECamspec'
    _select_blocks = ('143x143', '217x217', '143x217')


def read_camspec_data(data_dir, select_blocks=ALL_BLOCKS):
    """Load the real NPIPE 12.6 files (reference camspec.py:34-79 layout):
    like_NPIPE_12.6_unified_spectra.txt / _data_ranges.txt / _cov.bin.
    Returns the dict consumed by ``initialize(data=...)``."""
    spectra_tab = np.loadtxt(os.path.join(data_dir, 'like_NPIPE_12.6_unified_spectra.txt'),
                             ndmin=2)
    ells, spectra, masks = {}, {}, []
    with open(os.path.join(data_dir, 'like_NPIPE_12.6_unified_data_ranges.txt'),
              encoding='utf-8-sig') as fh:
        lines = [line.split() for line in fh if line.strip()]
    for icol, items in enumerate(lines):
        block, lo, hi = items[0], int(items[1]), int(items[2])
        nells = hi - lo + 1
        use = block in select_blocks and hi > 0
        masks.append(np.full(nells, use, dtype='?'))
        if use:
            ells[block] = np.arange(lo, hi + 1)
            spectra[block] = spectra_tab[lo:hi + 1, icol]
    mask = np.concatenate(masks)
    cov = np.fromfile(os.path.join(data_dir, 'like_NPIPE_12.6_unified_cov.bin'),
                      dtype=np.float32)
    n = mask.size
    cov = cov.reshape(n, n)[np.ix_(mask, mask)].astype('f8')
    return {'ells': ells, 'spectra': spectra, 'covariance': cov}


def write_camspec_data(data_dir, data):
    """Write the NPIPE 12.6 unified file layout (inverse of
    :func:`read_camspec_data`): spectra table indexed by multipole with one
    column per block, the data-ranges text file, and the float32 covariance
    binary. Used to exercise the real-file reader on synthetic fixtures in
    a zero-egress environment (reference layout: camspec.py:34-79)."""
    blocks = [b for b in ALL_BLOCKS if len(data['ells'].get(b, ())) > 0]
    nrows = max(int(np.max(data['ells'][b])) for b in blocks) + 1
    tab = np.zeros((nrows, len(blocks)))
    lines = []
    for icol, block in enumerate(blocks):
        ell = np.asarray(data['ells'][block], dtype='i8')
        lo, hi = int(ell[0]), int(ell[-1])
        if not np.array_equal(ell, np.arange(lo, hi + 1)):
            raise ValueError('NPIPE layout requires contiguous ell ranges (block {})'.format(block))
        tab[lo:hi + 1, icol] = np.asarray(data['spectra'][block], dtype='f8')
        lines.append('{} {:d} {:d}'.format(block, lo, hi))
    np.savetxt(os.path.join(data_dir, 'like_NPIPE_12.6_unified_spectra.txt'), tab)
    with open(os.path.join(data_dir, 'like_NPIPE_12.6_unified_data_ranges.txt'), 'w') as fh:
        fh.write('\n'.join(lines) + '\n')
    np.asarray(data['covariance'], dtype=np.float32).tofile(
        os.path.join(data_dir, 'like_NPIPE_12.6_unified_cov.bin'))


def synthetic_camspec_data(cl_tables, noise=1., seed=42,
                           params=None, lranges=None):
    """Build a CamSpec-layout fixture from raw C_ell tables (the zero-egress
    test path). Spectra are D_ell in muK^2 with the given foreground/
    calibration parameters applied, plus Gaussian scatter consistent with a
    cosmic-variance-like diagonal covariance scaled by ``noise``."""
    rng = np.random.default_rng(seed)
    params = dict(params or {})
    lranges = dict(lranges or {'100x100': (30, 1200), '143x143': (30, 2000),
                               '217x217': (500, 2500), '143x217': (500, 2500),
                               'TE': (30, 2000), 'EE': (30, 2000)})
    muk2 = (2.7255 * 1e6) ** 2
    lmax_avail = len(cl_tables['tt']) - 1
    ells, spectra, variances = {}, {}, []
    a2 = params.get('A_planck', 1.) ** 2
    cals = {'100x100': params.get('cal0', 1.), '143x143': 1.,
            '217x217': params.get('cal2', 1.),
            '143x217': np.sqrt(params.get('cal2', 1.)),
            'TE': params.get('calTE', 1.), 'EE': params.get('calEE', 1.)}
    for block, (lo, hi) in lranges.items():
        hi = min(hi, lmax_avail)
        ell = np.arange(lo, hi + 1)
        factor = ell * (ell + 1.) / (2. * np.pi)
        xy = 'tt' if block in TT_BLOCKS else block.lower()
        dl = factor * muk2 * np.asarray(cl_tables[xy][lo:hi + 1], dtype='f8')
        if block in TT_BLOCKS:
            name = block.split('x')[0] if block != '143x217' else '143x217'
            dl = dl + params.get('amp_' + name, 0.) * (ell / _FG_PIVOT) ** params.get('n_' + name, 1.)
        dl = dl / (cals[block] * a2)
        # cosmic-variance-like scatter floor keyed to the TT envelope
        dl_tt = factor * muk2 * np.asarray(cl_tables['tt'][lo:hi + 1], dtype='f8')
        sig = noise * np.sqrt(2. / (2. * ell + 1.)) * (np.abs(dl) + 0.05 * dl_tt + 1.)
        ells[block] = ell
        spectra[block] = dl + rng.standard_normal(ell.size) * sig
        variances.append(sig ** 2)
    cov = np.diag(np.concatenate(variances))
    return {'ells': ells, 'spectra': spectra, 'covariance': cov}
