"""Planck 2020 (NPIPE/PR4) hillipop high-ell TT/TE/EE likelihood.

Counterpart of ``desilike_tpu/likelihoods/cmb/hillipop.py``: a Gaussian
likelihood on cross-half-mission spectra with a physical foreground model
(point sources, dust, CIB, tSZ, kSZ, SZxCIB) and per-map calibrations.

Each foreground is a static (nxspec, lmax+1) shape times a per-chain factor
per cross-spectrum, and the model enters the data vector only through the
weighted cross-frequency average and the static multipole selection, both
linear. So per mode the flat theory is

    t = (cal @ W_cmb) * D_ell^CMB[ell of each datum] + (cal * factors) @ W_fg

with W_cmb (nxspec, ndata) and W_fg (ncomponents nxspec, ndata) built once
on the host in float64 (the averaging matrix, the weights, the shapes, the
selection and the division by the summed weights folded in): two products a
mode per evaluation, where the JAX package materialises the (nxspec,
lmax+1) model of each component. chi2 is diff @ precision @ diff with the
dense precision, a plain product as in the JAX package. The flat theory and
chi2 run in float64 from the theory's float64 spectra (``ClTheory.cls64``),
the log-likelihood is cast to the evaluation's dtype:
with errors of 0.01% of the signal (the JAX tests' fixture), float32's
rounding of D_ell ~ 5e3 muK^2 is ~1e-3 of an error, and the log-likelihood
was 2.2e-2 and its gradient 6.9e-3 of its norm from the JAX package's x64
values near the data (measured on the CPU; config 3d's limits are 2e-2 and
5e-4), and 2.7e-3 and 3.0e-3 with this stage in float64 but the spectra in
float32.

The readers and writers of the real PR4 files are numpy copies of the JAX
package's, on the port's FITS codec.
"""

import itertools

import numpy as np
import torch

from ..base import BaseLikelihood
from .base import request_cls
from ...install import installed_data_dir

T_CMB = 2.72548
K_B = 1.3806503e-23
H_PL = 6.626068e-34

# Planck effective frequencies (reference hillipop.py:36-42)
FREQ_EFF = {
    'sz': {100: 100.24, 143: 143., 217: 222.044},
    'dust': {100: 105.2, 143: 147.5, 217: 228.1, 353: 370.5},
    'cib': {100: 105.2, 143: 147.5, 217: 228.1, 353: 370.5},
    'syn': {100: 100., 143: 143., 217: 217.},
    'radio': {100: 100.4, 143: 140.5, 217: 218.6},
}
F0 = 143


def _f_tsz(freq):
    x = H_PL * freq * 1e9 / (K_B * T_CMB)
    return x / np.tanh(x / 2.) - 4.


def _f_planck(f, T):
    nu = f * 1e9
    return nu ** 3 / (np.exp(H_PL * nu / (K_B * T)) - 1.)


def _dbdt(f):
    nu = f * 1e9
    x = H_PL * nu / (K_B * T_CMB)
    return nu ** 4 * np.exp(x) / (np.exp(x) - 1.) ** 2


def tsz_ratio(f, f0=F0):
    return _f_tsz(f) / _f_tsz(f0)


def cib_ratio(f, f0, beta):
    """Modified blackbody ratio in thermodynamic units (T=25K)."""
    T = 25.
    return (f / f0) ** beta * (_f_planck(f, T) / _f_planck(f0, T)) * (_dbdt(f0) / _dbdt(f))


def dust_ratio(f, f0, beta):
    """Dust modified blackbody (T=19.6K)."""
    T = 19.6
    return (f / f0) ** beta * (_f_planck(f, T) / _f_planck(f0, T)) * (_dbdt(f0) / _dbdt(f))


def radio_ratio(f, f0, beta):
    return (f / f0) ** beta * (_dbdt(f0) / _dbdt(f))


def powerlaw_dl(lmax, alpha, lnorm=3000):
    """D_ell power-law template normalized at lnorm (reference
    hillipop.py:98-113)."""
    nmax = max(lmax, lnorm or lmax)
    ell = np.arange(2, nmax + 1, dtype='f8')
    t = np.zeros(nmax + 1)
    t[2:] = ell * (ell + 1) / (2 * np.pi) * ell ** alpha
    if lnorm is not None:
        t = t / t[lnorm]
    return t[:lmax + 1]


class FgComponent(object):
    """One foreground as the JAX package holds it: dl(pars) = factor(pars)[:,
    None] * shape. Kept as the plain holder (name, shape (nxspec, lmax + 1),
    factor (a callable of the parameters and the mode), modes) that the reference's
    ``fgmodel`` name resolves to; :func:`build_foregrounds` folds the
    foregrounds into static tables instead."""

    def __init__(self, name, shape, factor, modes=('TT',)):
        self.name = name
        self.shape = np.asarray(shape, dtype='f8')
        self.factor = factor
        self.modes = tuple(modes)

    def dl(self, pars, mode):
        if mode not in self.modes:
            return 0.
        factor = torch.as_tensor(self.factor(pars, mode))
        return factor[..., None] * torch.as_tensor(self.shape, dtype=factor.dtype, device=factor.device)


def _pair_exponents(pairs, f0):
    """For a ratio (f/f0)^beta of each frequency of each pair: the summed
    ln(f/f0) of the pair (the exponent per unit beta), (npairs,)."""
    return np.array([np.log(f1 / f0) + np.log(f2 / f0) for f1, f2 in pairs])


def _static_ratio(f, f0, T):
    """The beta-independent part of a modified-blackbody ratio at temperature T."""
    return (_f_planck(f, T) / _f_planck(f0, T)) * (_dbdt(f0) / _dbdt(f))


def build_foregrounds(mode, frequencies, lmax, templates=None):
    """The standard hillipop foreground set for one mode, as a list of
    (name, shape (nxspec, lmax+1), factor) with ``factor(pars)`` the
    per-chain (B, nxspec) amplitudes; ``pars`` the (B,) parameters.

    templates : dict, optional arrays:
        'dust_TT'/'dust_EE'/'dust_TE' : (nxfreq, lmax+1) galactic dust per
        cross-frequency, 'tsz', 'ksz', 'cib', 'szxcib' : (lmax+1,); the
        power-law fallbacks of the JAX package (documented approximations)
        when absent.
    """
    templates = dict(templates or {})
    xfreqs = list(itertools.combinations(frequencies, 2))
    nxspec = len(xfreqs)
    ll2pi = np.arange(lmax + 1, dtype='f8')
    ll2pi = ll2pi * (ll2pi + 1) / (3000. * 3001.)

    def pairs(d):
        return [(d[f1], d[f2]) for f1, f2 in xfreqs]

    def template(name, alpha):
        if name in templates:
            t = np.asarray(templates[name], dtype='f8')
            out = np.zeros(lmax + 1)
            n = min(lmax + 1, len(t))
            out[:n] = t[:n]
            return out
        return powerlaw_dl(lmax, alpha)

    comps = []
    if mode == 'TT':
        radio = np.array([radio_ratio(f1, F0, -0.8) * radio_ratio(f2, F0, -0.8) for f1, f2 in pairs(FREQ_EFF['radio'])])
        cib_f = pairs(FREQ_EFF['cib'])
        cib_exp = _pair_exponents(cib_f, F0)
        cib_static = np.array([_static_ratio(f1, F0, 25.) * _static_ratio(f2, F0, 25.) for f1, f2 in cib_f])
        sz_f = pairs(FREQ_EFF['sz'])
        comps.append(('ps_radio', np.tile(ll2pi, (nxspec, 1)), lambda pars, c: pars['Aradio'][..., None] * c(radio)))

        def cib(amplitude):
            return lambda pars, c: pars[amplitude][..., None] * torch.exp(pars['beta_cib'][..., None] * c(cib_exp)) \
                * c(cib_static)

        comps.append(('ps_dusty', np.tile(ll2pi, (nxspec, 1)), cib('Adusty')))
        comps.append(('cib', np.tile(template('cib', -1.3), (nxspec, 1)), cib('Acib')))
        t_tsz = template('tsz', -0.5)
        comps.append(('tsz', np.stack([t_tsz * tsz_ratio(f1) * tsz_ratio(f2) for f1, f2 in sz_f]),
                      lambda pars, c: pars['Atsz'][..., None].expand(pars['Atsz'].shape + (nxspec,))))
        comps.append(('ksz', np.tile(template('ksz', -0.6), (nxspec, 1)),
                      lambda pars, c: pars['Aksz'][..., None].expand(pars['Aksz'].shape + (nxspec,))))
        # SZ x CIB: tsz(f2) cib(f1) + tsz(f1) cib(f2), each cib ratio (fc/F0)^beta times its static part
        ln1 = np.array([np.log(fc1 / F0) for fc1, _ in cib_f])
        ln2 = np.array([np.log(fc2 / F0) for _, fc2 in cib_f])
        s1 = np.array([tsz_ratio(fs2) * _static_ratio(fc1, F0, 25.) for (_, fs2), (fc1, _) in zip(sz_f, cib_f)])
        s2 = np.array([tsz_ratio(fs1) * _static_ratio(fc2, F0, 25.) for (fs1, _), (_, fc2) in zip(sz_f, cib_f)])

        def szxcib(pars, c):
            beta = pars['beta_cib'][..., None]
            return -(pars['xi'] * torch.sqrt(torch.abs(pars['Acib'] * pars['Atsz'])))[..., None] \
                * (c(s1) * torch.exp(beta * c(ln1)) + c(s2) * torch.exp(beta * c(ln2)))

        comps.append(('szxcib', np.tile(template('szxcib', -1.0), (nxspec, 1)), szxcib))
    # galactic dust: per-cross-frequency template, amplitude x modified-blackbody ratios
    dust_key = 'dust_' + mode
    dust_f = pairs(FREQ_EFF['dust'])
    if dust_key in templates:
        shape = np.asarray(templates[dust_key], dtype='f8')[:, :lmax + 1]
        if shape.shape[0] != nxspec:
            # per-cross-FREQUENCY columns (the real DUST_Planck_PR4 file layout): expand to cross-spectra by
            # frequency-pair lookup
            freqs_u = sorted(set(frequencies))
            xfreq_pairs = [(f1, f2) for i, f1 in enumerate(freqs_u) for f2 in freqs_u[i:]]
            shape = shape[[xfreq_pairs.index(tuple(sorted(p))) for p in xfreqs]]
    else:
        # fallback: steep power law with the galactic TT/EE/TE hierarchy
        amp = {'TT': 1., 'EE': 0.02, 'TE': 0.1, 'ET': 0.1}[mode]
        shape = np.tile(amp * powerlaw_dl(lmax, -2.6, lnorm=80), (nxspec, 1))
    f353 = FREQ_EFF['dust'][353]
    ln_first = np.array([np.log(f1 / f353) for f1, _ in dust_f])
    ln_second = np.array([np.log(f2 / f353) for _, f2 in dust_f])
    dust_static = np.array([_static_ratio(f1, f353, 19.6) * _static_ratio(f2, f353, 19.6) for f1, f2 in dust_f])

    def dust(pars, c, m=mode):
        aT, bT = pars['AdustT'], pars['beta_dustT']
        aP, bP = pars.get('AdustP', aT), pars.get('beta_dustP', bT)
        a1, b1 = (aT, bT) if m[0] == 'T' else (aP, bP)
        a2, b2 = (aT, bT) if m[1] == 'T' else (aP, bP)
        return (a1 * a2)[..., None] * torch.exp(b1[..., None] * c(ln_first) + b2[..., None] * c(ln_second)) \
            * c(dust_static)

    comps.append(('dust', shape, dust))
    return comps


def _hillipop_params(modes):
    params = {
        'A_planck': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.0025),
                         ref=dict(dist='norm', loc=1., scale=0.002), proposal=0.0005,
                         latex=r'y_\mathrm{cal}'),
    }
    for m in ('100A', '100B', '143B', '217A', '217B'):
        params['cal' + m] = dict(value=1., prior=dict(limits=[0.9, 1.1]),
                                 ref=dict(dist='norm', loc=1., scale=0.005),
                                 latex=r'c_\mathrm{{{}}}'.format(m))
    params['cal143A'] = dict(value=1., fixed=True, latex=r'c_\mathrm{143A}')
    if 'EE' in modes or 'TE' in modes:
        for m in ('100A', '100B', '143A', '143B', '217A', '217B'):
            params['pe' + m] = dict(value=1., fixed=True, latex=r'pe_\mathrm{{{}}}'.format(m))
    if 'TT' in modes:
        params.update({
            'Aradio': dict(value=60., prior=dict(limits=[0., 150.]),
                           ref=dict(dist='norm', loc=60., scale=1.), latex=r'A_\mathrm{radio}^\mathrm{PS}'),
            'Adusty': dict(value=6., prior=dict(limits=[0., 100.]),
                           ref=dict(dist='norm', loc=6., scale=1.), latex=r'A_\mathrm{IR}^\mathrm{PS}'),
            'Acib': dict(value=4., prior=dict(limits=[0., 20.]),
                         ref=dict(dist='norm', loc=4., scale=1.), latex=r'A_\mathrm{CIB}'),
            'beta_cib': dict(value=1.75, prior=dict(dist='norm', loc=1.75, scale=0.06),
                             latex=r'\beta_\mathrm{CIB}'),
            'Atsz': dict(value=3., prior=dict(limits=[0., 50.]),
                         ref=dict(dist='norm', loc=3., scale=1.), latex=r'A_\mathrm{tSZ}'),
            'Aksz': dict(value=1., prior=dict(limits=[0., 50.]),
                         ref=dict(dist='norm', loc=1., scale=1.), latex=r'A_\mathrm{kSZ}'),
            'xi': dict(value=0.1, prior=dict(limits=[-1., 1.]),
                       ref=dict(dist='norm', loc=0.1, scale=0.1), latex=r'\xi_\mathrm{SZxCIB}'),
        })
    params.update({
        'AdustT': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.1),
                       ref=dict(dist='norm', loc=1., scale=0.02), latex=r'A_\mathrm{dustT}'),
        'beta_dustT': dict(value=1.51, prior=dict(dist='norm', loc=1.51, scale=0.01),
                           latex=r'\beta_\mathrm{dustT}'),
    })
    if 'EE' in modes or 'TE' in modes:
        params.update({
            'AdustP': dict(value=1., prior=dict(dist='norm', loc=1., scale=0.1),
                           ref=dict(dist='norm', loc=1., scale=0.02), latex=r'A_\mathrm{dustP}'),
            'beta_dustP': dict(value=1.59, prior=dict(dist='norm', loc=1.59, scale=0.02),
                               latex=r'\beta_\mathrm{dustP}'),
        })
    return params


class BaseHillipopLikelihood(BaseLikelihood):
    """Hillipop machinery for a set of modes among TT/EE/TE.

    Parameters
    ----------
    theory : ClTheory
    data : dict
        'dldata' : {mode: (nxspec, lmax+1)} measured cross-spectra D_ell
        (muK^2; modes among TT, EE, TE, ET),
        'dlweight' : same layout, inverse-variance combination weights,
        'invcov' : (ndata, ndata) precision of the flattened data vector,
        'lmins'/'lmaxs' : {mode: (nxfreq,)} multipole ranges,
        'templates' : optional foreground templates (see build_foregrounds),
        'frequencies' : default (100, 100, 143, 143, 217, 217).
    """

    modes = ('TT', 'EE', 'TE')
    name = 'Hillipop'

    @classmethod
    def _params(cls, init):
        base = dict(BaseLikelihood._params)
        base.update(_hillipop_params(cls.modes))
        return base

    def initialize(self, theory=None, data=None, data_dir=None, **kwargs):
        if data is None and data_dir is None:
            data_dir = installed_data_dir('Planck2020HillipopLikelihood')
        if data is None and data_dir is not None:
            data = read_hillipop_data(data_dir, modes=self.modes)
        if data is None:
            raise ValueError('provide data= dict (see class docstring) or data_dir= with the PR4 hillipop products')
        self.frequencies = tuple(data.get('frequencies', (100, 100, 143, 143, 217, 217)))
        self._mapnames = tuple(data.get('mapnames', ('100A', '100B', '143A', '143B', '217A', '217B')))
        nmap = len(self.frequencies)
        freqs = sorted(set(self.frequencies))
        self._nxspec = nmap * (nmap - 1) // 2
        self._nxfreq = len(freqs) * (len(freqs) + 1) // 2
        # xspec -> xfreq map and averaging matrix
        xfreq_pairs = [(f1, f2) for i, f1 in enumerate(freqs) for f2 in freqs[i:]]
        self._xspec_pairs = list(itertools.combinations(range(nmap), 2))
        xspec2xfreq = [xfreq_pairs.index(tuple(sorted((self.frequencies[m1], self.frequencies[m2]))))
                       for m1, m2 in self._xspec_pairs]
        avg = np.zeros((self._nxfreq, self._nxspec))
        avg[xspec2xfreq, np.arange(self._nxspec)] = 1.
        dldata = {m: np.asarray(v, dtype='f8') for m, v in data['dldata'].items()}
        if 'ET' not in dldata and 'TE' in dldata:
            dldata['ET'] = dldata['TE']
        self.lmax = max(v.shape[1] - 1 for v in dldata.values())
        dlweight = {m: np.asarray(v, dtype='f8') for m, v in
                    data.get('dlweight', {m: np.ones_like(v) for m, v in dldata.items()}).items()}
        if 'ET' not in dlweight and 'TE' in dlweight:
            dlweight['ET'] = dlweight['TE']
        lmins = {m: np.asarray(v, dtype='i8') for m, v in data['lmins'].items()}
        lmaxs = {m: np.asarray(v, dtype='i8') for m, v in data['lmaxs'].items()}
        self.precision = np.asarray(data['invcov'], dtype='f8')
        ell = np.arange(self.lmax + 1)
        flat, self._mode_tables = [], []
        for mode in self.modes:
            # the selected (cross-frequency, ell) of each datum, and the weighted averages' denominators there
            select = [(xf, l) for xf in range(self._nxfreq) for l in range(lmins[mode][xf], lmaxs[mode][xf] + 1)]
            xf_sel, l_sel = (np.array(v, dtype='i8') for v in zip(*select))
            submodes = ('TE', 'ET') if mode == 'TE' else (mode,)
            weights = {sm: dlweight[sm][:, :self.lmax + 1] for sm in submodes}
            wsum = sum((avg @ weights[sm])[xf_sel, l_sel] for sm in submodes)
            flat.append(sum((avg @ (weights[sm] * dldata[sm][:, :self.lmax + 1]))[xf_sel, l_sel]
                            for sm in submodes) / wsum)
            # W[xs, datum] = avg[xf, xs] w[xs, l] / wsum, for each submode; the CMB table and each component's
            # shape-weighted table
            tables = []
            for sm in submodes:
                W = avg[xf_sel, :].T * weights[sm][:, l_sel] / wsum
                fgs = build_foregrounds(sm, self.frequencies, self.lmax, templates=data.get('templates'))
                W_fg = np.concatenate([W * shape[:, l_sel] for _, shape, _ in fgs], axis=0)
                tables.append((sm, W, W_fg, [factor for _, _, factor in fgs]))
            self._mode_tables.append((mode, ell[l_sel], tables))
        self.flatdata = np.concatenate(flat)
        if len(self.flatdata) != self.precision.shape[0]:
            raise ValueError('invcov size {} != data vector size {}'.format(self.precision.shape[0],
                                                                             len(self.flatdata)))
        for imode, (mode, ells, tables) in enumerate(self._mode_tables):
            setattr(self, '_ells_{:d}'.format(imode), ells)
            for sm, W, W_fg, _ in tables:
                setattr(self, '_W_cmb_' + sm, W)
                setattr(self, '_W_fg_' + sm, W_fg)
        if theory is None:
            raise ValueError('pass theory=ClTheory(tables=...)')
        self.theory = theory
        cls_needed = {(mode.lower() if mode != 'TE' else 'te'): self.lmax for mode in self.modes}
        if 'TT' in self.modes or 'TE' in self.modes:
            cls_needed['tt'] = self.lmax
        if 'EE' in self.modes or 'TE' in self.modes:
            cls_needed['ee'] = self.lmax
        request_cls(theory, cls_needed)
        self.factor = ell * (ell + 1) / 2. / np.pi
        self._arrays = {}

    def _const(self, values):
        """A host array of the foreground factors as a float64 tensor on the evaluation's device (cached by
        identity)."""
        key = (id(values), self.device)
        if key not in self._arrays:
            self._arrays[key] = (values, torch.as_tensor(values, dtype=torch.float64, device=self.device))
        return self._arrays[key][1]

    def _calibrations(self, pars, mode):
        """(B, nxspec) calibration of each cross-spectrum."""
        cal = []
        for m1, m2 in self._xspec_pairs:
            n1, n2 = self._mapnames[m1], self._mapnames[m2]
            c1, c2 = pars['cal' + n1], pars['cal' + n2]
            if mode == 'EE':
                c1, c2 = c1 * pars['pe' + n1], c2 * pars['pe' + n2]
            elif mode == 'TE':
                c2 = c2 * pars['pe' + n2]
            elif mode == 'ET':
                c1 = c1 * pars['pe' + n1]
            cal.append(c1 * c2 / pars['A_planck'] ** 2)
        return torch.stack(cal, dim=-1)

    def loglike_of_dl(self, dlth, **pars):
        """dlth: {'TT'/'EE'/'TE': (..., lmax+1) D_ell muK^2} -> (B,) log-likelihood, computed in float64."""
        f64 = torch.float64
        dlth = {mode: value.to(f64) for mode, value in dlth.items()}
        pars = {name: value.to(f64) for name, value in pars.items()}
        flat = []
        for imode, (mode, _, tables) in enumerate(self._mode_tables):
            ells = self.const('_ells_{:d}'.format(imode), dtype=torch.long)
            theory = 0.
            for sm, _, _, factors in tables:
                cal = self._calibrations(pars, sm)
                fg = torch.cat([factor(pars, self._const) for factor in factors], dim=-1) * cal.repeat(1, len(factors))
                theory = theory + (cal @ self.const('_W_cmb_' + sm, dtype=f64)) * dlth[mode][..., ells] \
                    + fg @ self.const('_W_fg_' + sm, dtype=f64)
            flat.append(theory)
        self.flattheory = torch.cat(flat, dim=-1)
        diff = self.const('flatdata', dtype=f64) - self.flattheory
        return -0.5 * ((diff @ self.const('precision', dtype=f64)) * diff).sum(-1)

    def calculate(self, **params):
        factor = self.const('factor', dtype=torch.float64)
        cls = getattr(self.theory, 'cls64', self.theory.cls)
        dlth = {mode: cls[mode.lower()][..., :self.lmax + 1].double() * factor for mode in self.modes}
        self.loglikelihood = self.loglike_of_dl(dlth, **params).to(self.dtype)


class TTTEEEHighlPlanck2020HillipopLikelihood(BaseHillipopLikelihood):
    modes = ('TT', 'EE', 'TE')
    name = 'TTTEEEHighlPlanck2020Hillipop'


class TTHighlPlanck2020HillipopLikelihood(BaseHillipopLikelihood):
    modes = ('TT',)
    name = 'TTHighlPlanck2020Hillipop'


class EEHighlPlanck2020HillipopLikelihood(BaseHillipopLikelihood):
    modes = ('EE',)
    name = 'EEHighlPlanck2020Hillipop'


class TEHighlPlanck2020HillipopLikelihood(BaseHillipopLikelihood):
    modes = ('TE',)
    name = 'TEHighlPlanck2020Hillipop'


# --------------------------------------------------------------------------
# Real Planck PR4 (v4.2) file layout: reader + writer
#
# The reference reads these products with fitsio (ref hillipop.py:640-706):
#   data/binning_v4.2.fits                      BINTABLE per mode: header
#                                               'SPEC', columns LMIN/LMAX per
#                                               cross-SPECTRUM (nxspec=15)
#   data/dl_PR4_v4.2_{mA}x{mB}.fits             image ext 1: (>=4, lmax+1)
#                                               D_ell in K^2, rows TT/EE/BB/TE;
#                                               ext 2: same-layout sigma;
#                                               the reversed {mB}x{mA} file's
#                                               row 3 is the ET spectrum
#   data/invfll_PR4_v4.2_{MODES}.fits           image: flat (n*n,) inverse
#                                               covariance in K^-4
#   foregrounds/DUST_Planck_PR4_model_v4.2_{mode}.txt   columns: ell + one per
#                                               cross-frequency (6)
#   foregrounds/{SZ,kSZ,CIB,SZxCIB}_Planck_PR4_model.txt  columns: ell, D_ell
#                                               (normalized at ell=3000 on read)
#
# Here the same layouts go through the in-repo minimal FITS codec
# (desilike_tpu_torch/io_fits.py) so the real-product code path is exercised in a
# zero-egress container; the writer produces byte-layout-faithful fixtures.

DUST_XFREQ_COLUMNS = ('100x100', '100x143', '100x217', '143x143', '143x217', '217x217')
_SCALAR_TEMPLATES = {'tsz': 'SZ_Planck_PR4_model.txt',
                     'ksz': 'kSZ_Planck_PR4_model.txt',
                     'cib': 'CIB_Planck_PR4_model.txt',
                     'szxcib': 'SZxCIB_Planck_PR4_model.txt'}


def _xspec_maps(frequencies):
    freqs = sorted(set(frequencies))
    xfreq_pairs = [(f1, f2) for i, f1 in enumerate(freqs) for f2 in freqs[i:]]
    xspec_pairs = list(itertools.combinations(range(len(frequencies)), 2))
    xspec2xfreq = [xfreq_pairs.index(tuple(sorted((frequencies[m1], frequencies[m2]))))
                   for m1, m2 in xspec_pairs]
    return xspec_pairs, xspec2xfreq, len(xfreq_pairs)


def _read_dl_template_txt(filename, lmax, lnorm=3000):
    """(ell, D_ell) text template -> dense (lmax+1,), normalized at lnorm
    (reference hillipop.py:115-134)."""
    ell, data = np.loadtxt(filename, unpack=True)
    ell = np.asarray(ell, dtype='i8')
    t = np.zeros(max(lmax, int(ell.max())) + 1)
    t[ell] = data
    # real PR4 templates extend past lnorm; small-lmax fixtures don't --
    # skip the normalization rather than divide by an absent/zero bin
    if lnorm is not None and lnorm < len(t) and t[lnorm] != 0:
        t = t / t[lnorm]
    return t[:lmax + 1]


def read_hillipop_data(data_dir, modes=('TT', 'EE', 'TE'), version='v4.2',
                       frequencies=(100, 100, 143, 143, 217, 217),
                       mapnames=('100A', '100B', '143A', '143B', '217A', '217B')):
    """Load the real Planck PR4 hillipop products; returns the dict consumed
    by ``BaseHillipopLikelihood(data=...)``. ``modes`` must match the
    inverse-covariance file's mode suffix (e.g. TT/EE/TE -> TTTEEE)."""
    import os
    from ... import io_fits

    _, xspec2xfreq, nxfreq = _xspec_maps(frequencies)

    # multipole ranges: per-xspec in the file, per-xfreq in the data dict
    # (the reference itself only ever uses the first xspec of each xfreq,
    # ref hillipop.py:728-729)
    lmins, lmaxs = {}, {}
    fn = os.path.join(data_dir, 'data', 'binning_{}.fits'.format(version))
    for hdu in io_fits.hdus(fn)[1:]:
        hdr = hdu.read_header()
        tag = str(hdr.get('SPEC', hdr.get('spec', ''))).strip()
        first = [xspec2xfreq.index(xf) for xf in range(nxfreq)]
        lmins[tag] = np.asarray(hdu['LMIN'], dtype='i8')[first]
        lmaxs[tag] = np.asarray(hdu['LMAX'], dtype='i8')[first]
    lmax = int(max(v.max() for v in lmaxs.values()))

    # cross-spectra + weights: one file per ordered half-mission map pair
    basename = os.path.join(data_dir, 'data', 'dl_PR4_{}'.format(version))
    dldata = {m: [] for m in ('TT', 'EE', 'TE', 'ET')}
    dlsig = {m: [] for m in ('TT', 'EE', 'TE', 'ET')}
    for m1, m2 in itertools.combinations(mapnames, 2):
        for ext, dest in ((1, dldata), (2, dlsig)):
            fwd = io_fits.read('{}_{}x{}.fits'.format(basename, m1, m2), ext=ext) * 1e12
            rev = io_fits.read('{}_{}x{}.fits'.format(basename, m2, m1), ext=ext) * 1e12
            dest['TT'].append(fwd[0, :lmax + 1])
            dest['EE'].append(fwd[1, :lmax + 1])
            dest['TE'].append(fwd[3, :lmax + 1])
            dest['ET'].append(rev[3, :lmax + 1])
    dldata = {m: np.asarray(v) for m, v in dldata.items()}
    dlweight = {}
    for m, v in dlsig.items():
        sig = np.asarray(v)
        sig[sig == 0] = np.inf  # zero sigma marks unmeasured bins (ref :516)
        dlweight[m] = 1. / sig ** 2

    fn = os.path.join(data_dir, 'data',
                      'invfll_PR4_{}_{}.fits'.format(version, ''.join(modes)))
    invcov = np.asarray(io_fits.read(fn), dtype='f8').reshape(-1)
    n = int(round(np.sqrt(invcov.size)))
    invcov = invcov.reshape(n, n) / 1e24  # K^-4 -> muK^-4

    templates = {}
    fgdir = os.path.join(data_dir, 'foregrounds')
    for mode in ('TT', 'EE', 'TE'):
        fn = os.path.join(fgdir, 'DUST_Planck_PR4_model_{}_{}.txt'.format(version, mode))
        if os.path.exists(fn):
            tab = np.loadtxt(fn).T
            ell = np.asarray(tab[0], dtype='i8')
            dust = np.zeros((len(DUST_XFREQ_COLUMNS), max(lmax, int(ell.max())) + 1))
            for xf in range(len(DUST_XFREQ_COLUMNS)):
                dust[xf, ell] = tab[1 + xf]
            templates['dust_' + mode] = dust[:, :lmax + 1]
    for key, base in _SCALAR_TEMPLATES.items():
        fn = os.path.join(fgdir, base)
        if os.path.exists(fn):
            templates[key] = _read_dl_template_txt(fn, lmax)

    out = {'dldata': {m: dldata[m] for m in set(modes) | ({'TE', 'ET'} if 'TE' in modes else set())},
           'dlweight': {m: dlweight[m] for m in set(modes) | ({'TE', 'ET'} if 'TE' in modes else set())},
           'lmins': lmins, 'lmaxs': lmaxs, 'invcov': invcov,
           'frequencies': tuple(frequencies), 'mapnames': tuple(mapnames)}
    if templates:
        out['templates'] = templates
    return out


def write_hillipop_data(data_dir, data, version='v4.2', modes=('TT', 'EE', 'TE')):
    """Write the Planck PR4 hillipop file layout (inverse of
    :func:`read_hillipop_data`) — fixture generator for exercising the
    real-product readers without network access."""
    import os
    from ... import io_fits

    frequencies = tuple(data.get('frequencies', (100, 100, 143, 143, 217, 217)))
    mapnames = tuple(data.get('mapnames', ('100A', '100B', '143A', '143B', '217A', '217B')))
    xspec_pairs, xspec2xfreq, nxfreq = _xspec_maps(frequencies)
    os.makedirs(os.path.join(data_dir, 'data'), exist_ok=True)
    os.makedirs(os.path.join(data_dir, 'foregrounds'), exist_ok=True)

    dldata = {m: np.asarray(v, dtype='f8') for m, v in data['dldata'].items()}
    if 'ET' not in dldata and 'TE' in dldata:
        dldata['ET'] = dldata['TE']
    lmax = max(v.shape[1] - 1 for v in dldata.values())
    default_w = {m: np.ones_like(v) for m, v in dldata.items()}
    dlweight = {m: np.asarray(v, dtype='f8')
                for m, v in data.get('dlweight', default_w).items()}
    if 'ET' not in dlweight and 'TE' in dlweight:
        dlweight['ET'] = dlweight['TE']

    # binning: broadcast the per-xfreq ranges back to every xspec
    tables = []
    for mode in modes:
        lmin_xf = np.asarray(data['lmins'][mode], dtype='i8')
        lmax_xf = np.asarray(data['lmaxs'][mode], dtype='i8')
        tables.append(io_fits.Hdu(
            columns={'LMIN': lmin_xf[xspec2xfreq], 'LMAX': lmax_xf[xspec2xfreq]},
            header={'SPEC': mode}))
    io_fits.write(os.path.join(data_dir, 'data', 'binning_{}.fits'.format(version)),
                  tables)

    basename = os.path.join(data_dir, 'data', 'dl_PR4_{}'.format(version))

    def spectra_image(xs, te_mode):
        img = np.zeros((4, lmax + 1))
        img[0] = dldata['TT'][xs] if 'TT' in dldata else 0.
        img[1] = dldata['EE'][xs] if 'EE' in dldata else 0.
        img[3] = dldata[te_mode][xs] if te_mode in dldata else 0.
        return img * 1e-12  # muK^2 -> K^2 on disk

    def sigma_image(xs, te_mode):
        img = np.zeros((4, lmax + 1))
        for row, m in ((0, 'TT'), (1, 'EE'), (3, te_mode)):
            if m in dlweight:
                w = dlweight[m][xs]
                img[row] = np.where(w > 0, 1. / np.sqrt(np.maximum(w, 1e-300)), 0.)
        return img * 1e-12

    for xs, (m1, m2) in enumerate(itertools.combinations(mapnames, 2)):
        io_fits.write('{}_{}x{}.fits'.format(basename, mapnames[xspec_pairs[xs][0]],
                                             mapnames[xspec_pairs[xs][1]]),
                      [io_fits.Hdu(), io_fits.Hdu(data=spectra_image(xs, 'TE')),
                       io_fits.Hdu(data=sigma_image(xs, 'TE'))])
        io_fits.write('{}_{}x{}.fits'.format(basename, mapnames[xspec_pairs[xs][1]],
                                             mapnames[xspec_pairs[xs][0]]),
                      [io_fits.Hdu(), io_fits.Hdu(data=spectra_image(xs, 'ET')),
                       io_fits.Hdu(data=sigma_image(xs, 'ET'))])

    invcov = np.asarray(data['invcov'], dtype='f8') * 1e24
    io_fits.write(os.path.join(data_dir, 'data',
                               'invfll_PR4_{}_{}.fits'.format(version, ''.join(modes))),
                  [io_fits.Hdu(data=invcov.reshape(-1))])

    templates = data.get('templates') or {}
    ell = np.arange(lmax + 1)
    for mode in modes:
        key = 'dust_' + ('TE' if mode == 'ET' else mode)
        if key in templates:
            dust = np.asarray(templates[key], dtype='f8')
            tab = np.column_stack([ell] + [dust[xf, :lmax + 1]
                                           for xf in range(dust.shape[0])])
            np.savetxt(os.path.join(
                data_dir, 'foregrounds',
                'DUST_Planck_PR4_model_{}_{}.txt'.format(version, mode)), tab)
    for key, base in _SCALAR_TEMPLATES.items():
        if key in templates:
            t = np.asarray(templates[key], dtype='f8')
            np.savetxt(os.path.join(data_dir, 'foregrounds', base),
                       np.column_stack([ell[:len(t)], t]))
