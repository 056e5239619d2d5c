"""CMB C_ell theory node.

Counterpart of ``desilike_tpu/likelihoods/cmb/base.py`` (``ClTheory``): the
C_ell come from tables injected at initialization (computed once by any
Boltzmann code), with an optional first- and second-order Taylor response
in the cosmological parameters, or from the emulated-Cl engine
(:mod:`.cl_emulator`), which recomputes the tables from the parameters each
evaluation. Per evaluation each spectrum is one product: the response
tables stacked as a (nterms, ellmax + 1) matrix against the (B, nterms)
parameter shifts and their products.

Everything downstream (binning, foregrounds, the H&L transforms) reads
``self.cls``, a dict xy -> (B, ellmax + 1) tensor (or (ellmax + 1,) when
nothing varies it) in the evaluation's dtype; ``self.cls64`` holds the same
in float64, in which the table response is computed, for the likelihoods
whose errors are below float32's rounding of the spectra (hillipop).
"""

import numpy as np
import torch

from ...core import Calculator


ALLOWED_CLS = ('tt', 'ee', 'bb', 'te', 'tb', 'eb', 'pp', 'tp', 'ep')


class ClTheory(Calculator):
    """Theory CMB C_ell^{xy} from injected tables.

    Parameters
    ----------
    cls : dict
        Requested spectra: {xy: ellmax} with xy in tt, ee, bb, te, tb, eb
        (lensed) and pp, tp, ep (lensing potential).
    tables : dict
        {xy: array} raw (dimensionless) C_ell starting at ell=0. Spectra
        requested but absent ('tb'/'eb') are zero.
    derivatives : dict, default=None
        {param_name: {xy: dC_ell/dparam array}} first-order response tables;
        each named parameter is registered (varied) with fiducial value
        ``center[param_name]`` and C_ell = table + sum_i (p_i - center_i) *
        dtable_i.
    derivatives2 : dict, default=None
        {(name_i, name_j): {xy: d2C_ell/dp_i dp_j array}} second-order
        response tables (1/2 for i == j, 1 for a mixed pair, each unordered
        pair given once).
    center : dict, default=None
        Expansion point for ``derivatives``/``derivatives2``.
    emulator : dict or path, default=None
        Emulated-Cl engine weights (:mod:`.cl_emulator`). Mutually exclusive
        with tables/derivatives.
    unit : str, default=None
        None (raw) or 'muK': multiply by (T0 * 1e6)^(2 - n_p) with n_p the
        number of 'p' in xy.
    T0 : float, default=2.7255
        CMB temperature for the muK conversion.
    """

    _propagate_namespace = False

    @staticmethod
    def _params(init):
        params = {}
        center = dict(init.get('center') or {})
        names = list(init.get('derivatives') or {})
        for pair in (init.get('derivatives2') or {}):
            for name in pair:
                if name not in names:
                    names.append(name)
        emulator = init.get('emulator')
        if emulator is not None:
            from ...cosmology.emulator import load_weights
            if isinstance(emulator, str) or hasattr(emulator, '__fspath__'):
                emulator = load_weights(emulator)
            center = dict(emulator.get('fiducial') or {})
            names = list(emulator['param_names'])
        for name in names:
            params[name] = dict(value=float(center.get(name, 0.)), prior=dict(limits=[-np.inf, np.inf]),
                                delta=0.01, latex=name.replace('_', r'\_'))
        return params

    def initialize(self, cls=None, tables=None, derivatives=None, derivatives2=None, center=None, unit=None,
                   T0=2.7255, lensing=None, non_linear=None, emulator=None):
        self.requested_cls = dict(cls or {})
        for xy in self.requested_cls:
            if xy not in ALLOWED_CLS:
                raise ValueError('unknown Cl {}; allowed: {}'.format(xy, ALLOWED_CLS))
        if unit not in (None, 'muK'):
            raise ValueError("unit must be None or 'muK'")
        self.unit = unit
        self.T0 = float(T0)
        if emulator is not None:
            self._init_emulator(emulator)
            return
        self._emu = None
        if tables is None:
            raise ValueError(
                'ClTheory needs injected C_ell tables or emulator weights: the in-framework EH98 backend has no '
                "Boltzmann hierarchy. Compute the tables once with CLASS/CAMB and pass tables={'tt': cl_tt, ...} "
                '(+ optional derivatives=/derivatives2= for a differentiable Taylor response), or pass emulator= '
                '(likelihoods/cmb/cl_emulator.py) for full recomputation per evaluation.')
        tables = {k: np.asarray(v, dtype='f8') for k, v in tables.items()}
        derivs = {name: {k: np.asarray(v, dtype='f8') for k, v in tabs.items()}
                  for name, tabs in (derivatives or {}).items()}
        derivs2 = {tuple(pair): {k: np.asarray(v, dtype='f8') for k, v in tabs.items()}
                   for pair, tabs in (derivatives2 or {}).items()}
        names = list(derivs)
        for pair in derivs2:
            names.extend(n for n in pair if n not in names)
        self._center = {name: float((center or {}).get(name, 0.)) for name in names}
        self._names = names
        self._pairs = list(derivs2)
        # per spectrum: the base table and the stacked response tables, rows over names then pairs (zero rows
        # where a parameter does not move the spectrum), the unit factor applied
        self._spectra = {}
        for xy, ellmax in self.requested_cls.items():
            ellmax = int(ellmax)
            if xy in ('tb', 'eb') and xy not in tables:
                base = np.zeros(ellmax + 1)
            else:
                if xy not in tables:
                    raise ValueError('no table injected for requested Cl {}'.format(xy))
                base = _prepare(tables[xy], ellmax)
            factor = self._unit_factor(xy)
            rows = [_prepare(derivs[name][xy], ellmax) if xy in derivs.get(name, {}) else np.zeros(ellmax + 1)
                    for name in names if name in derivs]
            rows += [_prepare(derivs2[pair][xy], ellmax) * (0.5 if pair[0] == pair[1] else 1.)
                     if xy in derivs2[pair] else np.zeros(ellmax + 1) for pair in self._pairs]
            setattr(self, '_cl_base_' + xy, base * factor)
            setattr(self, '_cl_response_' + xy, np.array(rows).reshape(-1, ellmax + 1) * factor)
            self._spectra[xy] = bool(rows)
        self._first = [name for name in names if name in derivs]

    def _unit_factor(self, xy):
        if self.unit == 'muK':
            return (self.T0 * 1e6) ** (2 - xy.count('p'))
        return 1.

    def _init_emulator(self, emulator):
        """Emulated-Cl engine: the MLP recomputes the full tables each
        evaluation (no Taylor limit). See :mod:`.cl_emulator`."""
        from ...cosmology.emulator import load_weights
        from .cl_emulator import interpolation_matrix
        if isinstance(emulator, str) or hasattr(emulator, '__fspath__'):
            emulator = load_weights(emulator)
        self._emu = emulator
        self._center = dict(emulator.get('fiducial') or {})
        spectra = tuple(emulator['spectra'])
        for xy in self.requested_cls:
            if xy not in spectra and xy not in ('tb', 'eb'):
                raise ValueError('emulator predicts {}, not requested {}'.format(spectra, xy))
        self._emu_matrix = interpolation_matrix(emulator)
        self._emu_layers = {}

    def calculate(self, **params):
        if self._emu is not None:
            from ...cosmology.emulator import layer_tensors
            from .cl_emulator import predict_cls
            like = next(iter(params.values()))
            key = (like.dtype, like.device)
            if key not in self._emu_layers:
                self._emu_layers[key] = layer_tensors(self._emu, like.device)
            theta = torch.stack([torch.as_tensor(params.get(name, self._center.get(name, 0.)), dtype=like.dtype,
                                                 device=like.device).expand(like.shape)
                                 for name in self._emu['param_names']], dim=-1)
            predicted = predict_cls(self._emu, theta, matrix=self.const('_emu_matrix'), layers=self._emu_layers[key])
            cls = {}
            for xy, ellmax in self.requested_cls.items():
                ellmax = int(ellmax)
                if xy in ('tb', 'eb') and xy not in predicted:
                    cls[xy] = torch.zeros(like.shape + (ellmax + 1,), dtype=like.dtype, device=like.device)
                    continue
                tab = predicted[xy][..., :ellmax + 1]
                if tab.shape[-1] < ellmax + 1:
                    tab = torch.nn.functional.pad(tab, (0, ellmax + 1 - tab.shape[-1]))
                cls[xy] = tab * self._unit_factor(xy)
            self.cls = cls
            self.cls64 = {xy: value.double() for xy, value in cls.items()}
            return
        f64 = torch.float64
        deltas = {name: params[name].to(f64) - self._center[name] for name in self._names}
        terms = [deltas[name] for name in self._first] + [deltas[ni] * deltas[nj] for ni, nj in self._pairs]
        shifts = torch.stack(terms, dim=-1) if terms else None
        cls64 = {}
        for xy, varied in self._spectra.items():
            base = self.const('_cl_base_' + xy, dtype=f64)
            cls64[xy] = base + shifts @ self.const('_cl_response_' + xy, dtype=f64) if varied else base
        self.cls64 = cls64
        self.cls = {xy: value.to(self.dtype) for xy, value in cls64.items()}

    def get(self):
        return self.cls


def _prepare(tab, ellmax):
    out = np.zeros(ellmax + 1)
    n = min(ellmax + 1, len(tab))
    out[:n] = tab[:n]
    return out


def synthetic_cl_tables(lmax=2600, seed=None, amp=1., tilt=0., theta=1., damp_scale=1.):
    """Smooth CMB-like C_ell fixture (damped acoustic oscillations) for tests
    and examples -- NOT a Boltzmann computation; a numpy copy of the JAX
    package's. Raw (dimensionless) units. Returns dict with tt, ee, te, bb,
    pp. ``amp`` scales the overall power (A_s-like), ``tilt`` adds a spectral
    slope (n_s-like), ``theta`` shifts the acoustic phase (theta_*-like),
    ``damp_scale`` moves the damping tail (omega_b-like)."""
    ell = np.arange(lmax + 1).astype('f8')
    ells = np.maximum(ell, 1.)
    # acoustic envelope: Dl_tt ~ plateau * oscillations * damping
    x = theta * ell / 220.
    osc = 1. + 0.6 * np.cos(np.pi * x) * np.exp(-ell / 1600.)
    damp = np.exp(-(ell / (1200. * damp_scale)) ** 1.4)
    dl_tt = amp * 1e-10 * (5.e3 * (ells / 200.) ** (0.04 + tilt) * osc * damp
                           + 1.e3 * np.exp(-ell / 80.))
    cl_tt = 2. * np.pi * dl_tt / (ells * (ells + 1.))
    cl_ee = 0.04 * cl_tt * (1. + 0.8 * np.sin(np.pi * x)) ** 2
    cl_te = 0.35 * np.sqrt(np.abs(cl_tt * cl_ee)) * np.cos(np.pi * x + 0.3)
    cl_bb = 0.05 * cl_ee
    cl_pp = 1e-8 * (ells / 60.) ** -2.5 / (1. + (ell / 700.) ** 2)
    for cl in (cl_tt, cl_ee, cl_te, cl_bb, cl_pp):
        cl[:2] = 0.
    return {'tt': cl_tt, 'ee': cl_ee, 'te': cl_te, 'bb': cl_bb, 'pp': cl_pp}


def request_cls(theory, requested):
    """Ask a ``ClTheory`` for the spectra ``requested`` ({xy: ellmax}) in
    muK^2, keeping any larger ellmax already requested (the likelihoods'
    shared wiring)."""
    if isinstance(theory, ClTheory):
        cls = dict(theory.init.get('cls') or {})
        for xy, ellmax in requested.items():
            cls[xy] = max(int(ellmax), int(cls.get(xy, 0)))
        theory.init.update(cls=cls, unit='muK', T0=2.7255)
