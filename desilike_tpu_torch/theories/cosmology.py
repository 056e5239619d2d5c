"""Cosmology calculator node, evaluated per chain.

Counterpart of ``desilike_tpu/theories/cosmology.py`` for the ``eh98`` and
``eh99`` engines (EH98 transfer functions, and EH99's massive-neutrino
free-streaming suppression), the ``table`` engine (an injected pk at the
fiducial cosmology with the exact + EH98-ratio parameter response) and the
``emulator`` engine (a trained MLP correction to EH98,
:mod:`..cosmology.emulator`: its (nz, nk) ln-ratio table predicted per
chain, then linear in z and in ln k). Every parameter arrives as a ``(B,)``
tensor; the accessors return ``(B,)`` or ``(B, nk)`` tensors on the
evaluation's device, from one parameter dict built per evaluation, which
caches the growth solution (:func:`..cosmology.background.growth_solution`).
With ``theta=True`` the node varies ``theta_MC_100`` in place of h and
solves h per chain from 100 theta_* (:meth:`Cosmology._solve_h`).
The ``external`` engine reads a host code's products (E(z), the comoving
distance, rs_drag, the linear pk table, sigma8 and f sigma8) from tables on
fixed grids, set by :meth:`Cosmology.inject` or passed in through the
pipeline's ``'external:<index>:<attr>'`` values (the bindings,
:mod:`desilike_tpu_torch.bindings`): one table for every chain of the
batch, copied to the evaluation's device once per injection.
"""

import numpy as np
import torch

from ..core import Calculator
from ..cosmology import background as bg
from ..cosmology import linear as lin
from ..cosmology import eh
from ..cosmology import emulator as emu


_COSMO_PARAM_DEFAULTS = {
    'h': dict(value=0.6736, prior=dict(limits=[0.1, 1.]), ref=dict(dist='norm', loc=0.6736, scale=0.005), latex='h'),
    'omega_cdm': dict(value=0.1200, prior=dict(limits=[0.01, 0.99]), ref=dict(dist='norm', loc=0.12, scale=0.001), latex=r'\omega_{cdm}'),
    'omega_b': dict(value=0.02237, prior=dict(limits=[0.005, 0.1]), ref=dict(dist='norm', loc=0.02237, scale=0.0002), latex=r'\omega_{b}'),
    'logA': dict(value=3.036394, prior=dict(limits=[1.61, 3.91]), ref=dict(dist='norm', loc=3.036, scale=0.01), latex=r'\ln(10^{10} A_s)'),
    'n_s': dict(value=0.9649, prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=0.9649, scale=0.004), latex='n_s'),
    'tau_reio': dict(value=0.0544, prior=dict(limits=[0.01, 0.8]), latex=r'\tau'),
    'm_ncdm': dict(value=0.06, prior=dict(limits=[0., 5.]), latex=r'\sum m_\nu'),
    'N_ur': dict(value=2.0328, latex='N_{ur}'),
    'Omega_k': dict(value=0., prior=dict(limits=[-0.3, 0.3]), latex=r'\Omega_k'),
    'w0_fde': dict(value=-1., prior=dict(limits=[-3., 1.]), latex='w_0'),
    'wa_fde': dict(value=0., prior=dict(limits=[-3., 2.]), latex='w_a'),
}

TNCDM_NEFF = (bg.TNCDM / (4. / 11.) ** (1. / 3.)) ** 4


def get_from(obj, name, z=None):
    """Uniform quantity access used by templates and extractors."""
    fn = getattr(obj, name)
    return fn(z) if z is not None else fn()


class Cosmology(Calculator):
    """Differentiable cosmology node. All parameters fixed by default; vary a
    subset via ``init.params`` or ``fixed=``. One node is typically shared
    across tracers, so it keeps no namespace of theirs.

    Exposes: efunc(z), comoving_radial_distance(z),
    comoving_angular_distance(z), hubble_distance(z), rs_drag(),
    growth_rate(z), growth_factor(z), growth_rate_k(k, z), pk_dd(k, z),
    pk_dd_now(k, z), sigma_r(r, z), sigma8(z), fsigma8(z) and N_eff; ``z``
    static, ``k`` a grid (a tensor on the evaluation's device, or numpy).
    """

    _propagate_namespace = False

    @staticmethod
    def _params(init):
        fixed = init.get('fixed', True)
        theta = bool(init.get('theta', False))

        def is_fixed(name):
            return True if fixed is True else (name in fixed if hasattr(fixed, '__contains__') else bool(fixed))

        params = {name: dict(cfg, fixed=is_fixed(name)) for name, cfg in _COSMO_PARAM_DEFAULTS.items()
                  if not (theta and name == 'h')}
        if theta:
            # the CosmoMC-style sound-horizon angle in place of h, which is solved from it each evaluation
            params['theta_MC_100'] = dict(value=1.04109, prior=dict(limits=[0.9, 1.2]),
                                          ref=dict(dist='norm', loc=1.04109, scale=0.0005),
                                          fixed=is_fixed('theta_MC_100') and is_fixed('h'), latex=r'100\theta_\mathrm{MC}')
            params['h'] = dict(derived=True, latex='h')
        return params

    def initialize(self, fiducial=None, fixed=True, engine='eh98', pk_table=None, z_grid=None, k_grid=None,
                   zpk_grid=None, theta=False, emulator=None):
        self._use_theta = bool(theta)
        self.engine = str(engine)
        if self.engine not in ('eh98', 'eh99', 'table', 'external', 'emulator'):
            raise ValueError("engine must be 'eh98'/'eh99' (approximate few-percent transfer functions, "
                             "self-contained), 'emulator' (trained Boltzmann-correction MLP), 'table' (injected "
                             "Boltzmann pk, fiducial-pinned response) or 'external' (per-evaluation host-code "
                             "products, bindings)")
        base = dict(bg.DEFAULT_PARAMS)
        if fiducial:
            base.update(fiducial)
        self.fiducial_values = base
        if self.engine == 'emulator':
            if emulator is None:
                raise ValueError("engine='emulator' needs emulator=<weights dict or .npz path from "
                                 'cosmology.emulator.train_pk_emulator>')
            self._emu_weights = emu.load_weights(emulator) if isinstance(emulator, str) or \
                hasattr(emulator, '__fspath__') else emulator
            missing = [n for n in self._emu_weights['param_names'] if n not in base]
            if missing:
                raise ValueError('emulator expects unknown parameters {}'.format(missing))
            # static no-wiggle companion: a Gaussian ln-k smoothing of the predicted ln-ratio removes its
            # residual BAO-phase wiggles
            self._emu_lnk = np.log(np.asarray(self._emu_weights['k_grid'], dtype='f8'))
            self._emu_smooth_t = np.ascontiguousarray(lin.smoothing_matrix(self._emu_lnk).T)
            self._emu_layers = {}
        # the JAX package decides on a concrete value whether the massive neutrinos have a density: fixed at 0, none
        m_ncdm = next(param for param in self.params if param.basename == 'm_ncdm')
        self._massless_ncdm = not base.get('N_ncdm', 1) or (m_ncdm.fixed and float(m_ncdm.value) == 0.)
        if self.engine == 'table':
            if pk_table is None:
                raise ValueError("engine='table' needs pk_table=(k, pk) at z=0 from a Boltzmann code at the "
                                 'fiducial cosmology')
            ktab, pktab = (np.asarray(v, dtype='f8') for v in pk_table)
            self._lnk_tab, self._lnpk_tab = np.log(ktab), np.log(pktab)
            self._p_fid = bg.resolve(dict(base))
            self._p_fid_tensors = {}
            self._alpha_nw = lin.table_nowiggle_amplitude(self._p_fid, self._lnk_tab, self._lnpk_tab)
        if self.engine == 'external':
            self._init_external(z_grid, k_grid, zpk_grid)

    _EXTERNAL_ATTRS = ('efunc_tab', 'chi_tab', 'rs_drag_tab', 'pk_tab', 'fsigma8_tab', 'sigma8_tab')

    def _init_external(self, z_grid, k_grid, zpk_grid):
        """The host-cosmology tables on fixed grids (h-units: k in h/Mpc, pk
        in (Mpc/h)^3, distances in Mpc/h), filled with the EH98 values of the
        node's cosmology in float64 on the host, so that the node evaluates
        before the first injection; and the requirements a host code reads
        (``cosmo_requires``)."""
        self.z_grid = np.asarray(z_grid if z_grid is not None else np.linspace(0., 4., 65), dtype='f8')
        self.k_grid = np.asarray(k_grid if k_grid is not None else np.geomspace(1e-4, 10., 256), dtype='f8')
        self.zpk_grid = np.asarray(zpk_grid if zpk_grid is not None else np.linspace(0., 3., 13), dtype='f8')
        # the node's parameters stay fixed here (the host varies the cosmology): the EH98 no-wiggle shape
        # of pk_dd_now is that of their values, made on the host
        self._p_host = bg.resolve(self._inputs({param.basename: float(param.value) for param in self.params
                                                if param.derived is not True}))
        self._external_varied = any(param.varied for param in self.params)
        p = bg.resolve(dict(self.fiducial_values))
        self.efunc_tab = np.asarray(bg.efunc(p, self.z_grid), dtype='f8')
        self.chi_tab = np.asarray(bg.comoving_radial_distance(p, self.z_grid), dtype='f8')
        self.rs_drag_tab = np.asarray(bg.rs_drag(p), dtype='f8')
        self.pk_tab = np.stack([lin.pk_lin(p, self.k_grid, zz) for zz in self.zpk_grid])
        self.sigma8_tab = np.array([float(lin.sigma_r(p, 8., zz)) for zz in self.z_grid])
        self.fsigma8_tab = np.asarray(bg.growth_rate(p, self.z_grid), dtype='f8') * self.sigma8_tab
        self._external_attrs = self._EXTERNAL_ATTRS
        self._external_nowiggle = {}
        self.cosmo_requires = {
            'background': {'efunc': {'z': self.z_grid}, 'comoving_radial_distance': {'z': self.z_grid}},
            'thermodynamics': {'rs_drag': None},
            'fourier': {'pk_interpolator': {'k': self.k_grid, 'z': self.zpk_grid, 'of': [('delta_m', 'delta_m')],
                                            'non_linear': False},
                        'fsigma8': {'z': self.z_grid}, 'sigma8_z': {'z': self.z_grid}}}

    def inject(self, **arrays):
        """Set external tables (host arrays, float64). Keys: efunc_tab,
        chi_tab, rs_drag_tab, pk_tab, fsigma8_tab, sigma8_tab; each of the
        shape of the node's grids. A table the node has already read on a
        device is copied there now, once, and the pipeline's calls read that
        copy."""
        self.runtime_info.initialize()
        if self.engine != 'external':
            raise ValueError("inject() requires engine='external'")
        cache = self.__dict__.get('_const_cache', {})
        for name, value in arrays.items():
            if name not in self._external_attrs:
                raise ValueError('unknown external quantity {}; expected {}'.format(name, self._external_attrs))
            value = np.asarray(value, dtype='f8')
            expected = np.shape(getattr(self, name))
            if value.shape != expected:
                raise ValueError('{} shape {} != grid shape {}'.format(name, value.shape, expected))
            read = list(cache[name][1]) if name in cache else []  # the (dtype, device) the old table was read in
            setattr(self, name, value)
            for dtype, device in read:
                self.const(name, dtype, device)

    def external_tensor(self, name, dtype, device):
        """The current table ``name`` as a tensor of ``dtype`` on ``device``:
        the copy made at injection (or at the first read after it), or the
        table passed in for this call."""
        value = getattr(self, name)
        return value.to(dtype) if isinstance(value, torch.Tensor) else self.const(name, dtype, device)

    def _inputs(self, params):
        """The parameter dict of one evaluation, before :func:`bg.resolve`."""
        p = dict(self.fiducial_values)
        p.update({k: v for k, v in params.items() if k in p or k in ('A_s', 'alpha_s')})
        # alternative inputs: w0_fld/wa_fld are CLASS's names of w0_fde/wa_fde; N_eff is the total radiation
        # (N_ur + N_ncdm contributions); Omega_m sets omega_cdm given h, omega_b and the neutrino density
        if 'w0_fld' in params:
            p['w0_fde'] = params['w0_fld']
        if 'wa_fld' in params:
            p['wa_fde'] = params['wa_fld']
        if 'N_eff' in params:
            p['N_ur'] = params['N_eff'] - p.get('N_ncdm', 1) * TNCDM_NEFF
        if 'Omega_m' in params:
            p['omega_cdm'] = (params['Omega_m'] * p['h'] ** 2 - p['omega_b']
                              - p['m_ncdm'] * bg.NEUTRINO_MASS_TO_OMEGA)
        p['_massless_ncdm'] = self._massless_ncdm
        return p

    def calculate(self, **params):
        p = self._inputs(params)
        if self._use_theta and 'theta_MC_100' in params:
            p['h'] = self.h = self._solve_h(p, params['theta_MC_100'])
        self.p = bg.resolve(p)
        if self.engine == 'emulator':
            like = bg.ref(self.p)
            key = (like.dtype, like.device)
            if key not in self._emu_layers:
                self._emu_layers[key] = emu.layer_tensors(self._emu_weights, like.device)
            theta = torch.stack([torch.as_tensor(self.p[name], dtype=like.dtype, device=like.device).expand(like.shape)
                                 for name in self._emu_weights['param_names']], dim=-1)
            self._emu_lnr, self._emu_rs_ratio = emu.predict_tables(self._emu_weights, theta,
                                                                   layers=self._emu_layers[key])
            self._emu_lnr_smooth = self._emu_lnr @ bg.as_grid(self._emu_smooth_t, self.p)

    @staticmethod
    def _solve_h(p, target):
        """h per chain from 100 theta_* = ``target`` ((B,)): 8 Newton steps from
        the fiducial h, the iterates clipped to [0.05, 1.5], NaN for a chain
        whose residual is at or above 1e-6 of its target (the JAX package's
        rule, ``desilike_tpu/theories/cosmology.py:191-212``). The steps run
        outside the autograd graph; one more Newton step from the solution,
        with theta_* differentiable in the parameters and its slope in h held
        constant, carries the gradient: at the root it is the implicit
        function theorem's dh = -(d theta_* - d target) / (d theta_* / dh),
        the limit of the JAX package's derivative through its unrolled steps.
        In the evaluation's dtype: the 1e-6 gate sits ~9 float32 ulps from
        the target, but float32's residuals stayed within 3.4e-7 of it over
        4096 chains (measured on the CPU), so no chain is sent to NaN."""
        fixed = {name: value.detach() if isinstance(value, torch.Tensor) else value for name, value in p.items()}

        def theta(params, h):
            return bg.theta_star_100(bg.resolve({**params, 'h': h}))

        def value_and_slope(h):
            return torch.func.jvp(lambda hh: theta(fixed, hh), (h,), (torch.ones_like(h),))

        goal = target.detach()
        h = torch.full_like(goal, float(p['h']))
        with torch.no_grad():
            for _ in range(8):
                value, slope = value_and_slope(h)
                h = torch.clamp(h - (value - goal) / slope, 0.05, 1.5)
            value, slope = value_and_slope(h)
            converged = torch.abs(value - goal) < 1e-6 * goal
        h = h - (theta(p, h) - value - (target - goal)) / slope
        return torch.where(converged, h, torch.full_like(h, np.nan))

    # --- emulator-engine helpers ---

    def _emu_z_bracket(self, z):
        zg = np.asarray(self._emu_weights['z_grid'], dtype='f8')
        iz = int(np.clip(np.searchsorted(zg, z) - 1, 0, len(zg) - 2))
        t = float(np.clip((z - zg[iz]) / (zg[iz + 1] - zg[iz]), 0., 1.))
        return zg, iz, t

    def _emu_interp(self, rows, k):
        """rows (B, nk_emu) on the emulator's ln k grid, linear in ln k at
        ``k`` (a static grid (n,) or one row a chain (B, n)); the edge
        values outside."""
        lnk_grid = bg.as_grid(self._emu_lnk, self.p)
        lnk = torch.log(self._grid(k))
        idx = torch.clamp(torch.searchsorted(lnk_grid, lnk.contiguous(), right=True) - 1, 0, lnk_grid.shape[-1] - 2)
        t = torch.clamp((lnk - lnk_grid[idx]) / (lnk_grid[idx + 1] - lnk_grid[idx]), 0., 1.)
        if lnk.ndim == 1:
            lo, hi = rows[..., idx], rows[..., idx + 1]
        else:
            lo, hi = torch.gather(rows, -1, idx), torch.gather(rows, -1, idx + 1)
        return torch.lerp(lo, hi, t)

    def _emu_lnratio_at(self, table, k, z):
        """The ln-ratio table (B, nz, nk_emu) at ``k``: linear in z, then in ln k."""
        _, iz, t = self._emu_z_bracket(z)
        return self._emu_interp((1. - t) * table[..., iz, :] + t * table[..., iz + 1, :], k)

    def _grid(self, k):
        return bg.as_grid(k, self.p)

    # --- background ---

    def efunc(self, z):
        if self.engine == 'external':
            return self._external_at('efunc_tab', self.z_grid, z)
        return bg.efunc(self.p, z)

    def comoving_angular_distance(self, z):
        if self.engine == 'external':
            # flat geometry: the host products carry the radial distance only
            return self.comoving_radial_distance(z)
        return bg.comoving_angular_distance(self.p, z)

    def comoving_radial_distance(self, z):
        if self.engine == 'external':
            return self._external_at('chi_tab', self.z_grid, z)
        return bg.comoving_radial_distance(self.p, z)

    def hubble_distance(self, z):
        return bg.DH_100 / self.efunc(z)

    def rs_drag(self):
        if self.engine == 'external':
            return self._chains(self._external('rs_drag_tab'))
        if self.engine == 'emulator':
            return bg.rs_drag(self.p) * self._emu_rs_ratio
        return bg.rs_drag(self.p)

    @property
    def N_eff(self):
        return self.p['N_ur'] + self.p.get('N_ncdm', 1) * TNCDM_NEFF

    # --- growth & fourier ---

    def growth_rate(self, z):
        if self.engine == 'external':
            return self.fsigma8(z) / self.sigma8(z)
        return bg.growth_rate(self.p, z)

    def growth_factor(self, z):
        if self.engine == 'external':
            return self.sigma8(z) / self.sigma8(0.)
        return bg.growth_factor(self.p, z)

    def growth_rate_k(self, k, z):
        """Scale-dependent growth rate f(k, z), (B, nk): flat except for the
        eh99 engine, where massive-neutrino free-streaming suppresses it
        (EH99 eq. 11)."""
        k = self._grid(k)
        f = bg.over(self.growth_rate(z), k)
        if self.engine == 'eh99':
            return f * eh.growth_rate_ratio(self.p, k, z)
        if self.engine == 'emulator':
            # the ratio table carries the scale-dependent growth: f(k, z) = f_bg(z) - (1+z)/2 dln r/dz, with the
            # z-derivative from the table's piecewise-linear slope
            zg, iz, _ = self._emu_z_bracket(z)
            slope = (self._emu_lnr[..., iz + 1, :] - self._emu_lnr[..., iz, :]) / (zg[iz + 1] - zg[iz])
            return f - 0.5 * (1. + z) * self._emu_interp(slope, k)
        return f.expand(f.shape[:f.ndim - k.ndim] + k.shape)

    def _fiducial(self):
        """The table engine's fiducial parameters as tensors of the evaluation's dtype and device, made once."""
        like = bg.ref(self.p)
        key = (like.dtype, like.device)
        if key not in self._p_fid_tensors:
            self._p_fid_tensors[key] = bg.tensors(self._p_fid, like)
        return self._p_fid_tensors[key]

    def _pk(self, p, k, z):
        if self.engine == 'table':
            return lin.pk_lin_table(p, self._fiducial(), self._lnk_tab, self._lnpk_tab, k, z)
        if self.engine == 'eh99':
            return lin.pk_lin(p, k, z) * eh.neutrino_ratio(p, k, z)
        return lin.pk_lin(p, k, z)

    def pk_dd(self, k, z):
        k = self._grid(k)
        if self.engine == 'external':
            return self._pk_external(k, z)
        if self.engine == 'emulator':
            return lin.pk_lin(self.p, k, z) * torch.exp(self._emu_lnratio_at(self._emu_lnr, k, z))
        return self._pk(self.p, k, z)

    def pk_dd_rows(self, k, z):
        """pk_dd at one row of k a chain, (B, n) (the extractors' pivots
        rescaled per chain)."""
        if self.engine == 'external':
            return self._pk_external(k, z)
        rows = bg.per_chain(lambda p, row: self._pk(p, row, z), self.p, k)
        if self.engine == 'emulator':
            rows = rows * torch.exp(self._emu_lnratio_at(self._emu_lnr, k, z))
        return rows

    def pk_dd_now(self, k, z):
        k = self._grid(k)
        if self.engine == 'table':
            # the table's response algebra; the smooth EH98 shape scaled to its normalization
            return self._alpha_nw * lin.pk_lin(self.p, k, z, nowiggle=True)
        if self.engine == 'eh99':
            return lin.pk_lin(self.p, k, z, nowiggle=True) * eh.neutrino_ratio(self.p, k, z)
        if self.engine == 'external':
            # the smooth EH98 shape, amplitude-matched to the injected table: (sigma8(z) / sigma_r(8, z))^2
            # pk_lin(k, z, nowiggle=True), a no-wiggle reference for the wiggle-split filters
            return self.sigma8(z) ** 2 * self._nowiggle_shape(k, z)
        if self.engine == 'emulator':
            # the ln-k-smoothed ratio: the broadband correction without the truth table's residual wiggles
            return lin.pk_lin(self.p, k, z, nowiggle=True) * torch.exp(self._emu_lnratio_at(self._emu_lnr_smooth, k, z))
        return lin.pk_lin(self.p, k, z, nowiggle=True)

    def sigma_r(self, r, z=0.):
        if self.engine == 'eh98':
            return lin.sigma_r(self.p, r, z)
        if self.engine == 'external':
            return lin.sigma_r(self.p, r, z, pk_func=lambda k: self._pk_external(k, z))
        return lin.sigma_r(self.p, r, z, pk_func=lambda k: self.pk_dd(k, z))

    def sigma8(self, z=0.):
        if self.engine == 'external':
            return self._external_at('sigma8_tab', self.z_grid, z, chains=False)
        # through sigma_r, so that the table, eh99 and emulator engines stay consistent with pk_dd
        return self.sigma_r(8., z)

    def fsigma8(self, z=0.):
        if self.engine == 'external':
            return self._external_at('fsigma8_tab', self.z_grid, z, chains=False)
        return self.growth_rate(z) * self.sigma8(z)

    # --- external-engine helpers ---

    def _external(self, name):
        """The current table ``name`` in the evaluation's dtype, on its device."""
        like = bg.ref(self.p)
        return self.external_tensor(name, like.dtype, like.device)

    def _chains(self, value):
        """A value that is one for every chain, broadcast (a view) to the
        batch's leading dimension: (B,) + its shape. The distances and
        rs_drag are, as the AP effect's lookups take one row of k a chain;
        the growth quantities (f, sigma8, f sigma8, the pk tables) stay one
        value, so that the loop tables made from them are made once."""
        batch = bg.ref(self.p).shape
        return value.expand(batch + value.shape)

    def _external_at(self, name, grid, z, chains=True):
        """Table ``name`` on the host grid ``grid``, linear in z (``np.interp``:
        the edge values outside), (B,) + z's shape. A static z (a number or
        numpy) has its bracket found on the host (``chains=False``: z's shape,
        one value for every chain); a tensor one (one redshift a chain, (B,))
        by ``torch.searchsorted``."""
        table = self._external(name)
        if isinstance(z, torch.Tensor):
            return lin.interp(z.to(table.dtype), bg.as_grid(grid, self.p), table)
        z = np.asarray(z, dtype='f8')
        idx = np.clip(np.searchsorted(grid, z, side='right') - 1, 0, len(grid) - 2)
        t = np.clip((z - grid[idx]) / (grid[idx + 1] - grid[idx]), 0., 1.)
        out = [torch.lerp(table[i], table[i + 1], float(w)) for i, w in zip(idx.ravel(), t.ravel())]
        out = out[0] if z.ndim == 0 else torch.stack(out).reshape(z.shape)
        return self._chains(out) if chains else out

    def _pk_external(self, k, z):
        """The injected (nzpk, nk) table at ``k`` (a static grid, or one row a
        chain) and the static ``z``: linear in z between the two rows that
        bracket it (found on the host), then in ln k (``torch.searchsorted``
        and a gather), in ln pk; the edge values outside. On a static grid
        the result is one row for every chain, (nk,): its Chebyshev fit is
        made once, and the lookups share its coefficients."""
        lnpk = torch.log(self._external('pk_tab'))
        z = float(z)
        grid = self.zpk_grid
        iz = int(np.clip(np.searchsorted(grid, z, side='right') - 1, 0, len(grid) - 2))
        t = float(np.clip((z - grid[iz]) / (grid[iz + 1] - grid[iz]), 0., 1.))
        row = torch.lerp(lnpk[iz], lnpk[iz + 1], t)
        lnk = torch.log(self._grid(k).to(row.dtype))
        return torch.exp(lin.interp(lnk, bg.as_grid(np.log(self.k_grid), self.p), row))

    def _nowiggle_shape(self, k, z):
        """pk_lin(p, k, z, nowiggle=True) / sigma_r(p, 8, z)^2 of the node's
        cosmology, for pk_dd_now: with its parameters fixed, made once a grid
        (kept by the grid tensor's identity) in float64 on the host."""
        if self._external_varied:
            return lin.pk_lin(self.p, k, z, nowiggle=True) / bg.over(lin.sigma_r(self.p, 8., z) ** 2, k)
        key = (id(k), float(z))
        hit = self._external_nowiggle.get(key)
        if hit is None or hit[0] is not k:
            host_k = k.detach().cpu().double().numpy()
            shape = lin.pk_lin(self._p_host, host_k, z, nowiggle=True) / lin.sigma_r(self._p_host, 8., z) ** 2
            if len(self._external_nowiggle) >= 16:
                self._external_nowiggle.clear()
            hit = self._external_nowiggle[key] = (k, torch.as_tensor(shape, dtype=k.dtype, device=k.device))
        return hit[1]

    def get(self):
        return self
