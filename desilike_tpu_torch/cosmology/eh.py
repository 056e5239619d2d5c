"""Eisenstein & Hu transfer functions in torch, for one cosmology or a batch
of chains.

Counterpart of ``desilike_tpu/cosmology/eh.py``: the EH98 baryon+CDM
transfer with BAO wiggles (astro-ph/9709112 eqs. 2-24), the zero-baryon
no-wiggle form (eqs. 26-31), the EH98 sound horizon, and the EH99
massive-neutrino correction (astro-ph/9710252). Parameters and grids as in
:mod:`.background`: a host dict of numbers returns float64 numpy, a dict of
``(B,)`` tensors returns ``(B, nk)`` tensors.

All inputs: k in h/Mpc; internal EH scales in 1/Mpc.
"""

import math

import torch

from . import background as bg
from .background import host, as_grid, over


def _params_eh(p):
    """Common EH98 intermediate scales (per chain)."""
    h = p['h']
    om = bg.omega_cb(p)     # EH98 'omega_m h^2' (cdm+b; neutrinos excluded)
    ob = p['omega_b']
    theta = p['T_cmb'] / 2.7
    theta2 = theta * theta
    theta4 = theta2 * theta2

    z_eq = 2.50e4 * om / theta4
    k_eq = 7.46e-2 * om / theta2  # Mpc^-1

    b1 = 0.313 * om ** -0.419 * (1. + 0.607 * om ** 0.674)
    b2 = 0.238 * om ** 0.223
    z_d = 1291. * om ** 0.251 / (1. + 0.659 * om ** 0.828) * (1. + b1 * ob ** b2)

    R_d = 31.5 * ob / theta4 * (1e3 / z_d)
    R_eq = 31.5 * ob / theta4 * (1e3 / z_eq)

    s = 2. / (3. * k_eq) * torch.sqrt(6. / R_eq) * torch.log(
        (torch.sqrt(1. + R_d) + torch.sqrt(R_d + R_eq)) / (1. + torch.sqrt(R_eq)))

    k_silk = 1.6 * ob ** 0.52 * om ** 0.73 * (1. + (10.4 * om) ** -0.95)

    return dict(h=h, om=om, ob=ob, theta2=theta2, z_eq=z_eq, k_eq=k_eq,
                z_d=z_d, R_d=R_d, R_eq=R_eq, s=s, k_silk=k_silk)


def _T0_tilde(q, alpha, beta):
    """EH98 eqs. 19-20: pressureless CDM fit."""
    C = 14.2 / alpha + 386. / (1. + 69.9 * q ** 1.08)
    L = torch.log(math.e + 1.8 * beta * q)
    return L / (L + C * q * q)


def _over(values, k):
    """Per-chain constants against the grid ``k``, in ``k``'s dtype."""
    return {name: over(value.to(k.dtype) if isinstance(value, torch.Tensor) else value, k)
            for name, value in values.items()}


def _transfer_constants(p):
    """The per-chain constants of :func:`transfer`, in float64, computed once
    per parameter dict (kept in ``p['_eh98']``)."""
    if '_eh98' not in p:
        c = _params_eh(bg.float64(p))
        om, ob = c['om'], c['ob']
        fb = ob / om
        fc = 1. - fb
        # CDM piece (eqs. 11-12, 17-18)
        a1 = (46.9 * om) ** 0.670 * (1. + (32.1 * om) ** -0.532)
        a2 = (12.0 * om) ** 0.424 * (1. + (45.0 * om) ** -0.582)
        alpha_c = a1 ** (-fb) * a2 ** (-fb ** 3)
        bb1 = 0.944 / (1. + (458. * om) ** -0.708)
        bb2 = (0.395 * om) ** -0.0266
        beta_c = 1. / (1. + bb1 * (fc ** bb2 - 1.))
        # baryon piece (eqs. 14-15, 21-24)
        y = (1. + c['z_eq']) / (1. + c['z_d'])
        sqrt1y = torch.sqrt(1. + y)
        G = y * (-6. * sqrt1y + (2. + 3. * y) * torch.log((sqrt1y + 1.) / (sqrt1y - 1.)))
        alpha_b = 2.07 * c['k_eq'] * c['s'] * (1. + c['R_d']) ** -0.75 * G
        beta_b = 0.5 + fb + (3. - 2. * fb) * torch.sqrt((17.2 * om) ** 2 + 1.)
        beta_node = 8.41 * om ** 0.435
        p['_eh98'] = dict(h=c['h'], k_eq=c['k_eq'], s=c['s'], k_silk=c['k_silk'], fb=fb, fc=fc, alpha_c=alpha_c,
                          beta_c=beta_c, alpha_b=alpha_b, beta_b=beta_b, beta_node=beta_node)
    return p['_eh98']


@host
def transfer(p, k):
    """Full EH98 transfer T(k) with BAO wiggles; k in h/Mpc. The per-chain
    constants (the fitting formulas' coefficients) are computed in float64,
    the k grid in ``k``'s dtype: in float32 the cancellation in G (eq. 15:
    two terms of ~12.5 whose sum is ~0.25) puts up to 3.5e-5 on alpha_b, which put
    the reduced config 3d's log-posterior 2.5e-2 from the JAX package's x64
    values, over its 2e-2 limit (5e-3 with these constants in float64;
    measured on the CPU)."""
    k = as_grid(k, p)
    e = _over(_transfer_constants(p), k)
    km = k * e['h']  # Mpc^-1
    q = km / (13.41 * e['k_eq'])
    ks = km * e['s']
    f = 1. / (1. + (ks / 5.4) ** 4)
    T_c = f * _T0_tilde(q, 1., e['beta_c']) + (1. - f) * _T0_tilde(q, e['alpha_c'], e['beta_c'])
    s_tilde = e['s'] / (1. + (e['beta_node'] / ks) ** 3) ** (1. / 3.)
    j0 = torch.sinc(km * s_tilde / math.pi)  # spherical Bessel j0(x)
    T_b = (_T0_tilde(q, 1., 1.) / (1. + (ks / 5.2) ** 2)
           + e['alpha_b'] / (1. + (e['beta_b'] / ks) ** 3) * torch.exp(-(km / e['k_silk']) ** 1.4)) * j0
    return e['fb'] * T_b + e['fc'] * T_c


def _nowiggle_constants(p):
    """The per-chain constants of :func:`transfer_nowiggle`, in float64,
    computed once per parameter dict (kept in ``p['_eh98_nowiggle']``)."""
    if '_eh98_nowiggle' not in p:
        c = _params_eh(bg.float64(p))
        om, ob = c['om'], c['ob']
        fb = ob / om
        # eq. 26: fitted sound horizon (Mpc)
        s = 44.5 * torch.log(9.83 / om) / torch.sqrt(1. + 10. * ob ** 0.75)
        # eqs. 30-31
        alpha_g = 1. - 0.328 * torch.log(431. * om) * fb + 0.38 * torch.log(22.3 * om) * fb ** 2
        p['_eh98_nowiggle'] = dict(h=c['h'], s=s, alpha_g=alpha_g, om_h=om / c['h'], theta2=c['theta2'])
    return p['_eh98_nowiggle']


@host
def transfer_nowiggle(p, k):
    """EH98 zero-baryon (no-wiggle) transfer (eqs. 26, 28-31); k in h/Mpc;
    the per-chain constants in float64, as in :func:`transfer`."""
    k = as_grid(k, p)
    e = _over(_nowiggle_constants(p), k)
    km = k * e['h']
    gamma_eff = e['om_h'] * (e['alpha_g'] + (1. - e['alpha_g']) / (1. + (0.43 * km * e['s']) ** 4))
    q = k * e['theta2'] / gamma_eff
    L0 = torch.log(2. * math.e + 1.8 * q)
    C0 = 14.2 + 731. / (1. + 62.5 * q)
    return L0 / (L0 + C0 * q * q)


@host
def sound_horizon_eh(p):
    """EH98 sound horizon s (eq. 6) in Mpc/h (internal consistency scale)."""
    c = _params_eh(p)
    return c['s'] * c['h']


# --- Eisenstein & Hu 1999 massive-neutrino correction (astro-ph/9710252) ---

def _params_eh99(p):
    """EH99 density fractions and epochs (per chain). Total matter includes
    the massive-neutrino contribution; fractions are guarded so the f_nu ->
    0 limit is smooth."""
    h = p['h']
    onu = bg.omega_ncdm(p)
    ocb = bg.omega_cb(p)
    om = ocb + onu
    ob = p['omega_b']
    theta = p['T_cmb'] / 2.7
    theta2 = theta * theta

    fnu = torch.clamp(onu / om, 1e-12, 0.5)
    fb = ob / om
    fc = 1. - fb - fnu
    fcb = fc + fb
    fnub = fnu + fb
    Nnu = float(p.get('N_ncdm', 1) or 1)

    z_eq = 2.50e4 * om / theta2 ** 2
    b1 = 0.313 * om ** -0.419 * (1. + 0.607 * om ** 0.674)
    b2 = 0.238 * om ** 0.223
    z_d = 1291. * om ** 0.251 / (1. + 0.659 * om ** 0.828) * (1. + b1 * ob ** b2)
    y_d = (1. + z_eq) / (1. + z_d)
    # eq. 4: fitted sound horizon (Mpc)
    s = 44.5 * torch.log(9.83 / om) / torch.sqrt(1. + 10. * ob ** 0.75)

    def p_of(f):
        return (5. - torch.sqrt(1. + 24. * f)) / 4.

    return dict(h=h, om=om, theta2=theta2, fnu=fnu, fb=fb, fc=fc, fcb=fcb,
                fnub=fnub, Nnu=Nnu, z_eq=z_eq, y_d=y_d, s=s,
                p_c=p_of(fc), p_cb=p_of(fcb))


def _eh99_alpha_nu(c):
    """EH99 eq. 15: small-scale suppression amplitude alpha_nu."""
    fc, fcb, fnu, fnub, Nnu = c['fc'], c['fcb'], c['fnu'], c['fnub'], c['Nnu']
    p_c, p_cb, y_d = c['p_c'], c['p_cb'], c['y_d']
    out = (fc / fcb) * (5. - 2. * (p_c + p_cb)) / (5. - 4. * p_cb)
    out = out * (1. - 0.553 * fnub + 0.126 * fnub ** 3) \
        / (1. - 0.193 * torch.sqrt(fnu * Nnu) + 0.169 * fnu * Nnu ** 0.2)
    out = out * (1. + y_d) ** (p_cb - p_c)
    out = out * (1. + (p_c - p_cb) / 2. * (1. + 1. / ((3. - 4. * p_c) * (7. - 4. * p_cb))) / (1. + y_d))
    return out


def _eh99_master_sup(c, k):
    """EH99 eqs. 16-24: master suppression T_sup(k) * B(k); ``c``'s entries
    per chain, k (h/Mpc) a grid tensor."""
    alpha = _eh99_alpha_nu(c)
    e = {name: over(value, k) for name, value in c.items()}
    sqa = over(torch.sqrt(alpha), k)
    km = k * e['h']  # 1/Mpc
    gamma_eff = e['om'] * (sqa + (1. - sqa) / (1. + (0.43 * km * e['s']) ** 4))
    q_eff = km * e['theta2'] / gamma_eff
    beta_c = 1. / (1. - 0.949 * e['fnub'])
    L = torch.log(math.e + 1.84 * beta_c * sqa * q_eff)
    C = 14.4 + 325. / (1. + 60.5 * q_eff ** 1.11)
    T_sup = L / (L + C * q_eff ** 2)
    # free-streaming bump (eqs. 22-23); -> 1 as f_nu -> 0 or k -> 0
    q = km * e['theta2'] / e['om']
    fnu, Nnu = e['fnu'], c['Nnu']
    q_nu = 3.92 * q * math.sqrt(Nnu) / fnu
    B = 1. + (1.24 * fnu ** 0.64 * Nnu ** (0.3 + 0.6 * fnu)) / (q_nu ** -1.6 + q_nu ** 0.8)
    return T_sup * B


def _eh99_growth_u(c, p, k, z):
    """u = (D1/(1+y_fs))^0.7 with D1 in the EH99 normalization
    D1 ~ (1+z_eq) a in matter domination (eqs. 9, 12); D1 per chain, k a grid."""
    D1 = (1. + c['z_eq']) * bg.growth_factor(p, z, normalize='md')
    q = k * over(c['h'] * c['theta2'] / c['om'], k)
    fnu, Nnu = over(c['fnu'], k), c['Nnu']
    y_fs = 17.2 * fnu * (1. + 0.488 * fnu ** (-7. / 6.)) * (Nnu * q / fnu) ** 2
    return (over(D1, k) / (1. + y_fs)) ** 0.7, D1


def _massless_limit(c):
    """The f_nu -> 0 reference of ``c``: the neutrino mass moved into CDM at
    fixed total omega_m."""
    c0 = dict(c)
    c0['fnu'] = torch.full_like(c['fb'], 1e-12)
    c0['fc'] = 1. - c['fb'] - 1e-12
    c0['fcb'] = torch.full_like(c['fb'], 1. - 1e-12)
    c0['fnub'] = c['fb'] + 1e-12
    c0['p_c'] = (5. - torch.sqrt(1. + 24. * c0['fc'])) / 4.
    c0['p_cb'] = (5. - torch.sqrt(1. + 24. * c0['fcb'])) / 4.
    return c0


@host
def neutrino_ratio(p, k, z=0.):
    """Multiplicative P_cb(k, z) correction for massive neutrinos.

    EH99: the ratio of the master suppression function at (fixed total
    omega_m, f_nu) to its f_nu -> 0 limit, squared, times the squared
    scale-dependent cb growth D_cb(k, z) (eq. 11) normalized to its k -> 0
    limit, so that the large-scale amplitude is preserved; ~1 when m_ncdm =
    0. ``z`` static."""
    k = as_grid(k, p)
    c = _params_eh99(p)
    c0 = _massless_limit(c)
    t_ratio = _eh99_master_sup(c, k) / _eh99_master_sup(c0, k)
    # pin the large-scale amplitude: the response -> 1 as k -> 0
    kref = as_grid([1e-5], p)
    t_ratio = t_ratio / (_eh99_master_sup(c, kref) / _eh99_master_sup(c0, kref))
    u, D1 = _eh99_growth_u(c, p, k, z)
    p_cb = over(c['p_cb'], k)
    # D_cb = (1+u)^(p_cb/0.7) D1^(1-p_cb), normalized by its k->0 value
    u0 = over(D1 ** 0.7, k)
    g_ratio = ((1. + u) / (1. + u0)) ** (p_cb / 0.7)
    return (t_ratio * g_ratio) ** 2


@host
def growth_rate_ratio(p, k, z=0.):
    """Scale-dependent cb growth-rate factor f_cb(k, z)/f(z) from EH99
    eq. 11: dln D_cb/dln D1 = 1 - p_cb/(1 + u); -> 1 as f_nu -> 0."""
    k = as_grid(k, p)
    c = _params_eh99(p)
    u, D1 = _eh99_growth_u(c, p, k, z)
    u0 = over(D1 ** 0.7, k)
    p_cb = over(c['p_cb'], k)
    return (1. - p_cb / (1. + u)) / (1. - p_cb / (1. + u0))
