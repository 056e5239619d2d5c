"""Background cosmology in torch, for one cosmology or a batch of chains.

Counterpart of ``desilike_tpu/cosmology/background.py``: densities, E(z),
distances (64-node Gauss-Legendre quadrature in sqrt(a)), the linear growth
solution and rs_drag. One copy of the formulas serves two callers:

- the host, at initialization (fiducial tables): a parameter dict of plain
  numbers and numpy grids; the functions compute in float64 on the CPU and
  return numpy (:func:`host`);
- the per-chain path: every parameter a ``(B,)`` tensor (``Cosmology``
  node), the results ``(B,)`` or ``(B,) + grid shape`` tensors on the
  parameters' device and dtype.

Redshifts are static (numbers or numpy arrays): the growth lookups use them
to pick grid nodes on the host. The distances also take one redshift a
chain, a ``(B,)`` tensor (the recombination redshift :func:`z_star`), each
chain's quadrature nodes its own; and many static redshifts at once on one
shared node set (:class:`SharedQuadrature`, the supernova samples). The
growth equation is linear in (D, D'), so each RK4 step is a 2 x 2 matrix;
the 255 steps are built in one pass and multiplied out by a log-depth
prefix product (:func:`growth_solution`), solved once per parameter dict.
The recombination-era quantities (:func:`z_star`, :func:`sound_horizon`,
:func:`theta_star_100`) serve the compressed CMB likelihoods and
``Cosmology(theta=True)``.

Conventions: distances in Mpc/h, k in h/Mpc. Growth is solved in a
matter+Lambda(+w0wa) universe, neglecting radiation (the normalization
convention of the Eisenstein-Hu transfer functions).
"""

import functools

import numpy as np
import torch

C_KMS = 299792.458            # speed of light [km/s]
DH_100 = C_KMS / 100.0        # c / (100 km/s/Mpc) = 2997.92458 Mpc/h
TNCDM = 0.71611               # T_ncdm / T_cmb (CLASS default)
NEUTRINO_MASS_TO_OMEGA = 1. / 93.14  # omega_nu = sum(m_nu) / 93.14 eV


DEFAULT_PARAMS = dict(
    h=0.6736, omega_cdm=0.1200, omega_b=0.02237, logA=3.036394,
    n_s=0.9649, tau_reio=0.0544, m_ncdm=0.06, N_ur=2.0328, N_ncdm=1,
    Omega_k=0., w0_fde=-1., wa_fde=0., T_cmb=2.7255,
)
"""DESI fiducial cosmology (Planck 2018 base). logA = ln(10^10 A_s)."""

_STATIC_KEYS = ('N_ncdm',)  # counts, not parameters: they stay Python numbers
CACHES = ('_growth', '_eh98', '_eh98_nowiggle')  # what a parameter dict keeps of its own evaluation


def resolve(params=None):
    """Fill a parameter dict with DESI-fiducial defaults; derive A_s.

    ``'_massless_ncdm'`` records whether the massive-neutrino density is
    zero, as the JAX package decides it on a concrete value: a zero
    ``m_ncdm`` given as a number (a fixed parameter) has none, a tensor
    (a varied one) the massive formula, which at 0 gives the massless
    density. The ``Cosmology`` node sets it from the parameter's fixed host
    value."""
    full = dict(DEFAULT_PARAMS)
    full.update(params or {})
    if 'A_s' not in full:
        logA = full['logA']
        full['A_s'] = torch.exp(logA) * 1e-10 if isinstance(logA, torch.Tensor) else float(np.exp(logA)) * 1e-10
    if '_massless_ncdm' not in full:
        m = full['m_ncdm']
        full['_massless_ncdm'] = not full.get('N_ncdm', 1) or (not isinstance(m, torch.Tensor) and float(m) == 0.)
    return full


def tensors(p, like):
    """The numbers of the parameter dict ``p`` as 0-d tensors of ``like``'s
    dtype and device (counts, flags and tensors kept); ``p`` itself if it
    holds no number to convert (so that what it caches stays)."""
    numbers = [name for name, value in p.items() if not (name.startswith('_') or name in _STATIC_KEYS
                                                         or isinstance(value, torch.Tensor))]
    if not numbers:
        return p
    out = dict(p)
    for name in numbers:
        out[name] = torch.as_tensor(p[name], dtype=like.dtype, device=like.device)
    return out


def host_tensors(p):
    """A host parameter dict as float64 CPU tensors (:func:`tensors`)."""
    return tensors(p, torch.empty((), dtype=torch.float64))


def host(fn):
    """Let ``fn(p, *args)`` take a host parameter dict (plain numbers) and
    numpy arguments: it then runs in float64 on the CPU and returns numpy.
    With a tensor among the parameters or arguments, ``fn`` runs as it is."""

    @functools.wraps(fn)
    def wrapper(p, *args, **kwargs):
        if any(isinstance(v, torch.Tensor) for v in list(p.values()) + list(args) + list(kwargs.values())):
            return fn(p, *args, **kwargs)
        out = fn(host_tensors(p), *args, **kwargs)
        if isinstance(out, tuple):
            return tuple(o.numpy() if isinstance(o, torch.Tensor) else o for o in out)
        return out.numpy() if isinstance(out, torch.Tensor) else out

    return wrapper


def per_chain(fn, p, k, *args, **kwargs):
    """``fn(p, k, *args, **kwargs)`` with ``k`` one row a chain, (B, n), for
    the (B,) parameters of ``p``: ``fn``'s grid semantics applied to each
    chain's row (``torch.func.vmap`` over the chains). Returns (B, n)."""
    p = {name: value for name, value in p.items() if name not in CACHES}
    batched = {name: value for name, value in p.items() if isinstance(value, torch.Tensor) and value.ndim}
    static = {name: value for name, value in p.items() if name not in batched}
    return torch.func.vmap(lambda b, row: fn({**static, **b}, row, *args, **kwargs))(batched, k)


def float64(p):
    """The parameter dict in float64 (what it caches left out)."""
    return {name: value.double() if isinstance(value, torch.Tensor) else value for name, value in p.items()
            if name not in CACHES}


def ref(p):
    """A tensor of the parameter dict, for the dtype and device of its grids."""
    return p['h']


_GRIDS = {}  # static grids copied to a card, by content; never evicted: a captured graph reads them by address


def as_grid(x, p):
    """A static grid (number, numpy or tensor) as a tensor of ``p``'s dtype
    and device. A host grid is copied to a card once and kept (by content,
    never dropped: a graph captured on the card reads it by address); a copy
    each call would synchronise the host with the card."""
    like = ref(p)
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    x = np.asarray(x, dtype='f8')
    if like.device.type == 'cpu':
        return torch.as_tensor(x, dtype=like.dtype)
    key = (x.shape, x.tobytes(), like.dtype, like.device)
    if key not in _GRIDS:
        _GRIDS[key] = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return _GRIDS[key]


def over(value, grid):
    """A per-chain value (shape S: () or (B,)) against a grid tensor: shape
    S + (1,) * grid.ndim, so that the result has shape S + grid.shape; a
    number stays as it is."""
    if isinstance(value, torch.Tensor):
        return value.reshape(value.shape + (1,) * grid.ndim)
    return value


# --- densities ---

def omega_gamma(p):
    """Photon density omega_gamma = Omega_gamma h^2 from T_cmb."""
    return 2.472805e-5 * (p['T_cmb'] / 2.7255) ** 4


def omega_ur(p):
    """Massless (ultra-relativistic) neutrino density omega_ur."""
    return p['N_ur'] * (7. / 8.) * TNCDM ** 4 * omega_gamma(p)


def omega_ncdm(p):
    """Massive-neutrino density today (non-relativistic limit)."""
    return p['m_ncdm'] * NEUTRINO_MASS_TO_OMEGA


def _rho_ncdm_ratio(y):
    """rho_ncdm(a) / rho_ncdm,massless(a) for y = m a / T_nu
    (Komatsu et al. 2011, eq. 26)."""
    A = 0.3173
    pexp = 1.83
    return (1. + (A * y) ** pexp) ** (1. / pexp)


def omega_ncdm_a(p, a):
    """Massive-neutrino contribution to E^2(a) a^4 h^2; ``a`` a grid tensor."""
    if p['_massless_ncdm']:
        return torch.zeros_like(a)
    n = p.get('N_ncdm', 1)
    per_species_massless = (7. / 8.) * TNCDM ** 4 * omega_gamma(p)
    t_nu_ev = TNCDM * p['T_cmb'] / 2.7255 * 2.7255 * 8.617333262e-5
    y = over(p['m_ncdm'] / n, a) * a / over(t_nu_ev, a)
    return n * over(per_species_massless, a) * _rho_ncdm_ratio(y)


def omega_m(p):
    """Total matter density omega_m = omega_cdm + omega_b + omega_ncdm (late-time)."""
    return p['omega_cdm'] + p['omega_b'] + omega_ncdm(p)


def omega_cb(p):
    return p['omega_cdm'] + p['omega_b']


@host
def Omega_m(p):
    return omega_m(p) / p['h'] ** 2


def Omega_de(p):
    h2 = p['h'] ** 2
    return 1. - (omega_m(p) + omega_gamma(p) + omega_ur(p)) / h2 - p['Omega_k']


def _f_de(p, a):
    """Dark-energy density scaling for w0-wa (CPL): rho_de(a)/rho_de0, on the grid ``a``."""
    w0, wa = over(p['w0_fde'], a), over(p['wa_fde'], a)
    return a ** (-3. * (1. + w0 + wa)) * torch.exp(-3. * wa * (1. - a))


@host
def efunc_of_a(p, a):
    """E(a) = H(a)/H0 including radiation and massive neutrinos; ``a`` a grid."""
    a = as_grid(a, p)
    h2 = over(p['h'] ** 2, a)
    og = over(omega_gamma(p) + omega_ur(p), a)
    E2 = (over(omega_cb(p), a) * a ** -3 + og * a ** -4 + omega_ncdm_a(p, a) * a ** -4) / h2 \
        + over(p['Omega_k'], a) * a ** -2 + over(Omega_de(p), a) * _f_de(p, a)
    return torch.sqrt(E2)


@host
def efunc(p, z):
    """E(z) = H(z)/H0; ``z`` static."""
    return efunc_of_a(p, 1. / (1. + np.asarray(z, dtype='f8')))


_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(64)


def _integrand_u(p, u):
    """The integrand of D_C / DH in u = sqrt(a), 2 / (u^3 E(u^2)), on the grid ``u``."""
    return 2. / (u ** 3 * efunc_of_a(p, u ** 2))


@host
def comoving_radial_distance(p, z):
    """D_C(z) = c/H0 int dz'/E(z') in Mpc/h, by 64-node Gauss-Legendre
    quadrature in u = sqrt(a); ``z`` static, or a (B,) tensor of one
    redshift a chain (the nodes of each chain's quadrature its own)."""
    if isinstance(z, torch.Tensor):
        u_end = 1. / torch.sqrt(1. + z)
        u = u_end[..., None] + (1. - u_end[..., None]) * as_grid((_GL_NODES + 1.) / 2., p)
        integ = per_chain(_integrand_u, p, u) @ as_grid(_GL_WEIGHTS, p) * (1. - u_end) / 2.
        return DH_100 * integ
    u_end = 1. / np.sqrt(1. + np.asarray(z, dtype='f8'))
    u = as_grid(u_end[..., None] + (1. - u_end[..., None]) * (_GL_NODES + 1.) / 2., p)
    w = as_grid(_GL_WEIGHTS, p)
    integ = torch.sum(w * _integrand_u(p, u), dim=-1) * as_grid((1. - u_end) / 2., p)
    return DH_100 * integ


class SharedQuadrature(object):
    """D_C at many static redshifts from one node set in u = sqrt(a): the
    interval [u(z_max), 1] is cut into ``panels`` equal panels of ``order``
    Gauss-Legendre nodes, and D_C(z_i) / DH = W_i . f(u) with f the
    integrand 2 / (u^3 E(u^2)) at the nodes. W (n, panels * order), built on
    the host in float64, sums the panels above u_i and integrates the
    degree-(order - 1) interpolant of f over the part of u_i's panel above
    it. So a chain evaluates E at panels * order points, not at 64 a
    redshift (1829 x 64 for DES-Y5). Accuracy: the integrand is smooth in u;
    at the defaults (16 x 8 nodes to z = 2.3) the rule is within 1e-12 of
    the per-redshift 64-node rule (float64, measured on the CPU)."""

    def __init__(self, z, panels=16, order=8):
        self.z = np.asarray(z, dtype='f8')
        u = 1. / np.sqrt(1. + self.z.ravel())
        edges = np.linspace(min(u.min(), 1.), 1., panels + 1)
        x, w = np.polynomial.legendre.leggauss(order)
        half = (edges[1:] - edges[:-1]) / 2.
        self.u = ((edges[:-1] + edges[1:]) / 2.)[:, None] + half[:, None] * x  # (panels, order)
        # the partial panel: int_t^1 of the interpolant through the nodes x, in t = [-1, 1] units, is
        # (int_t^1 P_k) @ V^-1 f with V_jk = P_k(x_j) and int_t^1 P_k = (P_{k-1}(t) - P_{k+1}(t)) / (2k + 1), k >= 1
        vinv = np.linalg.inv(np.polynomial.legendre.legvander(x, order - 1))
        panel = np.clip(np.searchsorted(edges, u, side='right') - 1, 0, panels - 1)
        t = np.clip((u - (edges[panel] + half[panel])) / half[panel], -1., 1.)
        vander = np.polynomial.legendre.legvander(t, order)  # P_0 .. P_order at t
        partial = np.empty((u.size, order))
        partial[:, 0] = 1. - t
        for k in range(1, order):
            partial[:, k] = (vander[:, k - 1] - vander[:, k + 1]) / (2. * k + 1.)
        weights = np.zeros((u.size, panels, order))
        weights[np.arange(u.size), panel] = (partial @ vinv) * half[panel, None]
        above = np.arange(panels)[None, :] > panel[:, None]
        weights += above[..., None] * (w[None, None, :] * half[None, :, None])
        self.weights_t = np.ascontiguousarray(weights.reshape(u.size, -1).T)  # (panels * order, n)
        self.u = self.u.ravel()


@host
def comoving_radial_distances(p, rule):
    """D_C at the static redshifts of ``rule`` (a :class:`SharedQuadrature`),
    in Mpc/h: one evaluation of the integrand on the shared nodes and one
    product; shape S + rule.z.shape."""
    f = _integrand_u(p, as_grid(rule.u, p))
    out = DH_100 * (f @ as_grid(rule.weights_t, p))
    return out.reshape(out.shape[:-1] + rule.z.shape)


@host
def hubble_distance(p, z):
    """D_H(z) = c/H(z) in Mpc/h."""
    return DH_100 / efunc(p, z)


def _transverse(p, dc):
    """D_M from D_C with the curvature of ``p``, the branch chosen per chain."""
    ok = p['Omega_k']
    if isinstance(ok, torch.Tensor) and ok.ndim and dc.ndim > ok.ndim:
        ok = ok.reshape(ok.shape + (1,) * (dc.ndim - ok.ndim))
    elif not isinstance(ok, torch.Tensor):
        ok = torch.as_tensor(ok, dtype=dc.dtype, device=dc.device)
    sqrt_ok = torch.sqrt(torch.abs(ok) + 1e-15)
    x = sqrt_ok * dc / DH_100
    return torch.where(ok > 1e-8, DH_100 / sqrt_ok * torch.sinh(x),
                       torch.where(ok < -1e-8, DH_100 / sqrt_ok * torch.sin(x), dc))


@host
def comoving_angular_distance(p, z):
    """D_M(z): transverse comoving distance with curvature, Mpc/h; the
    curvature branch chosen per chain. ``z`` static or one a chain."""
    return _transverse(p, comoving_radial_distance(p, z))


@host
def comoving_angular_distances(p, rule):
    """D_M at the static redshifts of ``rule`` (:func:`comoving_radial_distances`)."""
    return _transverse(p, comoving_radial_distances(p, rule))


# --- growth (matter + DE only; EH normalization convention) ---

_GROWTH_LNA = np.linspace(np.log(1e-3), 0., 256)
_GROWTH_NODES = np.exp(np.stack([_GROWTH_LNA[:-1], _GROWTH_LNA[:-1] + 0.5 * np.diff(_GROWTH_LNA), _GROWTH_LNA[1:]]))


def _growth_steps(p):
    """The RK4 steps of D'' + (2 + dlnH/dlna) D' = (3/2) Om(a) D over the
    ln a grid as matrices: y' = A(ln a) y with y = (D, D') is linear, so one
    RK4 step from node n is exactly y_{n+1} = M_n y_n, with M_n built from A
    at the step's start, middle and end. Returns M, shape S + (255, 2, 2),
    in float64 (see :func:`growth_solution`)."""
    p = float64(p)
    om0 = omega_m(p) / p['h'] ** 2
    ok0 = p['Omega_k']
    ode0 = Omega_de(p)
    a = as_grid(_GROWTH_NODES, p)  # (3, 255): start, middle, end of each step
    om0, ok0, ode0 = over(om0, a), over(ok0, a), over(ode0, a)
    w0, wa = over(p['w0_fde'], a), over(p['wa_fde'], a)
    fde = _f_de(p, a)
    E2 = om0 * a ** -3 + ok0 * a ** -2 + ode0 * fde
    dfde = fde * (-3. * (1. + w0 + wa) / a + 3. * wa)
    dE2 = -3. * om0 * a ** -4 - 2. * ok0 * a ** -3 + ode0 * dfde
    damping = -(2. + a * dE2 / (2. * E2))       # A[1, 1]
    source = 1.5 * om0 * a ** -3 / E2           # A[1, 0]
    zeros, ones = torch.zeros_like(source), torch.ones_like(source)
    A = torch.stack([torch.stack([zeros, ones], dim=-1), torch.stack([source, damping], dim=-1)], dim=-2)
    A0, Ah, A1 = A.unbind(dim=-4)                # S + (255, 2, 2) each
    dx = float(_GROWTH_LNA[1] - _GROWTH_LNA[0])
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    K1 = A0
    K2 = _matmul2(Ah, eye + 0.5 * dx * K1)
    K3 = _matmul2(Ah, eye + 0.5 * dx * K2)
    K4 = _matmul2(A1, eye + dx * K3)
    return eye + dx / 6. * (K1 + 2. * K2 + 2. * K3 + K4)


def _matmul2(A, B):
    """Products of 2 x 2 matrices, (..., 2, 2) each, as one elementwise product
    and one sum: as a batched GEMM of B x 255 matrices of 2 x 2 in float64 the
    card took 60 ms of config 3d's 67 at B = 4096 (NVIDIA H100)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def _prefix_products(M):
    """P_n = M_n M_{n-1} ... M_0 for every n along axis -3, by a log-depth
    (Hillis-Steele) scan: ceil(log2 n) rounds of one batched matrix product."""
    n, shift = M.shape[-3], 1
    while shift < n:
        M = torch.cat([M[..., :shift, :, :], _matmul2(M[..., shift:, :, :], M[..., :-shift, :, :])], dim=-3)
        shift *= 2
    return M


def growth_solution(p):
    """(D, dD/dlna) on the 256-node ln a grid, shape S + (256,) each, with D =
    D' = a deep in matter domination: the RK4 solution of the JAX package's
    ``_growth_ode_scan``, reassociated as matrix products. Solved in float64
    and returned in the parameters' dtype: in float32 the products of 255
    steps carry a coherent 2-3e-6 of D, a shift of the pk amplitude that put
    the reduced config 3d's log-posterior 3.6e-2 from the JAX package's x64
    values, over its 2e-2 limit (2.5e-2 with this solution in float64, 5.4e-3
    with the transfers' constants too; measured on the CPU).
    Solved once per parameter dict: the result is kept in ``p['_growth']``."""
    if '_growth' not in p:
        P = _prefix_products(_growth_steps(p))
        a0 = float(np.exp(_GROWTH_LNA[0]))
        y = (a0 * P.sum(dim=-1)).to(ref(p).dtype)  # P @ (a0, a0)
        first = torch.full(y.shape[:-2] + (1,), a0, dtype=y.dtype, device=y.device)
        p['_growth'] = (torch.cat([first, y[..., 0]], dim=-1), torch.cat([first, y[..., 1]], dim=-1))
    return p['_growth']


def _interp_nodes(values, z):
    """Linear interpolation (``np.interp``) of ``values`` (S + (256,)) on the
    ln a grid at ln a = -ln(1 + z), ``z`` static: the nodes are chosen on the
    host."""
    z = np.asarray(z, dtype='f8')
    lnaq = np.clip(-np.log1p(z), _GROWTH_LNA[0], _GROWTH_LNA[-1])
    idx = np.clip(np.searchsorted(_GROWTH_LNA, lnaq, side='right') - 1, 0, len(_GROWTH_LNA) - 2)
    t = (lnaq - _GROWTH_LNA[idx]) / (_GROWTH_LNA[idx + 1] - _GROWTH_LNA[idx])
    out = [torch.lerp(values[..., i], values[..., i + 1], float(w)) for i, w in zip(idx.ravel(), t.ravel())]
    if z.ndim == 0:
        return out[0]
    return torch.stack(out, dim=-1).reshape(values.shape[:-1] + z.shape)


@host
def growth_factor(p, z, normalize='z0'):
    """Linear growth D(z); normalize='z0' -> D(0)=1, 'md' -> D ~ a in MD."""
    D, _ = growth_solution(p)
    Dq = _interp_nodes(D, z)
    if normalize == 'z0':
        return Dq / over(D[..., -1], as_grid(z, p))
    return Dq


@host
def growth_rate(p, z):
    """f(z) = dlnD/dlna."""
    D, Dp = growth_solution(p)
    return _interp_nodes(Dp / D, z)


@host
def rs_drag(p):
    """r_d in Mpc/h from the Aubourg et al. 2015 fit (eq. 16, arXiv:1411.1074)."""
    rd_mpc = 55.154 * torch.exp(-72.3 * (omega_ncdm(p) + 0.0006) ** 2) \
        / (omega_cb(p) ** 0.25351 * p['omega_b'] ** 0.12807)
    return rd_mpc * p['h']


# --- recombination-era quantities (compressed CMB likelihoods) ---

@host
def z_star(p):
    """Redshift of recombination (photon decoupling), Hu & Sugiyama 1996
    fitting formula (eq. E-1, arXiv:astro-ph/9510117): the approximation
    CosmoMC uses for its theta_MC parameter. (B,) for (B,) parameters."""
    ob = p['omega_b']
    om = omega_m(p)
    g1 = 0.0783 * ob ** -0.238 / (1. + 39.5 * ob ** 0.763)
    g2 = 0.560 / (1. + 21.1 * ob ** 1.81)
    return 1048. * (1. + 0.00124 * ob ** -0.738) * (1. + g1 * om ** g2)


_RS_LNA = np.linspace(np.log(1e-6), 0., 513)  # a_min = 1e-6: a^-4 stays float32-safe


def _sound_horizon_integrand(p, lna):
    """d r_s / d ln a = DH c_s / (a E(a)) on the ln a grid ``lna``, with
    c_s = 1 / sqrt(3 (1 + R)), R = 3 rho_b / (4 rho_gamma)."""
    a = torch.exp(lna)
    R = over(0.75 * p['omega_b'] / omega_gamma(p), a) * a
    return DH_100 / torch.sqrt(3. * (1. + R)) / (a * efunc_of_a(p, a))


@host
def sound_horizon(p, z):
    """Comoving sound horizon r_s(z) = int_0^{a(z)} c_s da / (a^2 H) in
    Mpc/h: trapezoid in ln a on 513 points from a = 1e-6 to a(z), plus the
    analytic radiation-era tail below a = 1e-6 (the integrand in a is
    constant there: the tail is DH / (sqrt(3) a_min E(a_min)), ~0.2% of
    r_s). ``z`` a number or one a chain ((B,) tensor)."""
    a_min = float(np.exp(_RS_LNA[0]))
    t = (_RS_LNA - _RS_LNA[0]) / (0. - _RS_LNA[0])  # 0 -> 1
    tail = DH_100 / (np.sqrt(3.) * a_min * efunc_of_a(p, np.array(a_min)))
    weights = np.full(t.size, 1.)
    weights[[0, -1]] = 0.5
    if isinstance(z, torch.Tensor):
        span = -torch.log1p(z) - _RS_LNA[0]  # ln a(z) - ln a_min, one a chain
        lna = _RS_LNA[0] + span[..., None] * as_grid(t, p)
        integ = per_chain(_sound_horizon_integrand, p, lna) @ as_grid(weights * (t[1] - t[0]), p)
        return tail + integ * span
    span = float(-np.log1p(z) - _RS_LNA[0])
    lna = as_grid(_RS_LNA[0] + span * t, p)
    return tail + (_sound_horizon_integrand(p, lna) @ as_grid(weights, p)) * (span * (t[1] - t[0]))


@host
def theta_star_100(p):
    """100 r_s(z_*) / D_M(z_*): the CosmoMC theta_MC_100 analog, each chain
    at its own z_*."""
    zs = z_star(p)
    if not (isinstance(zs, torch.Tensor) and zs.ndim):
        zs = float(zs)  # one cosmology: a static redshift
    return 100. * sound_horizon(p, zs) / comoving_angular_distance(p, zs)
