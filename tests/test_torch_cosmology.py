"""The port's per-chain cosmology (``desilike_tpu_torch.cosmology``: the
background, EH98/EH99 and the linear pk; the ``Cosmology`` node; the AP
effect in its 'geometry' and 'bao' modes) against the JAX package's x64
values frozen in ``tests/data/torch_port_direct_reference.npz``
(``scripts/make_torch_port_reference.py direct``), at 16 seeded cosmologies
that vary h, omega_cdm, omega_b, logA, n_s, m_ncdm (one at 0), Omega_k (one
at 0) and w0/wa.

Tolerances. In float64 the port computes the JAX package's arithmetic, the
growth solution reassociated (its RK4 steps as 2 x 2 matrices multiplied
out by a prefix product): 1e-12 of each value (measured: 5e-15). In
float32, as the likelihoods evaluate (the growth solution and the
transfers' per-chain constants in float64): 2e-5 (measured: 1.4e-6). The
growth solution against the port's former numpy RK4 loop, kept here as its
oracle: 1e-6 in float64 (measured: 4e-15).
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import Cosmology, Pipeline
from desilike_tpu_torch.cosmology import background as bg, linear as lin, eh
from desilike_tpu_torch.theories.base import APEffect

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_direct_reference.npz'))
COSMO_NAMES = ('h', 'omega_cdm', 'omega_b', 'logA', 'n_s', 'm_ncdm', 'Omega_k', 'w0_fde', 'wa_fde')
Z = np.array([0., 0.3, 0.8, 1.5, 3.])
K = np.geomspace(1e-4, 2., 200)
NODE_K = np.geomspace(1e-3, 1., 64)


def functions():
    """{name: port function of a parameter dict}: the counterparts of the
    reference script's ``cosmology_functions``."""
    nowiggle = lin.NoWiggleFilter(K)
    return {'efunc': lambda p: bg.efunc(p, Z), 'comoving_radial_distance': lambda p: bg.comoving_radial_distance(p, Z),
            'comoving_angular_distance': lambda p: bg.comoving_angular_distance(p, Z),
            'hubble_distance': lambda p: bg.hubble_distance(p, Z), 'rs_drag': bg.rs_drag,
            'growth_factor': lambda p: bg.growth_factor(p, Z), 'growth_factor_md': lambda p: bg.growth_factor(p, Z, 'md'),
            'growth_rate': lambda p: bg.growth_rate(p, Z), 'transfer': lambda p: eh.transfer(p, K),
            'transfer_nowiggle': lambda p: eh.transfer_nowiggle(p, K), 'sound_horizon_eh': eh.sound_horizon_eh,
            'neutrino_ratio': lambda p: eh.neutrino_ratio(p, K, 0.8),
            'growth_rate_ratio': lambda p: eh.growth_rate_ratio(p, K, 0.8),
            'pk_lin': lambda p: lin.pk_lin(p, K, 0.8), 'pk_lin_nowiggle': lambda p: lin.pk_lin(p, K, 0.8, nowiggle=True),
            'sigma8': lambda p: lin.sigma_r(p, 8., 0.8),
            'pknow': lambda p: nowiggle(lin.pk_lin(p, K, 0.8), lin.pk_lin(p, K, 0.8, nowiggle=True)),
            'primordial_curvature': lambda p: lin.primordial_curvature(dict(p, alpha_s=0.01), K)}


def batched(dtype):
    """The 16 frozen cosmologies as one parameter dict of (16,) tensors, the
    others at their defaults."""
    points = REFERENCE['cosmo_points']
    p = {name: torch.full((len(points),), value, dtype=dtype) for name, value in bg.DEFAULT_PARAMS.items()
         if name not in ('N_ncdm', 'T_cmb')}
    p.update({name: torch.tensor(points[:, i], dtype=dtype) for i, name in enumerate(COSMO_NAMES)})
    return bg.resolve(p)


@pytest.mark.parametrize('dtype, rtol', [(torch.float64, 1e-12), (torch.float32, 2e-5)], ids=['float64', 'float32'])
def test_functions_match_jax_x64(dtype, rtol):
    """Every function, batched over the 16 cosmologies, against JAX x64."""
    p = batched(dtype)
    for name, fn in functions().items():
        got, expected = fn(p).numpy(), REFERENCE['fn_' + name]
        assert got.shape == expected.shape, name
        np.testing.assert_allclose(got, expected, rtol=rtol, atol=0., err_msg=name)


def test_host_path_returns_numpy():
    """A host dict of numbers (the fiducial tables' path) computes in float64
    and returns numpy, equal to the batched path."""
    point = REFERENCE['cosmo_points'][3]
    p = bg.resolve(dict(zip(COSMO_NAMES, point)))
    batch = batched(torch.float64)
    for name in ('pk_lin', 'comoving_angular_distance', 'sigma8', 'growth_rate'):
        got = functions()[name](p)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, functions()[name](batch)[3].numpy(), rtol=1e-14, atol=0.)


def numpy_growth(p):
    """The port's former numpy RK4 loop of the growth equation (one
    cosmology, float64): (D, dD/dlna) on the 256-node ln a grid."""
    om0 = float(bg.omega_m(p) / p['h'] ** 2)
    ok0 = float(p['Omega_k'])
    ode0 = float(bg.Omega_de(p))
    w0, wa = float(p['w0_fde']), float(p['wa_fde'])

    def f_de(a):
        return a ** (-3. * (1. + w0 + wa)) * np.exp(-3. * wa * (1. - a))

    def E2g(a):
        return om0 * a ** -3 + ok0 * a ** -2 + ode0 * f_de(a)

    def rhs(y, lna):
        a = np.exp(lna)
        dfde = f_de(a) * (-3. * (1. + w0 + wa) / a + 3. * wa)
        dE2 = -3. * om0 * a ** -4 - 2. * ok0 * a ** -3 + ode0 * dfde
        return np.array([y[1], -(2. + a * dE2 / (2. * E2g(a))) * y[1] + 1.5 * om0 * a ** -3 / E2g(a) * y[0]])

    grid = bg._GROWTH_LNA
    dx = grid[1] - grid[0]
    ys = [np.full(2, np.exp(grid[0]))]
    for lna in grid[:-1]:
        y = ys[-1]
        k1 = rhs(y, lna)
        k2 = rhs(y + 0.5 * dx * k1, lna + 0.5 * dx)
        k3 = rhs(y + 0.5 * dx * k2, lna + 0.5 * dx)
        k4 = rhs(y + dx * k3, lna + dx)
        ys.append(y + dx / 6. * (k1 + 2 * k2 + 2 * k3 + k4))
    return np.array(ys).T


def test_growth_propagator_matches_numpy_rk4():
    """D and f from the propagator's prefix products (the 16 cosmologies in
    one batch) against the step-by-step RK4 loop, in float64."""
    p = batched(torch.float64)
    D, Dp = (t.numpy() for t in bg.growth_solution(p))
    for i in range(D.shape[0]):
        expected = numpy_growth({name: value[i] if isinstance(value, torch.Tensor) else value
                                 for name, value in p.items() if not name.startswith('_')} | {'_massless_ncdm': False})
        np.testing.assert_allclose(D[i], expected[0], rtol=1e-6, atol=0.)
        np.testing.assert_allclose(Dp[i] / D[i], expected[1] / expected[0], rtol=1e-6, atol=0.)


def test_growth_solved_once_and_differentiable():
    """The solution is kept in the parameter dict (one solve serves D, f, the
    linear pk and sigma8), and its gradient passes gradcheck in float64."""
    p = batched(torch.float64)
    bg.growth_rate(p, 0.8)
    solution = p['_growth']
    lin.sigma_r(p, 8., 0.8)
    assert p['_growth'] is solution
    omega_cdm = torch.tensor([0.11, 0.13], dtype=torch.float64, requires_grad=True)
    h = torch.tensor([0.65, 0.7], dtype=torch.float64, requires_grad=True)

    def fn(omega_cdm, h):
        q = bg.resolve({'omega_cdm': omega_cdm, 'h': h, 'm_ncdm': torch.full((2,), 0.06, dtype=torch.float64),
                        'Omega_k': torch.full((2,), 0.01, dtype=torch.float64)})
        return bg.growth_rate(q, 0.8), bg.growth_factor(q, [0.5, 1.]), lin.sigma_r(q, 8., 0.8)

    assert torch.autograd.gradcheck(fn, (omega_cdm, h))


NODE_CASES = {'eh98': 'eh98', 'eh99': 'eh99', 'table': 'table', 'massless_fixed': 'eh98', 'massless_varied': 'eh98',
              'Omega_m': 'eh98', 'w0_fld': 'eh98', 'N_eff': 'eh98', 'alpha_s': 'eh98'}
NODE_VARIED = {'h': 0.7, 'omega_cdm': 0.125, 'omega_b': 0.023, 'logA': 3.1, 'n_s': 0.95, 'm_ncdm': 0.1,
               'Omega_k': 0.02, 'w0_fde': -0.9, 'wa_fde': 0.1}
NODE_PARAMS = {
    'eh98': ({n: dict(fixed=False) for n in NODE_VARIED}, NODE_VARIED),
    'eh99': ({n: dict(fixed=False) for n in NODE_VARIED}, NODE_VARIED),
    'table': ({n: dict(fixed=False) for n in ('h', 'omega_cdm', 'logA', 'n_s')},
              {'h': 0.7, 'omega_cdm': 0.125, 'logA': 3.1, 'n_s': 0.95}),
    'massless_fixed': ({'m_ncdm': dict(value=0., fixed=True)}, {}),
    'massless_varied': ({'m_ncdm': dict(fixed=False)}, {'m_ncdm': 0.}),
    'Omega_m': ({'Omega_m': dict(value=0.3153, prior=dict(limits=[0.01, 1.]), fixed=False)}, {'Omega_m': 0.35}),
    'w0_fld': ({'w0_fld': dict(value=-0.9, fixed=False)}, {'w0_fld': -0.9}),
    'N_eff': ({'N_eff': dict(value=3.4, fixed=False)}, {'N_eff': 3.4}),
    'alpha_s': ({'alpha_s': dict(value=0., prior=dict(limits=[-0.1, 0.1]), fixed=False)}, {'alpha_s': 0.05})}


def fake_boltzmann_table():
    """The stand-in CLASS table of ``tests/test_pk_injection.py`` (EH98 x a
    smooth 3% distortion), from the port's host pk."""
    ktab = np.geomspace(1e-4, 10., 512)
    return ktab, lin.pk_lin(bg.resolve(), ktab, 0.) * (1. + 0.03 * np.tanh(np.log(ktab / 0.05)))


@pytest.mark.parametrize('case', list(NODE_CASES))
def test_node_matches_jax_x64(case):
    """The ``Cosmology`` node through a pipeline, in float64 at 2 chains (the
    same point twice; 1 where nothing varies), against the JAX node jitted as ``logpost_fn`` is (its
    varied parameters traced, its fixed ones host numbers): the engines, a
    massless neutrino fixed (no density) and varied at 0 (the massive
    formula: the massless density), and the alternative inputs Omega_m,
    w0_fld, N_eff and alpha_s."""
    params, values = NODE_PARAMS[case]
    kwargs = dict(engine=NODE_CASES[case], device='cpu')
    if case == 'table':
        kwargs['pk_table'] = fake_boltzmann_table()
    cosmo = Cosmology(**kwargs)
    cosmo.init.params = params
    Pipeline(cosmo).evaluate({n: torch.full((2,), v, dtype=torch.float64) for n, v in values.items()},
                             dtype=torch.float64)
    k = torch.tensor(NODE_K, dtype=torch.float64)
    got = {'pk_dd': cosmo.pk_dd(k, 0.8), 'pk_dd_now': cosmo.pk_dd_now(k, 0.8),
           'growth_rate_k': cosmo.growth_rate_k(k, 0.8), 'sigma8': cosmo.sigma8(0.8), 'fsigma8': cosmo.fsigma8(0.8),
           'efunc': cosmo.efunc(0.8), 'comoving_angular_distance': cosmo.comoving_angular_distance(0.8),
           'growth_factor': cosmo.growth_factor(0.8), 'rs_drag': cosmo.rs_drag()}
    for quantity, value in got.items():
        expected = REFERENCE['node_{}_{}'.format(case, quantity)]
        assert value.shape == (2 if values else 1,) + expected.shape, quantity
        np.testing.assert_allclose(value.numpy(), np.broadcast_to(expected, value.shape), rtol=1e-12, atol=0.,
                                   err_msg=quantity)
    if case == 'table':  # exact at the fiducial (tests/test_pk_injection.py)
        cosmo = Cosmology(**kwargs)
        Pipeline(cosmo).evaluate({}, dtype=torch.float64)
        ktab, pktab = kwargs['pk_table']
        np.testing.assert_allclose(cosmo.pk_dd(NODE_K, 0.)[0].numpy(),
                                   np.exp(np.interp(np.log(NODE_K), np.log(ktab), np.log(pktab))), rtol=1e-12)


@pytest.mark.parametrize('mode', ['geometry', 'bao'])
def test_apeffect_modes_match_jax_x64(mode):
    """``APEffect`` reading a varied cosmology (h, omega_cdm at 0.7, 0.125)
    against the DESI fiducial and against ``fiducial={'h': 0.65}``."""
    for label, fiducial in (('', None), ('fid_', {'h': 0.65})):
        cosmo = Cosmology(device='cpu')
        cosmo.init.params = {'h': dict(fixed=False), 'omega_cdm': dict(fixed=False)}
        ap = APEffect(z=0.8, mode=mode, cosmo=cosmo, fiducial=fiducial)
        Pipeline(ap).evaluate({'h': 0.7, 'omega_cdm': 0.125}, dtype=torch.float64)
        for q in ('qpar', 'qper'):
            np.testing.assert_allclose(getattr(ap, q).numpy(), REFERENCE['ap_{}_{}{}'.format(mode, label, q)],
                                       rtol=1e-12)
