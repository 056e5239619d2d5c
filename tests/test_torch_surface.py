"""The members of the JAX package's public surface that the PyTorch port
gained last (``desilike_tpu_torch``), on the CPU, against the JAX package's
members on the same numpy inputs made from a seed.

Tolerances: metadata, index sets and counts exactly; numbers at 1e-6 of
their magnitude in float32 and 1e-12 in float64 (the JAX side in x64);
gradients at 1e-5 of their magnitude. Config 1's ``get_fn`` and
``states_fn`` are bit-identical to ``Pipeline.evaluate``, and the
log-posterior rebuilt from ``get_fn`` at the solved parameters' best fits is
held to the frozen JAX values of ``tests/data/torch_port_bao_reference.npz``
at the limits of ``tests/test_torch_bao_likelihood.py``.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import desilike_tpu
import desilike_tpu_torch
import desilike_tpu_torch.theories
from desilike_tpu.ops import interp as jax_interp, legendre as jax_legendre, linalg as jax_linalg
from desilike_tpu.ops.spt_fftlog import FFTLogOneLoop as JaxFFTLogOneLoop
from desilike_tpu.theories import power_template as jax_power_template
from desilike_tpu.theories.base import ap_s_mu as jax_ap_s_mu
from desilike_tpu_torch.ops import interp, legendre, linalg
from desilike_tpu_torch.ops.spt_fftlog import FFTLogOneLoop
from desilike_tpu_torch.theories import power_template
from chip_smoke import build_likelihood

torch.set_num_threads(2)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_bao_reference.npz'))
PACKAGES = (desilike_tpu, desilike_tpu_torch)


def assert_close(got, expected, rtol):
    """|got - expected| within ``rtol`` of the largest |expected|."""
    got, expected = np.asarray(got, dtype='f8'), np.asarray(expected, dtype='f8')
    assert got.shape == expected.shape, (got.shape, expected.shape)
    np.testing.assert_allclose(got, expected, rtol=0., atol=rtol * np.abs(expected).max())


def spd(batch, n, seed, dtype='f8'):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(dtype)


def test_containers_and_parameters():
    """``tests/test_container_surface.py``'s Samples, Parameter and
    calculator cases on both packages, then the members against each other:
    ``to_array`` and ``match`` (also on a Chain), ``set``, ``Prior.isin``
    and ``affine_transform``, ``Parameter.logprior``,
    ``ParameterCollection.clone`` and ``prior`` on tensors, and the
    calculator's ``all_params``, ``varied_params`` and
    ``InitConfig.setdefault``."""
    rng = np.random.default_rng(2)
    perm = rng.permutation(12)
    results = []
    for package in PACKAGES:
        s = package.Samples({'x': np.arange(12.), 'y': np.arange(12.) ** 2})
        assert s.ndim == 1
        r = s.reshape(3, 4)
        assert r.shape == (3, 4) and np.asarray(r['x']).shape == (3, 4)
        s.update(package.Samples({'z': np.ones(12)}))
        assert 'z' in s.data
        stacked = s.to_array(params=['x', 'y'], struct=False)
        assert stacked.shape == (2, 12) and stacked.dtype == np.float64
        struct = s.to_array(params=['x'])
        assert struct.dtype.names == ('x',)
        shuffled = package.Samples({'x': np.arange(12.)[perm], 'y': (np.arange(12.) ** 2)[perm]})
        in_other, in_self = s.match(shuffled, params=['x', 'y'])
        np.testing.assert_array_equal(np.asarray(shuffled['x'])[in_other], np.asarray(s['x'])[in_self])
        chain = package.Chain({'x': np.arange(12.).reshape(3, 4), 'y': np.zeros((3, 4))})
        far = package.Chain({'x': np.array([1., 50.]), 'y': np.zeros(2)})
        s.set(np.full(12, 2.), name='w')
        assert np.asarray(s['w'])[0] == 2.
        with pytest.raises(ValueError):
            s.set(np.ones(12))
        results.append((s.to_array(), stacked, in_other, in_self, chain.match(far), chain.to_array(struct=False)))

        a = package.Parameter(basename='a', value=1., prior=dict(limits=[0., 2.]))
        assert a.limits == (0., 2.) and a.ndim == 0 and a.size == 1
        assert package.Parameter('free').limits == (-np.inf, np.inf)
        assert package.Parameter('v', shape=(3, 2)).ndim == 2 and package.Parameter('v', shape=(3, 2)).size == 6
        c = package.Parameter(basename='c', derived='{a}+2*{b}')
        assert c.eval(a=1., b=3.) == 7.
        with pytest.raises(ValueError):
            c.eval(a=1.)
        coll = package.ParameterCollection([a, {'basename': 'b', 'value': 3.}, c])
        out = coll.eval(a=1., b=3.)
        assert out['c'] == 7. and out['a'] == 1. and out['b'] == 3.
        assert coll.params(basename='a').names() == ['a']
        assert a.deepcopy().name == 'a'
        clone = coll.clone()
        assert clone.names() == coll.names() and clone['a'] is not coll['a'] and clone['a'].limits == (0., 2.)

        class Node(package.Calculator):
            _params = {'a': dict(value=1., prior=dict(limits=[0., 2.])), 'f': dict(value=0., fixed=True)}

            def calculate(self, a=1., f=0.):
                self.out = a

        node = Node()
        assert node.params['a'].value == 1.
        assert node.deepcopy().__class__ is Node
        assert node.all_params.names() == ['a', 'f'] and node.varied_params.names() == ['a']
        node.runtime_info.initialize()
        node.init.setdefault('extra', 1)
        node.init.setdefault('none', None)
        assert node.init['extra'] == 1 and not node.runtime_info.initialized
        node.runtime_info.initialize()
        node.init.setdefault('extra', 2)
        node.init.setdefault('none', 4)
        assert node.init['extra'] == 1 and node.init['none'] is None and node.runtime_info.initialized
        node.init.setdefault('none', 3, if_none=True)
        assert node.init['none'] == 3 and not node.runtime_info.initialized

    (port, jax_side) = results[1], results[0]
    assert port[0].dtype == jax_side[0].dtype
    for name in jax_side[0].dtype.names:
        np.testing.assert_array_equal(port[0][name], jax_side[0][name])
    np.testing.assert_array_equal(port[1], jax_side[1])
    for got, expected in zip(port[2] + port[3] + port[4][0] + port[4][1], jax_side[2] + jax_side[3] + jax_side[4][0]
                             + jax_side[4][1]):
        np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(port[5], jax_side[5])

    # priors and log-priors on the same draws: tensors (port) and arrays (JAX)
    x = rng.uniform(-1., 3., size=64)
    for spec in (dict(limits=[0., 2.]), dict(dist='norm', loc=1., scale=0.5, limits=[-0.5, 2.5]),
                 dict(dist='loguniform', limits=[0.1, 2.8])):
        priors = [package.Prior(**spec) for package in PACKAGES]
        np.testing.assert_array_equal(priors[1].isin(torch.tensor(x)).numpy(), np.asarray(priors[0].isin(jnp.asarray(x))))
        np.testing.assert_array_equal(priors[1].isin(x), priors[0].isin(x))
        for loc, scale in ((0.3, 2.), (-1., -0.5))[:1 if spec.get('dist') == 'loguniform' else 2]:
            moved = [prior.affine_transform(loc=loc, scale=scale) for prior in priors]
            assert moved[1].__getstate__() == moved[0].__getstate__()
            assert isinstance(moved[1], desilike_tpu_torch.Prior)
    params = [package.ParameterCollection([
        package.Parameter(basename='a', value=1., prior=dict(limits=[0., 2.])),
        package.Parameter(basename='b', value=1., prior=dict(dist='norm', loc=1., scale=0.5)),
        package.Parameter(basename='f', value=1., fixed=True, prior=dict(dist='norm', loc=0., scale=1.)),
        package.Parameter(basename='s', value=0., derived='.marg', prior=dict(dist='norm', loc=0., scale=2.)),
        package.Parameter(basename='n', value=0.)]) for package in PACKAGES]
    draws = {name: rng.uniform(0.1, 1.9, size=16).astype('f4') for name in ('a', 'b', 'f', 's', 'n')}
    expected = np.asarray(params[0].prior(**{n: jnp.asarray(v) for n, v in draws.items()}))
    got = params[1].prior(**{n: torch.tensor(v) for n, v in draws.items()})
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert_close(got, expected, 1e-6)
    assert float(params[1].prior()) == float(params[0].prior()) == 0.
    for name in ('a', 'n'):
        assert_close(params[1][name].logprior(torch.tensor(draws[name])), params[0][name].logprior(draws[name]), 1e-6)
    assert params[1]['n'].logprior(torch.ones(3)).shape == (3,)


def test_utils_keywords():
    """``evaluate(value, type, locals)`` and ``find_names(..., quiet)`` with
    the JAX package's positional order and raise."""
    for package in PACKAGES:
        out = package.utils.evaluate('1+2', float)
        assert out == 3.0 and type(out) is float
        assert package.utils.evaluate('x * 2', None, {'x': 4}) == 8
        names = ['a1', 'a2', 'b']
        assert package.utils.find_names(names, ['a*', 'b']) == ['a1', 'a2', 'b']
        assert package.utils.find_names(names, 'c') == []
        assert package.utils.find_names(names, 'c*', quiet=False) == []
        with pytest.raises(ValueError):
            package.utils.find_names(names, ['b', 'c'], quiet=False)


def test_legendre():
    """P_ell for ells 0-6 at 64 seeded points in [-1, 1], in float32 against
    the JAX package's float32 and in float64 against its x64."""
    x = np.random.default_rng(3).uniform(-1., 1., size=(4, 16))
    for ell in range(7):
        assert_close(legendre.legendre(ell, torch.tensor(x, dtype=torch.float32)),
                     jax_legendre.legendre(ell, jnp.asarray(x, dtype='f4')), 1e-6)
        with jax.enable_x64(True):
            expected = np.asarray(jax_legendre.legendre(ell, jnp.asarray(x)))
        got = legendre.legendre(ell, torch.tensor(x))
        assert got.dtype == torch.float64
        assert_close(got, expected, 1e-12)


def test_linalg():
    """chi2, inv, blockinv and logdet, and the small Cholesky helpers on a
    batch of seeded SPD matrices (and one that does not factor, which keeps
    the JAX package's clipped pivots), in float64 against the JAX package's
    x64."""
    rng = np.random.default_rng(4)
    mats = spd(6, 4, seed=5)
    diff = rng.normal(size=(6, 4))
    b = rng.normal(size=(6, 4))
    with jax.enable_x64(True):
        expected = dict(
            chi2_full=jax_linalg.chi2(jnp.asarray(diff), jnp.asarray(mats[0])),
            chi2_diag=jax_linalg.chi2(jnp.asarray(diff), jnp.asarray(np.diag(mats[0]))),
            logdet=jax_linalg.logdet(jnp.asarray(mats)),
            chol=jax_linalg.chol_small(jnp.asarray(mats)))
        expected['solve'] = jax_linalg.chol_solve_small(expected['chol'], jnp.asarray(b))
        expected['chol_logdet'] = jax_linalg.chol_logdet_small(expected['chol'])
        bad = np.array([[1., 2.], [2., 1.]])
        expected['bad'] = jax_linalg.chol_small(jnp.asarray(bad))
        expected = {key: np.asarray(value) for key, value in expected.items()}
    t = torch.tensor
    got = dict(chi2_full=linalg.chi2(t(diff), t(mats[0])), chi2_diag=linalg.chi2(t(diff), np.diag(mats[0])),
               logdet=linalg.logdet(t(mats)), chol=linalg.chol_small(t(mats)))
    got['solve'] = linalg.chol_solve_small(got['chol'], t(b))
    got['chol_logdet'] = linalg.chol_logdet_small(got['chol'])
    got['bad'] = linalg.chol_small(t(bad))
    for key, value in expected.items():
        assert got[key].dtype == torch.float64, key
        assert_close(got[key], value, 1e-12)
    # float32 on the same matrices against float64
    chol32 = linalg.chol_small(t(mats, dtype=torch.float32))
    assert_close(linalg.chol_logdet_small(chol32), expected['chol_logdet'], 1e-6)
    # inverses: host arrays as the JAX package, tensors batched
    assert_close(linalg.inv(mats[0]), jax_linalg.inv(mats[0]), 1e-12)
    assert_close(linalg.inv(t(mats)), np.linalg.inv(mats), 1e-12)
    singular = np.ones((3, 3))
    for mat in (singular, t(singular)):
        with pytest.raises((ValueError, np.linalg.LinAlgError)):
            linalg.inv(mat)
        assert_close(linalg.inv(mat, check_valid='ignore'), jax_linalg.inv(singular, check_valid='ignore'), 1e-12)
    with pytest.raises(ValueError):
        linalg.inv(np.ones((2, 3)))
    big = spd(1, 9, seed=6)[0]
    for split in ([0, 4, 9], [0, 2, 5, 9]):
        blocks = [[big[i0:i1, j0:j1] for j0, j1 in zip(split[:-1], split[1:])] for i0, i1 in zip(split[:-1], split[1:])]
        expected_inv = jax_linalg.blockinv(blocks)
        assert_close(linalg.blockinv(blocks), expected_inv, 1e-12)
        got_t = linalg.blockinv([[t(block) for block in row] for row in blocks])
        assert isinstance(got_t, torch.Tensor)
        assert_close(got_t, expected_inv, 1e-12)


@pytest.mark.parametrize('method', ['cubic', 'linear'])
def test_interp1d(method):
    """``interp1d`` on a non-uniform grid over a (3,) batch of tables,
    queries inside and up to half an edge interval outside the range,
    clipped and extended: the values and the gradients in y and xq against
    the JAX package's (``jax.vjp``) in x64, the port's float64 at 1e-12, its
    float32 at 1e-6 (values) and 1e-5 (gradients) of the magnitude;
    ``Interpolator1D`` and ``loglog_interp`` (ops and the template's) in
    float32 against the JAX package's float32 at 1e-6."""
    rng = np.random.default_rng(7)
    x = np.concatenate([[0.], np.sort(rng.uniform(0.5, 9.5, size=22)), [10.]])
    y = np.sin(x)[None, :] * np.array([1., 2., -0.5])[:, None] + rng.normal(size=(3, 24)) * 0.1
    xq = rng.uniform(-0.25, 10.25, size=(5, 7))
    weights = rng.normal(size=(3, 5, 7))
    # float32-exact inputs: the float64 reference then carries no input rounding the float32 run does not
    x, y, xq, weights = (array.astype('f4').astype('f8') for array in (x, y, xq, weights))
    for extrap in ('clip', False):
        def jax_side(y_, xq_):
            value, vjp = jax.vjp(lambda a, b: jax_interp.interp1d(b, jnp.asarray(x), a, method=method, extrap=extrap),
                                 y_, xq_)
            return (value,) + vjp(jnp.asarray(weights))

        with jax.enable_x64(True):
            expected = [np.asarray(a) for a in jax.jit(jax_side)(jnp.asarray(y), jnp.asarray(xq))]
        for dtype, rtols in ((torch.float64, (1e-12,) * 3), (torch.float32, (1e-6, 1e-5, 1e-5))):
            ty = torch.tensor(y, dtype=dtype, requires_grad=True)
            txq = torch.tensor(xq, dtype=dtype, requires_grad=True)
            got = interp.interp1d(txq, torch.tensor(x, dtype=dtype), ty, method=method, extrap=extrap)
            assert got.shape == (3, 5, 7) and got.dtype == dtype
            (got * torch.tensor(weights, dtype=dtype)).sum().backward()
            for value, reference, rtol in zip((got.detach(), ty.grad, txq.grad), expected, rtols):
                assert_close(value, reference, rtol)
        table = interp.Interpolator1D(x, y[0], method=method, extrap=extrap)(torch.tensor(xq, dtype=torch.float32))
        assert table.dtype == torch.float32
        assert_close(table, jax_interp.Interpolator1D(x, y[0], method=method, extrap=extrap)(jnp.asarray(xq, dtype='f4')),
                     1e-6)
    k = np.geomspace(1e-3, 1., 50)
    pk = (1e4 * k / (1. + (k / 0.02) ** 2.5)).astype('f4')
    kq = np.geomspace(2e-3, 0.5, 33).astype('f4')
    assert_close(interp.loglog_interp(torch.tensor(kq), k.astype('f4'), torch.tensor(pk), method=method),
                 jax_interp.loglog_interp(jnp.asarray(kq), jnp.asarray(k, dtype='f4'), jnp.asarray(pk), method=method), 1e-6)
    if method == 'cubic':
        assert_close(power_template.loglog_interp(np.log10(k).astype('f4'), torch.tensor(pk), torch.tensor(kq)),
                     jax_power_template.loglog_interp(jnp.asarray(np.log10(k), dtype='f4'), jnp.asarray(pk),
                                                      jnp.asarray(kq)), 1e-6)


def test_fftlog_coefficients():
    """``FFTLogOneLoop.coefficients`` and ``coefficients_half`` (the phase
    referred to x_0) of a smooth pk at both biases, in float64 against the
    JAX package's x64 at 1e-12, in float32 at 1e-6."""
    k = np.geomspace(0.02, 0.3, 6)
    port, ref = FFTLogOneLoop(k, nfft=64, nr=16, nx=8), JaxFFTLogOneLoop(k, nfft=64, nr=16, nx=8)

    def pk(x):
        return 2e4 * x / (1. + (x / 0.02) ** 2) ** 1.3

    for bias in (None, -1.2):
        for name in ('coefficients', 'coefficients_half'):
            with jax.enable_x64(True):
                expected = np.asarray(getattr(ref, name)(pk, bias=bias))
            got = getattr(port, name)(pk, bias=bias, dtype=torch.float64, device='cpu')
            assert got.dtype == torch.complex128 and got.shape == expected.shape
            assert_close(got.real, expected.real, 1e-12)
            assert_close(got.imag, expected.imag, 1e-12)
            got32 = getattr(port, name)(pk, bias=bias, device='cpu')
            assert got32.dtype == torch.complex64
            assert_close(torch.view_as_real(got32), np.stack([expected.real, expected.imag], axis=-1), 1e-6)


def test_theory_members():
    """The BAO theory's ``z``, and the template's ``ap_s_mu`` after an
    evaluation at (qpar, qper) = (1.02, 0.97) against the function the JAX
    template's member calls with its qpar and qper."""
    s, mu = np.linspace(20., 150., 14), np.linspace(0., 1., 5)
    theories = desilike_tpu_torch.theories
    theory = theories.DampedBAOWigglesPowerSpectrumMultipoles(template=theories.BAOPowerSpectrumTemplate(z=0.8),
                                                              device='cpu')
    theory.runtime_info.initialize()
    assert theory.z == theory.template.z == 0.8
    template = theories.BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper', device='cpu')
    desilike_tpu_torch.Pipeline(template).evaluate({'qpar': 1.02, 'qper': 0.97})
    jac, sap, muap = jax_ap_s_mu(jnp.asarray(s, dtype='f4'), jnp.asarray(mu, dtype='f4'), qpar=jnp.float32(1.02),
                                 qper=jnp.float32(0.97))
    port_jac, port_sap, port_muap = template.ap_s_mu(torch.tensor(s, dtype=torch.float32),
                                                     torch.tensor(mu, dtype=torch.float32))
    assert port_jac == jac == 1.
    assert_close(port_sap.reshape(sap.shape), sap, 1e-6)
    assert_close(port_muap.reshape(muap.shape), muap, 1e-6)


def test_pipeline_functions_config1():
    """Config 1 on the CPU: ``get_fn()`` and ``states_fn()`` (made once a
    pipeline) are bit-identical to ``evaluate`` at the 16 frozen points with
    the solved parameters at their best fits; the log-posterior rebuilt from
    them (plus the log-prior and the analytic marginalization's constant
    -1/2 log det(-H)) is within the limits of
    ``tests/test_torch_bao_likelihood.py`` of the frozen JAX float32 and x64
    values; ``ParameterCollection.prior`` equals the pipeline's log-prior;
    ``nvaried`` and ``ndof`` are the frozen build's counts;
    ``derived_params`` the pipeline's derived parameters."""
    like = build_likelihood('cpu')
    pipe = like.pipeline
    names = list(REFERENCE['names'])
    values = {n: torch.tensor(REFERENCE['points'][:, i], dtype=torch.float32) for i, n in enumerate(names)}
    with torch.no_grad():
        logpost, aux = like.logpost_fn()(values)
        full = dict(values, **aux['solved'])
        get, states = pipe.get_fn(), pipe.states_fn()
        assert pipe.get_fn() is get and pipe.states_fn() is states
        result = get(full)
        result_states, derived, snapshots = states(full)
        expected = pipe.evaluate(full)
    assert torch.equal(result, expected) and torch.equal(result_states, expected)
    assert list(derived) == list(pipe.derived) and all(torch.equal(derived[n], pipe.derived[n]) for n in derived)
    assert list(snapshots) == ['{}:{:d}'.format(c.runtime_info.name, i) for i, c in enumerate(pipe.calculators)]
    assert all(set(snapshots[key]) == set(calc.__getstate__()) for key, calc in zip(snapshots, pipe.calculators))
    constant = -0.5 * torch.linalg.slogdet(-aux['solved_hessian'].double())[1]
    rebuilt = (result.double() + constant + aux['logprior'].double()).numpy()
    np.testing.assert_allclose(rebuilt, REFERENCE['logpost_x64'], rtol=0., atol=2e-3)
    np.testing.assert_allclose(rebuilt, REFERENCE['logpost'], rtol=0., atol=5e-2)
    np.testing.assert_allclose(rebuilt, logpost.double().numpy(), rtol=0., atol=2e-3)
    assert torch.equal(pipe.params.prior(**values), aux['logprior'])
    assert like.nvaried == len(names) + 10 == REFERENCE['names'].size + 10
    assert like.size == REFERENCE['flatdata'].size and like.ndof == like.size - like.nvaried == 98
    assert like.varied_params.names() == names and like.all_params.names() == pipe.params.names()
    assert pipe.derived_params.names() == ['DH_over_rd', 'DM_over_rd', 'DV_over_rd', 'DH_over_DM', 'loglikelihood',
                                           'logprior']
