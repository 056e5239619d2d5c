"""The port's Fisher forecast on the CPU: ``Fisher``, ``LikelihoodFisher``,
``FisherGaussianLikelihood``, ``Differentiation`` and ``Chain.to_fisher``
against the JAX package's.

The toy likelihoods (the 2-parameter linear Gaussian of
``tests/test_samplers.py`` and a non-Gaussian one) and the numpy algebra are
compared with the live JAX package; config xi's Fisher matrix and the sum of
the compressed likelihood it gives with config 3 with the frozen JAX x64
values of ``tests/data/torch_port_marg_reference.npz``
(``scripts/make_torch_port_reference.py marg``). Each test states its
tolerance.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu.core import Calculator as JaxCalculator, Pipeline as JaxPipeline
from desilike_tpu.differentiation import Differentiation as JaxDifferentiation
from desilike_tpu.fisher import Fisher as JaxFisher, LikelihoodFisher as JaxLikelihoodFisher
from desilike_tpu.likelihoods import BaseLikelihood as JaxBaseLikelihood
from desilike_tpu.samples.chain import Chain as JaxChain
from desilike_tpu_torch import (Calculator, Pipeline, BaseLikelihood, Fisher, LikelihoodFisher, Differentiation,
                                FisherGaussianLikelihood)
from desilike_tpu_torch.samples import Chain
from chip_smoke import build_xi_likelihood, build_ept_likelihood
from test_torch_sampler_steps import GaussianModel, JaxGaussianModel, analytic_cov

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_marg_reference.npz'))
FISHER_RTOL = 1e-3   # |dF_ij| <= FISHER_RTOL sqrt(F_ii F_jj), config xi against JAX x64
EPT_X64_ATOL, EPT_X64_GRAD_RTOL = 2e-2, 5e-4  # config 3's, against JAX x64


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


NONGAUSSIAN = {'a': dict(value=0.8, prior=dict(dist='norm', loc=1., scale=2.)),
               'b': dict(value=-0.3, prior=dict(limits=[-3., 3.]))}


def nongaussian_loglike(a, b, exp):
    return -0.5 * (a - 1.) ** 2 / 0.1 - 0.25 * (b + 0.5) ** 4 - 0.3 * a * b + 0.2 * exp(0.5 * a * b)


class JaxNonGaussian(JaxBaseLikelihood):
    _params = dict(JaxBaseLikelihood._params, **NONGAUSSIAN)

    def calculate(self, a=0.8, b=-0.3, **kwargs):
        import jax.numpy as jnp
        self.loglikelihood = nongaussian_loglike(a, b, jnp.exp)


class NonGaussian(BaseLikelihood):
    _params = dict(BaseLikelihood._params, **NONGAUSSIAN)

    def calculate(self, a=0.8, b=-0.3):
        self.loglikelihood = nongaussian_loglike(a, b, torch.exp)


@pytest.mark.parametrize('model, method', [('gaussian', 'auto'), ('gaussian', 'finite'), ('nongaussian', 'auto'),
                                           ('nongaussian', 'finite')])
def test_fisher_matches_jax(model, method):
    """``Fisher`` of a Gaussian likelihood (jacfwd of the whitened residuals,
    or their central differences) and of a non-Gaussian one (its Hessian and
    gradient, or their central differences) against the JAX package's, both
    in float32: the matrix within 1e-4 (1e-3 by differences) of its largest
    entry, the gradient within 1e-4 of the matrix's scale; the Gaussian one's
    covariance within 1e-3 of the analytic one."""
    if model == 'gaussian':
        ours, theirs = GaussianModel(device='cpu'), JaxGaussianModel()
    else:
        ours, theirs = NonGaussian(device='cpu'), JaxNonGaussian()
    lf = Fisher(ours, method=method)()
    ref = JaxFisher(theirs, method=method)()
    assert lf.names() == ref.names() == ['a', 'b']
    rtol = 1e-4 if method == 'auto' else 1e-3
    scale = np.abs(ref.hessian).max()
    np.testing.assert_allclose(lf.hessian, ref.hessian, rtol=0., atol=rtol * scale)
    np.testing.assert_allclose(lf.gradient, ref.gradient, rtol=0., atol=1e-4 * scale)
    np.testing.assert_allclose(lf.center, ref.center, rtol=1e-7)
    if model == 'gaussian':
        np.testing.assert_allclose(lf.covariance(['a', 'b']), analytic_cov(), rtol=1e-3, atol=1e-8)


def test_likelihood_fisher_algebra_matches_jax():
    """The numpy algebra of ``LikelihoodFisher`` against the JAX package's, on
    the same matrices (1e-12): covariance, std, fom, marginalize, fix, mean,
    chi2min, var, corrcoef, shift, view (with a parameter it does not know),
    the sum of two, choice and to_stats; the getdist export raises
    ImportError without getdist, as the JAX package's does."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(4, 4))
    hessian = -(A @ A.T + 4. * np.eye(4))
    center, gradient = rng.normal(size=4), rng.normal(size=4)
    names = ['a', 'b', 'c', 'd']
    ours = LikelihoodFisher(center, names, hessian, gradient=gradient, offset=1.5)
    theirs = JaxLikelihoodFisher(center, names, hessian, gradient=gradient, offset=1.5)

    def close(got, expected):
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-14)

    close(ours.covariance(), theirs.covariance())
    close(ours.covariance(['b', 'd']), theirs.covariance(['b', 'd']))
    close(ours.std('c'), theirs.std('c'))
    close(ours.fom(['a', 'b']), theirs.fom(['a', 'b']))
    close(ours.mean(), theirs.mean())
    close(ours.mean('b'), theirs.mean('b'))
    close(ours.chi2min(), theirs.chi2min())
    close(ours.var(), theirs.var())
    close(ours.corrcoef(), theirs.corrcoef())
    assert ours.choice() == pytest.approx(theirs.choice(), rel=1e-12)
    for method, args in (('marginalize', (['b'],)), ('fix', (['a', 'c'],)), ('shift', (np.ones(4),)),
                         ('view', (['d', 'e', 'a'],)), ('__add__', (ours,))):
        got = getattr(ours, method)(*args)
        expected = getattr(theirs, method)(*[theirs if arg is ours else arg for arg in args])
        assert got.names() == expected.names()
        for attr in ('center', 'hessian', 'gradient', 'offset'):
            close(getattr(got, attr), getattr(expected, attr))
    assert ours.to_stats() == theirs.to_stats()
    for fisher in (ours, theirs):
        with pytest.raises(ImportError):
            fisher.to_getdist()


def test_differentiation_orders():
    """``Differentiation`` at orders 1 and 2 on a nonlinear quantity (the JAX
    package's tests): forward mode against the exact derivatives (1e-5) and
    the JAX package's (1e-5); the accuracy-4 stencil tightens the accuracy-2
    one's error on a coarse step by over 20 times, its mixed partial within
    1e-4 and its second derivative within 5e-3 (its truncation); a stencil
    that would cross the prior's edge is shrunk (1e-5)."""
    params = {'a': dict(value=0.4, prior=dict(limits=[0., 1.]), delta=0.15),
              'b': dict(value=0.3, prior=dict(limits=[0., 1.]), delta=0.15)}

    class Cubic(Calculator):
        _params = params

        def calculate(self, a=0.4, b=0.3):
            self.y = torch.stack([a ** 3 * b + torch.sin(3. * a), a * b ** 2], dim=-1)

    class JaxCubic(JaxCalculator):
        _params = params

        def calculate(self, a=0.4, b=0.3, **kwargs):
            import jax.numpy as jnp
            self.y = jnp.stack([a ** 3 * b + jnp.sin(3. * a), a * b ** 2])

    def run(cls, pipeline, **kwargs):
        calc = cls(device='cpu') if cls is Cubic else cls()
        pipeline(calc)
        return (Differentiation if cls is Cubic else JaxDifferentiation)(calc, getter=lambda: calc.y, **kwargs)()['value']

    a, b = 0.4, 0.3
    exact = {('a',): [3 * a ** 2 * b + 3 * np.cos(3 * a), b ** 2], ('b',): [a ** 3, 2 * a * b],
             ('a', 'a'): [6 * a * b - 9 * np.sin(3 * a), 0.], ('a', 'b'): [3 * a ** 2, 2 * b], ('b', 'b'): [0., 2 * a]}
    auto = run(Cubic, Pipeline, order=2, method='auto')
    jax_auto = run(JaxCubic, JaxPipeline, order=2, method='auto')
    for deriv, value in exact.items():
        np.testing.assert_allclose(auto[deriv], value, atol=1e-5)
        np.testing.assert_allclose(auto[deriv], np.asarray(jax_auto[deriv]), atol=1e-5)
    first = run(Cubic, Pipeline, order=1, method='auto')
    assert len(first.derivs) == 3 and first.shape == (2,)
    r2 = run(Cubic, Pipeline, order=2, method='finite', accuracy=2)
    r4 = run(Cubic, Pipeline, order=2, method='finite', accuracy=4)
    err2, err4 = (np.abs(r[('a',)] - exact[('a',)]).max() for r in (r2, r4))
    assert err4 < err2 / 20., (err2, err4)
    np.testing.assert_allclose(r4[('a', 'b')], exact[('a', 'b')], atol=1e-4)
    np.testing.assert_allclose(r4[('a', 'a')], exact[('a', 'a')], atol=5e-3)

    class Edge(Calculator):
        _params = {'a': dict(value=0.95, prior=dict(limits=[0., 1.]), delta=0.3)}

        def calculate(self, a=0.95):
            self.y = a ** 2

    calc = Edge(device='cpu')
    Pipeline(calc)
    r = Differentiation(calc, getter=lambda: calc.y, order=1, method='finite', accuracy=4)()['value']
    assert float(r[('a',)]) == pytest.approx(2 * 0.95, rel=1e-5)


def test_chain_to_fisher_matches_jax():
    """``Chain.to_fisher`` of weighted samples against the JAX package's
    (1e-12): center, hessian and names."""
    rng = np.random.default_rng(4)
    values = rng.normal(size=(300, 4, 2)) @ np.array([[1., 0.3], [0., 0.5]])
    weights = rng.uniform(0.5, 1.5, (300, 4))
    fishers = []
    for cls in (Chain, JaxChain):
        chain = cls()
        chain['a'], chain['b'], chain['aweight'] = values[..., 0], values[..., 1], weights
        fishers.append(chain.to_fisher(['a', 'b']))
    ours, theirs = fishers
    assert ours.names() == theirs.names() == ['a', 'b']
    np.testing.assert_allclose(ours.center, theirs.center, rtol=1e-12)
    np.testing.assert_allclose(ours.hessian, theirs.hessian, rtol=1e-12)


def test_fisher_to_likelihood():
    """The compressed likelihood of a Fisher: a 1-sigma shift in one
    parameter lowers the log-posterior by 1/2 (5e-2 relative, the JAX
    test's)."""
    lf = Fisher(GaussianModel(device='cpu'))()
    fn = lf.to_likelihood(device='cpu').logpost_fn()
    a = torch.tensor([lf.center[0], lf.center[0] + lf.std('a')])
    lp, _ = fn({'a': a, 'b': torch.tensor([lf.center[1]] * 2)})
    assert 2. * float(lp[0] - lp[1]) == pytest.approx(1., rel=0.05)


def test_config_xi_fisher_matches_jax_x64():
    """``Fisher`` of config xi at its fiducial (b1 = 2.0), over its 4 varied
    and 6 solved parameters, jacfwd through the FFTLog path in float32,
    against the JAX package's in x64: |dF_ij| <= 1e-3 sqrt(F_ii F_jj)."""
    lf = Fisher(build_xi_likelihood('cpu'))(b1=2.0)
    assert lf.names() == list(REFERENCE['fisher_xi_names_x64'])
    F, ref = lf.precision, -REFERENCE['fisher_xi_hessian_x64']
    bound = FISHER_RTOL * np.sqrt(np.outer(np.diag(ref), np.diag(ref)))
    assert np.all(np.abs(F - ref) <= bound), np.max(np.abs(F - ref) / bound)
    np.testing.assert_allclose(lf.center, REFERENCE['fisher_xi_center_x64'], rtol=1e-7)


def test_sum_with_fisher_likelihood_matches_jax_x64():
    """The compressed BAO likelihood of config xi's Fisher (its view on qpar
    and qper) plus config 3, which share qpar and qper, at the 16 frozen
    points against the JAX package's x64 values: config 3's limits, 2e-2 on
    the log-posterior and 5e-4 of the gradient's norm; built from the JAX
    package's Fisher, and from the port's own."""
    names = list(REFERENCE['sum_names'])
    view = LikelihoodFisher(REFERENCE['sum_fisher_center_x64'], list(REFERENCE['sum_fisher_names']),
                            REFERENCE['sum_fisher_hessian_x64'])
    own = Fisher(build_xi_likelihood('cpu'))(b1=2.0).view(['qpar', 'qper'])
    points = REFERENCE['sum_points']
    ept = build_ept_likelihood('cpu')
    for fisher in (view, own):
        total = FisherGaussianLikelihood(fisher=fisher, device='cpu') + ept
        assert total.pipeline.varied_params.names() == names
        assert total.pipeline.solved_params.names() == list(REFERENCE['sum_solved_names'])
        values = {n: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True) for i, n in enumerate(names)}
        logpost, _ = total.logpost_fn()(values)
        logpost.sum().backward()
        grad = torch.stack([values[n].grad for n in names], dim=-1).numpy()
        np.testing.assert_allclose(logpost.detach().numpy(), REFERENCE['sum_logpost_x64'], rtol=0., atol=EPT_X64_ATOL)
        err = np.linalg.norm(grad - REFERENCE['sum_grad_x64'], axis=-1) / np.linalg.norm(REFERENCE['sum_grad_x64'], axis=-1)
        assert err.max() < EPT_X64_GRAD_RTOL, err
