"""The port's general marginalization path on the CPU: the likelihood tests of
``tests/test_likelihood.py`` (its Percival tests are in
``tests/test_torch_files_likelihood.py``, with the other mock covariances) and the
cubic transform of ``tests/test_interop.py``, on the port's own pipelines.

Like the JAX package's tests these hold the port against closed forms and
against itself: the exact Gaussian integral for '.marg' and '.best' on each
path a solved parameter's design row can take (static, linearized, the two
mixed), '.prec' against '.marg', the non-Gaussian term of a sum, the
gradient through analytic rows beside a linearized parameter against finite
differences, and the cubic transform's local-Jacobian Newton step. The
cubic transform (with '.best' beside '.marg' on the linearize path) and
'.prec' are also held against the JAX package's x64 values frozen in
``tests/data/torch_port_marg_reference.npz``
(``scripts/make_torch_port_reference.py marg``); the other comparisons
against the JAX package's numbers are in
``tests/test_torch_ept_xi_likelihood.py`` (config 3xi, the EFT-like Kaiser
xi) and ``tests/test_torch_fisher.py`` (the summed likelihood). Each test
states its tolerance.
"""

import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import (DampedBAOWigglesTracerPowerSpectrumMultipoles, TracerPowerSpectrumMultipolesObservable,
                                BoxFootprint, ObservablesGaussianLikelihood, SumLikelihood, BaseLikelihood,
                                BaseGaussianLikelihood, EFTLikeKaiserTracerPowerSpectrumMultipoles,
                                ShapeFitPowerSpectrumTemplate, BAOPowerSpectrumTemplate, Pipeline, config)
from test_torch_sampler_steps import GaussianModel

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_marg_reference.npz'))
# the parameters of the frozen BAO cases, as scripts/make_torch_port_reference.py sets them
BAO_CUBIC_PARAMS = {'al*': dict(derived='.marg', prior=dict(dist='norm', loc=0., scale=1e3)),
                    'al0_0': dict(derived='.best', prior=dict(dist='norm', loc=0., scale=1e3))}
BAO_PREC_PARAMS = {'al*': dict(fixed=True),
                   'al0_0': dict(derived='.prec', fixed=False, prior=dict(dist='norm', loc=0., scale=100.))}


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_bao_likelihood(solve=False, ells=(0, 2), params=None, transform=None, data=None):
    """``tests/test_likelihood.py``'s BAO likelihood in the port, on the CPU."""
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=ells)
    if solve:
        theory.init.params = {'al*': dict(derived='.marg', prior=dict(dist='norm', loc=0., scale=1e3))}
    if params is not None:
        theory.init.params = params
    obs = TracerPowerSpectrumMultipolesObservable(data=data or {}, klim={ell: (0.02, 0.3, 0.01) for ell in ells},
                                                  theory=theory, transform=transform)
    return ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=1e10, nbar=1e-3)],
                                         device='cpu')


def defaults(like, batch=1, dtype=torch.float32, requires_grad=False):
    return {p.name: torch.full((batch,), p.value, dtype=dtype, requires_grad=requires_grad)
            for p in like.pipeline.varied_params}


def assert_matches_jax(like, prefix, rtol):
    """The log-posterior, its gradient and the solved values of ``like`` in
    float64 at the frozen points ``prefix`` against the JAX package's x64
    values: each within ``rtol`` of the largest magnitude of its kind (the
    gradient per point, of its norm)."""
    names = like.pipeline.varied_params.names()
    assert names == list(REFERENCE[prefix + '_names'])
    points = REFERENCE[prefix + '_points']
    config.set_dtype('float64')
    try:
        values = {n: torch.tensor(points[:, i], dtype=torch.float64, requires_grad=True) for i, n in enumerate(names)}
        lp, aux = like.logpost_fn()(values)
        lp.sum().backward()
    finally:
        config.set_dtype('float32')
    ref_lp, ref_grad = REFERENCE[prefix + '_logpost_x64'], REFERENCE[prefix + '_grad_x64']
    np.testing.assert_allclose(lp.detach().numpy(), ref_lp, rtol=0., atol=rtol * np.abs(ref_lp).max())
    grad = torch.stack([values[n].grad for n in names], dim=-1).numpy()
    assert np.all(np.linalg.norm(grad - ref_grad, axis=-1) <= rtol * np.linalg.norm(ref_grad, axis=-1))
    solved_names = list(REFERENCE[prefix + '_solved_names'])
    assert list(aux.get('solved', {})) == solved_names
    if solved_names:
        solved = torch.stack([aux['solved'][n] for n in solved_names], dim=-1).detach().numpy()
        ref_solved = REFERENCE[prefix + '_solved_x64']
        np.testing.assert_allclose(solved, ref_solved, rtol=0., atol=rtol * np.abs(ref_solved).max())


def test_truth_is_max_gradient_zero_batches_and_solved_broadband():
    """At the truth the log-likelihood is 0 (within 1e-3) and every shift
    lowers the posterior; the gradient of the log-likelihood there vanishes
    (each component of the posterior's below 0.5, the prior's); a batch of 16
    chains along qpar peaks at the truth, each row as its own call (1e-4).
    With the broadband of data made with al = 0 marginalized, the posterior
    still peaks at the truth and the solved values are within 0.1 of their
    own posterior standard deviation of 0."""
    like = make_bao_likelihood()
    fn = like.logpost_fn()
    values = defaults(like, requires_grad=True)
    lp0, aux = fn(values)
    assert float(aux['loglikelihood'].detach()) == pytest.approx(0., abs=1e-3)
    lp0.sum().backward()
    for name in ('qpar', 'qper', 'b1'):
        assert abs(float(values[name].grad)) < 0.5
        shifted = dict(defaults(like), **{name: torch.tensor([{'qpar': 1.03, 'qper': 0.97, 'b1': 1.8}[name]])})
        assert float(fn(shifted)[0]) < float(lp0)
    batch = defaults(like, batch=16)
    batch['qpar'] = torch.linspace(0.95, 1.05, 16)
    lps, _ = fn(batch)
    assert lps.shape == (16,) and bool(torch.isfinite(lps).all()) and int(torch.argmax(lps)) in (7, 8)
    single = [float(fn({name: value[i:i + 1] for name, value in batch.items()})[0]) for i in (0, 9)]
    np.testing.assert_allclose(lps[[0, 9]].numpy(), single, rtol=0., atol=1e-4)
    like = make_bao_likelihood(solve=True, ells=(0,))
    pipe = like.pipeline
    assert pipe.solved_params.names() == ['al0_-3', 'al0_-2', 'al0_-1', 'al0_0', 'al0_1']
    assert 'al0_0' not in pipe.varied_params.names()
    fn = like.logpost_fn()
    lp0, aux = fn(defaults(like))
    assert bool(torch.isfinite(lp0).all())
    solved = np.array([float(v) for v in aux['solved'].values()])
    sigma = np.sqrt(np.diag(np.linalg.inv(-aux['solved_hessian'].double().numpy())))
    assert np.all(np.abs(solved) < 0.1 * sigma)
    assert float(fn(dict(defaults(like), qpar=torch.tensor([1.05])))[0]) < float(lp0)


X = np.linspace(0, 1, 20)
COV = np.diag(np.full(20, 0.01))
DATA = 1.5 * X + 0.3 * X ** 2 - 0.2 * X ** 3


def toy(static):
    """The linear model of ``test_marginalization_matches_exact``: s1 '.marg'
    and s2 '.best', each with a static design row if named in ``static``,
    else on the linearize path (the toy declares no basis)."""

    class Toy(BaseGaussianLikelihood):
        _params = dict(BaseGaussianLikelihood._params,
                       a=dict(value=1.5, prior=dict(limits=[0, 3])),
                       s1=dict(value=0., derived='.marg', prior=dict(dist='norm', loc=0., scale=2.)),
                       s2=dict(value=0., derived='.best', prior=dict(dist='norm', loc=0., scale=3.)))
        _static_linear_solved = static

        def initialize(self):
            self.x = X
            super().initialize(data=DATA, covariance=COV)

        def flattheory(self):
            x = self.const('x')
            return self._a[..., None] * x + self._s1[..., None] * x ** 2 + self._s2[..., None] * x ** 3

        def calculate(self, a=1.5, s1=0., s2=0.):
            self._a, self._s1, self._s2 = a, s1, s2
            super().calculate()

    return Toy(device='cpu')


@pytest.mark.parametrize('static', [(), ('s1', 's2'), ('s1',), ('s2',)],
                         ids=['linearized', 'static', 'marg_static_best_linearized', 'marg_linearized_best_static'])
def test_marginalization_matches_exact(static):
    """Analytic marginalization of s1 ('.marg') and best fit of s2 ('.best')
    against the closed form of the linear model (1e-4 in float64, the solved
    values too), on each path their rows can take: both linearized (per-chain
    rows), both static, and each mix, where the log-determinant is that of
    the '.marg' sub-block: a constant (s1 static) or the per-chain Schur
    complement of it (s1 linearized)."""
    like = toy(static)
    aval = 1.4
    P = np.linalg.inv(COV)
    J = np.stack([X ** 2, X ** 3])
    d0 = aval * X - DATA
    prior_prec = np.diag([2. ** -2, 3. ** -2])
    g = -J @ P @ d0
    H = -(J @ P @ J.T) - prior_prec
    dx = -np.linalg.solve(H, g)
    ll = -0.5 * d0 @ P @ d0 + 0.5 * dx @ (-(J @ P @ J.T)) @ dx + g @ dx - 0.5 * np.log(-H[0, 0])
    logprior = sum(-0.5 * (dx[i] / s) ** 2 - 0.5 * np.log(2 * np.pi * s ** 2) for i, s in enumerate([2., 3.])) - np.log(3.)
    config.set_dtype('float64')
    try:
        lp, aux = like.logpost_fn()({'a': torch.tensor([aval, aval], dtype=torch.float64)})
    finally:
        config.set_dtype('float32')
    np.testing.assert_allclose(lp.numpy(), ll + logprior, rtol=0., atol=1e-4)
    np.testing.assert_allclose(torch.stack([aux['solved']['s1'], aux['solved']['s2']], -1).numpy(), [dx, dx], atol=1e-4)
    expected_shape = (2, 2) if len(static) == 2 else (2, 2, 2)
    assert tuple(aux['solved_hessian'].shape) == expected_shape


def test_sum_likelihood():
    """``SumLikelihood`` and ``+`` (which flattens a + b + c): on shared
    parameters, the log-likelihood of the sum of n copies is n times that of
    one (1e-4 of its magnitude), the prior counted once."""
    likes = [make_bao_likelihood(ells=(0,)) for _ in range(3)]
    values = defaults(likes[0], batch=2)
    values['qpar'] = torch.tensor([1.0, 1.01])
    _, one = likes[0].logpost_fn()(values)
    for total, n in ((SumLikelihood(likelihoods=likes[:2]), 2), (likes[0] + likes[1] + likes[2], 3)):
        assert len(total.likelihoods) == n
        lp, aux = total.logpost_fn()(values)
        scale = float(one['loglikelihood'].abs().max())
        np.testing.assert_allclose(aux['loglikelihood'].numpy(), n * one['loglikelihood'].numpy(), rtol=0.,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(lp.numpy(), (aux['loglikelihood'] + one['logprior']).numpy(), rtol=1e-6)


class PlainLikelihood(BaseLikelihood):
    """A non-Gaussian likelihood in c."""
    _params = dict(BaseLikelihood._params, c=dict(value=0.3, prior=dict(dist='norm', loc=0., scale=1.),
                                                  ref=dict(dist='norm', loc=0., scale=0.1)))

    def calculate(self, c=0.):
        self.loglikelihood = -0.5 * (c / 0.5) ** 2


class SolvedGaussian(GaussianModel):
    """The 2-parameter Gaussian with b solved: it declares no basis, so b
    takes the linearize path."""
    _params = dict(GaussianModel._params, b=dict(GaussianModel._params['b'], derived='.marg',
                                                 prior=dict(dist='norm', loc=-0.5, scale=10.)))


def test_sum_with_nongaussian_and_linearized_solved():
    """A non-Gaussian likelihood beside a Gaussian one whose solved parameter
    takes the linearize path: the non-Gaussian term moves the posterior by
    exactly its own difference and its prior's, and its gradient flows
    (1e-4)."""
    total = SolvedGaussian(device='cpu') + PlainLikelihood(device='cpu')
    fn = total.logpost_fn()
    c = torch.tensor([0.3, 0.6], requires_grad=True)
    lp, aux = fn({'a': torch.tensor([1., 1.]), 'c': c})
    assert bool(torch.isfinite(lp).all()) and 'b' in aux['solved'] and aux['solved_hessian'].shape == (2, 1, 1)
    expected = -0.5 * (0.6 / 0.5) ** 2 + 0.5 * (0.3 / 0.5) ** 2 - 0.5 * (0.6 ** 2 - 0.3 ** 2)
    assert float(lp[1] - lp[0]) == pytest.approx(expected, abs=1e-4)
    lp.sum().backward()
    assert float(c.grad[0]) == pytest.approx(-0.3 / 0.25 - 0.3, abs=1e-4)


def test_prec_matches_marg_and_rebuilds_idempotently():
    """'.prec' (folded into the covariance once) against '.marg' (per
    evaluation) for a linear parameter: the same log-likelihood differences
    between points (1e-3 relative or absolute, float64); rebuilding
    ``logpost_fn`` leaves the covariance exactly as it was and the value to
    1e-6; with the other broadband terms fixed, the log-posterior and its
    gradient match the JAX package's x64 values at 4 frozen points (float64,
    1e-9 of their magnitude)."""
    def build(status):
        return make_bao_likelihood(ells=(0,), params={'al0_0': dict(derived=status, prior=dict(dist='norm', loc=0.,
                                                                                                 scale=100.))})

    diffs = []
    for status in ('.marg', '.prec'):
        like = build(status)
        values = defaults(like, batch=2, dtype=torch.float64)
        values['qpar'] = torch.tensor([1.0, 1.02], dtype=torch.float64)
        loglike = like.logpost_fn()(values)[1]['loglikelihood']
        diffs.append(float(loglike[1] - loglike[0]))
    assert diffs[0] == pytest.approx(diffs[1], rel=1e-3, abs=1e-3)
    assert 'al0_0' not in like.pipeline.varied_params.names()
    cov1 = np.array(like.covariance)
    fn1 = like.logpost_fn()
    assert np.abs(like.covariance - like._covariance_prefold).max() > 0.
    fn2 = like.logpost_fn()
    np.testing.assert_array_equal(like.covariance, cov1)
    np.testing.assert_allclose(fn1(values)[0].numpy(), fn2(values)[0].numpy(), rtol=1e-6)
    assert_matches_jax(make_bao_likelihood(ells=(0,), params=BAO_PREC_PARAMS), 'bao_prec', 1e-9)


def test_analytic_basis_with_linearized_solved():
    """The counterterms' analytic rows beside a parameter that enters
    nonlinearly (sigmapar, '.best', linearized): both solved, and the
    gradient through the analytic rows' dependence on the varied parameters
    agrees with central differences (2e-2 relative, as the JAX test)."""
    theory = EFTLikeKaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=ShapeFitPowerSpectrumTemplate(z=1.))
    theory.init.params = {'ct*': dict(derived='.marg')}
    obs = TracerPowerSpectrumMultipolesObservable(data={'b1': 2.0}, klim={0: (0.02, 0.2, 0.01), 2: (0.02, 0.2, 0.01)},
                                                  theory=theory)
    like = ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)], device='cpu')
    like.pipeline.params.update({'sigmapar': dict(derived='.best', fixed=False, prior=dict(dist='norm', loc=4., scale=3.))},
                                basename=True)
    pipe = like.pipeline
    aidx, _ = like._analytic_basis_plan(pipe.solved_params, range(len(pipe.solved_params)), [like])
    assert [pipe.solved_params[i].name for i in aidx] == ['ct0_2', 'ct2_2']
    fn = like.logpost_fn()
    eps = 1e-3
    values = defaults(like, batch=3, dtype=torch.float64)
    values['df'] = torch.tensor([1., 1. + eps, 1. - eps], dtype=torch.float64, requires_grad=True)
    lp, aux = fn(values)
    assert bool(torch.isfinite(lp).all()) and 'sigmapar' in aux['solved'] and 'ct0_2' in aux['solved']
    lp[0].backward()
    fd = float(lp[1] - lp[2]) / (2. * eps)
    assert float(values['df'].grad[0]) == pytest.approx(fd, rel=2e-2)


def test_cubic_transform():
    """transform='cubic' (Wang et al. 2023, arXiv:2302.07484 eq. 16): the
    identity at theory == data (1e-5), exactly (3 (T/D)^(1/3) - 2) D off it
    (2e-5), and other values raise. It makes the residual nonlinear in the
    exactly linear broadband: neither a static design matrix nor primal rows,
    but the linearize path, whose one Newton step from al = 0 matches a
    manual one with the local Jacobian of the whitened transformed residual
    (3e-2 of the largest step, the JAX test's), while a secant over the
    solve's scale differs from it by over 10 times that error. With al0_0
    '.best' beside the others' '.marg', the log-posterior, its gradient and
    the solved values match the JAX package's x64 values at 4 frozen points
    (float64, 1e-9 of their magnitude)."""
    def observable(transform):
        theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,), template=BAOPowerSpectrumTemplate(z=0.8,
                                                                                                              apmode='qiso'))
        return TracerPowerSpectrumMultipolesObservable(data={'qiso': 1.0, 'b1': 2.0}, klim={0: (0.05, 0.2, 0.01)},
                                                       theory=theory, transform=transform)

    obs = observable('cubic')
    pipe = Pipeline(obs)
    pipe.host_evaluate({'qiso': 1.0, 'b1': 2.0})
    np.testing.assert_allclose(obs.flattheory[0].numpy(), obs.flatdata, rtol=1e-5)
    pipe.host_evaluate({'qiso': 1.02, 'b1': 2.1})
    raw_obs = observable(None)
    Pipeline(raw_obs).host_evaluate({'qiso': 1.02, 'b1': 2.1})
    raw, data = raw_obs.flattheory[0].numpy(), obs.flatdata
    np.testing.assert_allclose(obs.flattheory[0].numpy(), (3. * (raw / data) ** (1. / 3.) - 2.) * data, rtol=2e-5)
    with pytest.raises(ValueError):
        Pipeline(observable('quartic'))

    def build(solve):
        params = {'al*': dict(prior=dict(dist='norm', loc=0., scale=1e3))}
        if solve:
            params['al*']['derived'] = '.marg'
        return make_bao_likelihood(ells=(0,), params=params, transform='cubic', data={'b1': 2.2})

    like = build(solve=True)
    solved = like.pipeline.solved_params
    assert len(solved) == 5 and like._static_linear_indices(like.pipeline, solved, [like]) == []
    assert like.solved_flat_basis_fn(solved[0]) is False
    lp, aux = like.logpost_fn()(defaults(like, dtype=torch.float64))
    assert bool(torch.isfinite(lp).all())
    got = np.array([float(aux['solved'][p.name]) for p in solved])
    ref = build(solve=False)
    names = [p.name for p in solved]

    def fdw(overrides):
        values = {p.name: p.value for p in ref.pipeline.varied_params}
        values.update(overrides)
        ref.pipeline.host_evaluate(values)
        return ref.flatdiff_white[0].numpy()

    d0 = fdw({})
    J_local = np.stack([(fdw({n: 1.}) - fdw({n: -1.})) / 2. for n in names])
    J_secant = np.stack([(fdw({n: 2000.}) - d0) / 2000. for n in names])

    def newton(J):
        return -np.linalg.solve(-(J @ J.T) - 1e-6 * np.eye(len(names)), -J @ d0)

    dx_local, dx_secant = newton(J_local), newton(J_secant)
    err = np.max(np.abs(got - dx_local))
    assert np.max(np.abs(dx_secant - dx_local)) > 10 * err
    np.testing.assert_allclose(got, dx_local, rtol=3e-2, atol=3e-2 * np.max(np.abs(dx_local)))
    assert_matches_jax(make_bao_likelihood(ells=(0,), params=BAO_CUBIC_PARAMS, transform='cubic', data={'b1': 2.2}),
                       'bao_cubic', 1e-9)
