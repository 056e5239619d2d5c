"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``).

They skip without a card. The machine with the card has no JAX, so this
file imports none, and runs without the JAX-pinning ``tests/conftest.py``,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (build_joint_likelihood, build_likelihood, case_inputs, case_label, chains, check_coeff_grad_case,
                        check_derivatives, check_failed_chain, check_kernel_case, coeff_grad_cases, kernel_cases)
from desilike_tpu_torch.cosmology import background, linear
from desilike_tpu_torch.ops import cuda_kernels
from desilike_tpu_torch.ops.chebyshev import ChebyshevLogInterp
from desilike_tpu_torch.ops.cuda_kernels import clenshaw, clenshaw_reference

pytestmark = pytest.mark.gpu

REFERENCE = os.path.join(os.path.dirname(__file__), 'data', 'torch_port_bao_reference.npz')


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def coeffs(cuda):
    """ln pk Chebyshev coefficients of the config-1 template (order 202)."""
    kgrid = np.geomspace(1e-4, 1., 2000)
    cheb = ChebyshevLogInterp(kgrid)
    return torch.tensor(cheb.coeffs(linear.pk_lin(background.resolve(), kgrid, 0.8)), dtype=torch.float32,
                        device=cuda)


@pytest.mark.parametrize('shared', [True, False], ids=['shared', 'per_row'])
@pytest.mark.parametrize('log_values', [True, False], ids=['exp', 'series'])
def test_kernel_matches_reference(cuda, coeffs, shared, log_values):
    """At the main-path width, Q = 560 and order 202: both float32; the kernel
    fuses 2x b1 - b2 into one FMA where torch rounds each operation, so they
    agree to 1e-5 of the output's magnitude."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.uniform(-1., 1., size=(64, 560)), dtype=torch.float32, device=cuda)
    c = coeffs
    if not shared:
        c = (coeffs + torch.tensor(1e-3 * rng.normal(size=(64, coeffs.numel())), dtype=torch.float32,
                                   device=cuda)).contiguous()
    before = cuda_kernels.CLENSHAW_LAUNCHES
    got = clenshaw(x, c, log_values=log_values)
    torch.cuda.synchronize()
    assert cuda_kernels.CLENSHAW_LAUNCHES == before + 1
    expected = clenshaw_reference(x, c, log_values=log_values)
    torch.testing.assert_close(got, expected, rtol=0., atol=1e-5 * float(expected.abs().max()))


@pytest.mark.parametrize('case', kernel_cases(), ids=case_label)
def test_kernel_cases_match_reference(cuda, case):
    """The shapes chip_smoke.py checks: ragged Q, orders 1 to 320, shared and
    per-row, with and without exp, a view at a storage offset, 70000 rows
    (also walked with a grid stride), K = 2 and 8; 1e-5 of the magnitude."""
    check_kernel_case(case, cuda)


def test_kernel_walks_rows_past_the_grid_limit(cuda, coeffs):
    """More rows than gridDim.y allows (65535): per-row and shared coefficients."""
    rng = np.random.default_rng(4)
    rows = 70000
    x = torch.tensor(rng.uniform(-1., 1., size=(rows, 8)), dtype=torch.float32, device=cuda)
    per_row = (coeffs + 1e-3 * torch.randn((rows, coeffs.numel()), generator=torch.Generator(cuda).manual_seed(0),
                                           device=cuda)).contiguous()
    for c in (coeffs, per_row):
        got = clenshaw(x, c, log_values=False)
        expected = clenshaw_reference(x, c, log_values=False)
        torch.testing.assert_close(got, expected, rtol=0., atol=1e-5 * float(expected.abs().max()))


def test_kernel_gradient(cuda, coeffs):
    """x-gradient through the kernel's backward (the derivative series on
    the same kernel) against autograd through the plain recurrence."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-1., 1., size=(4096, 560)), dtype=torch.float32, device=cuda)
    xk = x.clone().requires_grad_(True)
    clenshaw(xk, coeffs).sum().backward()
    xr = x.clone().requires_grad_(True)
    clenshaw_reference(xr, coeffs).sum().backward()
    torch.testing.assert_close(xk.grad, xr.grad, rtol=0., atol=1e-4 * float(xr.grad.abs().max()))


def test_kernel_rejects_bad_inputs(cuda, coeffs):
    x = torch.zeros((4, 560), device=cuda)
    with pytest.raises(TypeError):
        clenshaw(x.double(), coeffs.double())
    with pytest.raises(ValueError, match='contiguous'):
        clenshaw(torch.zeros((560, 4), device=cuda).t(), coeffs)
    with pytest.raises(ValueError, match='one shape'):
        cuda_kernels._launch_coeff_grad(x, x[:, :8].contiguous(), None, 202, True)
    with pytest.raises(ValueError, match='48 KB'):
        clenshaw(x, torch.ones(12289, device=cuda))
    with pytest.raises(ValueError, match='queries_per_thread'):
        cuda_kernels._launch_clenshaw(x, coeffs, True, queries_per_thread=7)


def test_kernel_raises_when_library_fails_to_build(cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_kernels, '_LIBRARY', None)
    monkeypatch.setattr(cuda_kernels, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        clenshaw(torch.zeros((2, 3), device=cuda), torch.ones(4, device=cuda))


def test_logpost_on_card_matches_cpu(cuda):
    """Config 1 on the card, where a likelihood built with no device runs
    (the kernel, forward and backward), against the port's CPU plain path,
    both float32, at the 16 frozen points."""
    reference = np.load(REFERENCE)
    names = list(reference['names'])
    results = []
    for device in (None, 'cpu'):  # no device: the card
        like = build_likelihood(device)
        values = {n: torch.tensor(reference['points'][:, i], dtype=torch.float32, device=like.pipeline.device,
                                  requires_grad=True) for i, n in enumerate(names)}
        before = cuda_kernels.CLENSHAW_LAUNCHES
        logpost, _ = like.logpost_fn()(values)
        logpost.sum().backward()
        launched = cuda_kernels.CLENSHAW_LAUNCHES - before
        assert like.pipeline.device.type == (device or 'cuda')
        assert launched == (5 if device is None else 0)  # 3 lookups forward, 2 with a gradient
        grad = torch.stack([values[n].grad for n in names], dim=-1)
        results.append((logpost.detach().cpu().numpy(), grad.cpu().numpy()))
    (lp, g), (lp_cpu, g_cpu) = results
    np.testing.assert_allclose(lp, lp_cpu, rtol=0., atol=2e-3)
    assert (np.linalg.norm(g - g_cpu, axis=-1) / np.linalg.norm(g_cpu, axis=-1)).max() < 5e-4


@pytest.mark.parametrize('case', coeff_grad_cases(), ids=case_label)
def test_coeff_grad_cases_match_reference(cuda, case):
    """The coefficient-gradient kernel over the shapes chip_smoke.py checks
    (the main-path shapes, ragged Q, orders 1 to 320, per-row and shared, with
    and without exp, 70000 rows, a grid stride, column tiles) against its plain
    version: 1e-4 of the gradient's magnitude (another summation order over a
    float32 forward recurrence)."""
    before = cuda_kernels.COEFF_GRAD_LAUNCHES
    check_coeff_grad_case(case, cuda)
    assert cuda_kernels.COEFF_GRAD_LAUNCHES == before + 1


def test_backward_with_per_row_coefficients(cuda):
    """The full backward of the series at the full-shape lookups' shape
    (4096, 288, 202), per-row coefficients: x-gradient (the forward kernel
    on per-row derivative coefficients) and coefficient gradient (its own
    kernel) against autograd through the plain recurrence."""
    x, c = case_inputs(dict(rows=4096, q=288, order=202, per_row=True, log_values=True), cuda)
    weight = torch.tensor(np.random.default_rng(4).normal(size=tuple(x.shape)), dtype=torch.float32, device=cuda)
    grads = []
    before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
    for function in (clenshaw, clenshaw_reference):
        xg, cg = x.clone().requires_grad_(True), c.clone().requires_grad_(True)
        (function(xg, cg) * weight).sum().backward()
        grads.append((xg.grad, cg.grad))
    assert (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES) == (before[0] + 2, before[1] + 1)
    for got, expected in zip(*grads):
        torch.testing.assert_close(got, expected, rtol=0., atol=1e-4 * float(expected.abs().max()))


def test_joint_logpost_on_card_matches_cpu(cuda):
    """Config 4 on the card, where a likelihood built with no device runs
    (both kernels, forward and backward), against the port's CPU plain path,
    both float32, at 4 frozen points; tolerances of chip_smoke.py."""
    from chip_smoke import JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_joint_reference.npz'))
    names = list(reference['names'])
    results = []
    for device in (None, 'cpu'):  # no device: the card
        like = build_joint_likelihood(device)
        values = {n: torch.tensor(reference['points'][:4, i], dtype=torch.float32, device=like.pipeline.device,
                                  requires_grad=True) for i, n in enumerate(names)}
        before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        logpost, _ = like.logpost_fn()(values)
        logpost.sum().backward()
        launched = (cuda_kernels.CLENSHAW_LAUNCHES - before[0], cuda_kernels.COEFF_GRAD_LAUNCHES - before[1])
        assert like.pipeline.device.type == (device or 'cuda')
        # forward: 3 lookups a BAO observable, 1 a full-shape one (8); backward: 2 and 1 more (6), and the
        # coefficient gradient of each ShapeFit table
        assert launched == ((14, 2) if device is None else (0, 0))
        grad = torch.stack([values[n].grad for n in names], dim=-1)
        results.append((logpost.detach().cpu().numpy(), grad.cpu().numpy()))
    (lp, g), (lp_cpu, g_cpu) = results
    np.testing.assert_allclose(lp, lp_cpu, rtol=0., atol=JOINT_X64_ATOL)
    assert (np.linalg.norm(g - g_cpu, axis=-1) / np.linalg.norm(g_cpu, axis=-1)).max() < JOINT_X64_GRAD_RTOL


def test_emulated_logpost_on_card_matches_cpu(cuda):
    """Config 5 (config 4 with the JAX package's emulators carried across
    from tests/data/torch_port_emulator_reference.npz) on the card, where a
    likelihood built with no device runs, against the port's CPU plain path,
    both float32, at 4 frozen points; config 4's tolerances and launches.
    Its Fisher on the card (forward mode under vmap through the MLP's sliced
    outputs) is finite."""
    from chip_smoke import JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL, build_emulated_likelihood
    from desilike_tpu_torch import Fisher
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_emulator_reference.npz'))
    names = list(reference['names'])
    results = []
    for device in (None, 'cpu'):  # no device: the card
        like = build_emulated_likelihood(device, reference=reference)
        values = {n: torch.tensor(reference['points'][:4, i], dtype=torch.float32, device=like.pipeline.device,
                                  requires_grad=True) for i, n in enumerate(names)}
        before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        logpost, _ = like.logpost_fn()(values)
        logpost.sum().backward()
        launched = (cuda_kernels.CLENSHAW_LAUNCHES - before[0], cuda_kernels.COEFF_GRAD_LAUNCHES - before[1])
        assert like.pipeline.device.type == (device or 'cuda')
        assert launched == ((14, 2) if device is None else (0, 0))
        grad = torch.stack([values[n].grad for n in names], dim=-1)
        results.append((logpost.detach().cpu().numpy(), grad.cpu().numpy()))
        if device is None:
            assert np.isfinite(Fisher(like)().hessian).all()
    (lp, g), (lp_cpu, g_cpu) = results
    np.testing.assert_allclose(lp, lp_cpu, rtol=0., atol=JOINT_X64_ATOL)
    assert (np.linalg.norm(g - g_cpu, axis=-1) / np.linalg.norm(g_cpu, axis=-1)).max() < JOINT_X64_GRAD_RTOL


def test_ept_logpost_on_card_matches_cpu(cuda):
    """Config 3 on the card, where a likelihood built with no device runs
    (both kernels at orders 105 and 320, forward and backward), against the
    port's CPU plain path, both float32, at 4 frozen points; tolerances of
    chip_smoke.py."""
    from chip_smoke import build_ept_likelihood, EPT_X64_ATOL, EPT_X64_GRAD_RTOL
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_ept_reference.npz'))
    names = list(reference['names'])
    results = []
    for device in (None, 'cpu'):  # no device: the card
        like = build_ept_likelihood(device)
        values = {n: torch.tensor(reference['points'][:4, i], dtype=torch.float32, device=like.pipeline.device,
                                  requires_grad=True) for i, n in enumerate(names)}
        before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        logpost, _ = like.logpost_fn()(values)
        logpost.sum().backward()
        launched = (cuda_kernels.CLENSHAW_LAUNCHES - before[0], cuda_kernels.COEFF_GRAD_LAUNCHES - before[1])
        assert like.pipeline.device.type == (device or 'cuda')
        # forward: the three loop tables' series (order 105) and the two template lookups (order 320);
        # backward: each one's x-gradient series and its coefficient gradient
        assert launched == ((10, 5) if device is None else (0, 0))
        grad = torch.stack([values[n].grad for n in names], dim=-1)
        results.append((logpost.detach().cpu().numpy(), grad.cpu().numpy()))
    (lp, g), (lp_cpu, g_cpu) = results
    np.testing.assert_allclose(lp, lp_cpu, rtol=0., atol=EPT_X64_ATOL)
    assert (np.linalg.norm(g - g_cpu, axis=-1) / np.linalg.norm(g_cpu, axis=-1)).max() < EPT_X64_GRAD_RTOL


def test_direct_logpost_on_card_matches_cpu_and_jax(cuda):
    """Config 3d (config 3 on direct cosmology parameters: the cosmology per
    chain on the card) against the port's CPU plain path and the frozen JAX
    x64 values at 4 points; the Clenshaw kernel launched as in config 3 (5
    forward and 5 more in the backward, 5 coefficient gradients)."""
    from chip_smoke import build_ept_direct_likelihood, EPT_X64_ATOL, EPT_X64_GRAD_RTOL
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_direct_reference.npz'))
    names = list(reference['names'])
    results = []
    for device in (None, 'cpu'):  # no device: the card
        like = build_ept_direct_likelihood(device)
        values = {n: torch.tensor(reference['points'][:4, i], dtype=torch.float32, device=like.pipeline.device,
                                  requires_grad=True) for i, n in enumerate(names)}
        before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        logpost, _ = like.logpost_fn()(values)
        logpost.sum().backward()
        launched = (cuda_kernels.CLENSHAW_LAUNCHES - before[0], cuda_kernels.COEFF_GRAD_LAUNCHES - before[1])
        assert like.pipeline.device.type == (device or 'cuda')
        assert launched == ((10, 5) if device is None else (0, 0))
        grad = torch.stack([values[n].grad for n in names], dim=-1)
        results.append((logpost.detach().cpu().numpy(), grad.cpu().numpy()))
    (lp, g), (lp_cpu, g_cpu) = results
    for expected, expected_grad in ((lp_cpu, g_cpu), (reference['logpost_x64'][:4], reference['grad_x64'][:4])):
        np.testing.assert_allclose(lp, expected, rtol=0., atol=EPT_X64_ATOL)
        assert (np.linalg.norm(g - expected_grad, axis=-1) / np.linalg.norm(expected_grad, axis=-1)).max() \
            < EPT_X64_GRAD_RTOL


def test_eh99_golden_on_card(cuda):
    """The ``eh99_pk`` golden vector through a Direct template on the eh99
    engine, built with no device (the card), at the golden test's tolerance;
    and its scale-dependent growth rate through the lookup of its fk table."""
    from desilike_tpu_torch import DirectPowerSpectrumTemplate, Pipeline
    golden = np.load(os.path.join(os.path.dirname(__file__), 'data', 'golden_theories.npz'))
    k29 = np.linspace(0.02, 0.3, 29)
    template = DirectPowerSpectrumTemplate(z=0.8, k=k29, engine='eh99')
    Pipeline(template).evaluate({})
    got, ref = template.pk_dd[0].cpu().numpy().astype('f8'), golden['eh99_pk']
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=2e-5)
    before = cuda_kernels.CLENSHAW_LAUNCHES
    fk = template.f_of_k(torch.tensor(k29, dtype=torch.float32, device=template.pk_dd.device)[None])
    assert cuda_kernels.CLENSHAW_LAUNCHES == before + 1
    np.testing.assert_allclose(fk.cpu().numpy(), template.fk.cpu().numpy(), rtol=1e-4)


def test_xi_logpost_on_card_matches_cpu(cuda):
    """Config xi on the card, where a likelihood built with no device runs
    (the kernel at (B, 3000, 230) shared, forward and backward; the rfft/irfft
    pair), against the port's CPU plain path, both float32, at 4 frozen
    points, and the JAX x64 values; tolerances of chip_smoke.py."""
    from chip_smoke import build_xi_likelihood, XI_X64_ATOL, XI_X64_GRAD_RTOL
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_xi_reference.npz'))
    names = list(reference['names'])
    results = []
    for device in (None, 'cpu'):  # no device: the card
        like = build_xi_likelihood(device)
        values = {n: torch.tensor(reference['points'][:4, i], dtype=torch.float32, device=like.pipeline.device,
                                  requires_grad=True) for i, n in enumerate(names)}
        before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        logpost, _ = like.logpost_fn()(values)
        logpost.sum().backward()
        launched = (cuda_kernels.CLENSHAW_LAUNCHES - before[0], cuda_kernels.COEFF_GRAD_LAUNCHES - before[1])
        assert like.pipeline.device.type == (device or 'cuda')
        # forward: pk and the no-wiggle pk at the AP-remapped (k, mu), the no-wiggle pk at the observed k;
        # backward: the x-gradient series of the first two; the template's coefficients are constant
        assert launched == ((5, 0) if device is None else (0, 0))
        grad = torch.stack([values[n].grad for n in names], dim=-1)
        results.append((logpost.detach().cpu().numpy(), grad.cpu().numpy()))
    (lp, g), (lp_cpu, g_cpu) = results
    for expected, expected_grad in ((lp_cpu, g_cpu), (reference['logpost_x64'][:4], reference['grad_x64'][:4])):
        np.testing.assert_allclose(lp, expected, rtol=0., atol=XI_X64_ATOL)
        assert (np.linalg.norm(g - expected_grad, axis=-1) / np.linalg.norm(expected_grad, axis=-1)).max() \
            < XI_X64_GRAD_RTOL


def test_ept_xi_logpost_on_card_matches_cpu_and_jax(cuda):
    """Config 3xi on the card, where a likelihood built with no device runs
    (the counterterms by the linearize path: forward mode under vmap through
    the xi step, its gradient through both kernels), against the port's CPU
    plain path and the JAX x64 values at 4 frozen points, and the solved
    counterterms against JAX x64; tolerances of chip_smoke.py."""
    from chip_smoke import build_ept_xi_likelihood, EPT_X64_ATOL, EPT_X64_GRAD_RTOL, SOLVED_RTOL
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_marg_reference.npz'))
    names = list(reference['ept_xi_names'])
    results = []
    for device in (None, 'cpu'):  # no device: the card
        like = build_ept_xi_likelihood(device)
        values = {n: torch.tensor(reference['ept_xi_points'][:4, i], dtype=torch.float32,
                                  device=like.pipeline.device, requires_grad=True) for i, n in enumerate(names)}
        before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        logpost, aux = like.logpost_fn()(values)
        logpost.sum().backward()
        launched = (cuda_kernels.CLENSHAW_LAUNCHES - before[0], cuda_kernels.COEFF_GRAD_LAUNCHES - before[1])
        assert like.pipeline.device.type == (device or 'cuda')
        assert launched == ((10, 5) if device is None else (0, 0))
        grad = torch.stack([values[n].grad for n in names], dim=-1)
        solved = torch.stack([aux['solved'][n] for n in like.pipeline.solved_params.names()], dim=-1)
        results.append((logpost.detach().cpu().numpy(), grad.cpu().numpy(), solved.detach().cpu().numpy()))
    (lp, g, solved), (lp_cpu, g_cpu, _) = results
    for expected, expected_grad in ((lp_cpu, g_cpu), (reference['ept_xi_logpost_x64'][:4],
                                                      reference['ept_xi_grad_x64'][:4])):
        np.testing.assert_allclose(lp, expected, rtol=0., atol=EPT_X64_ATOL)
        assert (np.linalg.norm(g - expected_grad, axis=-1) / np.linalg.norm(expected_grad, axis=-1)).max() \
            < EPT_X64_GRAD_RTOL
    expected = reference['ept_xi_solved_x64'][:4]
    assert np.all(np.abs(solved - expected) <= SOLVED_RTOL * np.maximum(100., np.abs(expected)))


def test_fisher_and_sum_on_card(cuda):
    """``Fisher`` of config xi on the card (jacfwd through the kernel) against
    the JAX x64 matrix, then the compressed likelihood of its view on qpar
    and qper plus config 3 against the JAX x64 values at 16 frozen points
    (chip_smoke.check_fisher_and_sum)."""
    from chip_smoke import build_ept_likelihood, build_xi_likelihood, check_fisher_and_sum
    out = check_fisher_and_sum(build_xi_likelihood(None), build_ept_likelihood(None), 'card')
    assert out['launches_fisher'][0] > 0 and out['launches_sum']['with gradient'] == (10, 5)


def test_xi_goldens_on_card(cuda):
    """The xi theories built with no device run on the card: ``damped_bao_xi``
    against its golden vector, ``ept_xi`` against the JAX x64 vector
    (chip_smoke.theory_golden)."""
    from chip_smoke import theory_golden
    from desilike_tpu_torch import (DampedBAOWigglesTracerCorrelationFunctionMultipoles, BAOPowerSpectrumTemplate,
                                    EPTTracerCorrelationFunctionMultipoles, ShapeFitPowerSpectrumTemplate)
    golden = np.load(os.path.join(os.path.dirname(__file__), 'data', 'golden_theories.npz'))
    reference = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_xi_reference.npz'))
    s = np.linspace(40., 140., 26)
    theory_golden('card', DampedBAOWigglesTracerCorrelationFunctionMultipoles(
        ells=(0, 2), s=s, template=BAOPowerSpectrumTemplate(z=0.8)), golden, 'damped_bao_xi')
    theory_golden('card', EPTTracerCorrelationFunctionMultipoles(
        ells=(0, 2), s=s, template=ShapeFitPowerSpectrumTemplate(z=0.8), resum=None), golden, 'ept_xi',
        x64=reference['ept_xi_x64'])


@pytest.mark.parametrize('case', [dict(rows=4096, q=288, order=202, per_row=True, log_values=True),
                                  dict(rows=4096, q=560, order=202, per_row=False, log_values=True)], ids=case_label)
def test_derivatives_through_the_kernels(cuda, case):
    """torch.func.jvp (x, c), jacfwd (x, c) on a (4, 16) slice, vmap over a
    leading 3 (x; x and c), double backward (d2/dx2, d2/(dx dc)) and reverse
    mode over vmap of jvp through the Functions that launch the kernels,
    against the same transforms of the plain recurrence; tolerances of
    chip_smoke.py."""
    before = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
    check_derivatives(case, cuda)
    assert cuda_kernels.CLENSHAW_LAUNCHES > before[0] and cuda_kernels.COEFF_GRAD_LAUNCHES > before[1]


def test_failed_chain_on_card(cuda):
    """Config 4 on the card with one chain forced to fail: the others' values
    and gradients stay bit-identical, the failed one reads -inf with a finite
    gradient, nothing raises."""
    like = build_joint_likelihood(None)
    names = like.pipeline.varied_params.names()
    check_failed_chain(like, like.logpost_fn(), chains(names, 64, seed=0, device=cuda), index=5)


def test_chees_on_config1(cuda):
    """Five ChEES iterations over 256 chains of config 1 on the card, through the kernel."""
    from desilike_tpu_torch.samplers import ChEESSampler
    sampler = ChEESSampler(build_likelihood(None), nchains=256, seed=3)
    before = cuda_kernels.CLENSHAW_LAUNCHES
    chain = sampler.run(nsteps=5, nwarmup=0)
    assert chain.shape == (5, 256)
    assert np.isfinite(chain['logposterior']).all()
    assert cuda_kernels.CLENSHAW_LAUNCHES > before
    assert sampler.diagnostics['leapfrogs'] >= 5
