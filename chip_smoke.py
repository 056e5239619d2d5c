"""Smoke test of the PyTorch port (desilike_tpu_torch) on one CUDA card.

Drives the port's main path, the batched config-1 BAO log-posterior of
``__graft_entry__._build_likelihood`` at full width, on the card, through
the hand-written CUDA Clenshaw kernel, and checks it:

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the kernel library's build time;
2. the kernel against its plain PyTorch version (:func:`kernel_cases`): the
   main-path shapes (B in {1, 4096}, Q = 560, the template's order 202),
   ragged Q in {1, 3, 561} at orders {1, 2, 3, 203, 320}, shared and per-row
   coefficients, with and without exp, an x view with a storage offset,
   70000 rows (also walked with a grid stride), K = 2 and 8 queries a thread,
   the (56, 1) lookup's one-block launch; and its x-gradient against autograd
   through the plain version at B = 1 and 4096;
3. the likelihood at full width: log-posterior and gradient over B = 4096
   seeded chains (finite, through the kernel; launches counted forward and
   with the gradient), the frozen JAX values of
   ``tests/data/torch_port_bao_reference.npz``, the ``damped_bao`` golden
   vector of ``tests/data/golden_theories.npz`` from a theory built with no
   device (the card by default), and the gradient on the card against the
   port's CPU plain path;
4. times: the kernel's device time from CUDA-graph replay of 50 launches at
   (4096, 560, 202) shared and per-row and (65536, 560, 202) shared, each
   beside its bound; the wrapper's host time a call; the plain version; and
   log-posterior evaluations per second at B = 4096 and 65536.

Any failure raises (exit code 1). The last two lines of standard output are
a JSON object describing the kernels, then ``{"ok": true, "device": ...}``.
Needs one CUDA device and no network; imports nothing of JAX.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
BIG_BATCH = 65536
NQUERY = 560  # 56 k bins x 10 mu nodes per chain
KGRID = np.geomspace(1e-4, 1., 2000)  # the config-1 template grid
FP32_FLOPS = 67e12   # published H100 SXM FP32 rate outside the tensor cores, at 700 W
HBM_BYTES = 3.35e12  # published H100 SXM memory rate
KERNEL_RTOL = 1e-5   # of the output's magnitude: the kernel fuses 2x b1 - b2 + c into one FFMA
                     # and an FADD where torch rounds every operation, both float32


def build_likelihood(device):
    """Config 1 in the port, as a user builds it (``device=None``: the card)."""
    from desilike_tpu_torch import (DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    template = BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper')
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0, 2), template=template)
    theory.init.params = {'al*': dict(derived='.marg')}
    klim = {0: (0.02, 0.3, 0.005), 2: (0.02, 0.3, 0.005)}
    obs = TracerPowerSpectrumMultipolesObservable(data={'qpar': 1.0, 'qper': 1.0, 'b1': 2.0},
                                                  klim=klim, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device=device)
    like.pipeline
    return like


def chains(names, batch, seed, device):
    """Seeded parameter batch around the fiducial, inside the priors."""
    import torch
    rng = np.random.default_rng(seed)
    center = {'qpar': 1., 'qper': 1., 'b1': 2., 'dbeta': 1.}
    width = {'qpar': 0.04, 'qper': 0.04, 'b1': 0.3, 'dbeta': 0.1}
    return {n: torch.tensor(center[n] + width[n] * rng.uniform(-1., 1., batch), dtype=torch.float32,
                            device=device, requires_grad=True) for n in names}


def logpost_and_grad(fn, values):
    import torch
    logpost, _ = fn(values)
    logpost.sum().backward()
    grad = torch.stack([v.grad for v in values.values()], dim=-1)
    return logpost.detach(), grad


def check_close(label, got, expected, atol, grad=None, expected_grad=None, grad_rtol=None):
    """Raise unless |got - expected| <= atol, and the gradient within grad_rtol
    of its norm; print the measured errors."""
    err = float(np.abs(np.asarray(got) - np.asarray(expected)).max())
    line = '{}: max |d logpost| {:.3e} (tol {:.1e})'.format(label, err, atol)
    ok = err <= atol
    if grad is not None:
        gerr = float((np.linalg.norm(np.asarray(grad) - expected_grad, axis=-1)
                      / np.linalg.norm(expected_grad, axis=-1)).max())
        line += ', max |d grad|/|grad| {:.3e} (tol {:.1e})'.format(gerr, grad_rtol)
        ok = ok and gerr <= grad_rtol
    print(line)
    if not ok:
        raise AssertionError(line)


def kernel_cases():
    """The shapes at which the Clenshaw kernel is held against its plain
    version: dicts of rows, q, order, per_row, log_values, and optionally
    offset (x a view at that storage offset, in elements), k (queries a
    thread) and max_grid (a smaller grid, so that blocks walk their tiles)."""
    cases = []
    for rows in (1, BATCH):
        for per_row in (False, True):
            for log_values in (True, False):
                cases.append(dict(rows=rows, q=NQUERY, order=202, per_row=per_row, log_values=log_values))
    for q in (1, 3, 561):
        for order in (1, 2, 3, 203, 320):
            for per_row in (False, True):
                for log_values in (True, False):
                    cases.append(dict(rows=56, q=q, order=order, per_row=per_row, log_values=log_values))
    for rows, q in ((56, 561), (BATCH, NQUERY)):
        for per_row in (False, True):
            cases.append(dict(rows=rows, q=q, order=202, per_row=per_row, log_values=True, offset=1))
    for per_row in (False, True):
        cases.append(dict(rows=70000, q=561, order=202, per_row=per_row, log_values=False))
        cases.append(dict(rows=70000, q=3, order=202, per_row=per_row, log_values=True, max_grid=7))
        for k in (2, 8):
            cases.append(dict(rows=BATCH, q=NQUERY, order=202, per_row=per_row, log_values=True, k=k))
    cases.append(dict(rows=56, q=1, order=202, per_row=False, log_values=True))  # the kobs lookup
    return cases


def case_label(case):
    return '{rows}x{q} order {order} {}{}{}{}{}'.format(
        'per-row' if case['per_row'] else 'shared', ' exp' if case['log_values'] else ' series',
        ' offset {}'.format(case['offset']) if case.get('offset') else '',
        ' K={}'.format(case['k']) if case.get('k') else '',
        ' grid {}'.format(case['max_grid']) if case.get('max_grid') else '', **case)


_COEFFS = {}


def ln_pk_coeffs(order):
    """Chebyshev coefficients of the config-1 ln pk table at ``order`` (float64 numpy)."""
    if order not in _COEFFS:
        from desilike_tpu_torch.cosmology import background, linear
        from desilike_tpu_torch.ops.chebyshev import ChebyshevLogInterp
        _COEFFS[order] = ChebyshevLogInterp(KGRID, order=order).coeffs(linear.pk_lin(background.resolve(), KGRID, 0.8))
    return _COEFFS[order]


def case_inputs(case, device, seed=1):
    """Seeded x (rows, q) in [-1, 1] and the case's float32 coefficients on ``device``."""
    import torch
    rng = np.random.default_rng(seed)
    rows, q, order = case['rows'], case['q'], case['order']
    coeffs = ln_pk_coeffs(order)
    if case['per_row']:
        coeffs = coeffs + 1e-3 * rng.normal(size=(rows, order)) / (1. + np.arange(order))
    x = torch.tensor(rng.uniform(-1., 1., (rows, q)), dtype=torch.float32, device=device)
    offset = case.get('offset', 0)
    if offset:
        storage = torch.empty(rows * q + offset, dtype=torch.float32, device=device)
        storage[offset:] = x.reshape(-1)
        x = storage[offset:].view(rows, q)
        assert x.is_contiguous() and x.storage_offset() == offset
    return x, torch.tensor(coeffs, dtype=torch.float32, device=device)


def check_kernel_case(case, device):
    """Launch the kernel on ``case`` and hold it against clenshaw_reference;
    returns (max abs err, err relative to the output's max, geometry).
    Raises if they disagree beyond KERNEL_RTOL."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    x, c = case_inputs(case, device)
    if case.get('k') or case.get('max_grid'):
        got = cuda_kernels._launch_clenshaw(x, c, case['log_values'],
                                            queries_per_thread=case.get('k'),
                                            max_grid=case.get('max_grid', cuda_kernels.MAX_GRID))
    else:
        got = cuda_kernels.clenshaw(x, c, log_values=case['log_values'])
    geometry = cuda_kernels.LAST_GEOMETRY
    expected = cuda_kernels.clenshaw_reference(x, c, log_values=case['log_values'])
    torch.cuda.synchronize()
    err = float((got - expected).abs().max())
    rel = err / float(expected.abs().max())
    if not rel <= KERNEL_RTOL:
        raise AssertionError('kernel disagrees with clenshaw_reference at {}: {:.3e} of the magnitude'.format(
            case_label(case), rel))
    return err, rel, geometry


def clenshaw_bound_ms(rows, q, order, per_row):
    """Least time of the H100 for the series: 3 FLOP (an FFMA and an FADD) a
    step-query at the FP32 rate, or x and y once and the coefficients once at
    the memory rate, whichever is larger. Returns (ms, 'operations' or 'bytes')."""
    flops = 3. * rows * q * (order - 1)
    nbytes = 4. * (2 * rows * q + (rows if per_row else 1) * order)
    ops_ms, bytes_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def time_cuda(fn, iterations, warmup=3):
    """Mean milliseconds per call, CUDA events around ``iterations`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iterations


def time_graph(fn, launches=50, replays=10):
    """Device milliseconds per call of ``fn``: ``launches`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events. The host's
    work (checks, allocation, the ctypes call) is not in the number."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * launches)
    del graph
    return ms


def host_ms(fn, calls=200):
    """Host milliseconds a call to enqueue ``fn`` (no synchronisation inside
    the window; the device queue holds the calls)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False')
    sys.path.insert(0, ROOT)
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.ops.cuda_kernels import clenshaw, clenshaw_reference
    from desilike_tpu_torch.interop import state_from_numpy
    from desilike_tpu_torch import Pipeline, config
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_bao_reference.npz'))
    golden = np.load(os.path.join(ROOT, 'tests', 'data', 'golden_theories.npz'))
    cuda = config.device('cuda')

    # --- phase 1: the card ---
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cuda_kernels.library()
    ptxas = [line.strip() for line in cuda_kernels.BUILD_INFO['log'].splitlines() if 'registers' in line or 'spill' in line]
    print('phase 1: card {!r}; torch {}, CUDA {}; kernel library built and loaded in {:.2f} s; ptxas: {}'.format(
        smi, torch.__version__, torch.version.cuda, cuda_kernels.BUILD_INFO['seconds'], ' | '.join(ptxas)))
    print(smi)

    # --- phase 2: the kernel against its plain version ---
    like = build_likelihood(None)  # no device: the card
    pipe = like.pipeline
    names = pipe.varied_params.names()
    template = pipe.calculators[1]
    order = template._cheb.order
    if order != 202:
        raise AssertionError('the kernel cases assume the template\'s order 202, got {}'.format(order))
    coeffs = torch.tensor(template.pk_dd_coeffs_fid, dtype=torch.float32, device=cuda)
    max_abs_err, max_rel = 0., 0.
    kobs = None
    for case in kernel_cases():
        err, rel, geometry = check_kernel_case(case, cuda)
        max_abs_err, max_rel = max(max_abs_err, err), max(max_rel, rel)
        print('phase 2: {}: max abs err {:.3e}, relative to max {:.3e}; K={} {} blocks of {} threads, '
              '{} rows a block, idle {:.3f}'.format(case_label(case), err, rel, geometry.k, geometry.grid,
                                                    geometry.threads, geometry.rows_per_block, geometry.idle))
        if case == dict(rows=56, q=1, order=202, per_row=False, log_values=True):
            kobs = geometry
    print('phase 2: the (56, 1) lookup launched {} block(s) of {} threads'.format(kobs.grid, kobs.threads))
    if kobs.grid > 1:
        raise AssertionError('the (56, 1) lookup takes more than one block')
    rng = np.random.default_rng(1)
    for batch in (1, BATCH):
        x = torch.tensor(rng.uniform(-1., 1., (batch, NQUERY)), dtype=torch.float32, device=cuda)
        xk = x.clone().requires_grad_(True)
        clenshaw(xk, coeffs).sum().backward()
        xr = x.clone().requires_grad_(True)
        clenshaw_reference(xr, coeffs).sum().backward()
        torch.cuda.synchronize()
        rel = float((xk.grad - xr.grad).abs().max() / xr.grad.abs().max())
        print('phase 2: B={} x-gradient through the kernel vs autograd of the plain version: max err relative to max {:.3e}'.format(
            batch, rel))
        if not rel <= 1e-4:
            raise AssertionError('kernel x-gradient disagrees with autograd of clenshaw_reference')
    print('phase 2: {} kernel cases agree with clenshaw_reference: max abs err {:.3e}, relative {:.3e} (tol {:.0e})'.format(
        len(kernel_cases()), max_abs_err, max_rel, KERNEL_RTOL))

    # --- phase 3: the likelihood at full width ---
    fn = like.logpost_fn()
    if pipe.device.type != 'cuda':
        raise AssertionError('a likelihood built with no device evaluates on {}'.format(pipe.device))
    values = chains(names, BATCH, seed=0, device=cuda)
    cuda_kernels.CLENSHAW_LAUNCHES = 0
    with torch.no_grad():
        fn(values)
    torch.cuda.synchronize()
    launches_forward = cuda_kernels.CLENSHAW_LAUNCHES
    cuda_kernels.CLENSHAW_LAUNCHES = 0
    logpost, grad = logpost_and_grad(fn, values)
    torch.cuda.synchronize()
    launches = cuda_kernels.CLENSHAW_LAUNCHES
    finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())
    print('phase 3: logpost and gradient over B={} chains on {}: shape {}, all finite {}, mean logpost {:.4f}, '
          'Clenshaw launches {} forward, {} with the gradient'.format(
              BATCH, logpost.device, tuple(logpost.shape), finite, float(logpost.mean()), launches_forward, launches))
    if logpost.shape != (BATCH,) or not finite or launches_forward <= 0 or launches <= launches_forward:
        raise AssertionError('main path failed')

    points = reference['points']

    def at_points(likelihood, rows):
        vals = {n: torch.tensor(rows[:, i], dtype=torch.float32, device=likelihood.pipeline.device,
                                requires_grad=True) for i, n in enumerate(names)}
        lp, g = logpost_and_grad(likelihood.logpost_fn(), vals)
        return lp.cpu().numpy(), g.cpu().numpy()

    # the JAX float32 values carry up to 0.036 / 0.71% of their own float32
    # error (measured against the JAX package in x64); the x64 values bound
    # the port's own float32 error
    lp, g = at_points(state_from_numpy(build_likelihood('cuda'), reference), points)
    check_close('phase 3: card, JAX host state vs JAX float32 at 16 points', lp, reference['logpost'], 5e-2,
                g, reference['grad'], 1e-2)
    lp, g = at_points(like, points)
    check_close('phase 3: card, own host state vs JAX float32 at 16 points', lp, reference['logpost'], 5e-2,
                g, reference['grad'], 1e-2)
    check_close('phase 3: card, own host state vs JAX float64 (x64) at 16 points', lp, reference['logpost_x64'],
                2e-3, g, reference['grad_x64'], 5e-4)
    cpu_like = build_likelihood('cpu')
    lp_cpu, g_cpu = at_points(cpu_like, points[:4])
    check_close('phase 3: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, 2e-3, g[:4], g_cpu, 5e-4)

    from desilike_tpu_torch import DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=np.linspace(0.02, 0.3, 29),
        template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper'))  # no device: the card
    # the parameter values of tests/test_golden.py that this theory takes
    golden_values = {'qpar': 1.02, 'qper': 0.98, 'b1': 1.8, 'sigmapar': 9., 'sigmaper': 6., 'sigmas': 2.,
                     'dbeta': 1.1, 'df': 1.05}
    tpipe = Pipeline(theory)
    tpipe.evaluate(golden_values)
    if theory.power.device.type != 'cuda':
        raise AssertionError('a theory built with no device evaluates on {}'.format(theory.power.device))
    got = theory.power[0].cpu().numpy().astype('f8')
    ref = golden['damped_bao']
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print('phase 3: damped_bao theory on the card (built with no device) vs golden: max err relative to max '
          '{:.3e} (tol 2e-5 + 2e-5 rtol)'.format(err))
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=2e-5)

    # --- phase 4: times (reported, not gated) ---
    saved = cuda_kernels.CLENSHAW_LAUNCHES
    timed = {}
    for label, rows, per_row in (('shared', BATCH, False), ('per-row', BATCH, True), ('shared', BIG_BATCH, False)):
        case = dict(rows=rows, q=NQUERY, order=order, per_row=per_row, log_values=True)
        x, c = case_inputs(case, cuda, seed=2)
        runs = [time_graph(lambda: clenshaw(x, c)) for _ in range(2)]
        bound_ms, bound_by = clenshaw_bound_ms(rows, NQUERY, order, per_row)
        timed[label, rows] = dict(ms=float(np.mean(runs)), bound_ms=bound_ms, bound_by=bound_by,
                                  geometry=cuda_kernels.LAST_GEOMETRY)  # that of the launches timed
        print('phase 4: Clenshaw {}x{} order {} {} on {!r}: device time {:.4f} ms a launch (CUDA-graph replay, '
              'runs {}); bound {:.4f} ms ({}), {:.1%} of it'.format(
                  rows, NQUERY, order, label, smi, timed[label, rows]['ms'], ['%.4f' % t for t in runs], bound_ms,
                  bound_by, bound_ms / timed[label, rows]['ms']))
    main = timed['shared', BATCH]
    x, c = case_inputs(dict(rows=BATCH, q=NQUERY, order=order, per_row=False, log_values=True), cuda, seed=2)
    wrapper_host_ms = host_ms(lambda: clenshaw(x, c))
    plain = [time_cuda(lambda: clenshaw_reference(x, c), 10)]
    events = [time_cuda(lambda: clenshaw(x, c), 200)]
    plain.append(time_cuda(lambda: clenshaw_reference(x, c), 10))
    plain_ms = float(np.mean(plain))
    print('phase 4: Clenshaw {}x{} order {}: wrapper host time {:.4f} ms a call; back-to-back calls {:.4f} ms a '
          'call (CUDA events, host included); plain version {:.4f} ms (runs {})'.format(
              BATCH, NQUERY, order, wrapper_host_ms, events[0], plain_ms, ['%.4f' % t for t in plain]))
    cuda_kernels.CLENSHAW_LAUNCHES = saved

    rates = {}
    for batch in (BATCH, BIG_BATCH):
        fixed = chains(names, batch, seed=1, device=cuda)
        with torch.no_grad():
            forward_ms = time_cuda(lambda: fn(fixed), 50 if batch == BATCH else 20)
        rates[batch] = batch / forward_ms * 1e3
        line = 'phase 4: logpost at B={} on {!r}: {:.4f} ms a call, {:.0f} evals/s'.format(
            batch, smi, forward_ms, rates[batch])
        if batch == BATCH:
            backward_ms = time_cuda(lambda: fn(fixed)[0].sum().backward(), 20)  # gradients accumulate; harmless
            line += '; with gradient {:.4f} ms, {:.0f} evals/s'.format(backward_ms, batch / backward_ms * 1e3)
        print(line)
        del fixed

    print(json.dumps({'kernels': [{
        'name': 'clenshaw', 'route': 'cuda', 'source': 'desilike_tpu_torch/csrc/clenshaw.cu',
        'replaces': 'desilike_tpu/ops/pallas_kernels.py:30', 'launches': launches,
        'launches_forward': launches_forward, 'launches_with_gradient': launches,
        'queries_per_thread': main['geometry'].k, 'max_abs_err': max_abs_err,
        'ms': main['ms'], 'plain_ms': plain_ms, 'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
        'share_of_bound': main['bound_ms'] / main['ms'], 'library_ms': None,
        'ms_per_row': timed['per-row', BATCH]['ms'], 'ms_65536': timed['shared', BIG_BATCH]['ms'],
        'bound_ms_65536': timed['shared', BIG_BATCH]['bound_ms'], 'host_ms': wrapper_host_ms,
        'geometry': main['geometry']._asdict(), 'evals_per_s': {str(b): r for b, r in rates.items()}}]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
