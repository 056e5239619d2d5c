"""Where a log-posterior call spends its time on one CUDA card.

Builds config 1, 3, 3d, 3j, 4, xi or 3xi of ``chip_smoke.py`` on the card and, for the
forward call and for the call with its gradient, at each batch of seeded
chains:

- times the call on the host's clock (10 calls ending in a synchronise);
- runs ``torch.profiler`` over 5 calls (``--calls``) and reports, a call: the CUDA kernels
  launched, the device-busy time (the sum of the kernels' durations), the
  share of the wall time the card is idle, the host's time in each CUDA
  runtime call, the card's largest idle gaps between two kernels (with the
  kernels around them), the kernels that take the
  most device time, by name, the device time by kind of kernel (GEMM,
  cuFFT, the Clenshaw kernels, MAGMA, reductions, the rest elementwise),
  and by the operator that launched it with its input shapes; for config 3
  also the shares of the FFTLog quadratic forms (B6: the products with a
  130-wide operand) and of the static landing and radial pieces (B7: the
  products with a 25056- or 256-wide operand), forward and backward; for
  config xi the device time by stage (``xi_stages_ms_a_call``): the
  Clenshaw kernel, the landing GEMM (a 1105-wide operand), cuFFT, the
  product onto s (a 78-wide operand), the window and solve (the matrix
  products with a 156-, 52- or 6-wide operand: window, whitening and
  design matrices; and MAGMA), the other matrix products, and the
  elementwise rest (reductions included); the products by the device time
  of the operators that launched them, the rest by kind of kernel; for
  config 3xi (config 3's theory in configuration space) config 3's B6 and
  B7 beside config xi's stages (``stages_ms_a_call``).

Prints one JSON line per (mode, batch), each with the card's name and power
limit, and writes them to ``--out`` if given.

    python3 scripts/profile_logpost.py [--config 1|3|3d|3j|4|xi|3xi] [--batches 4096 32768] [--calls 5] [--out FILE]

(config 3j writes its supernova files into a temporary directory first).
"""

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


KINDS = (('clenshaw', ('clenshaw',)), ('gemm', ('gemm', 'xmma', 'cutlass', 'gemv', 'dot_kernel')),
         ('cufft', ('fft',)), ('magma', ('magma', 'trsm', 'trsv', 'potrf', 'displace', 'batch_')),
         ('reduction', ('reduce',)))


def kind(kernel):
    """The kind of a CUDA kernel, from its name; 'elementwise' for the rest."""
    name = kernel.lower()
    return next((label for label, patterns in KINDS if any(p in name for p in patterns)), 'elementwise')


def loop_stage(shapes):
    """Config 3's 1-loop stage of a matrix-product operator, from its input
    shapes: 'B6' (a 130-wide operand: the FFTLog quadratic forms), 'B7' (a
    25056-wide operand, the static landing, or a 256-wide one, the radial
    P13 and P(kr)^2 pieces), else None."""
    dims = {d for shape in shapes for d in shape}
    if 130 in dims:
        return 'B6'
    if 25056 in dims or 256 in dims:
        return 'B7'
    return None


def xi_stage(shapes):
    """Config xi's stage of a matrix-product operator, from its input shapes:
    'landing' (a 1105-wide operand: the landing of pk onto the FFTLog grid
    up to the last k of the P(k) model), 'onto_s' (a 78-wide one: the
    interpolation onto the window's s, and the tail's term), 'window_solve'
    (a 156-, 52- or 6-wide one: the window, whitening and design matrices),
    else 'other_gemm'."""
    dims = {d for shape in shapes for d in shape}
    if 1105 in dims:
        return 'landing'
    if 78 in dims:
        return 'onto_s'
    if dims & {156, 52, 6}:
        return 'window_solve'
    return 'other_gemm'


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--config', choices=('1', '3', '3d', '3j', '4', 'xi', '3xi'), default='4')
    parser.add_argument('--batches', type=int, nargs='+', default=[4096, 32768])
    parser.add_argument('--out', default=None, help='file the JSON lines are also written to')
    parser.add_argument('--calls', type=int, default=5,
                        help='calls profiled (the profiler holds memory a call: config 3xi needs 1 at 4096 chains)')
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('needs a CUDA device: torch.cuda.is_available() is False')
    from torch.profiler import profile, ProfilerActivity
    import chip_smoke
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.config == '3j':
        directory = tempfile.mkdtemp()
        chip_smoke.write_probe_files(directory)
        like = chip_smoke.build_probes_likelihood(None, directory)
        shutil.rmtree(directory)
    else:
        like = {'1': chip_smoke.build_likelihood, '3': chip_smoke.build_ept_likelihood,
                '3d': chip_smoke.build_ept_direct_likelihood, '4': chip_smoke.build_joint_likelihood,
                'xi': chip_smoke.build_xi_likelihood, '3xi': chip_smoke.build_ept_xi_likelihood}[args.config](None)
    fn = like.logpost_fn()
    names = like.pipeline.varied_params.names()
    lines = []
    for batch in args.batches:
        values = chip_smoke.chains(names, batch, seed=1, device=torch.device('cuda'))

        def forward():
            with torch.no_grad():
                fn(values)

        def with_gradient():
            for value in values.values():
                value.grad = None
            fn(values)[0].sum().backward()

        for mode, call in (('forward', forward), ('with gradient', with_gradient)):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 10 * 1e3
            calls = args.calls
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            kernels = collections.Counter()
            busy_us = collections.Counter()
            kinds = collections.Counter()
            runtime_us = collections.Counter()
            spans = []
            for event in prof.events():
                if event.device_type == torch.autograd.DeviceType.CUDA:
                    us = event.device_time if hasattr(event, 'device_time') else event.cuda_time
                    kernels[event.name] += 1
                    busy_us[event.name] += us
                    kinds[kind(event.name)] += us
                    spans.append((event.time_range.start, event.time_range.end, event.name))
                elif event.name.startswith('cuda'):  # the host's CUDA runtime calls
                    runtime_us[event.name] += event.time_range.elapsed_us()
            device_ms = sum(busy_us.values()) / calls * 1e-3
            # the card's idle gaps between consecutive kernels, largest first, with the kernels around them
            spans.sort()
            gaps = sorted(((b[0] - a[1], a[2], b[2]) for a, b in zip(spans, spans[1:])), reverse=True)
            ops, stages = [], collections.Counter()
            for average in prof.key_averages(group_by_input_shape=True):
                if average.device_type != torch.autograd.DeviceType.CPU:  # the kernels themselves: counted above
                    continue
                us = getattr(average, 'self_device_time_total', None)
                us = average.self_cuda_time_total if us is None else us
                if us <= 0:
                    continue
                shapes = [tuple(shape) for shape in (average.input_shapes or []) if shape]
                ops.append((us, average.key, shapes))
                product = any(k in average.key for k in ('mm', 'matmul', 'mv', 'dot', 'einsum', 'linear'))
                stage = {'3': loop_stage, 'xi': xi_stage, '3xi': lambda shapes: loop_stage(shapes) or xi_stage(shapes)}.get(
                    args.config, lambda _: None)(shapes) if product else None
                if stage:
                    stages[stage] += us
            ops.sort(key=lambda op: -op[0])
            line = {'config': args.config, 'mode': mode, 'batch': batch, 'card': smi, 'wall_ms': wall_ms,
                    'evals_per_s': batch / wall_ms * 1e3, 'kernels_a_call': sum(kernels.values()) / calls,
                    'device_busy_ms': device_ms, 'idle_share': 1. - device_ms / wall_ms,
                    'max_memory_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
                    'kinds_ms_a_call': {k: us / calls * 1e-3 for k, us in kinds.most_common()},
                    'top': [{'name': name[:80], 'launches_a_call': kernels[name] / calls,
                             'device_ms_a_call': us / calls * 1e-3} for name, us in busy_us.most_common(12)],
                    'top_ops': [{'op': key, 'shapes': str(shapes)[:160], 'device_ms_a_call': us / calls * 1e-3}
                                for us, key, shapes in ops[:15]],
                    'host_runtime_ms_a_call': {k: us / calls * 1e-3 for k, us in runtime_us.most_common(8)},
                    'largest_gaps': [{'ms': us * 1e-3, 'after': before[:60], 'before': after[:60]}
                                     for us, before, after in gaps[:8]]}
            if args.config == '3':
                line['loop_stages_ms_a_call'] = {k: us / calls * 1e-3 for k, us in stages.items()}
            if args.config == '3xi':
                line['stages_ms_a_call'] = dict(
                    {k: us / calls * 1e-3 for k, us in stages.items()}, magma=kinds['magma'] / calls * 1e-3,
                    clenshaw=kinds['clenshaw'] / calls * 1e-3, cufft=kinds['cufft'] / calls * 1e-3,
                    elementwise=(kinds['elementwise'] + kinds['reduction']) / calls * 1e-3)
            if args.config == 'xi':
                # the matrix products by stage (device time of the operators that launched them), MAGMA
                # beside the window and solve; the kinds of kernel for the rest
                line['xi_stages_ms_a_call'] = dict(
                    {k: us / calls * 1e-3 for k, us in stages.items()}, magma=kinds['magma'] / calls * 1e-3,
                    clenshaw=kinds['clenshaw'] / calls * 1e-3, cufft=kinds['cufft'] / calls * 1e-3,
                    elementwise=(kinds['elementwise'] + kinds['reduction']) / calls * 1e-3)
            lines.append(json.dumps(line))
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as file:
            file.write('\n'.join(lines) + '\n')


if __name__ == '__main__':
    main()
