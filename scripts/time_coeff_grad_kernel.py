"""Device time of the CUDA coefficient-gradient kernel on one card, its
variants and another version in turns, and the SASS of its inner loop.

At (4096, 288, 202), (4096, 560, 202) and (32768, 288, 202) (config 4's
large batch, whose inputs exceed the L2 cache), per-row coefficients with the
exp'd series' y multiplied in at load (as the config-4 path launches it), it
times 50 launches captured in a CUDA graph and replayed between CUDA events
(``chip_smoke.time_graph``), each beside the H100's bound for the same work
(``chip_smoke.coeff_grad_bound_ms``):

- the wrapper's launch (its geometry: half a warp a row, prefetch, the
  persistent grid of SMs x the blocks an SM holds);
- the same geometry with the direct loads instead of the prefetch;
- the grid cut to one block an SM, so that each team walks more rows;
- with ``--variant-source FILE`` (repeatable), an edited copy of the
  checkout's ``clenshaw_coeff_grad.cu`` (same interface), at the wrapper's
  geometry with the grid from its own occupancy, with the prefetch and with
  the direct loads;
- with ``--baseline-source FILE``, another ``clenshaw_coeff_grad.cu`` with
  the first design's interface ``clenshaw_coeff_grad_f32(x, grad_y, y, gc,
  rows, q, order, per_row, nq, warps, grid, stream)`` (one warp a row; e.g.
  the parent commit's).

Other sources are built with the port's nvcc flags into a temporary
directory.

Every variant is checked against the plain version first, then all are
timed in turns (a, b, ..., b, a, repeated). It samples the SM clock and
power with nvidia-smi while the wrapper's launch replays at Q = 288. Last it
compiles each source to a cubin and counts, with ``cuobjdump -sass``, the
instructions of the loop over a chunk of 16 degrees for each kernel, a
(query, degree), with ptxas's registers and spills.

Prints one line a measurement and a JSON summary as its last line; with
``--out DIR`` it writes the SASS there. Needs one CUDA card and nvcc. Run
from the repository root:

    python3 scripts/time_coeff_grad_kernel.py [--baseline-source FILE] [--variant-source FILE ...] [--out DIR]
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import time_clenshaw_kernel as tools  # noqa: E402

ORDER = chip_smoke.ORDER
SHAPES = ((chip_smoke.BATCH, chip_smoke.FS_NQUERY), (chip_smoke.BATCH, chip_smoke.NQUERY),
          (chip_smoke.JOINT_BIG_BATCH, chip_smoke.FS_NQUERY))
ROUNDS = 3


def bind(lib):
    """Set the argument types of a library built from a source of the checkout's interface."""
    lib.clenshaw_coeff_grad_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.clenshaw_coeff_grad_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def resident_blocks(lib, g):
    """Blocks of ``lib``'s instance at geometry ``g`` (per-row) that an SM holds."""
    blocks = ctypes.c_int(0)
    err = lib.clenshaw_coeff_grad_occupancy(1, g.nq, int(g.prefetch), g.warps, g.smem, ctypes.byref(blocks))
    if err or blocks.value < 1:
        raise RuntimeError('occupancy query at {} gave cudaError {} and {} blocks'.format(g, err, blocks.value))
    return blocks.value


def launch(geometry, x, w, y, order, lib=None):
    """The kernel of the checkout (or of ``lib``, of the same interface) at ``geometry`` (per-row coefficients)."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    rows, q = x.shape
    gc = torch.empty((rows, order), dtype=torch.float32, device=x.device)
    err = (lib or cuda_kernels.library()).clenshaw_coeff_grad_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), gc.data_ptr(), rows, q, order, 1, geometry.nq, int(geometry.prefetch),
        geometry.warps, geometry.smem, geometry.grid, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError('launch at {} failed with cudaError {}'.format(geometry, err))
    return gc


def baseline_launch(fn, x, w, y, order):
    """A launch of the first design's interface: one warp a row, ceil(q / 32)
    rounded up to 1, 9 or 18 queries a lane, 8 warps a block."""
    import torch
    rows, q = x.shape
    need = -(-q // 32)
    nq = next((n for n in (1, 9, 18) if n >= need), 18)
    warps = min(8, rows)
    gc = torch.empty((rows, order), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), gc.data_ptr(), rows, q, order, 1, nq, warps,
             min(-(-rows // warps), 65535), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError('baseline launch failed with cudaError {}'.format(err))
    return gc


def per_query_degree(name, loop):
    """Instructions of the chunk loop a (query, degree) of one lane: the loop
    advances NQ queries (the template's first argument) over 16 degrees
    for each 16 NQ FFMAs it holds (the compiler may unroll it)."""
    nq = int(re.search(r'ILi(\d+)E', name).group(1))
    counts = loop['counts']
    degrees = 16 * max(1, round(counts.get('FFMA', 0) / (16 * nq)))
    fp32 = sum(counts.get(op, 0) for op in ('FFMA', 'FADD', 'FMUL'))
    shfl = sum(v for k, v in counts.items() if k.startswith('SHFL'))
    steps = degrees * nq
    return dict(total=loop['total'] / steps, fp32=fp32 / steps, shfl=shfl / steps,
                other=(loop['total'] - fp32 - shfl) / steps, degrees_an_iteration=degrees, nq=nq)


def main():
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--baseline-source', help='another clenshaw_coeff_grad.cu, with the first design\'s interface')
    parser.add_argument('--variant-source', action='append', default=[],
                        help='an edited clenshaw_coeff_grad.cu of the checkout\'s interface (repeatable)')
    parser.add_argument('--out', help='directory for the SASS')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('needs a CUDA device: torch.cuda.is_available() is False')
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.ops.cuda_kernels import clenshaw_coeff_grad_reference
    device = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print('card: {}, {} SMs'.format(smi, sms))
    summary = {'card': smi, 'sms': sms, 'times': [], 'geometries': {}, 'sass': {}, 'clocks': {}}
    cuda_kernels.library()
    with tempfile.TemporaryDirectory() as scratch:
        sources = {'kernel': cuda_kernels._SOURCES[1]}
        baseline = None
        if args.baseline_source:
            sources['baseline'] = args.baseline_source
            lib, _, log = tools.build(args.baseline_source, scratch, 'baseline')
            baseline = lib.clenshaw_coeff_grad_f32
            baseline.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            print('baseline ptxas: ' + ' | '.join(line.strip() for line in log.splitlines() if 'registers' in line))
        others = {}
        for path in args.variant_source:
            label = os.path.splitext(os.path.basename(path))[0]
            lib, _, log = tools.build(path, scratch, label)
            others[label] = bind(lib)
            print('{} ptxas: {}'.format(label, ' | '.join(line.strip() for line in log.splitlines() if 'registers' in line)))
        for rows, q in SHAPES:
            case = dict(rows=rows, q=q, order=ORDER, per_row=True, log_values=True)
            x, c = chip_smoke.case_inputs(case, device, seed=2)
            w = torch.tensor(np.random.default_rng(5).normal(size=(rows, q)), dtype=torch.float32, device=device)
            with torch.no_grad():
                y = cuda_kernels.clenshaw(x, c)
            expected = clenshaw_coeff_grad_reference(x, w * y, ORDER)
            bound_ms, bound_by = chip_smoke.coeff_grad_bound_ms(rows, q, ORDER, True)
            cuda_kernels._launch_coeff_grad(x, w, y, ORDER, True)
            default = cuda_kernels.LAST_COEFF_GRAD_GEOMETRY
            variants = {'wrapper': default, 'direct loads': default._replace(prefetch=False, smem=0),
                        'one block an SM': default._replace(grid=min(default.grid, sms))}
            calls = [('wrapper', lambda: cuda_kernels._launch_coeff_grad(x, w, y, ORDER, True))]
            calls += [(label, lambda g=g: launch(g, x, w, y, ORDER)) for label, g in variants.items()
                      if label != 'wrapper']
            for name, lib in others.items():
                for suffix, g in (('', default), (' direct loads', variants['direct loads'])):
                    g = g._replace(grid=min(-(-rows // (2 * g.warps)), sms * resident_blocks(lib, g)))
                    print('{}x{} {}{}: {}, {} blocks an SM'.format(rows, q, name, suffix, g, resident_blocks(lib, g)))
                    calls.append((name + suffix, lambda g=g, lib=lib: launch(g, x, w, y, ORDER, lib)))
            if baseline is not None:
                calls.append(('baseline', lambda: baseline_launch(baseline, x, w, y, ORDER)))
            for label, g in variants.items():
                blocks = cuda_kernels.coeff_grad_resident_blocks(g.nq, True, g.prefetch, g.warps, g.smem)
                summary['geometries']['{} {}'.format(q, label)] = dict(g._asdict(), resident_blocks=blocks)
                print('{}x{} {}: {}, {} blocks an SM'.format(rows, q, label, g, blocks))
            for label, fn in calls:
                err = float((fn() - expected).abs().max() / expected.abs().max())
                print('{}x{} {}: {:.3e} of the magnitude from the plain version'.format(rows, q, label, err))
                if not err <= chip_smoke.COEFF_GRAD_RTOL:
                    raise AssertionError('{} disagrees with the plain version: {:.3e}'.format(label, err))
            for _ in range(ROUNDS):
                for label, fn in calls + calls[::-1]:  # in turns: a, b, ..., b, a
                    ms = chip_smoke.time_graph(fn)
                    summary['times'].append(dict(rows=rows, q=q, order=ORDER, call=label, ms=ms, bound_ms=bound_ms,
                                                 bound_by=bound_by, share_of_bound=bound_ms / ms))
                    print('{}x{} order {} per-row with y, {}: {:.4f} ms a launch (CUDA-graph replay), bound {:.4f} ms '
                          '({}), {:.1%} of it'.format(rows, q, ORDER, label, ms, bound_ms, bound_by, bound_ms / ms))
            if (rows, q) == SHAPES[0]:
                for label, fn in [call for call in calls if call[0] in ('wrapper', 'baseline')]:
                    summary['clocks'][label] = tools.sm_clocks(fn)
                    print('{} under load: {}'.format(label, summary['clocks'][label]))
            del x, c, w, y, expected
            torch.cuda.empty_cache()
        for which, source in sources.items():
            built = tools.sass_of(source, scratch, which)
            if built is None:
                print('cuobjdump not found: no SASS counts')
                break
            sass, log = built
            usage = tools.ptxas_usage(log)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, 'sass_coeff_grad_{}.txt'.format(which)), 'w') as file:
                    file.write(sass)
            # the chunk loop ends with the reduction: shuffles in the first design, shared loads now
            for name, loop in tools.loop_counts(sass, marker=('SHFL', 'LDS'), most_ffma=True).items():
                per = per_query_degree(name, loop)
                summary['sass']['{}:{}'.format(which, tools.short_name(name))] = dict(
                    counts=loop['counts'], ptxas=usage.get(name), **per)
                print('SASS {} {}: chunk loop {} instructions over {} degrees {}; a (query, degree): {:.3f} in all, '
                      '{:.3f} FP32, {:.3f} shuffles, {:.3f} other; ptxas: {}'.format(
                          which, tools.short_name(name), loop['total'], per['degrees_an_iteration'], loop['counts'],
                          per['total'], per['fp32'], per['shfl'], per['other'], usage.get(name)))
    print(json.dumps(summary))


if __name__ == '__main__':
    main()
