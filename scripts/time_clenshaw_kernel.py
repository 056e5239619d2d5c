"""Device time of the CUDA Clenshaw kernel on one card: the K sweep, the
first design in turns, the SM clock under load, and the SASS of each kernel.

For each shape ((4096, 560, 202) shared and per-row, (65536, 560, 202)
shared, exp fused) it times 50 launches captured in a CUDA graph, replayed
between CUDA events (``chip_smoke.time_graph``): the wrapper's default
geometry and K = 2, 4 and 8 queries a thread, each beside the H100's bound
for the same work (``chip_smoke.clenshaw_bound_ms``). With
``--baseline-source FILE``, a ``clenshaw.cu`` with the first design's
one-thread-a-query interface ``clenshaw_f32(x, coeffs, out, rows, q,
order, coeff_row_stride, log_values, stream)`` (e.g. the parent commit's)
is built with the port's nvcc flags into a temporary directory, checked
against the plain version and timed the same way, in turns (a, b, ..., b,
a). At the main shape it samples the SM clock and power with nvidia-smi
while the kernel replays.

Last it compiles each source to a cubin and counts, with ``cuobjdump
-sass``, for each kernel: the instructions of the innermost loop a
step-query (FP32: FFMA, FADD, FMUL; shared loads: LDS; the rest), and the
static instructions outside that loop (the tile's set-up, staging, row
lookups, loads, exp and stores), with ptxas's registers and spills.

Prints one line a measurement and a JSON summary as its last line; with
``--out DIR`` it writes the SASS there. Needs one CUDA card and nvcc. Run
from the repository root:

    python3 scripts/time_clenshaw_kernel.py [--baseline-source FILE] [--out DIR]
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SHAPES = ((chip_smoke.BATCH, False), (chip_smoke.BATCH, True), (chip_smoke.BIG_BATCH, False))
ORDER = 202


def build(source, directory, name):
    """nvcc ``source`` with the port's flags into ``directory``; (library, path, nvcc's output)."""
    from desilike_tpu_torch.ops import cuda_kernels
    target = os.path.join(directory, 'lib{}.so'.format(name))
    cmd = [cuda_kernels._nvcc(), *cuda_kernels._NVCC_FLAGS, '-shared', '-o', target, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('building {} failed:\n{}{}'.format(source, proc.stdout, proc.stderr))
    return ctypes.CDLL(target), target, proc.stdout + proc.stderr


def sass_of(source, directory, name):
    """(``cuobjdump -sass`` of ``source`` compiled to a cubin for sm_90a,
    ptxas's -v output), or None without cuobjdump."""
    from desilike_tpu_torch.ops import cuda_kernels
    tool = cuobjdump()
    if tool is None:
        return None
    cubin = os.path.join(directory, '{}.cubin'.format(name))
    flags = [f for f in cuda_kernels._NVCC_FLAGS if f not in ('-shared', '-Xcompiler', '-fPIC')]
    proc = subprocess.run([cuda_kernels._nvcc(), *flags, '-cubin', '-o', cubin, source], check=True,
                          capture_output=True, text=True)
    sass = subprocess.run([tool, '-sass', cubin], check=True, capture_output=True, text=True).stdout
    return sass, proc.stdout + proc.stderr


def baseline_call(fn, x, c, log_values=True):
    """A launch of the one-thread-a-query interface."""
    import torch
    out = torch.empty_like(x)
    rows, q = x.shape
    order = c.shape[-1]
    err = fn(x.data_ptr(), c.data_ptr(), out.data_ptr(), rows, q, order, order if c.ndim == 2 else 0,
             int(log_values), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError('baseline launch failed with cudaError {}'.format(err))
    return out


def sm_clocks(fn, seconds=1.5):
    """SM clock (MHz) and power (W) that nvidia-smi samples while ``fn``'s
    launches replay back to back for ``seconds``: (min, median, max) each."""
    import torch
    graph = torch.cuda.CUDAGraph()
    fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(50):
            fn()
    sampler = subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw', '--format=csv,noheader,nounits',
                                '-lms', '50'], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                graph.replay()
            torch.cuda.synchronize()
    finally:
        sampler.terminate()
        out, _ = sampler.communicate(timeout=10)
    samples = np.array([[float(v) for v in line.split(',')] for line in out.splitlines()[3:] if line.strip()])
    if not samples.size:
        return None
    return {'sm_mhz': [float(v) for v in np.percentile(samples[:, 0], [0, 50, 100])],
            'power_w': [float(v) for v in np.percentile(samples[:, 1], [0, 50, 100])], 'samples': len(samples)}


def cuobjdump():
    path = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    if os.path.isfile(path):
        return path
    found = shutil.which('cuobjdump')
    if found:
        return found
    try:
        import triton
        path = os.path.join(os.path.dirname(triton.__file__), 'backends', 'nvidia', 'bin', 'cuobjdump')
        return path if os.path.isfile(path) else None
    except ImportError:
        return None


_INSTRUCTION = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;')
_LABEL = re.compile(r'^\s*(\.L_x_\d+):')
_TARGET = re.compile(r'`?\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b')


def _count(ops):
    counts = {}
    for op in ops:
        key = op if op.startswith('LDS') else op.split('.')[0]
        counts[key] = counts.get(key, 0) + 1
    return counts


def loop_counts(sass, marker='LDS', most_ffma=False):
    """{function: counts} for the innermost loop of the recurrence (the
    shortest backward branch over at least 8 FFMAs and an instruction whose
    mnemonic starts with ``marker`` (a prefix or a tuple of them): the shared
    loads of the Clenshaw kernel; with ``most_ffma``
    the one with the most FFMAs, then the shortest, which passes over the
    compiler's loops around a shuffle in a divergent warp) of each function in
    ``cuobjdump -sass`` output: instructions by mnemonic, the loop's SASS
    text, and the static counts of the rest of the function (``outside``,
    by mnemonic, with ``f64`` the double-precision ones, which the row
    lookup uses). Branch targets are labels or addresses."""
    result = {}
    for block in sass.split('Function : ')[1:]:
        name, body = block.split('\n', 1)
        instructions, targets, texts = [], {}, []
        for line in body.splitlines():
            label = _LABEL.match(line)
            if label:
                targets[label.group(1)] = len(instructions)
                continue
            match = _INSTRUCTION.search(line)
            if match:
                targets['0x' + match.group(1).lstrip('0').rjust(1, '0')] = len(instructions)
                instructions.append(re.sub(r'^@!?U?P[T0-9]+\s+', '', match.group(2)))
                texts.append(line.strip())
        best = None
        for index, text in enumerate(instructions):
            if not text.startswith('BRA'):
                continue
            target = _TARGET.search(text[3:])
            if not target:
                continue
            key = target.group(1) or '0x' + target.group(2)[2:].lstrip('0').rjust(1, '0')
            begin = targets.get(key, index + 1)
            if begin > index:
                continue
            ops = [t.split()[0] for t in instructions[begin:index + 1]]
            ffma = sum(op.startswith('FFMA') for op in ops)
            key = (-ffma if most_ffma else 0, len(ops))
            if any(op.startswith(marker) for op in ops) and ffma >= 8 and (best is None or key < best[3]):
                best = ((begin, index + 1), ops, texts[begin:index + 1], key)
        if best is None:
            continue
        (begin, end), ops, text, _ = best
        rest = [t.split()[0] for t in instructions[:begin] + instructions[end:]]
        rest = [op for op in rest if not op.startswith('NOP')]
        outside = _count(rest)
        outside['f64'] = sum('F64' in op or op.split('.')[0] in ('DMUL', 'DADD', 'DFMA') for op in rest)
        result[name.strip()] = dict(counts=_count(ops), total=len(ops), text='\n'.join(text),
                                    outside=outside, outside_total=len(rest))
    return result


def ptxas_usage(log):
    """{function: 'Used N registers ...; spills'} from ptxas's -v output."""
    usage, name = {}, None
    for line in log.splitlines():
        match = re.search(r'Function properties for (\S+)', line)
        if match:
            name = match.group(1)
        elif name and 'spill' in line:
            usage[name] = line.strip()
        elif name and 'Used' in line and 'registers' in line:
            usage[name] = line.split(':', 1)[-1].strip() + '; ' + usage.get(name, '')
            name = None
    return usage


def short_name(name):
    """``clenshaw_flat_kernel<4, 1, 1>`` for a mangled kernel name (the name itself if it is not one)."""
    match = re.search(r'\d+(clenshaw_\w+?)I((?:L[a-z]\d+E)+)E', name)
    if not match:
        return name
    return '{}<{}>'.format(match.group(1), ', '.join(re.findall(r'L[a-z](\d+)E', match.group(2))))


def per_step_query(name, loop):
    """FP32 and LDS instructions a step-query: the kernel of the checkout reads
    one float4 (4 steps) per LDS.128 for K queries (K from the template
    argument); a one-thread-a-query kernel does one step per LDS. For the
    checkout's kernels also ``outside``: the static instructions outside the
    loop that are not steps of the recurrence (not FFMA, FADD or LDS: the
    set-up, staging, row lookups, loads, exp and stores), over the
    step-queries a thread has in a tile at ORDER (K x 4 x ceil(ORDER / 4)).
    That is what they cost a step-query if each runs once a tile, as at the
    timed shapes (one tile a block); branches not taken count too."""
    counts = loop['counts']
    lds = sum(v for k, v in counts.items() if k.startswith('LDS'))
    fp32 = sum(counts.get(op, 0) for op in ('FFMA', 'FADD', 'FMUL'))
    k = re.search(r'ILi(\d+)E', name)
    if k and lds:
        step_queries = 4 * lds * int(k.group(1))
    else:
        step_queries = max(lds, 1)
    result = dict(fp32=fp32 / step_queries, lds=lds / step_queries, other=(loop['total'] - fp32 - lds) / step_queries,
                  step_queries=step_queries)
    if k:
        outside = loop['outside']
        steps = outside.get('FFMA', 0) + outside.get('FADD', 0) + sum(
            v for key, v in outside.items() if key.startswith('LDS'))
        result['outside'] = (loop['outside_total'] - steps) / (int(k.group(1)) * 4 * -(-ORDER // 4))
    return result


def main():
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--baseline-source', help='another clenshaw.cu, with the one-thread-a-query interface')
    parser.add_argument('--out', help='directory for the SASS of the loops')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('needs a CUDA device: torch.cuda.is_available() is False')
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.ops.cuda_kernels import clenshaw_reference
    device = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print('card: {}'.format(smi))
    summary = {'card': smi, 'times': [], 'sass': {}, 'clocks': {}}
    with tempfile.TemporaryDirectory() as scratch:
        sources = {'kernel': cuda_kernels._SOURCES[0]}
        libraries = {'kernel': None}
        cuda_kernels.library()
        if args.baseline_source:
            sources['baseline'] = args.baseline_source
            lib, _, log = build(args.baseline_source, scratch, 'baseline')
            libraries['baseline'] = lib.clenshaw_f32
            libraries['baseline'].argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            print('baseline ptxas: ' + ' | '.join(line.strip() for line in log.splitlines() if 'registers' in line))
        for rows, per_row in SHAPES:
            nquery = chip_smoke.NQUERY
            case = dict(rows=rows, q=nquery, order=ORDER, per_row=per_row, log_values=True)
            x, c = chip_smoke.case_inputs(case, device, seed=2)
            bound_ms, bound_by = chip_smoke.clenshaw_bound_ms(rows, nquery, ORDER, per_row)
            expected = clenshaw_reference(x, c)
            default = cuda_kernels.clenshaw_geometry(rows, nquery, ORDER, per_row)
            calls = [('default K={} {} R={}'.format(default.k, 'flat' if default.flat else 'rows', default.rows_per_block),
                      lambda: cuda_kernels.clenshaw(x, c))]
            calls += [('K={}'.format(k), lambda k=k: cuda_kernels._launch_clenshaw(x, c, True, queries_per_thread=k))
                      for k in (2, 4, 8) if k != default.k or per_row]
            if 'baseline' in libraries:
                calls.append(('baseline', lambda fn=libraries['baseline']: baseline_call(fn, x, c)))
            for label, fn in calls:
                err = float((fn() - expected).abs().max() / expected.abs().max())
                if not err <= chip_smoke.KERNEL_RTOL:
                    raise AssertionError('{} disagrees with the plain version: {:.3e}'.format(label, err))
            for label, fn in calls + calls[::-1]:  # in turns: a, b, ..., b, a
                ms = chip_smoke.time_graph(fn)
                summary['times'].append(dict(rows=rows, q=nquery, order=ORDER, per_row=per_row,
                                             call=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                                             share_of_bound=bound_ms / ms))
                print('{}x{} order {} {} {}: {:.4f} ms a launch (CUDA-graph replay), bound {:.4f} ms ({}), '
                      '{:.1%} of it'.format(rows, nquery, ORDER, 'per-row' if per_row else 'shared',
                                            label, ms, bound_ms, bound_by, bound_ms / ms))
            if (rows, nquery, per_row) == (chip_smoke.BATCH, chip_smoke.NQUERY, False):
                for label, fn in calls[:1] + [call for call in calls if call[0] == 'baseline']:
                    clocks = sm_clocks(fn)
                    summary['clocks'][label] = clocks
                    print('{} under load: {}'.format(label, clocks))
            del x, c, expected
            torch.cuda.empty_cache()
        for which, source in sources.items():
            built = sass_of(source, scratch, which)
            if built is None:
                print('cuobjdump not found: no SASS counts')
                break
            sass, log = built
            usage = ptxas_usage(log)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, 'sass_{}.txt'.format(which)), 'w') as file:
                    file.write(sass)
            for name, loop in loop_counts(sass).items():
                per = per_step_query(name, loop)
                summary['sass']['{}:{}'.format(which, short_name(name))] = dict(
                    counts=loop['counts'], outside_counts=loop['outside'], outside_total=loop['outside_total'],
                    ptxas=usage.get(name), **per)
                print('SASS {} {}: innermost loop {} instructions {}; a step-query: {:.3f} FP32, {:.4f} LDS, '
                      '{:.3f} other; outside the loop {} static instructions{} {}; ptxas: {}'.format(
                          which, short_name(name), loop['total'], loop['counts'], per['fp32'], per['lds'], per['other'],
                          loop['outside_total'],
                          ' ({:.3f} a step-query once a tile at order {}, steps of the recurrence left out)'.format(
                              per['outside'], ORDER)
                          if 'outside' in per else '', loop['outside'], usage.get(name)))
    print(json.dumps(summary))


if __name__ == '__main__':
    main()
