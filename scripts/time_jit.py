"""The port's compiled entry points (jit: CUDA-graph capture and replay) on
one card, config by config: phase A19 of ``chip_smoke.py`` without the
phases before it, each case's failure reported and the next case run.

For each config of ``--configs`` and batch of ``--batches`` (default: the
config's two timed batches, ``chip_smoke.A19_BATCHES``, or B = 4096):
``logpost_fn()`` replayed against ``logpost_fn(jit=False)``
(:func:`chip_smoke.jit_forward_case`: errors, launches, synchronising
calls of a replay, wall and device milliseconds, kernels a call, peak
and held memory) and, with ``--gradient``, the samplers' captured
log-density and gradient (:func:`chip_smoke.jit_gradient_case`); with
``--samplers``, the runs of ``chip_smoke.A19_SAMPLERS`` eager and
captured given the same draws. One JSON line a case on stdout and into
``--out``. With ``--settle-solves``, first which solves synchronise with
the host (:func:`settle_solves`). With ``--capture-memory``, each case
also records the memory allocated and reserved on the card as each of its
captures begins (after the cache is emptied). Exits 1 if any case failed.
The caching allocator is the port's default (expandable segments) unless
``PYTORCH_CUDA_ALLOC_CONF`` is set, empty for fixed segments.

    python3 scripts/time_jit.py --configs 1 4 3d --gradient --out time_jit.jsonl
    PYTORCH_CUDA_ALLOC_CONF= python3 scripts/time_jit.py --configs 3 3d --batches 32768 --gradient --capture-memory
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def build(config, directory):
    """The likelihood of ``config`` on the card, as phase 3 builds it."""
    cs = chip_smoke
    if config == '3f':
        cs.write_files(directory)
        return cs.build_files_likelihood(None, directory)
    if config == '3j':
        cs.write_probe_files(directory)
        return cs.build_probes_likelihood(None, directory)
    if config == '5':
        reference = np.load(os.path.join(cs.ROOT, 'tests', 'data', 'torch_port_emulator_reference.npz'))
        return cs.build_emulated_likelihood(None, reference=reference)
    return {'1': cs.build_likelihood, '4': cs.build_joint_likelihood, '3': cs.build_ept_likelihood,
            '3d': cs.build_ept_direct_likelihood, 'xi': cs.build_xi_likelihood, '3xi': cs.build_ept_xi_likelihood,
            'tns': cs.build_tns_likelihood}[config](None)


def settle_solves(smi, batch=4096):
    """Which of the solves of ``likelihoods/base.py`` synchronise with the
    host at the main path's shapes (per-chain factors (B, n, n) of configs
    4 and 3d's Schur complements, n = 4 and 3; the constant factor of config
    4's 26 static rows against (B, 26, m)): for ``torch.cholesky_solve``,
    the two triangular solves (``ops.linalg.cholesky_solve``) and
    ``torch.linalg.cholesky_ex``, the runtime's synchronising calls of one
    call (torch.profiler) and whether a CUDA-graph capture of it succeeds."""
    import torch
    from desilike_tpu_torch.ops.linalg import cholesky_solve
    rng = np.random.default_rng(19)
    out = []
    for n, m, batched in ((4, 1, True), (3, 1, True), (26, 1, False), (26, 5, False)):
        a = rng.normal(size=(batch if batched else 1, n, n))
        matrix = torch.tensor(a @ np.swapaxes(a, -1, -2) + n * np.eye(n), dtype=torch.float32, device='cuda')
        matrix = matrix if batched else matrix[0]
        factor = torch.linalg.cholesky(matrix)
        rhs = torch.tensor(rng.normal(size=(batch, n, m)), dtype=torch.float32, device='cuda')
        for name, call in (('torch.cholesky_solve', lambda: torch.cholesky_solve(rhs, factor)),
                           ('ops.linalg.cholesky_solve', lambda: cholesky_solve(rhs, factor)),
                           ('torch.linalg.cholesky_ex', lambda: torch.linalg.cholesky_ex(matrix))):
            entry = {'case': 'solve', 'op': name, 'factor': list(factor.shape), 'rhs': list(rhs.shape), 'card': smi,
                     'runtime_syncs': chip_smoke.runtime_syncs(call)}
            if name == 'torch.cholesky_solve':  # MAGMA aborts the process under capture: try it in a child
                probe = subprocess.run([sys.executable, os.path.abspath(__file__), '--capture-probe', str(n), str(m),
                                        str(int(batched))], capture_output=True, text=True)
                entry.update(captured=probe.returncode == 0, capture_returncode=probe.returncode,
                             capture_error=probe.stderr.strip().splitlines()[-3:])
                out.append(entry)
                continue
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    call()
                graph.replay()
                torch.cuda.synchronize()
                entry['captured'] = True
            except Exception as exc:  # the capture's verdict is the measurement
                entry['captured'] = False
                entry['capture_error'] = '{}: {}'.format(type(exc).__name__, str(exc)[:300])
                torch.cuda.synchronize()
            del graph
            out.append(entry)
    return out


def capture_probe(n, m, batched, batch=4096):
    """Capture ``torch.cholesky_solve`` of a (B, n, m) right-hand side in a
    CUDA graph and replay it: exit 0 if that works (run in a child process:
    MAGMA's failure aborts it)."""
    import torch
    a = np.random.default_rng(19).normal(size=(batch if batched else 1, n, n))
    matrix = torch.tensor(a @ np.swapaxes(a, -1, -2) + n * np.eye(n), dtype=torch.float32, device='cuda')
    factor = torch.linalg.cholesky(matrix if batched else matrix[0])
    rhs = torch.ones((batch, n, m), device='cuda')
    torch.cholesky_solve(rhs, factor)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        torch.cholesky_solve(rhs, factor)
    graph.replay()
    torch.cuda.synchronize()


def main():
    import torch
    import desilike_tpu_torch  # noqa: F401 (its allocator setting, before CUDA starts)
    if sys.argv[1:2] == ['--capture-probe']:
        capture_probe(*(int(v) for v in sys.argv[2:5]))
        return
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--configs', nargs='+', default=list(chip_smoke.A19_CONFIGS))
    parser.add_argument('--batches', nargs='+', type=int, default=None)
    parser.add_argument('--gradient', action='store_true')
    parser.add_argument('--samplers', action='store_true')
    parser.add_argument('--settle-solves', action='store_true')
    parser.add_argument('--theta', action='store_true', help='Cosmology(theta=True) captured (jit_theta_case)')
    parser.add_argument('--capture-memory', action='store_true')
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    at_capture = []
    if args.capture_memory:
        enter = torch.cuda.graph.__enter__

        def recording_enter(graph):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            at_capture.append({'allocated_gib': torch.cuda.memory_allocated() / 2 ** 30,
                               'reserved_gib': torch.cuda.memory_reserved() / 2 ** 30})
            return enter(graph)
        torch.cuda.graph.__enter__ = recording_enter
    if not torch.cuda.is_available():
        raise SystemExit('time_jit.py needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    records, failed = [], []

    def record(entry):
        records.append(entry)
        print(json.dumps(entry), flush=True)

    if args.settle_solves:
        for entry in settle_solves(smi):
            record(entry)
    if args.theta:
        try:
            record(dict(chip_smoke.jit_theta_case(smi), case='theta', card=smi))
        except Exception:
            failed.append('theta')
            record({'case': 'theta', 'error': traceback.format_exc()})
    likes = {}
    with tempfile.TemporaryDirectory() as directory:
        for config in args.configs:
            t0 = time.perf_counter()
            try:
                likes[config] = build(config, directory)
            except Exception:
                failed.append(config)
                record({'config': config, 'case': 'build', 'error': traceback.format_exc()})
                continue
            record({'config': config, 'case': 'build', 'seconds': time.perf_counter() - t0, 'card': smi})
            batches = args.batches or chip_smoke.A19_BATCHES.get(config, (chip_smoke.BATCH,))
            for batch in batches:
                cases = [('forward', lambda: chip_smoke.jit_forward_case(
                    config, likes[config], batch, smi, no_sync=config in chip_smoke.A19_NO_SYNC))]
                if args.gradient:
                    cases.append(('gradient', lambda: chip_smoke.jit_gradient_case(config, likes[config], batch, smi)))
                for case, run in cases:
                    chip_smoke.release_state(likes[config])  # as phase A19: the last case's tensors out of the way
                    try:
                        del at_capture[:]
                        record(dict(run(), config=config, case=case, card=smi,
                                    **({'at_capture': list(at_capture)} if args.capture_memory else {})))
                    except Exception:
                        failed.append('{} {} {}'.format(config, case, batch))
                        record({'config': config, 'case': case, 'batch': batch, 'error': traceback.format_exc()})
                    torch.cuda.empty_cache()
            chip_smoke.release_state(likes[config])  # as phase A19: this config's last tensors out of the next one's way
        if args.samplers:
            from desilike_tpu_torch.samplers import ChEESSampler, NUTSSampler
            classes = {'ChEESSampler': ChEESSampler, 'NUTSSampler': NUTSSampler}
            for cls_name, config, options, run in chip_smoke.A19_SAMPLERS:
                if config not in likes:
                    continue
                label = '{} over {} chains on config {}'.format(cls_name, options['nchains'], config)
                try:
                    record(dict(chip_smoke.jit_sampler_pair(
                        label, lambda: classes[cls_name](likes[config], **options), run, smi), case=label, card=smi))
                except Exception:
                    failed.append(label)
                    record({'case': label, 'error': traceback.format_exc()})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as file:
            for entry in records:
                file.write(json.dumps(entry) + '\n')
    print(json.dumps({'failed': failed}))
    sys.exit(1 if failed else 0)


if __name__ == '__main__':
    main()
