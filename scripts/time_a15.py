"""Phase A15 of ``chip_smoke.py`` on its own, after a Metropolis run timed
step by step, on the card.

Builds config 1, config 3d and config 3j (its probe files written into a
temporary directory) with no device (the card). Then, on config 3d at 4096
chains, twice (the first use of the likelihood in the process, then
warm): ``MCMCSampler.get_start``, the start's aux call, each of 24 steps (16
adapting) and one forward call, each between two synchronisations, and a
whole ``run`` of the same length; ``torch.profiler`` over three adaptation
steps (operators by host time, with their device time and calls). Last,
``chip_smoke.run_a15`` as phase A15 runs it. Prints one JSON line a
measurement (and the profiler's table); ``--out`` also writes the JSON
lines to a file.

Run from the repository root on a machine with one CUDA card:
``python3 scripts/time_a15.py --out chiprun_out/time_a15.jsonl``
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synced(fn):
    """(fn(), seconds) between two synchronisations of the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def metropolis_breakdown(direct, nchains=4096, nsteps=24, nadapt=16, seed=11):
    """One Metropolis run of ``direct`` taken apart: start, aux, each step,
    a forward call; then a whole run. Returns the numbers."""
    import torch
    from desilike_tpu_torch.samplers import MCMCSampler
    sampler = MCMCSampler(direct, nchains=nchains, seed=seed)
    (start, lp0), start_s = synced(lambda: sampler.get_start(nchains))
    (_, aux0), aux_s = synced(lambda: sampler.logpost_batch(start))
    zero = torch.zeros((), device=sampler.device)
    ndim = sampler.ndim
    state = (start, lp0, aux0, zero, torch.as_tensor(sampler._chol, dtype=torch.float32, device=sampler.device),
             torch.zeros(ndim, device=sampler.device), torch.zeros((ndim, ndim), device=sampler.device), zero, zero)
    step = sampler._build_step(nadapt)
    steps_ms = []
    with torch.no_grad():
        for i in range(nsteps):
            (state, _), seconds = synced(lambda: step(state, sampler.normal(nchains, ndim), sampler.uniform(nchains),
                                                      i < nadapt))
            steps_ms.append(1e3 * seconds)
        _, forward_s = synced(lambda: sampler.logpost_batch(state[0]))
    _, run_s = synced(lambda: MCMCSampler(direct, nchains=nchains, seed=seed + 100).run(nsteps=nsteps, nadapt=nadapt))
    return dict(get_start_s=start_s, aux_s=aux_s, step_ms=steps_ms, forward_ms=1e3 * forward_s, run_s=run_s,
                run_iterations_per_s=nsteps / run_s), (sampler, step, state)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=None, help='also write the JSON lines to this file')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('time_a15.py needs a CUDA device')
    sys.path.insert(0, ROOT)
    import chip_smoke
    from desilike_tpu_torch import config
    from desilike_tpu_torch.ops import cuda_kernels
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lines = []

    def emit(record):
        record = dict(record, card=smi)
        lines.append(json.dumps(record))
        print(lines[-1], flush=True)

    cuda_kernels.library()
    like = chip_smoke.build_likelihood(None)
    direct = chip_smoke.build_ept_direct_likelihood(None)
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_probe_files(tmp)
        probes = chip_smoke.build_probes_likelihood(None, tmp)
    for rep in ('first use', 'warm'):
        numbers, (sampler, step, state) = metropolis_breakdown(direct, seed=11 if rep == 'first use' else 12)
        emit(dict(measurement='metropolis breakdown, config 3d, 4096 chains', rep=rep, **numbers))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.no_grad():
            for _ in range(3):
                state, _ = step(state, sampler.normal(4096, sampler.ndim), sampler.uniform(4096), True)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by='cpu_time_total', row_limit=25))
    syncs = [event.count for event in prof.key_averages() if event.key == 'cudaStreamSynchronize']
    emit(dict(measurement='torch.profiler over 3 Metropolis adaptation steps', cuda_stream_synchronize=syncs))
    emit(dict(measurement='phase A15', a15=chip_smoke.run_a15(like, direct, probes, smi, config.device('cuda'))))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as file:
            file.write('\n'.join(lines) + '\n')


if __name__ == '__main__':
    main()
