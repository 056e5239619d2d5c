"""The cost of a one-card NCCL chain mesh, on the card.

Builds config 4 (``chip_smoke.build_joint_likelihood``) with no device (the
card) and brings up a world of one NCCL process
(``desilike_tpu_torch.parallel.distributed.initialize``). Then times, each
over 500 calls between two synchronisations, the mesh's gather of a
(4096, 18) float32 batch, its sum of a (2, 18) tensor, and a plain mean
over the same batch; runs ChEES on config 4 at 4096 chains (phase A16's
run: 24 warm-up and 8 sampling iterations, at most 32 leapfrogs) five turns
with and five without the mesh, alternating which goes first; and last,
``torch.profiler`` over a shorter run of each (operators by host time).
Prints one JSON line with the times and the profiler's two tables.

``--root`` takes the checkout whose port is timed (default: this one), so
that two versions can be compared in one call, one process each.

Run from the repository root on a machine with one CUDA card:
``python3 scripts/time_mesh.py [--root DIR] [--label NAME]``
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, torch, ncalls=500):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ncalls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ncalls * 1e6


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--root', default=ROOT, help='checkout whose port is timed')
    parser.add_argument('--label', default='this', help='name printed with the results')
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from desilike_tpu_torch import samplers
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.parallel import distributed, make_mesh

    cuda_kernels.library()
    joint = chip_smoke.build_joint_likelihood(None)
    distributed.initialize()
    mesh = make_mesh(1)
    if mesh.group is None:
        raise AssertionError('make_mesh(1) in a world of one process gave no group')
    out = {'label': args.label, 'root': os.path.abspath(args.root),
           'card': chip_smoke.subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                                             capture_output=True, text=True).stdout.strip()}
    x = torch.randn(4096, 18, device='cuda')
    s = torch.randn(2, 18, device='cuda')
    out['gather_4096x18_us'] = per_call_us(lambda: mesh.gather(x), torch)
    out['sum_2x18_us'] = per_call_us(lambda: mesh.sum(s), torch)
    out['plain_mean_4096x18_us'] = per_call_us(lambda: x.mean(0), torch)

    def chees(key, **run):
        return samplers.ChEESSampler(joint, nchains=4096, mesh=mesh if key == 'mesh' else None, max_leapfrog=32,
                                     seed=22).run(**run)

    seconds = {'none': [], 'mesh': []}
    for turn in range(5):
        for key in (('none', 'mesh') if turn % 2 == 0 else ('mesh', 'none')):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chees(key, nsteps=8, nwarmup=24)
            torch.cuda.synchronize()
            seconds[key].append(time.perf_counter() - t0)
    out['chees_seconds'] = seconds
    out['mesh_over_none_median'] = float(np.median(seconds['mesh']) / np.median(seconds['none']))
    out['mesh_over_none_sum'] = float(sum(seconds['mesh']) / sum(seconds['none']))
    for key in ('mesh', 'none'):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chees(key, nsteps=4, nwarmup=4)
            torch.cuda.synchronize()
        out['profile_' + key] = prof.key_averages().table(sort_by='self_cpu_time_total', row_limit=18,
                                                           max_name_column_width=50)
    distributed.shutdown()
    print(json.dumps(out))


if __name__ == '__main__':
    main()
