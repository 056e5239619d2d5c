"""Where a log-posterior call spends its time on one CUDA card.

Builds config 1 or config 4 of ``chip_smoke.py`` on the card and, for the
forward call and for the call with its gradient, at each batch of seeded
chains:

- times the call on the host's clock (10 calls ending in a synchronise);
- runs ``torch.profiler`` over 5 calls and reports, a call: the CUDA kernels
  launched, the device-busy time (the sum of the kernels' durations), the
  share of the wall time the card is idle, and the kernels that take the
  most device time, by name.

Prints one JSON line per (mode, batch), each with the card's name and power
limit, and writes them to ``--out`` if given.

    python3 scripts/profile_logpost.py [--config 1|4] [--batches 4096 32768] [--out FILE]
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--config', type=int, choices=(1, 4), default=4)
    parser.add_argument('--batches', type=int, nargs='+', default=[4096, 32768])
    parser.add_argument('--out', default=None, help='file the JSON lines are also written to')
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('needs a CUDA device: torch.cuda.is_available() is False')
    from torch.profiler import profile, ProfilerActivity
    import chip_smoke
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    like = (chip_smoke.build_likelihood if args.config == 1 else chip_smoke.build_joint_likelihood)(None)
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
            calls = 5
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            kernels = collections.Counter()
            busy_us = collections.Counter()
            for event in prof.events():
                if event.device_type == torch.autograd.DeviceType.CUDA:
                    kernels[event.name] += 1
                    busy_us[event.name] += event.device_time if hasattr(event, 'device_time') else event.cuda_time
            device_ms = sum(busy_us.values()) / calls * 1e-3
            line = {'config': args.config, 'mode': mode, 'batch': batch, 'card': smi, 'wall_ms': wall_ms,
                    'evals_per_s': batch / wall_ms * 1e3, 'kernels_a_call': sum(kernels.values()) / calls,
                    'device_busy_ms': device_ms, 'idle_share': 1. - device_ms / wall_ms,
                    'top': [{'name': name[:80], 'launches_a_call': kernels[name] / calls,
                             'device_ms_a_call': us / calls * 1e-3} for name, us in busy_us.most_common(12)]}
            lines.append(json.dumps(line))
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as file:
            file.write('\n'.join(lines) + '\n')


if __name__ == '__main__':
    main()
