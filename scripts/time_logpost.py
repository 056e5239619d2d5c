"""Log-posterior evaluations per second of config 1 on one CUDA card.

Builds the config-1 likelihood of the checkout at ``--root`` (its
``chip_smoke.build_likelihood``, on the card) and times the batched forward
log-posterior with CUDA events around 20 calls, five times after warm-up,
at each batch of seeded chains, and reports each run and their median.
Pointing ``--root`` at an unpacked copy of another commit times that commit
the same way, so that two versions can be compared in turns within one
session on one card. Prints one JSON line.

    python3 scripts/time_logpost.py [--root DIR] [--batches 4096 65536]
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--root', default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help='checkout whose desilike_tpu_torch and chip_smoke.py are timed')
    parser.add_argument('--batches', type=int, nargs='+', default=[4096, 65536])
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('needs a CUDA device: torch.cuda.is_available() is False')
    import chip_smoke
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    like = chip_smoke.build_likelihood('cuda')
    fn = like.logpost_fn()
    names = like.pipeline.varied_params.names()
    result = {'root': root, 'card': smi, 'runs_ms': {}, 'ms': {}, 'evals_per_s': {}}
    for batch in args.batches:
        values = chip_smoke.chains(names, batch, seed=1, device=torch.device('cuda'))
        with torch.no_grad():
            runs = [chip_smoke.time_cuda(lambda: fn(values), 20, warmup=10 if run == 0 else 0) for run in range(5)]
        result['runs_ms'][batch] = runs
        result['ms'][batch] = sorted(runs)[2]
        result['evals_per_s'][batch] = batch / result['ms'][batch] * 1e3
    print(json.dumps(result))


if __name__ == '__main__':
    main()
