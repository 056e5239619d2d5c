"""Reckon, on the CPU, the bytes that autograd keeps for the backward of one
log-posterior call, by batch: the slope in B of the bytes of every tensor
saved for backward (``torch.autograd.graph.saved_tensors_hooks``), at two
small batches, at full width. The slope times the batch plus the forward's
own tensors is the reckoning of the card's peak with the gradient, made
before the first run there.

Run from the repository root:
``python scripts/reckon_saved_bytes.py --config 3f [3d] [3j] --batches 2 4``
(configs 3f and 3j write their files into a temporary directory first).
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def saved_bytes(fn, values):
    """Bytes of the distinct tensor storages saved for backward by one call of ``fn``."""
    storages = {}

    def pack(tensor):
        storage = tensor.untyped_storage()
        storages[storage.data_ptr()] = storage.nbytes()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
        logpost, _ = fn(values)
    logpost.sum().backward()
    return sum(storages.values())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--config', nargs='+', default=['3f'], choices=['3f', '3d', '3j'])
    parser.add_argument('--batches', nargs=2, type=int, default=[2, 4])
    args = parser.parse_args()
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        for config in args.config:
            if config == '3f':
                chip_smoke.write_files(tmp)
                like = chip_smoke.build_files_likelihood('cpu', tmp)
            elif config == '3j':
                chip_smoke.write_probe_files(tmp)
                like = chip_smoke.build_probes_likelihood('cpu', tmp)
            else:
                like = chip_smoke.build_ept_direct_likelihood('cpu')
            fn = like.logpost_fn()
            names = like.pipeline.varied_params.names()
            sizes = [saved_bytes(fn, chip_smoke.chains(names, batch, seed=0, device='cpu')) for batch in args.batches]
            slope = (sizes[1] - sizes[0]) / (args.batches[1] - args.batches[0])
            print('config {}: bytes saved for backward at B = {}: {}; {:.3f} MB a chain; at B = 4096 {:.2f} GiB, '
                  'at B = 16384 {:.2f} GiB, at B = 32768 {:.2f} GiB'.format(
                      config, args.batches, sizes, slope / 1e6,
                      *((sizes[0] + slope * (batch - args.batches[0])) / 2 ** 30 for batch in (4096, 16384, 32768))))


if __name__ == '__main__':
    main()
