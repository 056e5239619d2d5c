"""The process group: one process a card, over ``torch.distributed``.

Counterpart of ``desilike_tpu/parallel/distributed.py``. Every process
calls :func:`initialize` once (NCCL on the card, gloo on the CPU); then
:func:`global_mesh` spans the world, and a sampler given that mesh runs the
same program on every process, each stepping its own rows of the chain
batch (``desilike_tpu_torch.parallel.mesh``). Nothing tells a program of a
cluster, so the address, the world size and the rank are given::

    # on every process i of N (one card each):
    from desilike_tpu_torch.parallel import distributed
    distributed.initialize(coordinator_address='host0:12345', num_processes=N, process_id=i)
    mesh = distributed.global_mesh()
    chain = NUTSSampler(likelihood, nchains=4096, mesh=mesh).run(...)

With no arguments, ``initialize`` starts a world of one process on a free
local port.

In the port a sharded tensor is a rank's own rows: :func:`from_process_local`
assembles the whole batch on every rank from them, and
:func:`process_allgather` does the same into numpy.
"""

import socket

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def initialize(coordinator_address=None, num_processes=None, process_id=None, local_device_ids=None,
               backend=None, timeout=None):
    """Bring up the process group (idempotent). ``coordinator_address``
    'host:port' of rank 0, ``num_processes`` the world size, ``process_id``
    this rank; ``backend`` defaults to 'nccl' where a card is visible and
    'gloo' otherwise. With NCCL, this process drives card
    ``local_device_ids[0]`` (default: its rank modulo the visible cards).
    ``timeout`` in seconds. Returns (rank, world size)."""
    if not is_initialized():
        if backend is None:
            backend = 'nccl' if torch.cuda.is_available() else 'gloo'
        kwargs = {}
        if timeout is not None:
            import datetime
            kwargs['timeout'] = datetime.timedelta(seconds=float(timeout))
        if coordinator_address is not None:
            world, rank = int(num_processes), int(process_id)
            init_method = 'tcp://{}'.format(coordinator_address)
        else:
            world, rank = 1, 0
            init_method = 'tcp://localhost:{:d}'.format(_free_port())
        if backend == 'nccl':
            index = local_device_ids[0] if local_device_ids else rank % max(torch.cuda.device_count(), 1)
            torch.cuda.set_device(index)
            kwargs['device_id'] = torch.device('cuda', index)
        dist.init_process_group(backend=backend, init_method=init_method, world_size=world, rank=rank, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def is_initialized():
    """True once the process group is up."""
    return dist.is_available() and dist.is_initialized()


def shutdown():
    """Tear the process group down (after a last barrier)."""
    if is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def device():
    """The card this process drives under NCCL, else the CPU."""
    if is_initialized() and dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def global_mesh(axis='chains', n_devices=None):
    """One-axis mesh over the whole world (one card a process). With one
    process this is exactly ``make_mesh``."""
    return make_mesh(n_devices=n_devices, axis=axis)


def local_chain_slice(nchains, mesh=None):
    """(start, stop) of the chains this process steps, for a batch of
    ``nchains`` over ``mesh`` (default: the world)."""
    if mesh is None:
        mesh = global_mesh()
    return mesh.bounds(nchains)


def from_process_local(local_values, mesh, axis='chains'):
    """The whole batch, on every rank, from each rank's local rows (numpy or
    tensor; a tensor on the mesh's backend's device: the card under NCCL)."""
    local = torch.as_tensor(np.asarray(local_values)) if not isinstance(local_values, torch.Tensor) \
        else local_values
    if mesh.group is not None and dist.get_backend(mesh.group) == 'nccl' and local.device.type != 'cuda':
        local = local.to(device())
    return mesh.gather(local)


def process_allgather(x, mesh=None):
    """Every rank's rows of ``x`` concatenated in rank order, as numpy on
    every rank (the replacement for the reference's MPI gather of chains
    to rank 0, samplers/base.py:471-478; no special rank)."""
    if mesh is None:
        mesh = global_mesh()
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if mesh.group is not None and dist.get_backend(mesh.group) == 'nccl' and x.device.type != 'cuda':
        x = x.to(device())
    return mesh.gather(x).cpu().numpy()


def sync_global_devices(tag='desilike_tpu_torch'):
    """Barrier across the processes (replacement for mpi.barrier_idle,
    mpi.py:594); ``tag`` is kept for the JAX package's signature."""
    if is_initialized():
        dist.barrier()
