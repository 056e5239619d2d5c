"""The chain mesh: chains laid out over processes, one card each.

Counterpart of ``desilike_tpu/parallel/mesh.py``. Where the JAX package
shards a batch over a one-axis device mesh and lets XLA insert the
collectives, the port runs one process a card (PyTorch's own idiom): a
:class:`Mesh` holds the ``torch.distributed`` group, this process's rank in
it and the axis name; a sharded batch is the rank's own rows; cross-chain
statistics are ``all_reduce`` sums or ``all_gather``\\ s over the group.
Without an initialized process group a mesh is this process alone and every
collective is the identity.

Determinism (SURVEY.md §2.11): a sampler draws the whole batch's random
numbers on every rank and keeps its rows, and reduces across chains on the
gathered batch, so a mesh of one gives the same chains as no mesh, bit for
bit, and a fixed (seed, world) gives the same chains again.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..utils import tree_map


class Mesh(object):
    """A one-axis mesh of ``size`` processes; this one is ``rank``.

    ``group`` is the ``torch.distributed`` process group of the mesh, or
    None for a mesh of this process alone (no communication)."""

    def __init__(self, size=1, rank=0, axis='chains', group=None):
        self.size = int(size)
        self.rank = int(rank)
        self.axis = axis
        self.group = group

    @property
    def axis_names(self):
        return (self.axis,)

    def __repr__(self):
        return 'Mesh({}={}, rank={}, {})'.format(self.axis, self.size, self.rank,
                                                 'local' if self.group is None else dist.get_backend(self.group))

    def bounds(self, n):
        """(lo, hi) of this rank's rows of a batch of ``n``; raises where the
        batch does not divide over the mesh."""
        if n % self.size:
            raise ValueError('chain batch size {} is not divisible by mesh size {}'.format(n, self.size))
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def shard(self, value, dim=0):
        """This rank's rows of a tensor, or of every tensor of a nest of
        dicts, lists and tuples, along ``dim``."""
        def one(tensor):
            lo, hi = self.bounds(tensor.shape[dim])
            return tensor.narrow(dim, lo, hi - lo)
        return tree_map(one, value)

    def gather(self, value, dim=0):
        """Every rank's rows, in rank order, along ``dim``: a tensor, or every
        tensor of a nest (each the same shape on every rank)."""
        if self.group is None:
            return value

        def one(tensor):
            moved = tensor.dtype == torch.bool
            local = (tensor.to(torch.uint8) if moved else tensor).contiguous()
            parts = [torch.empty_like(local) for _ in range(self.size)]
            dist.all_gather(parts, local, group=self.group)
            out = torch.cat(parts, dim=dim)
            return out.to(torch.bool) if moved else out
        return tree_map(one, value)

    def sum(self, tensor):
        """The sum of ``tensor`` over the ranks, on every rank."""
        if self.group is None:
            return tensor
        out = tensor.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out


def make_mesh(n_devices=None, axis='chains', devices=None):
    """One-axis mesh over the processes of the default group (one card each).

    ``n_devices=None`` spans the world and 1 is this process alone; another
    count raises ValueError (a mesh spans the world or one process; the
    JAX package's first ``n_devices`` devices of one process have no
    counterpart where a process drives one card). ``devices`` is accepted
    for the JAX package's signature and ignored."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    n_devices = int(n_devices)
    if n_devices > world:
        raise ValueError('requested a {}-device mesh but only {} processes are in the world '
                         '(one card each; start them with distributed.initialize)'.format(n_devices, world))
    if n_devices == world and dist.is_available() and dist.is_initialized():
        return Mesh(world, dist.get_rank(), axis=axis, group=dist.group.WORLD)
    if n_devices == 1:
        return Mesh(1, 0, axis=axis)
    raise ValueError('a mesh spans the whole world ({} processes) or one process, not {}'.format(world, n_devices))


def shard_batch(values, mesh, axis='chains'):
    """This rank's rows of a batch (a tensor or a nest of them, leading axis
    the batch)."""
    return mesh.shard(values)


def sharded_vmap_fn(fn, mesh, axis='chains'):
    """``fn`` (a batched function: dict of (B,) tensors -> (logpost, aux),
    the port's ``logpost_fn``) evaluated on this rank's rows of the batch;
    returns the whole batch's outputs, gathered from every rank. Outputs
    without the batch axis are returned as this rank computed them."""
    def wrapper(values):
        local = mesh.shard(values)
        nlocal = next(iter(local.values())).shape[0]
        out = fn(local)
        return tree_map(lambda t: mesh.gather(t) if t.ndim and t.shape[0] == nlocal else t, out)
    return wrapper


def fold_keys(key, n, mesh=None):
    """``n`` per-chain seeds (int64 tensor) from one root seed, each a
    SplitMix64 hash of (key, chain index): the same for a chain however the
    chains are laid out over the mesh."""
    with np.errstate(over='ignore'):
        z = np.uint64(int(key) & 0xFFFFFFFFFFFFFFFF) * np.uint64(0x9E3779B97F4A7C15) \
            + (np.arange(n, dtype=np.uint64) + np.uint64(1)) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return torch.as_tensor((z >> np.uint64(1)).astype(np.int64))


def chain_gelman_rubin(x, mesh=None):
    """Split-R statistic of chain positions x (nsteps, nchains, ndim), in
    float64. With a mesh, x is this rank's chains and the cross-chain means
    and variances are built from ``all_reduce`` sums, so no chain leaves its
    card; without one it is the host formula (the JAX package's
    ``chain_gelman_rubin``)."""
    x = x.double()
    nsteps, nlocal = x.shape[0], x.shape[1]
    if mesh is None:
        within = x.var(0, unbiased=True).mean(0)
        between = nsteps * x.mean(0).var(0, unbiased=True)
    else:
        nchains = nlocal * mesh.size
        means = x.mean(0)                                   # (nlocal, ndim)
        sums = mesh.sum(torch.stack([x.var(0, unbiased=True).sum(0), means.sum(0)]))
        within, grand = sums[0] / nchains, sums[1] / nchains
        between = nsteps * mesh.sum(((means - grand) ** 2).sum(0)) / (nchains - 1)
    var = (nsteps - 1.) / nsteps * within + between / nsteps
    return torch.sqrt(var / within)
