"""CollectionCalculator and the batch-evaluation facade.

Counterparts of ``desilike_tpu/core/collection.py`` (reference base.py:1325,
CollectionCalculator, and base.py:232, vmap): the collection treats N
calculators as one node with namespaced states; the vmap facade batches a
pipeline function over dicts of parameter arrays with an error policy
(non-finite results masked, raised or replaced).
"""

import numpy as np
import torch

from .calculator import Calculator
from .. import config
from ..utils import tree_map


class CollectionCalculator(Calculator):
    """Treats a list of calculators as one: their states are exposed as
    '{i}_{name}'."""

    def initialize(self, calculators=None):
        self.calculators = list(calculators or [])
        self.requires = list(self.calculators)

    def calculate(self, **params):
        pass

    def __getstate__(self):
        state = {}
        for i, calc in enumerate(self.calculators):
            for name, value in calc.__getstate__().items():
                state['{}_{}'.format(i, name)] = value
        return state

    def __len__(self):
        return len(self.calculators)

    def __iter__(self):
        return iter(self.calculators)

    def __getitem__(self, i):
        return self.calculators[i]


def _tree_tensors(tree):
    out = []
    tree_map(out.append, tree)
    return out


def vmap(fn, errors='nan', backend=None, ref_values=None):
    """Batch a pipeline function over dicts of parameter arrays.

    Counterpart of the JAX package's facade (the reference's triple-backend
    vmap, base.py:232-383). The port's pipeline functions (``logpost_fn``,
    ``pipeline.evaluate``) are batched already: ``fn`` maps a dict of (B,)
    tensors to a tensor or a nest of tensors whose leading axis is the
    batch; entries without that axis are left alone. Values that are not
    tensors become (B,) CPU tensors of the compute dtype (give a likelihood
    on the card tensors on the card); ``ref_values`` go to the values'
    device. ``backend`` is accepted for the reference's signature and
    ignored.

    Error policy (under batching a failed point is a non-finite row, not a
    Python exception):

    - 'nan' (default): non-finite outputs stay for the caller to mask;
    - 'raise': raise FloatingPointError naming the failed batch indices;
    - 'ref': replace the failed rows with the output at ``ref_values``
      (the reference-state replacement policy, base.py:253).
    """
    if errors not in ('nan', 'raise', 'ref'):
        raise ValueError("errors must be 'nan', 'raise' or 'ref'")
    if errors == 'ref' and ref_values is None:
        raise ValueError("errors='ref' requires ref_values (reference parameter dict)")

    def _as_batch(value, like=None):
        if isinstance(value, torch.Tensor):
            return torch.atleast_1d(value)
        dev = like.device if like is not None else torch.device('cpu')
        return torch.atleast_1d(torch.as_tensor(np.asarray(value), dtype=config.get_dtype(), device=dev))

    def wrapper(values):
        values = {name: _as_batch(value) for name, value in values.items()}
        out = fn(values)
        if errors == 'nan':
            return out
        nbatch = max(value.shape[0] for value in values.values())
        batched = [leaf for leaf in _tree_tensors(out) if leaf.ndim and leaf.shape[0] == nbatch]
        good = torch.ones(nbatch, dtype=torch.bool, device=batched[0].device if batched else None)
        for leaf in batched:
            good = good & torch.isfinite(leaf.detach().reshape(nbatch, -1)).all(-1)
        bad = torch.nonzero(~good).reshape(-1).tolist()
        if not bad:
            return out
        if errors == 'raise':
            raise FloatingPointError('non-finite results in batched evaluation at indices {}'.format(bad))
        like = next(iter(values.values()))
        ref_out = fn({name: _as_batch(value, like=like) for name, value in ref_values.items()})
        ref_leaves = iter(_tree_tensors(ref_out))

        def replace(leaf):
            ref = next(ref_leaves)
            if not (leaf.ndim and leaf.shape[0] == nbatch):
                return leaf
            mask = good.reshape((-1,) + (1,) * (leaf.ndim - 1))
            return torch.where(mask, leaf, ref.to(leaf.dtype))

        return tree_map(replace, out)

    return wrapper
