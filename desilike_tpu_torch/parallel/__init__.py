from .mesh import Mesh, make_mesh, shard_batch, sharded_vmap_fn, fold_keys, chain_gelman_rubin
from . import distributed
