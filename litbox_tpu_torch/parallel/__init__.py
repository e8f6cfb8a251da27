"""Scaling over ranks on torch.distributed (counterpart of the JAX
package's parallel/): the data-parallel oracle and RBT (sharded.py,
rbt_sharded.py), the bin-sharded RBT (rbt_bins.py) and the sharded
denoiser training step (train_sharded.py). `world` starts the ranks (the
counterpart of JAX's SPMD launch) and builds the meshes; every rank calls
these functions with its own local block."""

from .rbt_bins import (
    BinShardedFields,
    bins_resolve,
    bins_trace_frame,
    make_bins_mesh,
    shard_fields_bins,
    zero_sources_bins,
)
from .rbt_sharded import (
    sharded_rbt_resolve,
    sharded_rbt_resolve_bins,
    sharded_rbt_trace_frame,
    zero_sources_sharded,
)
from .sharded import make_mesh, sharded_trace_frame

__all__ = [
    "make_mesh",
    "sharded_trace_frame",
    "sharded_rbt_trace_frame",
    "sharded_rbt_resolve",
    "sharded_rbt_resolve_bins",
    "zero_sources_sharded",
    "BinShardedFields",
    "make_bins_mesh",
    "shard_fields_bins",
    "zero_sources_bins",
    "bins_trace_frame",
    "bins_resolve",
]
