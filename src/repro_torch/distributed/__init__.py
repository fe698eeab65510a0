"""repro_torch.distributed: mesh-layout rules for params, optimizer, batch and
caches (sharding.py) and the named-axis collectives of the mesh path with
the mesh context (collectives.py). Neither imports the models: the models
import them."""
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    batch_layout,
    batch_specs,
    cache_specs,
    make_mesh_ctx,
    param_specs,
    router_state_specs,
    shard_tree,
    train_state_specs,
    unshard_tree,
)

__all__ = [
    "batch_layout",
    "batch_specs",
    "cache_specs",
    "collectives",
    "make_mesh_ctx",
    "param_specs",
    "router_state_specs",
    "shard_tree",
    "train_state_specs",
    "unshard_tree",
]
