"""Data parallelism of the port over every visible card
(``monorec_tpu/parallel``): ``mesh.py`` the ranks, their group and the rows
each holds; ``collectives.py`` the global batch's reductions, the gathered
metric inputs and the gradient all-reduce."""

from monorec_tpu_torch.parallel.collectives import (
    batch_mean,
    broadcast_module,
    gather_rows,
    global_sum,
    ratio_of_sums,
    reduce_gradients,
)
from monorec_tpu_torch.parallel.mesh import (
    barrier,
    batch_scope,
    broadcast_object,
    default_world_size,
    draw_rows,
    is_active,
    is_main,
    launch,
    loader_batch,
    rank,
    shard_batch,
    shard_rows,
    sharded,
    world_size,
)

__all__ = [
    "barrier", "batch_mean", "batch_scope", "broadcast_module", "broadcast_object",
    "default_world_size", "draw_rows", "gather_rows", "global_sum", "is_active", "is_main",
    "launch", "loader_batch", "rank", "ratio_of_sums", "reduce_gradients", "shard_batch",
    "shard_rows", "sharded", "world_size",
]
