"""Data parallelism (``parallel.distributed``)."""

from distillclip_tpu_torch.parallel.distributed import (
    active,
    all_equal,
    all_gather,
    all_reduce_gradients,
    barrier,
    env_world_size,
    gather_with_grad,
    initialize_distributed,
    is_main,
    local_rank,
    on_first_rank,
    process_device,
    rank,
    shard_kwargs,
    world_size,
)

__all__ = [
    "active",
    "all_equal",
    "all_gather",
    "all_reduce_gradients",
    "barrier",
    "env_world_size",
    "gather_with_grad",
    "initialize_distributed",
    "is_main",
    "local_rank",
    "on_first_rank",
    "process_device",
    "rank",
    "shard_kwargs",
    "world_size",
]
