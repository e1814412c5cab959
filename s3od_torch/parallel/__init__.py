"""Data parallelism and sharding (counterpart of `s3od_tpu/parallel/`):
one process per device under `torch.distributed`, DDP or FSDP2 over a
`DeviceMesh` whose axes keep the JAX names ("dcn", "data", "fsdp")."""

from s3od_torch.parallel.distributed import (
    data_axes,
    init_distributed,
    make_hybrid_mesh,
    spawn_local,
)
from s3od_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    shard_batch,
    shard_module,
    unwrap,
)

__all__ = [
    "make_mesh",
    "make_hybrid_mesh",
    "init_distributed",
    "batch_sharding",
    "data_axes",
    "shard_batch",
    "shard_module",
    "spawn_local",
    "unwrap",
]
