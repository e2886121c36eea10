from speechflow_torch.parallel.distributed import (
    backend,
    broadcast_bytes,
    global_batch,
    init_distributed,
    is_distributed,
    process_count,
    process_index,
    shutdown_distributed,
)
from speechflow_torch.parallel.mesh import data_sharding, make_mesh, replicate_state, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate_state", "data_sharding",
           "init_distributed", "is_distributed", "global_batch", "broadcast_bytes",
           "process_index", "process_count", "backend", "shutdown_distributed"]
