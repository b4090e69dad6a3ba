from .sharding import (
    BATCH_AXIS,
    BatchMesh,
    gather_batch,
    make_batch_mesh,
    pad_to_multiple,
    replicate_params,
    shard_batch,
)

__all__ = [
    "BATCH_AXIS",
    "BatchMesh",
    "gather_batch",
    "make_batch_mesh",
    "pad_to_multiple",
    "replicate_params",
    "shard_batch",
]
