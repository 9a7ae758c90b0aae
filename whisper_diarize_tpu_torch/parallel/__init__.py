"""Parallelism of the port: chunk batching, and ("data", "model") meshes
over torch.distributed, one process per GPU (`mesh.py`, `distributed.py`,
`dryrun.py`)."""

from .batching import ChunkWindow, iter_batches, plan_windows
from .mesh import (
    Mesh,
    data_slice,
    make_mesh,
    param_sharding_spec,
    replicate,
    shard_params,
)
