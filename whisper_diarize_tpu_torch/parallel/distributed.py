"""Process-group initialization and the global mesh (counterpart of
`whisper_diarize_tpu/parallel/distributed.py`).

The JAX package initializes `jax.distributed` once per host; the port runs
one process per GPU and initializes `torch.distributed`: from torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or from explicit
arguments for a cluster launched some other way. Single-process callers
never need this module (`mesh.make_mesh(1, 1)` makes its own one-rank
group).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.constants import default_pg_timeout

from .mesh import Mesh, data_slice, default_backend, make_mesh

logger = logging.getLogger(__name__)


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 60.0,
) -> bool:
    """Initialize the default process group (idempotent); True when one is
    up. With no arguments it reads torchrun's environment, and without one
    logs and stays single-process. Explicit arguments that fail raise: the
    caller configured a cluster. `backend` defaults to NCCL where CUDA is
    available, else gloo. `timeout_s` bounds the rendezvous alone, so a bad
    address fails in seconds; collectives and barriers keep PyTorch's
    default timeout (ranks wait at a barrier while rank 0 downloads or
    converts a checkpoint)."""
    if dist.is_initialized():
        return True
    explicit = init_method is not None
    if not explicit and "MASTER_ADDR" not in os.environ:
        logger.info("torch.distributed not initialized (no torchrun environment)")
        return False
    backend = backend or default_backend(_device_type())
    kw = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    try:
        store, rank, world_size = next(dist.rendezvous(
            init_method or "env://", rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size,
            timeout=datetime.timedelta(seconds=timeout_s)))
        dist.init_process_group(backend, store=store, world_size=world_size, rank=rank, **kw)
        store.set_timeout(default_pg_timeout)
    except Exception as e:
        if explicit:
            raise
        logger.info("torch.distributed not initialized: %s", e)
        return False
    logger.info("torch.distributed initialized: rank %d of %d (%s)",
                dist.get_rank(), dist.get_world_size(), backend)
    return True


def global_mesh(n_model: int = 1, device_type: Optional[str] = None) -> Mesh:
    """("data", "model") mesh over every rank of the world. Ranks
    d * n_model .. d * n_model + n_model - 1 form a model group, so under
    torchrun with a multiple of n_model processes a node the head-split
    collectives stay inside the node and only data-parallel gathers cross
    nodes."""
    return make_mesh(n_model=n_model, device_type=device_type or _device_type())


def local_batch_slice(global_batch: int, n_model: int = 1) -> slice:
    """Row range of the global batch owned by this process's data rank
    (ranks of one model group share rows): `mesh.data_slice` at this
    process's place in a (world / n_model, n_model) mesh, which refuses a
    batch the data axis does not divide."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    return data_slice(Mesh(world // n_model, n_model, rank // n_model, rank % n_model),
                      global_batch)
