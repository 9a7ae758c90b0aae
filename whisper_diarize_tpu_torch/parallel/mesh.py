"""Device meshes, sharding rules and the Megatron collectives of the port
(counterpart of `whisper_diarize_tpu/parallel/mesh.py`).

The JAX package lays its parameters out with NamedShardings over a
("data", "model") mesh of one process's chips and lets GSPMD insert the
collectives. The port runs one process per GPU (`torchrun`), each process
one rank of a ("data", "model") `DeviceMesh` over `torch.distributed`
(NCCL on CUDA, gloo on the CPU). Every rank runs the same program:

* "data": each data rank computes its own slice of the batch rows
  (`data_slice`); results are all-gathered over the data group;
* "model": each model rank holds a head slice of every layer (`shard_params`,
  the same rules as the JAX package: q/k/v, cq/ck/cv and fc1
  column-parallel, o, co and fc2 row-parallel, the vocab rows of `tok_emb`),
  and the collectives are written out: an all-reduce after each row-parallel
  product (`reduce_from_model`), its mirror before each column-parallel one
  (`copy_to_model`, identity forward, all-reduce backward), the vocab-parallel
  embedding lookup (`vocab_embed`) and the all-gather of vocab-sharded logits
  (`gather_from_model`). Each is a `torch.autograd.Function`, so the training
  step differentiates through them; the gradient of a replicated leaf then
  comes out whole and identical on every model rank.

A dimension that the model axis does not divide is refused (ValueError), as
the JAX `device_put` refuses it; so are batch rows the data axis does not
divide.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ("data", "model") mesh: its coordinates, the
    process groups of its data column and of its model row, and the device
    its tensors live on. Global rank = data_rank * n_model + model_rank, so
    a model group is n_model consecutive ranks (inside one node under
    torchrun). Groups are None where the axis has one rank."""

    n_data: int
    n_model: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    device: torch.device = torch.device("cpu")
    device_mesh: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def rank(self) -> int:
        return self.data_rank * self.n_model + self.model_rank


def model_parallel(mesh: Optional[Mesh]) -> bool:
    """True where the rank holds a head slice (n_model > 1)."""
    return mesh is not None and mesh.n_model > 1


def data_parallel(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.n_data > 1


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cuda", device: Optional[torch.device] = None) -> Mesh:
    """The ("data", "model") mesh over the initialized world, which must hold
    exactly n_data * n_model ranks (`n_data` None: the world's ranks over
    `n_model`). Without a process group a 1 x 1 mesh makes its one-rank group
    itself (NCCL for CUDA, gloo for the CPU), as one JAX host needs no
    initialization; a larger one raises. `device` defaults to the current
    CUDA device for "cuda", else the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh {n_data}x{n_model}: both axes need at least one rank")
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise ValueError(
                f"mesh {n_data}x{n_model} needs an initialized process group of "
                f"{(n_data or 1) * n_model} ranks: run under torchrun or call "
                "parallel.distributed.initialize first")
        kw = {}
        if device_type == "cuda":
            kw["device_id"] = device or torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(default_backend(device_type),
                                store=dist.HashStore(), world_size=1, rank=0, **kw)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks in the process group")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
                  else torch.device("cpu"))
    dm = init_device_mesh(device_type, (n_data, n_model),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    rank = dist.get_rank()
    return Mesh(n_data=n_data, n_model=n_model, data_rank=rank // n_model,
                model_rank=rank % n_model,
                data_group=dm.get_group(DATA_AXIS) if n_data > 1 else None,
                model_group=dm.get_group(MODEL_AXIS) if n_model > 1 else None,
                device=device, device_mesh=dm)


# --------------------------------------------------------------------------
# Sharding rules (keyed by the stacked-weight leaf name; encoder and
# decoder share names). The result is the dimension split over "model".
# --------------------------------------------------------------------------

_COL_PARALLEL = {"q_w", "k_w", "v_w", "cq_w", "ck_w", "cv_w", "fc1_w"}
_ROW_PARALLEL = {"o_w", "co_w", "fc2_w"}
_COL_BIAS = {"q_b", "v_b", "cq_b", "cv_b", "fc1_b"}


def param_sharding_spec(path: str, ndim: int) -> Optional[int]:
    """The dimension of one parameter that the model axis splits, by its
    tree path's leaf name, or None (replicated)."""
    leaf = path.split(".")[-1]
    if leaf in _COL_PARALLEL and ndim == 3:  # [L, in, out]
        return 2
    if leaf in _ROW_PARALLEL and ndim == 3:  # [L, in, out]
        return 1
    if leaf in _COL_BIAS and ndim == 2:  # [L, out]
        return 1
    if leaf == "tok_emb":  # [V, d]: vocab rows, for the logits product
        return 0
    return None


def check_model_split(cfg, n_model: int) -> None:
    """Refuse a model axis the configuration cannot be split over: heads
    and vocab rows must divide evenly. Any local head count runs: K2 covers
    an odd one with its 64-column edge tile, and K1, K4 and K5 run a head
    at a time."""
    if n_model <= 1:
        return

    def divides(what, n):
        if n % n_model:
            raise ValueError(f"{what} {n} are not divisible by the mesh model axis {n_model}")

    divides("encoder heads", cfg.n_audio_head)
    divides("decoder heads", cfg.n_text_head)
    divides("vocab rows", cfg.n_vocab)


def _split(path: str, leaf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dim = param_sharding_spec(path, leaf.ndim)
    if dim is None or mesh.n_model == 1:
        return leaf
    size = leaf.shape[dim]
    if size % mesh.n_model:
        raise ValueError(f"{path}: dimension {dim} of {tuple(leaf.shape)} is not divisible "
                         f"by the mesh model axis {mesh.n_model}")
    part = size // mesh.n_model
    return leaf.narrow(dim, mesh.model_rank * part, part).clone()


def shard_params(params: Dict[str, Any], mesh: Mesh, prefix: str = "") -> Dict[str, Any]:
    """This rank's slice of every leaf of a whisper parameter tree (the
    replicated leaves as they are)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out[k] = shard_params(v, mesh, path)
        elif isinstance(v, torch.Tensor):
            out[k] = _split(path, v, mesh)
        else:
            out[k] = v
    return out


def data_slice(mesh: Optional[Mesh], batch: int) -> slice:
    """This rank's rows of a batch of `batch` rows; rows the data axis does
    not divide are refused."""
    if mesh is None or mesh.n_data == 1:
        return slice(0, batch)
    if batch % mesh.n_data:
        raise ValueError(f"batch of {batch} rows is not divisible by the mesh "
                         f"data axis {mesh.n_data}")
    per = batch // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def replicate(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x made the same on every rank: global rank 0's copy, broadcast in
    place."""
    if mesh is not None and mesh.n_data * mesh.n_model > 1:
        _collective(dist.broadcast, x, 0)
    return x


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

# This process's collectives while `timed_collectives` is on (else None),
# and the device it synchronizes.
_clock: Optional[Dict[str, float]] = None
_clock_device = torch.device("cpu")


@contextlib.contextmanager
def timed_collectives(device: torch.device):
    """Count and time this process's collectives inside the block. Yields
    {"calls", "seconds", "device_wait_s"}, filled as the block runs: before
    each collective the device is synchronized (`device_wait_s`: the queued
    work a collective over CUDA tensors waits for anyway), then the
    collective is timed on the wall clock to its end on the device
    (`seconds`: copies, the exchange and the wait for the peer ranks)."""
    global _clock, _clock_device
    prev = _clock, _clock_device
    _clock, _clock_device = {"calls": 0, "seconds": 0.0, "device_wait_s": 0.0}, device
    try:
        yield _clock
    finally:
        _clock, _clock_device = prev


def _sync() -> None:
    if _clock_device.type == "cuda":
        torch.cuda.synchronize(_clock_device)


def _collective(op, *a, **k) -> None:
    if _clock is None:
        op(*a, **k)
        return
    t0 = time.perf_counter()
    _sync()
    t1 = time.perf_counter()
    op(*a, **k)
    _sync()
    _clock["calls"] += 1
    _clock["device_wait_s"] += t1 - t0
    _clock["seconds"] += time.perf_counter() - t1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` into a new tensor; half-precision partials are summed
    in f32 and rounded once."""
    wide = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    y = x.to(wide, copy=True).contiguous()
    _collective(dist.all_reduce, y, group=group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim`, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _collective(dist.all_gather, parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.part, ctx.rank = x.shape[-1], rank
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.part, ctx.part).contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Before a column-parallel product: identity forward, the gradient
    all-reduced over the model group."""
    return _CopyToModel.apply(x, mesh.model_group) if model_parallel(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """After a row-parallel product: the partial sums all-reduced over the
    model group (gradient passed through)."""
    return _Reduce.apply(x, mesh.model_group) if model_parallel(mesh) else x


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Vocab-sharded logits [..., V / M] -> [..., V] on every model rank
    (gradient: this rank's columns)."""
    if not model_parallel(mesh):
        return x
    return _GatherFromModel.apply(x, mesh.model_group, mesh.model_rank)


def vocab_embed(tok_emb: torch.Tensor, tokens: torch.Tensor,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """Rows of a vocab-sharded embedding: each model rank looks up the
    tokens in its rows (zeros elsewhere) and the model group sums them,
    which is exact (one rank holds each row)."""
    if not model_parallel(mesh):
        return tok_emb[tokens]
    part = tok_emb.shape[0]
    local = tokens - mesh.model_rank * part
    mine = (local >= 0) & (local < part)
    rows = tok_emb[local.clamp(0, part - 1)] * mine[..., None].to(tok_emb.dtype)
    return reduce_from_model(rows, mesh)


def gather_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every data rank's rows of `x`, concatenated in rank order (the whole
    batch on every rank)."""
    if not data_parallel(mesh):
        return x
    return all_gather(x, mesh.data_group, dim=0)


def reduce_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the data group (gradient passed through: each data rank
    differentiates its own rows' share)."""
    return _Reduce.apply(x, mesh.data_group) if data_parallel(mesh) else x
