"""Fine-tuning step for Whisper models (teacher-forced cross-entropy), the
counterpart of `whisper_diarize_tpu/training.py`.

The loss runs `encode` and `decoder_forward_nocache` (plain torch products
and `_attn`, as the JAX step runs plain XLA: no kernel, no custom backward)
under autograd, and `torch.optim.AdamW` with optax's `adamw` defaults takes
the step. Parameters are the port's dict of leaf tensors; the step updates
them in place and returns them with the optimizer.

Under a mesh (`parallel/mesh.py`) every rank passes its slice of the
parameters (`shard_params`) and its rows of the batch (`data_slice`). The
loss is the whole batch's: the masked NLL sum and the mask count are summed
over the data group before the division (ranks carry different mask
counts, so a mean of per-rank means would be wrong). The head split's
collectives are differentiable (`copy_to_model` / `reduce_from_model` /
`vocab_embed` / `gather_from_model`), so every rank's gradient of a
replicated leaf comes out whole and the same on each model rank; gradients
are then summed over the data group, which replicates every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .models import whisper as wm
from .parallel.mesh import (Mesh, data_parallel, model_parallel, param_sharding_spec,
                            reduce_data)


def _leaves(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out += _leaves(v, path)
        else:
            out.append((path, v))
    return out


def loss_fn(params: Dict[str, Any], cfg: wm.WhisperConfig, mel: torch.Tensor,
            tokens: torch.Tensor, loss_mask: torch.Tensor,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Masked mean NLL of the next token. mel [B, n_mels, 3000], tokens
    [B, S] (the whole target, sot .. eot), loss_mask [B, S - 1] (1 where the
    predicted token counts). Under `mesh` the rank's rows, and the loss of
    the whole batch on every rank."""
    xa = wm.encode(params, mel, cfg, mesh=mesh)
    logits = wm.decoder_forward_nocache(params, cfg, tokens[:, :-1], xa, mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
    mask = loss_mask.to(nll.dtype)
    total = reduce_data((nll * mask).sum(), mesh)
    count = reduce_data(mask.sum().detach(), mesh)
    return total / torch.clamp(count, min=1.0)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8, decay on every
    leaf. optax adds lr * wd * p to the update, which is torch's decoupled
    decay p * (1 - lr * wd) followed by the Adam step."""

    lr: float = 1e-4
    weight_decay: float = 0.01

    def init(self, params: Dict[str, Any]) -> torch.optim.AdamW:
        """The optimizer state of `params`, whose leaves become trainable."""
        leaves = [t.requires_grad_(True) for _, t in _leaves(params)]
        return torch.optim.AdamW(leaves, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


def make_train_step(cfg: wm.WhisperConfig, optimizer: AdamW, mesh: Optional[Mesh] = None):
    """(params, opt_state, mel, tokens, mask) -> (params, opt_state, loss):
    one AdamW step, the parameters updated in place (`opt_state` from
    `optimizer.init(params)`)."""

    def train_step(params, opt_state: torch.optim.AdamW, mel, tokens, loss_mask):
        opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(params, cfg, mel, tokens, loss_mask, mesh)
            loss.backward()
        if data_parallel(mesh):
            grads = [t.grad for _, t in _leaves(params) if t.grad is not None]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=mesh.data_group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step


def global_grad_norm(params: Dict[str, Any], mesh: Optional[Mesh] = None) -> torch.Tensor:
    """L2 norm of the whole model's gradient (after a step): the model
    group's slices of the sharded leaves summed, each replicated leaf once."""
    sharded = replicated = None
    for path, t in _leaves(params):
        if t.grad is None:
            continue
        sq = t.grad.double().pow(2).sum()
        if param_sharding_spec(path, t.ndim) is not None:
            sharded = sq if sharded is None else sharded + sq
        else:
            replicated = sq if replicated is None else replicated + sq
    zero = torch.zeros((), dtype=torch.float64)
    sharded = zero if sharded is None else sharded
    replicated = zero.to(sharded.device) if replicated is None else replicated
    if model_parallel(mesh):
        sharded = sharded.clone()
        dist.all_reduce(sharded, group=mesh.model_group)
    return torch.sqrt(sharded + replicated)
