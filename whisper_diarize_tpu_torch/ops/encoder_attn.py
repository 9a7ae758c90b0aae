"""K10: flash self-attention of the encoder, in the TPU kernel's two forms,
beside its plain PyTorch versions.

Counterpart of `tools/bench_encoder_attn.py::encoder_self_attention`, which
`make_encode(cfg, "flash-custom")` puts in every encoder layer in place of
the plain softmax attention. Non-causal attention over q, k, v
[B, H, T, Dh]; q and k are each scaled by Dh^-0.25 and rounded to the input
dtype; keys at or beyond `ta_total` are masked.

- single pass (the default, what "flash-custom" runs): p = exp(s - m) over
  the whole key row, rounded to the value dtype before P.V; the normalizer
  is the f32 sum of those rounded p, applied at the end;
- two pass: the online recurrence over 512-key blocks (the TPU kernel's
  block; `cdiv(T, 128) * 128` keys, i.e. the whole row, below 512): f32 p,
  running max and normalizer, p rounded to the value dtype for P.V.

On a CUDA tensor the wrapper launches `csrc/encoder_attn.cu` (bf16, Dh 64,
q / k / v read through their strides, so the encoder's head views need no
copy; the output is laid out [B, T, H, Dh] and returned as its [B, H, T, Dh]
view) or raises; the plain versions run only for CPU tensors.
`encoder_self_attention.launches` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .attn import qk_scaled

TWO_PASS_BLOCK = 512  # the TPU kernel's key block


def _masked_scores(qs: torch.Tensor, ks: torch.Tensor, k0: int,
                   ta_total: int) -> torch.Tensor:
    """f32 scores of the scaled q against keys k0 .. k0 + len(ks) - 1;
    keys >= ta_total at -inf."""
    s = torch.matmul(qs, ks.transpose(-1, -2))
    cols = torch.arange(k0, k0 + ks.shape[-2], device=s.device)
    return s.masked_fill(cols >= ta_total, float("-inf"))


def encoder_self_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ta_total: Optional[int] = None, single_pass: bool = True,
) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] -> [B, H, T, Dh] with each form's rounding
    points (module docstring)."""
    T = q.shape[-2]
    ta = T if ta_total is None else int(ta_total)
    qs, ks = qk_scaled(q), qk_scaled(k)
    if single_pass:
        s = _masked_scores(qs, ks, 0, ta)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(v.dtype)
        out = torch.matmul(p.float(), v.float()) / p.float().sum(dim=-1, keepdim=True)
        return out.to(q.dtype)
    blk = TWO_PASS_BLOCK if T >= TWO_PASS_BLOCK else T
    m = torch.full(q.shape[:-1], -1e30, device=q.device)
    l = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, T, blk):
        s = _masked_scores(qs, ks[..., k0:k0 + blk, :], k0, ta)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v[..., k0:k0 + blk, :].float())
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def _row_strides(name: str, *tensors: torch.Tensor):
    """The (b, h, t) element strides the kernel reads q, k, v through: one
    set for all three, last axis contiguous, rows 16-byte aligned."""
    strides = {t.stride() for t in tensors}
    if len(strides) != 1:
        raise ValueError(f"{name}: q, k, v with different strides {strides}")
    sb, sh, st, sd = strides.pop()
    if sd != 1 or sb % 8 or sh % 8 or st % 8:
        raise ValueError(f"{name}: kernel reads rows of 64 contiguous values at "
                         f"16-byte aligned strides, got {(sb, sh, st, sd)}")
    return sb, sh, st


def encoder_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ta_total: Optional[int] = None, single_pass: bool = True,
) -> torch.Tensor:
    """K10. Same contract as `encoder_self_attention_plain`."""
    if q.device.type == "cpu":
        return encoder_self_attention_plain(q, k, v, ta_total, single_pass)
    name = "encoder_self_attention"
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in (q, k, v):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: kernel takes torch.bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel needs 16-byte aligned tensors")
    B, H, T, Dh = q.shape
    if Dh != 64 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (kernel takes equal shapes, Dh = 64)")
    sb, sh, st = _row_strides(name, q, k, v)
    ta = T if ta_total is None else int(ta_total)
    if not 0 < ta <= T:
        raise ValueError(f"{name}: ta_total {ta} outside (0, {T}]")
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=dev).transpose(1, 2)
    ob, oh, ot, _ = out.stride()
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(lib.wdt_encoder_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, ta,
            sb, sh, st, ob, oh, ot, int(bool(single_pass)), kernels.stream_ptr(dev),
        ), name)
    encoder_self_attention.launches += 1
    return out


encoder_self_attention.launches = 0
