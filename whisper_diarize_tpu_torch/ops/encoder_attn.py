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

The TPU kernel is written over the operand dtype; off a TPU the JAX tool
runs it at f32, where every rounding above is the identity and the two
forms are one function. On a CUDA tensor the wrapper launches
`csrc/encoder_attn.cu` (bf16: TMA + wgmma, each form its own schedule; f32:
one sweep for both forms, 3xTF32 wgmma on the tensor cores, held to the
f32 check against each form's plain version, `kernels.agreement.F32`;
Dh 64, q / k / v of one dtype, read through their strides, so the
encoder's head views need no copy; the output is laid out
[B, T, H, Dh] and returned as its [B, H, T, Dh] view) or raises; a mix of
dtypes raises TypeError; the plain versions run only for CPU tensors.
`encoder_self_attention.launches` counts the kernel's launches (both
dtypes), `.launches_f32` those of the f32 form.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .attn import _count, _float_dtype, qk_scaled

TWO_PASS_BLOCK = 512  # the TPU kernel's key block


def _masked_scores(qs: torch.Tensor, ks: torch.Tensor, k0: int,
                   ta_total: int) -> torch.Tensor:
    """Scores of the scaled q against keys k0 .. k0 + len(ks) - 1, in the
    compute type; keys >= ta_total at -inf."""
    s = torch.matmul(qs, ks.transpose(-1, -2))
    cols = torch.arange(k0, k0 + ks.shape[-2], device=s.device)
    return s.masked_fill(cols >= ta_total, float("-inf"))


def encoder_self_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ta_total: Optional[int] = None, single_pass: bool = True,
    rounding: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] -> [B, H, T, Dh] with each form's rounding
    points (module docstring), computed in f32 (float64 for float64
    inputs: the f32 check's reference). `rounding` replaces the input
    dtype at those points (a planted fault: the bf16 form's rounding at
    f32)."""
    T = q.shape[-2]
    ta = T if ta_total is None else int(ta_total)
    qs, ks = qk_scaled(q, rounding), qk_scaled(k, rounding)
    ct, pt = qs.dtype, rounding or v.dtype
    va = v.to(ct)
    if single_pass:
        s = _masked_scores(qs, ks, 0, ta)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(pt).to(ct)
        out = torch.matmul(p, va) / p.sum(dim=-1, keepdim=True)
        return out.to(q.dtype)
    blk = TWO_PASS_BLOCK if T >= TWO_PASS_BLOCK else T
    m = torch.full(q.shape[:-1], -1e30, dtype=ct, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=ct, device=q.device)
    acc = torch.zeros(q.shape, dtype=ct, device=q.device)
    for k0 in range(0, T, blk):
        s = _masked_scores(qs, ks[..., k0:k0 + blk, :], k0, ta)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(pt).to(ct), va[..., k0:k0 + blk, :])
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def _row_strides(name: str, *tensors: torch.Tensor):
    """The (b, h, t) element strides the kernel reads q, k, v through: one
    set for all three, last axis contiguous, rows 16-byte aligned."""
    strides = {t.stride() for t in tensors}
    if len(strides) != 1:
        raise ValueError(f"{name}: q, k, v with different strides {strides}")
    sb, sh, st, sd = strides.pop()
    per16 = 16 // tensors[0].element_size()  # elements of 16 bytes
    if sd != 1 or sb % per16 or sh % per16 or st % per16:
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
    dt = _float_dtype(name, q)
    for t in (q, k, v):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: kernel takes one dtype for q, k, v: {dt}, got {t.dtype}")
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
    entry = lib.wdt_encoder_attn_f32 if dt == torch.float32 else lib.wdt_encoder_attn
    with torch.cuda.device(dev):
        kernels.check(entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, ta,
            sb, sh, st, ob, oh, ot, int(bool(single_pass)), kernels.stream_ptr(dev),
        ), name)
    _count(encoder_self_attention, dt)
    return out


encoder_self_attention.launches = 0
encoder_self_attention.launches_f32 = 0
