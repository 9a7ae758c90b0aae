"""Attention kernels of the decoder, each beside its plain PyTorch version:
K2 (cross K/V build), K1 (flash cross-attention of one layer), K5 (K1 over
the int8 cross cache) and K4 (split-cache self-attention of one layer for a
beam step); and `quantize_cross_kv`, the int8 cross cache K5 reads.

Counterpart of `whisper_diarize_tpu/ops/pallas_attn.py`. The cross cache is
`[L, B, H, Ta, Dh]` contiguous (the JAX package's plain `cross_kv` layout),
not the TPU kernel's lane-tiled `[L, B, NT, H, Dh, 512]`; the int8 cache is
the same layout in int8 with f32 scales `[L, B, H, Ta]`.

Dispatch: a wrapper runs the plain version only when its tensors lie on the
CPU. On a CUDA tensor it launches the hand-written kernel
(`csrc/cross_attn.cu` for K1 and K5, `csrc/cross_kv.cu`,
`csrc/split_self.cu`) or raises; it never falls back. Each wrapper counts
its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels


def _require_cuda(name: str, *tensors: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor of `dtype` on one device (`device`, or the first tensor's)."""
    dev = tensors[0].device if device is None else device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel needs 16-byte aligned tensors")


def qk_scaled(x: torch.Tensor) -> torch.Tensor:
    """x * Dh^-0.25 in f32, rounded to x's dtype, as f32: how the self
    attentions of the encoder (K10) and of the greedy front (K8) scale q
    and k each."""
    return (x.float() * x.shape[-1] ** -0.25).to(x.dtype).float()


# --------------------------------------------------------------------------
# K1: cross-attention of one decoder layer
# --------------------------------------------------------------------------

def cross_attn_layer_plain(
    layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ta_total: Optional[int] = None,
) -> torch.Tensor:
    """q [B, Q, H, Dh] against layer `layer` of k, v [L, B, H, Ta, Dh] ->
    [B, Q, H, Dh]; columns >= ta_total are masked. The numerics of the TPU
    kernel: q scaled by Dh^-0.5 in f32 then cast to the K/V dtype, f32
    scores and normalizer, probabilities cast to the V dtype before P.V."""
    Dh = q.shape[-1]
    ta = k.shape[3] if ta_total is None else int(ta_total)
    kl = k[layer, :, :, :ta].float()
    vl = v[layer, :, :, :ta]
    qs = (q.float() * Dh ** -0.5).to(k.dtype).float()
    s = torch.einsum("bqhd,bhtd->bhqt", qs, kl)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)  # [B, H, Q, 1]
    o = torch.einsum("bhqt,bhtd->bhqd", p.to(v.dtype).float(), vl.float())
    return (o / denom).permute(0, 2, 1, 3).to(q.dtype)


def cross_attn_layer(
    layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ta_total: Optional[int] = None,
) -> torch.Tensor:
    """K1. Same contract as `cross_attn_layer_plain`."""
    if q.device.type == "cpu":
        return cross_attn_layer_plain(layer, q, k, v, ta_total)
    _require_cuda("cross_attn_layer", q, k, v)
    B, Q, H, Dh = q.shape
    L, Bk, Hk, Ta, Dhk = k.shape
    if Dh != 64 or (Bk, Hk, Dhk) != (B, H, Dh) or v.shape != k.shape:
        raise ValueError(
            f"cross_attn_layer: q {tuple(q.shape)} vs k {tuple(k.shape)} / "
            f"v {tuple(v.shape)} (kernel takes Dh = 64)")
    ta = Ta if ta_total is None else int(ta_total)
    if not (0 <= layer < L and 0 < ta <= Ta):
        raise ValueError(f"cross_attn_layer: layer {layer} / ta_total {ta}")
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(lib.wdt_cross_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Q, H, Ta, int(layer), ta, kernels.stream_ptr(q.device),
        ), "cross_attn_layer")
    cross_attn_layer.launches += 1
    return out


cross_attn_layer.launches = 0


# --------------------------------------------------------------------------
# The int8 cross cache and K5: cross-attention of one layer over it
# --------------------------------------------------------------------------

def _quantize_rows(x: torch.Tensor, out: torch.Tensor, scale: torch.Tensor) -> None:
    """Symmetric per-row int8 over the last axis, into `out` / `scale`:
    s = max(amax|x|, 1e-8) / 127 and round(x / s) (half to even) clipped to
    +-127, in f32: the JAX package's `quantize_cross_kv` op for op."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    out.copy_(torch.round(xf / s[..., None]).clamp_(-127, 127))
    scale.copy_(s)


def quantize_cross_kv(
    k: torch.Tensor, v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross K/V [L, B, H, Ta, Dh] -> (k8, ks, v8, vs): int8 payloads of the
    same shape and f32 scales [L, B, H, Ta], one per key / value position
    (symmetric over Dh). Semantics of the JAX package's
    `models/whisper.py::quantize_cross_kv` and `ops/pallas_attn.py::
    tile_quantize_cross_kv` (without the tiling): the payloads match it bit
    for bit. Plain PyTorch on every device, as the JAX package quantizes in
    XLA outside any kernel; one layer at a time to bound the f32 temporaries."""
    out = []
    for x in (k, v):
        x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        xs = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        for l in range(x.shape[0]):
            _quantize_rows(x[l], x8[l], xs[l])
        out += [x8, xs]
    return out[0], out[1], out[2], out[3]


# the TPU kernel's key tile: its flash running max moves once per tile, and
# the bf16 rounding of p * vs falls where the max stands
Q8_KEY_TILE = 512


def cross_attn_layer_q8_plain(
    layer: int, q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
    v8: torch.Tensor, vs: torch.Tensor, ta_total: Optional[int] = None,
) -> torch.Tensor:
    """q [B, Q, H, Dh] against layer `layer` of the int8 cache k8, v8
    [L, B, H, Ta, Dh] with scales ks, vs [L, B, H, Ta] -> [B, Q, H, Dh];
    columns >= ta_total are masked. The numerics of the TPU kernel
    (`_flash_kernel_q8`), whatever the dtype of q: q scaled by Dh^-0.5 in
    f32 and rounded to bf16; score = (q . k8) * ks[t] in f32; the flash
    recurrence over Q8_KEY_TILE-key tiles, whose normalizer sums the
    unscaled probabilities p and whose P.V takes bf16(p * vs[t]) against
    the int8 values (exact in bf16); f32 accumulation divided by the
    normalizer at the end."""
    B, Q, H, Dh = q.shape
    ta = k8.shape[3] if ta_total is None else int(ta_total)
    qs = (q.float() * Dh ** -0.5).to(torch.bfloat16).float()
    m = torch.full((B, H, Q), -1e30, device=q.device)
    l = torch.zeros((B, H, Q), device=q.device)
    acc = torch.zeros((B, H, Q, Dh), device=q.device)
    for t0 in range(0, ta, Q8_KEY_TILE):
        t = slice(t0, min(t0 + Q8_KEY_TILE, ta))
        s = torch.einsum("bqhd,bhtd->bhqt", qs, k8[layer, :, :, t].float())
        s = s * ks[layer, :, :, None, t].float()
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = (p * vs[layer, :, :, None, t].float()).to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqt,bhtd->bhqd", pv, v8[layer, :, :, t].float())
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def cross_attn_layer_q8(
    layer: int, q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
    v8: torch.Tensor, vs: torch.Tensor, ta_total: Optional[int] = None,
) -> torch.Tensor:
    """K5. Same contract as `cross_attn_layer_q8_plain`."""
    if q.device.type == "cpu":
        return cross_attn_layer_q8_plain(layer, q, k8, ks, v8, vs, ta_total)
    name = "cross_attn_layer_q8"
    _require_cuda(name, q)
    _require_cuda(name, k8, v8, dtype=torch.int8, device=q.device)
    _require_cuda(name, ks, vs, dtype=torch.float32, device=q.device)
    B, Q, H, Dh = q.shape
    L, Ta = k8.shape[0], k8.shape[3]
    if (Dh != 64 or tuple(k8.shape) != (L, B, H, Ta, Dh) or v8.shape != k8.shape
            or tuple(ks.shape) != (L, B, H, Ta) or vs.shape != ks.shape):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} vs k8 {tuple(k8.shape)} / v8 "
            f"{tuple(v8.shape)}, ks {tuple(ks.shape)} / vs {tuple(vs.shape)} "
            "(kernel takes Dh = 64)")
    ta = Ta if ta_total is None else int(ta_total)
    if not (0 <= layer < L and 0 < ta <= Ta):
        raise ValueError(f"{name}: layer {layer} / ta_total {ta}")
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(lib.wdt_cross_attn_q8(
            q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
            vs.data_ptr(), out.data_ptr(), B, Q, H, Ta, int(layer), ta,
            kernels.stream_ptr(q.device),
        ), name)
    cross_attn_layer_q8.launches += 1
    return out


cross_attn_layer_q8.launches = 0


# --------------------------------------------------------------------------
# K2: cross K/V of every decoder layer, built at prefill
# --------------------------------------------------------------------------

def cross_kv_build_plain(
    xa: torch.Tensor, ck_w: torch.Tensor, cv_w: torch.Tensor,
    cv_b: torch.Tensor, n_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """xa [B, Ta, D], ck_w/cv_w [L, D, H*Dh], cv_b [L, H*Dh] ->
    (k, v) [L, B, H, Ta, Dh]: f32 products, the V bias added in f32 before
    the cast to the activation dtype."""
    L, _, HD = ck_w.shape
    B, Ta, _ = xa.shape
    Dh = HD // n_heads
    x = xa.float().unsqueeze(0)  # [1, B, Ta, D]

    def heads(y: torch.Tensor) -> torch.Tensor:  # [L, B, Ta, HD]
        y = y.view(L, B, Ta, n_heads, Dh).permute(0, 1, 3, 2, 4)
        return y.contiguous().to(xa.dtype)

    k = torch.matmul(x, ck_w.float().unsqueeze(1))
    v = torch.matmul(x, cv_w.float().unsqueeze(1)) + cv_b.float()[:, None, None, :]
    return heads(k), heads(v)


def cross_kv_build(
    xa: torch.Tensor, ck_w: torch.Tensor, cv_w: torch.Tensor,
    cv_b: torch.Tensor, n_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2. Same contract as `cross_kv_build_plain`."""
    if xa.device.type == "cpu":
        return cross_kv_build_plain(xa, ck_w, cv_w, cv_b, n_heads)
    _require_cuda("cross_kv_build", xa, ck_w, cv_w, cv_b)
    B, Ta, D = xa.shape
    L, Dw, HD = ck_w.shape
    if (Dw != D or cv_w.shape != ck_w.shape or tuple(cv_b.shape) != (L, HD)
            or D % 32 or HD % 64 or HD % n_heads):
        raise ValueError(
            f"cross_kv_build: xa {tuple(xa.shape)}, weights "
            f"{tuple(ck_w.shape)} / {tuple(cv_w.shape)} / {tuple(cv_b.shape)} "
            "(kernel takes D % 32 == 0 and H*Dh % 64 == 0)")
    Dh = HD // n_heads
    k = torch.empty((L, B, n_heads, Ta, Dh), dtype=xa.dtype, device=xa.device)
    v = torch.empty_like(k)
    lib = kernels.library()
    with torch.cuda.device(xa.device):
        kernels.check(lib.wdt_cross_kv(
            xa.data_ptr(), ck_w.data_ptr(), cv_w.data_ptr(), cv_b.data_ptr(),
            k.data_ptr(), v.data_ptr(), L, B, Ta, D, n_heads, Dh,
            kernels.stream_ptr(xa.device),
        ), "cross_kv_build")
    cross_kv_build.launches += 1
    return k, v


cross_kv_build.launches = 0


# --------------------------------------------------------------------------
# K4: split-cache self-attention of one decoder layer (beam step)
# --------------------------------------------------------------------------

def split_self_attn_layer_plain(
    layer: int, q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
    dk: torch.Tensor, dv: torch.Tensor, anc_j: torch.Tensor, step: int,
    row_pad: torch.Tensor, prompt_len: int,
) -> torch.Tensor:
    """q [B, K, H, Dh] (the step's queries, beams folded) against layer
    `layer` of the beam-shared prompt K/V pk, pv [L, B, H, Tp, Dh] and the
    per-beam decode K/V dk, dv [L, B*K, H, Td, Dh], under one softmax ->
    [B, K, H, Dh]. Beam k of stream b reads decode slot t from row
    b*K + anc_j[b, k, t]; slots > step are masked, and so are prompt slots
    < row_pad[b] or >= prompt_len. The numerics of the TPU kernel: q scaled
    by Dh^-0.5 in f32 then cast to the cache dtype, f32 scores, max and
    normalizer, probabilities cast to the V dtype before P.V, f32
    accumulation divided by the normalizer at the end."""
    B, K, H, Dh = q.shape
    Tp, Td = pk.shape[3], dk.shape[3]
    qs = (q.float() * Dh ** -0.5).to(pk.dtype).float()
    tp = torch.arange(Tp, device=q.device)
    pmask = (tp[None, :] >= row_pad.long()[:, None]) & (tp[None, :] < prompt_len)
    sp = torch.einsum("bkhd,bhtd->bkht", qs, pk[layer].float())
    sp = sp.masked_fill(~pmask[:, None, None, :], float("-inf"))
    # decode rows through the ancestry map: [B, K, H, Td, Dh]
    idx = anc_j.long()[:, :, None, :, None].expand(B, K, H, Td, Dh)
    gk = torch.gather(dk[layer].view(B, K, H, Td, Dh), 1, idx)
    gv = torch.gather(dv[layer].view(B, K, H, Td, Dh), 1, idx)
    sd = torch.einsum("bkhd,bkhtd->bkht", qs, gk.float())
    sd = sd.masked_fill(torch.arange(Td, device=q.device) > step, float("-inf"))
    s = torch.cat([sp, sd], dim=-1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)  # [B, K, H, 1]
    wp = p[..., :Tp].to(pv.dtype).float()
    wd = p[..., Tp:].to(dv.dtype).float()
    o = (torch.einsum("bkht,bhtd->bkhd", wp, pv[layer].float())
         + torch.einsum("bkht,bkhtd->bkhd", wd, gv.float()))
    return (o / denom).to(q.dtype).contiguous()


def _int32_on(name: str, device: torch.device, t: torch.Tensor) -> torch.Tensor:
    """An index tensor as the kernel's C interface takes it: int32,
    contiguous, on `device` (the port keeps indices int64: converted)."""
    if t.device != device:
        raise ValueError(f"{name}: index tensor on {t.device}, queries on {device}")
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: index tensors are int32 or int64, got {t.dtype}")
    return t.to(torch.int32).contiguous()


def split_self_attn_layer(
    layer: int, q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
    dk: torch.Tensor, dv: torch.Tensor, anc_j: torch.Tensor, step: int,
    row_pad: torch.Tensor, prompt_len: int,
) -> torch.Tensor:
    """K4. Same contract as `split_self_attn_layer_plain`."""
    if q.device.type == "cpu":
        return split_self_attn_layer_plain(
            layer, q, pk, pv, dk, dv, anc_j, step, row_pad, prompt_len)
    name = "split_self_attn_layer"
    _require_cuda(name, q, pk, pv, dk, dv)
    anc_j = _int32_on(name, q.device, anc_j)
    row_pad = _int32_on(name, q.device, row_pad)
    B, K, H, Dh = q.shape
    L, Tp, Td = pk.shape[0], pk.shape[3], dk.shape[3]
    if (Dh != 64 or tuple(pk.shape) != (L, B, H, Tp, Dh) or pv.shape != pk.shape
            or tuple(dk.shape) != (L, B * K, H, Td, Dh) or dv.shape != dk.shape
            or tuple(anc_j.shape) != (B, K, Td) or tuple(row_pad.shape) != (B,)):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pk {tuple(pk.shape)}, dk "
            f"{tuple(dk.shape)}, anc_j {tuple(anc_j.shape)}, row_pad "
            f"{tuple(row_pad.shape)} (kernel takes Dh = 64)")
    if not (0 <= layer < L and 0 <= step < Td and 0 < prompt_len <= Tp
            and K * H * Td * Dh < 2 ** 31):
        raise ValueError(f"{name}: layer {layer}, step {step}, prompt_len "
                         f"{prompt_len}, K * H * Td * Dh {K * H * Td * Dh}")
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(lib.wdt_split_self_attn(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), anc_j.data_ptr(), row_pad.data_ptr(), out.data_ptr(),
            B, K, H, Tp, Td, int(layer), int(step), int(prompt_len),
            kernels.stream_ptr(q.device),
        ), name)
    split_self_attn_layer.launches += 1
    return out


split_self_attn_layer.launches = 0
