"""Attention kernels of the decoder, each beside its plain PyTorch version:
K2 (cross K/V build), K1 (flash cross-attention of one layer), K5 (K1 over
the int8 cross cache) and K4 (split-cache self-attention of one layer for a
beam step); and `quantize_cross_kv`, the int8 cross cache K5 reads.

Counterpart of `whisper_diarize_tpu/ops/pallas_attn.py`. The cross cache is
`[L, B, H, Ta, Dh]` contiguous (the JAX package's plain `cross_kv` layout),
not the TPU kernel's lane-tiled `[L, B, NT, H, Dh, 512]`; the int8 cache is
the same layout in int8 with f32 scales `[L, B, H, Ta]`.

K1 and K5 split a layer's keys across the CTAs of a thread-block cluster;
`cross_attn_plan` picks the split from the shape and the wrappers (and the
fused tail, `ops/tail.py`) pass it to the kernel. `cross_attn_split_plain`
is the kernels' order of rounding in plain PyTorch, the tests' model of the
split.

Dispatch: a wrapper runs the plain version only when its tensors lie on the
CPU. On a CUDA tensor it launches the hand-written kernel
(`csrc/cross_attn.cu` for K1 and K5, `csrc/cross_kv.cu`,
`csrc/split_self.cu`) or raises; it never falls back. Each wrapper counts
its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

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
# K1 / K5's launch plan: the key split inside a thread-block cluster
# --------------------------------------------------------------------------

CLUSTER_MAX = 8  # CTAs a cluster: the portable limit
KEYS_PER_TILE = 64  # K1 / K5's shared-memory tile (csrc/cross_attn.cu)
QUERY_CHUNK = 16  # queries a CTA at Q <= 16 (warps split the keys of a tile)
ROW_CHUNK = 64  # queries a CTA at Q > 16 (each warp 16 of them, all keys)
# CTAs a launch aims at, bf16 / int8 cache: the fewest that keep enough
# bytes in flight. Each span costs a share of the cluster's combine, so at
# B 8 two spans (320 CTAs) beat eight (1,280) for K1 and three for K5,
# whose int8 tiles hold half the bytes; at B 1 every shape wants the full
# cluster (`tools/bench_attn_kernel.py --plans` measures each split)
CTA_TARGET = 320
CTA_TARGET_INT8 = 480


class CrossAttnPlan(NamedTuple):
    n_span: int  # CTAs of a cluster, one key span each
    span_keys: int  # keys a span (a multiple of KEYS_PER_TILE)


def cross_attn_plan(B: int, H: int, Q: int, ta_total: int,
                    int8: bool = False) -> CrossAttnPlan:
    """How K1 / K5 split one layer's keys: one cluster of `n_span` CTAs per
    (b, h, chunk of QUERY_CHUNK queries, ROW_CHUNK where Q > QUERY_CHUNK),
    CTA r over keys [r * span_keys,
    (r + 1) * span_keys) of [0, ta_total). As many spans as bring the grid
    near CTA_TARGET CTAs (CTA_TARGET_INT8 over the int8 cache, `int8`), at
    most CLUSTER_MAX and one 64-key tile each; the tiles are then dealt
    evenly, so every span holds an unmasked key. A pure function of the
    shape: the wrappers and the fused tail pass it to the kernel, which
    refuses a plan that does not cover the keys."""
    if min(B, H, Q, ta_total) <= 0:
        raise ValueError(f"cross_attn_plan: B {B}, H {H}, Q {Q}, ta_total {ta_total}")
    tiles = -(-ta_total // KEYS_PER_TILE)
    ctas = B * H * -(-Q // (QUERY_CHUNK if Q <= QUERY_CHUNK else ROW_CHUNK))
    target = CTA_TARGET_INT8 if int8 else CTA_TARGET
    n = max(1, min(CLUSTER_MAX, tiles, -(-target // ctas)))
    per = -(-tiles // n)
    return CrossAttnPlan(-(-tiles // per), per * KEYS_PER_TILE)


def split_plans(ta_total: int) -> List[CrossAttnPlan]:
    """Every key split the kernels take at `ta_total` keys, one for each
    number of spans up to CLUSTER_MAX (tiles dealt evenly, as
    `cross_attn_plan` deals them): what `tools/bench_attn_kernel.py --plans`
    times."""
    tiles = -(-ta_total // KEYS_PER_TILE)
    out = []
    for n in range(1, min(CLUSTER_MAX, tiles) + 1):
        per = -(-tiles // n)
        plan = CrossAttnPlan(-(-tiles // per), per * KEYS_PER_TILE)
        if plan not in out:
            out.append(plan)
    return out


def _flash_tiles(qs: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor,
                 ksl: Optional[torch.Tensor], vsl: Optional[torch.Tensor],
                 t0: int, t1: int, tile: int):
    """The flash recurrence over keys [t0, t1) in `tile`-key steps: f32
    scores (times ksl, the int8 cache's key scales), the running max moving
    once a step, the normalizer summing the unrounded p, and P.V on
    bf16(p) (bf16(p * vsl) over the int8 cache). qs [B, Q, H, Dh] f32,
    kl / vl [B, H, Ta, Dh], ksl / vsl [B, H, Ta] or None. Returns the
    unnormalized state (acc [B, H, Q, Dh], m [B, H, Q], l [B, H, Q])."""
    B, Q, H, Dh = qs.shape
    m = torch.full((B, H, Q), -1e30, device=qs.device)
    l = torch.zeros((B, H, Q), device=qs.device)
    acc = torch.zeros((B, H, Q, Dh), device=qs.device)
    for a in range(t0, t1, tile):
        t = slice(a, min(a + tile, t1))
        s = torch.einsum("bqhd,bhtd->bhqt", qs, kl[:, :, t].float())
        if ksl is not None:
            s = s * ksl[:, :, None, t].float()
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if vsl is not None:
            p = p * vsl[:, :, None, t].float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqt,bhtd->bhqd", p.to(torch.bfloat16).float(), vl[:, :, t].float())
        m = m_new
    return acc, m, l


def cross_attn_span_states(
    layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ta_total: Optional[int] = None, plan: Optional[CrossAttnPlan] = None,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The plain model of K1's (with ks, vs: K5's) key split: for each span
    of `plan` (default `cross_attn_plan`), in order, the unnormalized state
    (acc, m, l) of the flash recurrence over the span's keys < ta_total in
    64-key tiles, p rounded to bf16 against the span's running max, as one
    CTA of the cluster computes it."""
    B, Q, H, Dh = q.shape
    ta = k.shape[3] if ta_total is None else int(ta_total)
    n_span, span_keys = plan or cross_attn_plan(B, H, Q, ta, int8=ks is not None)
    qs = (q.float() * Dh ** -0.5).to(torch.bfloat16).float()
    ksl = None if ks is None else ks[layer]
    vsl = None if vs is None else vs[layer]
    return [_flash_tiles(qs, k[layer], v[layer], ksl, vsl, r * span_keys,
                         min((r + 1) * span_keys, ta), KEYS_PER_TILE)
            for r in range(n_span)]


def combine_span_states(states, dtype: torch.dtype) -> torch.Tensor:
    """The cluster's combine: each span's (acc, l) rescaled by exp(m - max m)
    and summed in span order; bf16(acc / l) as [B, Q, H, Dh] of `dtype`."""
    m_max = torch.stack([m for _, m, _ in states]).amax(dim=0)
    acc, l = 0.0, 0.0
    for a, m, s in states:
        w = torch.exp(m - m_max)
        acc = acc + a * w[..., None]
        l = l + s * w
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(dtype)


def cross_attn_split_plain(
    layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ta_total: Optional[int] = None, plan: Optional[CrossAttnPlan] = None,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1's (K5's, with ks, vs) function in the kernel's order: the spans of
    `cross_attn_span_states` combined by `combine_span_states`. It differs
    from `cross_attn_layer_plain` only by where p is rounded to bf16; the
    tests hold it to the JAX kernel (`kernels.agreement`)."""
    return combine_span_states(
        cross_attn_span_states(layer, q, k, v, ta_total, plan, ks, vs), q.dtype)


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
    ta_total: Optional[int] = None, plan: Optional[CrossAttnPlan] = None,
) -> torch.Tensor:
    """K1. Same contract as `cross_attn_layer_plain`. `plan` (default
    `cross_attn_plan`) is for probes that compare key splits."""
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
            B, Q, H, Ta, int(layer), ta, *(plan or cross_attn_plan(B, H, Q, ta)),
            kernels.stream_ptr(q.device),
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


# the TPU kernels' key tile: their flash running max moves once per tile,
# and the bf16 rounding of p (K9d) or p * vs (K5) falls where the max stands
KEY_TILE = 512


def cross_attn_layer_q8_plain(
    layer: int, q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
    v8: torch.Tensor, vs: torch.Tensor, ta_total: Optional[int] = None,
) -> torch.Tensor:
    """q [B, Q, H, Dh] against layer `layer` of the int8 cache k8, v8
    [L, B, H, Ta, Dh] with scales ks, vs [L, B, H, Ta] -> [B, Q, H, Dh];
    columns >= ta_total are masked. The numerics of the TPU kernel
    (`_flash_kernel_q8`), whatever the dtype of q: q scaled by Dh^-0.5 in
    f32 and rounded to bf16; score = (q . k8) * ks[t] in f32; the flash
    recurrence over KEY_TILE-key tiles, whose normalizer sums the
    unscaled probabilities p and whose P.V takes bf16(p * vs[t]) against
    the int8 values (exact in bf16); f32 accumulation divided by the
    normalizer at the end."""
    Dh = q.shape[-1]
    ta = k8.shape[3] if ta_total is None else int(ta_total)
    qs = (q.float() * Dh ** -0.5).to(torch.bfloat16).float()
    acc, _, l = _flash_tiles(qs, k8[layer], v8[layer], ks[layer], vs[layer], 0, ta, KEY_TILE)
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def cross_attn_layer_q8(
    layer: int, q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
    v8: torch.Tensor, vs: torch.Tensor, ta_total: Optional[int] = None,
    plan: Optional[CrossAttnPlan] = None,
) -> torch.Tensor:
    """K5. Same contract as `cross_attn_layer_q8_plain`; `plan` as for K1."""
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
            *(plan or cross_attn_plan(B, H, Q, ta, int8=True)), kernels.stream_ptr(q.device),
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


CROSS_KV_ROWS = 192  # rows of one stream a K2 tile (three 64-row warpgroups)
CROSS_KV_COLS = 128  # output columns a K2 tile (two heads), of K's or of V's half


class CrossKVTile(NamedTuple):
    layer: int
    stream: int
    t0: int  # first row (audio position) of the tile
    n0: int  # first column of [0, 2 H Dh): K's columns, then V's


def cross_kv_tiles(L: int, B: int, Ta: int, HD: int) -> int:
    """How many tiles K2's persistent CTAs walk (`cross_kv_tile`)."""
    return L * B * -(-Ta // CROSS_KV_ROWS) * (2 * HD // CROSS_KV_COLS)


def cross_kv_tile(i: int, L: int, B: int, Ta: int, HD: int) -> CrossKVTile:
    """Tile i of K2's walk (`csrc/cross_kv.cu::tile_at`): the layer
    outermost, then the stream and its row tile, the column innermost. A
    tile's rows stay inside one stream; rows past Ta are the kernel's zero
    fill and are not stored."""
    row_tiles, col_tiles = -(-Ta // CROSS_KV_ROWS), 2 * HD // CROSS_KV_COLS
    r = i // col_tiles % (B * row_tiles)
    return CrossKVTile(i // (col_tiles * B * row_tiles), r // row_tiles,
                       r % row_tiles * CROSS_KV_ROWS, i % col_tiles * CROSS_KV_COLS)


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
            or D % 64 or HD % CROSS_KV_COLS or HD != 64 * n_heads):
        raise ValueError(
            f"cross_kv_build: xa {tuple(xa.shape)}, weights "
            f"{tuple(ck_w.shape)} / {tuple(cv_w.shape)} / {tuple(cv_b.shape)}, "
            f"{n_heads} heads (kernel takes Dh = 64, D % 64 == 0 and "
            f"H*Dh % {CROSS_KV_COLS} == 0)")
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
