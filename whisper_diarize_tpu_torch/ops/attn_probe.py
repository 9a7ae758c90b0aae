"""K1's function in the three forms that `tools/bench_attn_kernel.py`
measured beside it, each beside its plain PyTorch version: K9a
`cross_attn_presliced` (one layer's K/V sliced out on the host), K9c
`cross_attn_const_layer` (the layer a compile-time constant) and K9d
`cross_attn_flat` (the audio axis split: one CTA per span of KEY_TILE keys,
then a combine). Probes of where K1's time goes; the decoder never calls
them.

Numerics are `ops/attn.py::cross_attn_layer_plain`'s; ta_total defaults to
1500 (whisper's audio context), as the TPU tool hard-coded it, and keys at
or past it are masked.

Dispatch as in `ops/attn.py`: a wrapper runs its plain version only for
tensors on the CPU; on CUDA tensors it launches its kernel
(`csrc/cross_attn.cu`: K1's own entry point for K9a, K1's kernel in another
form for K9c and K9d) or raises. Each counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from .. import kernels
from .attn import KEY_TILE, _require_cuda, cross_attn_layer_plain

TA_TOTAL = 1500
CONST_LAYER = 1  # K9c's layer, as the TPU tool fixed it


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  layer_axis: bool) -> None:
    B, Q, H, Dh = q.shape
    kv = tuple(k.shape[1:] if layer_axis else k.shape)
    if Dh != 64 or kv[:2] != (B, H) or kv[3] != Dh or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} (kernel takes Dh = 64)")


# --------------------------------------------------------------------------
# K9a: K1 over one layer already sliced out
# --------------------------------------------------------------------------

def cross_attn_presliced_plain(q: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                               ta_total: int = TA_TOTAL) -> torch.Tensor:
    """q [B, Q, H, Dh] against k_l, v_l [B, H, Ta, Dh] -> [B, Q, H, Dh];
    keys >= ta_total masked (none where Ta <= ta_total)."""
    return cross_attn_layer_plain(0, q, k_l[None], v_l[None], min(ta_total, k_l.shape[2]))


def cross_attn_presliced(q: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                         ta_total: int = TA_TOTAL) -> torch.Tensor:
    """K9a. Same contract as `cross_attn_presliced_plain`: K1's entry point
    on the one-layer cache k_l[None], at layer 0."""
    if q.device.type == "cpu":
        return cross_attn_presliced_plain(q, k_l, v_l, ta_total)
    name = "cross_attn_presliced"
    _require_cuda(name, q, k_l, v_l)
    _check_shapes(name, q, k_l, v_l, layer_axis=False)
    if ta_total <= 0:
        raise ValueError(f"{name}: ta_total {ta_total}")
    B, Q, H, _ = q.shape
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(lib.wdt_cross_attn(
            q.data_ptr(), k_l.data_ptr(), v_l.data_ptr(), out.data_ptr(), B, Q, H,
            k_l.shape[2], 0, int(ta_total), kernels.stream_ptr(q.device)), name)
    cross_attn_presliced.launches += 1
    return out


cross_attn_presliced.launches = 0


# --------------------------------------------------------------------------
# K9c: K1 with the layer a compile-time constant
# --------------------------------------------------------------------------

def cross_attn_const_layer_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 ta_total: int = TA_TOTAL) -> torch.Tensor:
    """q [B, Q, H, Dh] against layer CONST_LAYER of k, v [L, B, H, Ta, Dh]."""
    return cross_attn_layer_plain(CONST_LAYER, q, k, v, min(ta_total, k.shape[3]))


def cross_attn_const_layer(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           ta_total: int = TA_TOTAL) -> torch.Tensor:
    """K9c. Same contract as `cross_attn_const_layer_plain`."""
    if q.device.type == "cpu":
        return cross_attn_const_layer_plain(q, k, v, ta_total)
    name = "cross_attn_const_layer"
    _require_cuda(name, q, k, v)
    _check_shapes(name, q, k, v, layer_axis=True)
    if k.shape[0] <= CONST_LAYER or ta_total <= 0:
        raise ValueError(f"{name}: {k.shape[0]} layers (needs > {CONST_LAYER}), "
                         f"ta_total {ta_total}")
    B, Q, H, _ = q.shape
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(lib.wdt_cross_attn_const_layer(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Q, H,
            k.shape[3], int(ta_total), kernels.stream_ptr(q.device)), name)
    cross_attn_const_layer.launches += 1
    return out


cross_attn_const_layer.launches = 0


# --------------------------------------------------------------------------
# K9d: K1 with the audio axis split into spans of KEY_TILE keys
# --------------------------------------------------------------------------

def cross_attn_flat_plain(layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ta_total: int = TA_TOTAL) -> torch.Tensor:
    """q [B, Q, H, Dh] against layer `layer` of k, v [L, B, H, Ta, Dh], in
    the TPU kernel's order: the flash recurrence over KEY_TILE-key tiles,
    its running max moving once a tile, so p is rounded to the V dtype
    against the max of the tiles so far; f32 normalizer and accumulator
    divided at the end."""
    B, Q, H, Dh = q.shape
    ta = min(ta_total, k.shape[3])
    qs = (q.float() * Dh ** -0.5).to(k.dtype).float()
    m = torch.full((B, H, Q), -1e30, device=q.device)
    l = torch.zeros((B, H, Q), device=q.device)
    acc = torch.zeros((B, H, Q, Dh), device=q.device)
    for t0 in range(0, ta, KEY_TILE):
        t = slice(t0, min(t0 + KEY_TILE, ta))
        s = torch.einsum("bqhd,bhtd->bhqt", qs, k[layer, :, :, t].float())
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqt,bhtd->bhqd", p.to(v.dtype).float(), v[layer, :, :, t].float())
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def n_spans(Ta: int, ta_total: int) -> int:
    """K9d's spans: the KEY_TILE-key spans that hold an unmasked key."""
    return -(-min(Ta, ta_total) // KEY_TILE)


def cross_attn_flat(layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ta_total: int = TA_TOTAL) -> torch.Tensor:
    """K9d. Same contract as `cross_attn_flat_plain`."""
    if q.device.type == "cpu":
        return cross_attn_flat_plain(layer, q, k, v, ta_total)
    name = "cross_attn_flat"
    _require_cuda(name, q, k, v)
    _check_shapes(name, q, k, v, layer_axis=True)
    L, Ta = k.shape[0], k.shape[3]
    if not (0 <= layer < L and ta_total > 0):
        raise ValueError(f"{name}: layer {layer} of {L}, ta_total {ta_total}")
    B, Q, H, Dh = q.shape
    spans = n_spans(Ta, ta_total)
    part = torch.empty((B, spans, H, Q, Dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(lib.wdt_cross_attn_flat(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(),
            B, Q, H, Ta, int(layer), int(ta_total), KEY_TILE, spans,
            kernels.stream_ptr(q.device)), name)
    cross_attn_flat.launches += 1
    return out


cross_attn_flat.launches = 0
