"""K3 and K6: the decoder-layer tail of a single-token sampling step, beside
its plain PyTorch version; and `quantize_tail_weights`, the int8 weights K6
reads.

Counterpart of `whisper_diarize_tpu/ops/pallas_tail.py::fused_tail_layer`.
Everything after self-attention for one layer:

    x  += bf16(self_out @ o_w + o_b)
    cq  = bf16(ln2(x) @ cq_w + cq_b)
    x  += bf16(cross_attention(cq, K[l], V[l]) @ co_w + co_b)
    x  += bf16(gelu(ln3(x) @ fc1_w + fc1_b) @ fc2_w + fc2_b)

K3 is the bf16 form. K6 takes the TPU kernel's int8 forms, each
independent of the other: `wq`, int8 weights (`quantize_tail_weights`:
o / cq / co / fc1 with one f32 scale per output column, folded into the
product's output; fc2 with one per input row, folded into the activations as
bf16(f32(h) * ws), rounded to the activation dtype); and `kvq`, the int8
cross cache of `attn.quantize_cross_kv`, attended with K5's numerics.

The weights are the stacked decoder blocks `[L, Din, Dout]` as they are;
the TPU kernel's packed tile layout (`pack_tail_weights`) is not carried
over. On CUDA the wrapper launches `csrc/tail.cu` (a fixed sequence of
hand-written launches: skinny GEMMs with fused layernorm / scales / bias /
GELU / residual, and K1's or K5's attention) or raises; the plain version
runs only for CPU tensors. `fused_tail_layer.launches` counts the wrapper's
launches of the bf16 form (K3), `fused_tail_layer.launches_int8` those of
an int8 form (K6).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .attn import _require_cuda, cross_attn_layer_plain, cross_attn_layer_q8_plain

_TAIL_KEYS = ("o_w", "o_b", "ln2_s", "ln2_b", "cq_w", "cq_b", "co_w", "co_b",
              "ln3_s", "ln3_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
_MATRICES = ("o_w", "cq_w", "co_w", "fc1_w", "fc2_w")
_SCALES = tuple(f"{m}s" for m in _MATRICES)  # "o_ws", ..., "fc2_ws"


def quantize_tail_weights(blocks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tail's weights for K6's `wq` form: the five matrices as int8 of
    the same `[L, Din, Dout]` shape, with f32 scales "o_ws", "cq_ws",
    "co_ws", "fc1_ws" `[L, Dout]` (one per output column, over Din) and
    "fc2_ws" `[L, 4D]` (one per input row, over D); the biases and layer
    norms are the same tensors as in `blocks`. Symmetric int8 with
    s = max(amax|w|, 1e-8) / 127 and round(w / s) clipped to +-127: the
    semantics of the JAX package's `pack_tail_weights(quantize=True)`, whose
    tiles share one scale per tile column (an output column, or an fc2 input
    row of the transposed fc2 tiles); the payloads match it bit for bit."""
    out = {key: blocks[key] for key in _TAIL_KEYS if key not in _MATRICES}
    for m in _MATRICES:
        w = blocks[m].float()
        axis = 2 if m == "fc2_w" else 1  # reduce over D (fc2) or over Din
        s = w.abs().amax(dim=axis).clamp_min(1e-8) / 127.0
        out[m] = torch.round(w / s.unsqueeze(axis)).clamp_(-127, 127).to(torch.int8)
        out[f"{m}s"] = s
    return out


def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 layernorm (biased variance, eps 1e-5), result in x's dtype."""
    return F.layer_norm(
        x.float(), (x.shape[-1],), s.float(), b.float(), 1e-5).to(x.dtype)


def _proj(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          col_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 product (times the int8 weights' column scale) plus bias: the
    kernel's f32 accumulator and epilogue."""
    y = torch.matmul(h.float(), w.float())
    if col_scale is not None:
        y = y * col_scale.float()
    return y + b.float()


def _is_int8(blocks: Dict[str, torch.Tensor]) -> bool:
    kinds = {blocks[m].dtype == torch.int8 for m in _MATRICES}
    if len(kinds) != 1:
        raise TypeError("fused_tail_layer: the five tail matrices are all int8 "
                        "or all floating point")
    return kinds.pop()


def _check_cache(k: torch.Tensor, ks, vs) -> bool:
    kvq = k.dtype == torch.int8
    if kvq != (ks is not None) or (ks is None) != (vs is None):
        raise ValueError("fused_tail_layer: an int8 cross cache comes with its "
                         "scales ks, vs, and a bf16 one without")
    return kvq


def fused_tail_layer_plain(
    layer: int, x: torch.Tensor, self_out: torch.Tensor,
    blocks: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
    beams: int = 1, ta_total: Optional[int] = None,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x [N, 1, D], self_out [N, H, 1, Dh], the stacked tail weights
    `blocks` (bf16 / f32, or int8 with scales as `quantize_tail_weights`
    gives them), cross k/v [L, N // beams, H, Ta, Dh] (or int8 with scales
    ks, vs [L, N // beams, H, Ta]) -> new x [N, 1, D]."""
    N, _, D = x.shape
    H, Dh = self_out.shape[1], self_out.shape[3]
    dt = x.dtype
    wq = _is_int8(blocks)
    kvq = _check_cache(k, ks, vs)
    w = {key: t[layer] for key, t in blocks.items()}

    def cs(m):  # the column scale of an int8 matrix
        return w[f"{m}s"] if wq else None

    x1 = x + _proj(self_out.reshape(N, 1, D), w["o_w"], w["o_b"], cs("o_w")).to(dt)
    cq = _proj(_ln(x1, w["ln2_s"], w["ln2_b"]), w["cq_w"], w["cq_b"], cs("cq_w")).to(dt)
    q = cq.reshape(N // beams, beams, H, Dh)
    if kvq:
        a = cross_attn_layer_q8_plain(layer, q, k, ks, v, vs, ta_total)
    else:
        a = cross_attn_layer_plain(layer, q, k, v, ta_total)
    x2 = x1 + _proj(a.reshape(N, 1, D), w["co_w"], w["co_b"], cs("co_w")).to(dt)
    h = _proj(_ln(x2, w["ln3_s"], w["ln3_b"]), w["fc1_w"], w["fc1_b"], cs("fc1_w"))
    h = F.gelu(h, approximate="tanh").to(dt)
    if wq:  # fc2's scale is per input row: it scales the activations
        h = (h.float() * w["fc2_ws"].float()).to(dt)
    return x2 + _proj(h, w["fc2_w"], w["fc2_b"]).to(dt)


def fused_tail_layer(
    layer: int, x: torch.Tensor, self_out: torch.Tensor,
    blocks: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
    beams: int = 1, ta_total: Optional[int] = None,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3 (bf16 weights and cache) and K6 (int8 weights and / or int8 cache).
    Same contract as `fused_tail_layer_plain`."""
    if x.device.type == "cpu":
        return fused_tail_layer_plain(
            layer, x, self_out, blocks, k, v, beams, ta_total, ks, vs)
    name = "fused_tail_layer"
    wq = _is_int8(blocks)
    kvq = _check_cache(k, ks, vs)
    dev = x.device
    small = [key for key in _TAIL_KEYS if key not in _MATRICES]
    _require_cuda(name, x, self_out, *[blocks[key] for key in small])
    _require_cuda(name, *[blocks[m] for m in _MATRICES],
                  dtype=torch.int8 if wq else torch.bfloat16, device=dev)
    _require_cuda(name, k, v, dtype=torch.int8 if kvq else torch.bfloat16, device=dev)
    if wq:
        _require_cuda(name, *[blocks[s] for s in _SCALES], dtype=torch.float32,
                      device=dev)
    if kvq:
        _require_cuda(name, ks, vs, dtype=torch.float32, device=dev)
    N, S, D = x.shape
    L, Bc, H, Ta, Dh = k.shape
    want = {key: (L, D) for key in _TAIL_KEYS}
    want.update(o_w=(L, D, D), cq_w=(L, D, D), co_w=(L, D, D),
                fc1_w=(L, D, 4 * D), fc1_b=(L, 4 * D), fc2_w=(L, 4 * D, D))
    if wq:
        want.update(o_ws=(L, D), cq_ws=(L, D), co_ws=(L, D), fc1_ws=(L, 4 * D),
                    fc2_ws=(L, 4 * D))
    shapes_ok = (
        S == 1 and tuple(self_out.shape) == (N, H, 1, Dh) and H * Dh == D
        and Dh == 64 and D % 64 == 0 and N == Bc * beams
        and v.shape == k.shape and 0 <= layer < L
        and all(tuple(blocks[key].shape) == shape for key, shape in want.items())
        and (not kvq or (tuple(ks.shape) == (L, Bc, H, Ta) and vs.shape == ks.shape))
    )
    if not shapes_ok:
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, self_out {tuple(self_out.shape)}, "
            f"k {tuple(k.shape)}, beams {beams}, layer {layer} (kernel takes "
            "S = 1, Dh = 64, D % 64 == 0)")
    ta = Ta if ta_total is None else int(ta_total)
    if not 0 < ta <= Ta:
        raise ValueError(f"{name}: ta_total {ta} outside (0, {Ta}]")
    scratch = torch.empty((4, N, D), dtype=x.dtype, device=dev)
    h4 = torch.empty((N, 4 * D), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    scales = [blocks[s].data_ptr() if wq else None for s in _SCALES]
    scales += [ks.data_ptr(), vs.data_ptr()] if kvq else [None, None]
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(lib.wdt_fused_tail(
            x.data_ptr(), self_out.data_ptr(),
            *[blocks[key].data_ptr() for key in _TAIL_KEYS],
            k.data_ptr(), v.data_ptr(), *[s.data_ptr() for s in scratch],
            h4.data_ptr(), out.data_ptr(), *scales,
            int(layer), N, D, H, Bc, int(beams), Ta, ta,
            kernels.stream_ptr(dev),
        ), name)
    if wq or kvq:
        fused_tail_layer.launches_int8 += 1
    else:
        fused_tail_layer.launches += 1
    return out


fused_tail_layer.launches = 0
fused_tail_layer.launches_int8 = 0
