"""K3 and K6: the decoder-layer tail of a single-token sampling step, beside
its plain PyTorch version; and `quantize_tail_weights`, the int8 weights K6
reads.

Counterpart of `whisper_diarize_tpu/ops/pallas_tail.py::fused_tail_layer`.
Everything after self-attention for one layer:

    x  += bf16(self_out @ o_w + o_b)
    cq  = bf16(ln2(x) @ cq_w + cq_b)
    x  += bf16(cross_attention(cq, K[l], V[l]) @ co_w + co_b)
    x  += bf16(gelu(ln3(x) @ fc1_w + fc1_b) @ fc2_w + fc2_b)

K3 is the form over bf16 or f32 weights and cache (the TPU kernel's over
the operand dtype: at f32 every rounding above is the identity and each
product runs in 3xTF32 on the tensor cores, an f32 product's accuracy).
K6 takes the TPU kernel's int8 forms, each independent of the other: `wq`,
int8 weights (`quantize_tail_weights`: o / cq / co / fc1 with one f32 scale
per output column, folded into the product's output; fc2 with one per input row, folded into the activations as
bf16(f32(h) * ws), rounded to the activation dtype); and `kvq`, the int8
cross cache of `attn.quantize_cross_kv`, attended with K5's numerics.

The weights are the stacked decoder blocks `[L, Din, Dout]` as they are;
the TPU kernel's packed tile layout (`pack_tail_weights`) is not carried
over. On CUDA the wrapper launches `csrc/tail.cu` (a fixed sequence of
hand-written launches: skinny GEMMs with fused layernorm / scales / bias /
GELU / residual, each on the split `skinny_plan` gives it, and K1's or K5's
attention on `attn.cross_attn_plan` for N // beams streams of `beams`
queries) or raises; the plain version runs only for CPU tensors. The
activations, biases and layer norms of a call share one dtype, bf16 or f32
(the weights too unless int8; the cache too unless int8); a mixed call
raises TypeError. `fused_tail_layer.launches` counts the wrapper's
launches of K3 (either dtype), `fused_tail_layer.launches_int8` those of
an int8 form (K6); `.cross_attn_launches` and `.cross_attn_q8_launches`
count the K1 and K5 launches the tail makes inside them (one a call). Each
has an `_f32` twin that counts the f32 activations' launches alone.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..utils import ieee_f32_products
from .attn import (_acc, _float_dtype, _require_cuda, cross_attn_layer_plain,
                   cross_attn_layer_q8_plain, cross_attn_plan)

_TAIL_KEYS = ("o_w", "o_b", "ln2_s", "ln2_b", "cq_w", "cq_b", "co_w", "co_b",
              "ln3_s", "ln3_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
_MATRICES = ("o_w", "cq_w", "co_w", "fc1_w", "fc2_w")
_SCALES = tuple(f"{m}s" for m in _MATRICES)  # "o_ws", ..., "fc2_ws"


# --------------------------------------------------------------------------
# The skinny GEMM's split (csrc/tail.cu; K8's product, csrc/front.cu, too)
# --------------------------------------------------------------------------

SKINNY_K_TILE = 64  # weight rows a ring tile; spans are whole tiles
SKINNY_ROW_PAD = 8  # values an activation row of a ring tile is padded by
SKINNY_MAX_ROWS = 80  # rows a launch (five m16 tiles); more go in launches of 80
SKINNY_CLUSTER_MAX = 8  # spans a strip, one CTA of a cluster each: the portable size
SKINNY_CTA_TARGET = 264  # two CTAs on each of the H100's 132 SMs
SKINNY_SMS = 132
SKINNY_STAGES = (3, 4)  # the copy ring's tiles, fewest and most
SKINNY_SMEM_MAX = 200 * 1024  # dynamic shared memory a CTA may take
SM_SHARED = 233472  # shared memory an SM
# a CTA's static shared memory (csrc/tail.cu) and the 1 KB the card reserves
SKINNY_CTA_RESERVE = (128 + 4 * SKINNY_MAX_ROWS) * 4 + 160 + 8 + 1024


class SkinnyPlan(NamedTuple):
    bn: int  # columns a strip: 32 or 64
    n_split: int  # spans of the input dimension a strip, one CTA each
    span_k: int  # input rows a span (a multiple of SKINNY_K_TILE)
    stages: int  # tiles of the CTA's copy ring


def _ring_tile(rows: int, bn: int, int8: bool, ln: bool, f32: bool = False) -> int:
    """Bytes of one ring tile: 64 weight rows padded by 16 bytes and, without
    a layer norm, 64 columns of the activation rows padded by 8 values (bf16,
    or f32 with `f32`; f32 weights too unless int8)."""
    es = 4 if f32 else 2
    tile = SKINNY_K_TILE * ((bn if int8 else es * bn) + 16)
    return tile + (0 if ln else rows * (SKINNY_K_TILE + SKINNY_ROW_PAD) * es)


def skinny_smem(rows: int, plan: SkinnyPlan, int8: bool, ln: bool = False,
                f32: bool = False) -> int:
    """Dynamic shared memory of one CTA (`csrc/tail.cu::smem_bytes`): with a
    layer norm (`ln`), the span of `rows` activation rows and a zero row
    (bf16 or f32, padded by 16 bytes) and ln_g / ln_b over it; the
    combine's receive buffer (rows x bn / 2 pairs of f32, and 8 more); the
    ring."""
    es = 4 if f32 else 2
    span = (rows + 1) * (plan.span_k * es + 16) + 2 * es * plan.span_k if ln else 0
    return (span + (rows * plan.bn // 2 + 8) * 8
            + plan.stages * _ring_tile(rows, plan.bn, int8, ln, f32))


@lru_cache(maxsize=None)  # a pure function, asked at every launch
def skinny_plan(N: int, Din: int, Dout: int, int8: bool = False,
                ln: bool = False, f32: bool = False) -> SkinnyPlan:
    """How the skinny GEMM splits out[N, Dout] = A[N, Din] @ W[Din, Dout]:
    Dout into strips of `bn` columns, each strip's Din into `n_split`
    spans of `span_k` rows (tiles dealt evenly, so no span is empty), one
    CTA a (strip, span), a strip's spans one cluster, each CTA with a copy
    ring of `stages` tiles. The first split (64 columns before 32, then the
    fewest spans) that gives at least SKINNY_CTA_TARGET CTAs, all resident
    at once with a ring of at least 3 tiles; its ring is as deep as the
    shared memory of the CTAs an SM that takes leaves (at most 4 tiles: 6 and
    8 ran slower at fc2's shape, PERF.md; no more than the span's tiles and
    one). Where no split does, the one
    that runs in one wave with the most CTAs (then, where none runs in one
    wave, the most CTAs resident). A pure function of (N, Din, Dout, weight
    type, layer norm: a product with one stages its whole span of
    activations, activation type: `f32`): the tail and the front pass it to
    the kernel, which refuses one that does not cover Din or does not fit."""
    if min(N, Din, Dout) <= 0 or Din % SKINNY_K_TILE or Dout % 32:
        raise ValueError(f"skinny_plan: N {N}, Din {Din}, Dout {Dout} (kernel takes "
                         f"Din % {SKINNY_K_TILE} == 0, Dout % 32 == 0)")
    rows, tiles = min(N, SKINNY_MAX_ROWS), Din // SKINNY_K_TILE
    lo, hi = SKINNY_STAGES
    best = None
    for bn in (64, 32):
        if Dout % bn:
            continue
        tile = _ring_tile(rows, bn, int8, ln, f32)
        for n in range(1, min(SKINNY_CLUSTER_MAX, tiles) + 1):
            per = -(-tiles // n)
            split = -(-tiles // per)
            ctas = Dout // bn * split
            fixed = skinny_smem(rows, SkinnyPlan(bn, split, per * SKINNY_K_TILE, 0), int8, ln,
                                f32)
            # the partial [rows, bn] f32 lives in the ring once the loop is done
            least = max(lo, -(-rows * bn * 4 // tile))
            room = min(SKINNY_SMEM_MAX, SM_SHARED // -(-ctas // SKINNY_SMS) - SKINNY_CTA_RESERVE)
            stages = max(least, min(hi, per + 1, (room - fixed) // tile))
            plan = SkinnyPlan(bn, split, per * SKINNY_K_TILE, stages)
            smem = skinny_smem(rows, plan, int8, ln, f32)
            if smem > SKINNY_SMEM_MAX:
                continue
            resident = SKINNY_SMS * (SM_SHARED // (smem + SKINNY_CTA_RESERVE))
            if SKINNY_CTA_TARGET <= ctas <= resident:
                return plan
            key = (ctas <= resident, min(ctas, resident), -ctas)
            if best is None or key > best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"skinny_plan: no split of Din {Din} fits at N {N}")
    return best[1]


@lru_cache(maxsize=None)
def tail_plans(N: int, D: int, int8: bool = False, f32: bool = False) -> Tuple[SkinnyPlan, ...]:
    """The splits of the tail's five products: o, cq, co ([D, D]; cq with
    its layer norm), fc1 ([D, 4D], with its layer norm) and fc2 ([4D, D])."""
    return (skinny_plan(N, D, D, int8, f32=f32), skinny_plan(N, D, D, int8, ln=True, f32=f32),
            skinny_plan(N, D, D, int8, f32=f32),
            skinny_plan(N, D, 4 * D, int8, ln=True, f32=f32),
            skinny_plan(N, 4 * D, D, int8, f32=f32))


def fused_tail_int_args(layer: int, N: int, D: int, H: int, Bc: int, beams: int, Ta: int,
                        ta_total: int, wq: bool, kvq: bool,
                        f32: bool = False) -> Tuple[int, ...]:
    """The int arguments of `wdt_fused_tail` (`wdt_fused_tail_f32` with f32
    activations, `f32`), in order: the shape, K1 / K5's key split
    (`attn.cross_attn_plan`) and the five products' splits (`tail_plans`)."""
    return (int(layer), N, D, H, Bc, int(beams), Ta, int(ta_total),
            *cross_attn_plan(Bc, H, int(beams), int(ta_total), int8=kvq, f32=f32),
            *(x for plan in tail_plans(N, D, wq, f32) for x in plan))


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
    """f32 layernorm (biased variance, eps 1e-5; float64 for float64 x),
    result in x's dtype."""
    xa = _acc(x)
    return F.layer_norm(xa, (x.shape[-1],), s.to(xa.dtype), b.to(xa.dtype),
                        1e-5).to(x.dtype)


def _proj(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          col_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 product (times the int8 weights' column scale) plus bias: the
    kernel's f32 accumulator and epilogue (float64 for float64 h)."""
    ha = _acc(h)
    y = torch.matmul(ha, w.to(ha.dtype))
    if col_scale is not None:
        y = y * col_scale.to(ha.dtype)
    return y + b.to(ha.dtype)


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
                         "scales ks, vs, and a bf16 or f32 one without")
    return kvq


@ieee_f32_products
def fused_tail_layer_plain(
    layer: int, x: torch.Tensor, self_out: torch.Tensor,
    blocks: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
    beams: int = 1, ta_total: Optional[int] = None,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
    proj: Optional[Callable] = None, ln: Optional[Callable] = None,
    attend: Optional[Callable] = None,
) -> torch.Tensor:
    """x [N, 1, D], self_out [N, H, 1, Dh], the stacked tail weights
    `blocks` (bf16 / f32, or int8 with scales as `quantize_tail_weights`
    gives them), cross k/v [L, N // beams, H, Ta, Dh] (or int8 with scales
    ks, vs [L, N // beams, H, Ta]) -> new x [N, 1, D]. `proj(name, h, w, b,
    col_scale)` and `ln(name, x, s, b)`, where given, replace the f32
    products ("o", "cq", "co", "fc1", "fc2") and layer norms ("ln2",
    "ln3"): how the planted faults of `kernels/agreement.py` slip.
    `attend(layer, q, k, v, ta_total, ks, vs)` replaces the cross attention
    (q [N // beams, beams, H, Dh]): the split model of the f32 check, or a
    fault."""
    N, _, D = x.shape
    H, Dh = self_out.shape[1], self_out.shape[3]
    dt = x.dtype
    wq = _is_int8(blocks)
    kvq = _check_cache(k, ks, vs)
    w = {key: t[layer] for key, t in blocks.items()}

    def cs(m):  # the column scale of an int8 matrix
        return w[f"{m}s"] if wq else None

    def P(name, h, m, col_scale=None):
        if proj is not None:
            return proj(name, h, w[f"{m}_w"], w[f"{m}_b"], col_scale)
        return _proj(h, w[f"{m}_w"], w[f"{m}_b"], col_scale)

    def LN(name, h):
        s, b = w[f"{name}_s"], w[f"{name}_b"]
        return _ln(h, s, b) if ln is None else ln(name, h, s, b)

    x1 = x + P("o", self_out.reshape(N, 1, D), "o", cs("o_w")).to(dt)
    cq = P("cq", LN("ln2", x1), "cq", cs("cq_w")).to(dt)
    q = cq.reshape(N // beams, beams, H, Dh)
    if attend is not None:
        a = attend(layer, q, k, v, ta_total, ks, vs)
    elif kvq:
        a = cross_attn_layer_q8_plain(layer, q, k, ks, v, vs, ta_total)
    else:
        a = cross_attn_layer_plain(layer, q, k, v, ta_total)
    x2 = x1 + P("co", a.reshape(N, 1, D), "co", cs("co_w")).to(dt)
    h = P("fc1", LN("ln3", x2), "fc1", cs("fc1_w"))
    h = F.gelu(h, approximate="tanh").to(dt)
    if wq:  # fc2's scale is per input row: it scales the activations
        ha = _acc(h)
        h = (ha * w["fc2_ws"].to(ha.dtype)).to(dt)
    return x2 + P("fc2", h, "fc2").to(dt)


def fused_tail_layer(
    layer: int, x: torch.Tensor, self_out: torch.Tensor,
    blocks: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
    beams: int = 1, ta_total: Optional[int] = None,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3 (bf16 or f32 weights and cache) and K6 (int8 weights and / or
    int8 cache). Same contract as `fused_tail_layer_plain`."""
    if x.device.type == "cpu":
        return fused_tail_layer_plain(
            layer, x, self_out, blocks, k, v, beams, ta_total, ks, vs)
    name = "fused_tail_layer"
    wq = _is_int8(blocks)
    kvq = _check_cache(k, ks, vs)
    dev = x.device
    dt = _float_dtype(name, x)
    f32 = dt == torch.float32
    small = [key for key in _TAIL_KEYS if key not in _MATRICES]
    _require_cuda(name, x, self_out, *[blocks[key] for key in small], dtype=dt)
    _require_cuda(name, *[blocks[m] for m in _MATRICES],
                  dtype=torch.int8 if wq else dt, device=dev)
    _require_cuda(name, k, v, dtype=torch.int8 if kvq else dt, device=dev)
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
    entry = lib.wdt_fused_tail_f32 if f32 else lib.wdt_fused_tail
    with torch.cuda.device(dev):
        kernels.check(entry(
            x.data_ptr(), self_out.data_ptr(),
            *[blocks[key].data_ptr() for key in _TAIL_KEYS],
            k.data_ptr(), v.data_ptr(), *[s.data_ptr() for s in scratch],
            h4.data_ptr(), out.data_ptr(), *scales,
            *fused_tail_int_args(layer, N, D, H, Bc, beams, Ta, ta, wq, kvq, f32),
            kernels.stream_ptr(dev),
        ), name)
    # the form, then the attention inside: K5 over the int8 cache, else K1
    for attr in ("launches_int8" if wq or kvq else "launches",
                 "cross_attn_q8_launches" if kvq else "cross_attn_launches"):
        setattr(fused_tail_layer, attr, getattr(fused_tail_layer, attr) + 1)
        if f32:
            setattr(fused_tail_layer, f"{attr}_f32",
                    getattr(fused_tail_layer, f"{attr}_f32") + 1)
    return out


for _attr in ("launches", "launches_int8", "cross_attn_launches", "cross_attn_q8_launches"):
    setattr(fused_tail_layer, _attr, 0)
    setattr(fused_tail_layer, f"{_attr}_f32", 0)
