"""K3: the decoder-layer tail of a single-token sampling step, beside its
plain PyTorch version.

Counterpart of `whisper_diarize_tpu/ops/pallas_tail.py::fused_tail_layer`
(bf16 variant). Everything after self-attention for one layer:

    x  += bf16(self_out @ o_w + o_b)
    cq  = bf16(ln2(x) @ cq_w + cq_b)
    x  += bf16(cross_attention(cq, K[l], V[l]) @ co_w + co_b)
    x  += bf16(gelu(ln3(x) @ fc1_w + fc1_b) @ fc2_w + fc2_b)

The weights are the stacked decoder blocks `[L, Din, Dout]` as they are;
the TPU kernel's packed tile layout (`pack_tail_weights`) is not carried
over. On CUDA the wrapper launches `csrc/tail.cu` (a fixed sequence of
hand-written launches: skinny GEMMs with fused layernorm / bias / GELU /
residual, and K1's attention) or raises; the plain version runs only for
CPU tensors. `fused_tail_layer.launches` counts wrapper calls that launched
the kernel sequence.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .attn import _require_cuda, cross_attn_layer_plain

_TAIL_KEYS = ("o_w", "o_b", "ln2_s", "ln2_b", "cq_w", "cq_b", "co_w", "co_b",
              "ln3_s", "ln3_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 layernorm (biased variance, eps 1e-5), result in x's dtype."""
    return F.layer_norm(
        x.float(), (x.shape[-1],), s.float(), b.float(), 1e-5).to(x.dtype)


def _proj(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product plus bias (the kernel's f32 accumulator + epilogue)."""
    return torch.matmul(h.float(), w.float()) + b.float()


def fused_tail_layer_plain(
    layer: int, x: torch.Tensor, self_out: torch.Tensor,
    blocks: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
    beams: int = 1, ta_total: Optional[int] = None,
) -> torch.Tensor:
    """x [N, 1, D], self_out [N, H, 1, Dh], stacked `blocks`, cross k/v
    [L, N // beams, H, Ta, Dh] -> new x [N, 1, D]."""
    N, _, D = x.shape
    H, Dh = self_out.shape[1], self_out.shape[3]
    dt = x.dtype
    w = {key: blocks[key][layer] for key in _TAIL_KEYS}
    x1 = x + _proj(self_out.reshape(N, 1, D), w["o_w"], w["o_b"]).to(dt)
    cq = _proj(_ln(x1, w["ln2_s"], w["ln2_b"]), w["cq_w"], w["cq_b"]).to(dt)
    a = cross_attn_layer_plain(
        layer, cq.reshape(N // beams, beams, H, Dh), k, v, ta_total)
    x2 = x1 + _proj(a.reshape(N, 1, D), w["co_w"], w["co_b"]).to(dt)
    h = _proj(_ln(x2, w["ln3_s"], w["ln3_b"]), w["fc1_w"], w["fc1_b"])
    h = F.gelu(h, approximate="tanh").to(dt)
    return x2 + _proj(h, w["fc2_w"], w["fc2_b"]).to(dt)


def fused_tail_layer(
    layer: int, x: torch.Tensor, self_out: torch.Tensor,
    blocks: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
    beams: int = 1, ta_total: Optional[int] = None,
) -> torch.Tensor:
    """K3. Same contract as `fused_tail_layer_plain`."""
    if x.device.type == "cpu":
        return fused_tail_layer_plain(
            layer, x, self_out, blocks, k, v, beams, ta_total)
    ws = [blocks[key] for key in _TAIL_KEYS]
    _require_cuda("fused_tail_layer", x, self_out, k, v, *ws)
    N, S, D = x.shape
    L, Bc, H, Ta, Dh = k.shape
    want = {key: (L, D) for key in _TAIL_KEYS}
    want.update(o_w=(L, D, D), cq_w=(L, D, D), co_w=(L, D, D),
                fc1_w=(L, D, 4 * D), fc1_b=(L, 4 * D), fc2_w=(L, 4 * D, D))
    shapes_ok = (
        S == 1 and tuple(self_out.shape) == (N, H, 1, Dh) and H * Dh == D
        and Dh == 64 and D % 64 == 0 and N == Bc * beams
        and v.shape == k.shape and 0 <= layer < L
        and all(tuple(blocks[key].shape) == want[key] for key in _TAIL_KEYS)
    )
    if not shapes_ok:
        raise ValueError(
            f"fused_tail_layer: x {tuple(x.shape)}, self_out "
            f"{tuple(self_out.shape)}, k {tuple(k.shape)}, beams {beams}, "
            f"layer {layer} (kernel takes S = 1, Dh = 64, D % 64 == 0)")
    ta = Ta if ta_total is None else int(ta_total)
    if not 0 < ta <= Ta:
        raise ValueError(f"fused_tail_layer: ta_total {ta} outside (0, {Ta}]")
    scratch = torch.empty((4, N, D), dtype=x.dtype, device=x.device)
    h4 = torch.empty((N, 4 * D), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.wdt_fused_tail(
            x.data_ptr(), self_out.data_ptr(), *[t.data_ptr() for t in ws],
            k.data_ptr(), v.data_ptr(), *[s.data_ptr() for s in scratch],
            h4.data_ptr(), out.data_ptr(),
            int(layer), N, D, H, Bc, int(beams), Ta, ta,
            kernels.stream_ptr(x.device),
        ), "fused_tail_layer")
    fused_tail_layer.launches += 1
    return out


fused_tail_layer.launches = 0
