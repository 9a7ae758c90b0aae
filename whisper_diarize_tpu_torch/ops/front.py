"""K8: the front of one decoder layer for a greedy (single-token) step,
beside its plain PyTorch version; and `pack_front_weights`, the weights it
reads.

Counterpart of `tools/pallas_front.py::fused_front_layer`, which the JAX
package's `decode_step` runs at every single-token step when a "front" pack
is attached to the decoder params. Everything before the layer tail:

    h      = ln1(x)                                    (f32 statistics)
    q|k|v  = bf16(h @ [q_w | k_w | v_w] + [q_b | 0 | v_b])
    out    = attention of q over the self cache, slots row_pad[n] <= t <= pos
             (and always the self slot t == pos): q and k each scaled by
             Dh^-0.25 and rounded, f32 scores and softmax, bf16(p / l) . V

The TPU kernel reads the cache before the update and attends the new K/V
as an extra "self column"; the port's decode step writes the cache in
place, so both versions here write this step's K/V into slot `pos` of
kc / vc themselves (the cache is UPDATED IN PLACE) and attend the slots up
to `pos`: the same function. On CUDA the wrapper launches `csrc/front.cu`
(K3's skinny GEMM over the packed weights on the split
`tail.skinny_plan(N, D, 3D, ln=True)`, then one CTA per (row, head)) or
raises; the plain version runs only for CPU tensors.
`fused_front_layer.launches` counts the wrapper's launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .attn import _int32_on, _require_cuda, qk_scaled
from .tail import skinny_plan

_FRONT_KEYS = ("w", "b", "ln1_s", "ln1_b")


def pack_front_weights(params, cfg) -> Dict[str, torch.Tensor]:
    """The decoder's front weights in K8's layout: "w" [L, D, 3D] =
    [q_w | k_w | v_w], "b" [L, 3D] = [q_b | 0 | v_b] (k has no bias),
    "ln1_s", "ln1_b" [L, D] (the blocks' own tensors). Like the JAX
    package's `pack_front_weights`, a copy of the three matrices; attach it
    as `params["decoder"]["front"]` to run K8 in every greedy step."""
    blocks = params["decoder"]["blocks"]
    if blocks["q_w"].shape[1] != cfg.n_text_state:
        raise ValueError(f"pack_front_weights: q_w {tuple(blocks['q_w'].shape)} "
                         f"for n_text_state {cfg.n_text_state}")
    q_b = blocks["q_b"]
    return {
        "w": torch.cat([blocks["q_w"], blocks["k_w"], blocks["v_w"]], dim=2).contiguous(),
        "b": torch.cat([q_b, torch.zeros_like(q_b), blocks["v_b"]], dim=1).contiguous(),
        "ln1_s": blocks["ln1_s"], "ln1_b": blocks["ln1_b"],
    }


def front_qkv_plain(layer: int, x: torch.Tensor, front: Dict[str, torch.Tensor],
                    n_heads: int) -> Tuple[torch.Tensor, ...]:
    """x [N, 1, D] -> (q, k_new, v_new) [N, H, 1, Dh] in x's dtype: f32 layer
    norm rounded to x's dtype, f32 product plus bias rounded once."""
    N, _, D = x.shape
    h = F.layer_norm(x.float(), (D,), front["ln1_s"][layer].float(),
                     front["ln1_b"][layer].float(), 1e-5).to(x.dtype)
    y = (torch.matmul(h.float(), front["w"][layer].float())
         + front["b"][layer].float()).to(x.dtype)
    return tuple(t.reshape(N, n_heads, 1, D // n_heads) for t in y.split(D, dim=-1))


def valid_slots(pos: int, row_pad: torch.Tensor, Tc: int) -> torch.Tensor:
    """[N, Tc] bool: row_pad[n] <= t <= pos, and the self slot t == pos."""
    t = torch.arange(Tc, device=row_pad.device)
    return (t <= pos) & ((t >= row_pad.long()[:, None]) | (t == pos))


def attend(qs: torch.Tensor, ks: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """qs [N, H, 1, Dh] and ks [N, H, Tc, Dh] scaled (f32), v [N, H, Tc, Dh],
    valid [N, Tc] -> [N, H, 1, Dh] in v's dtype: f32 scores and softmax,
    weights rounded to v's dtype, f32 P.V."""
    s = torch.matmul(qs, ks.transpose(-1, -2))
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(v.dtype)


def fused_front_layer_plain(
    layer: int, pos: int, row_pad: torch.Tensor, x: torch.Tensor,
    front: Dict[str, torch.Tensor], kc: torch.Tensor, vc: torch.Tensor,
    keep: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N, 1, D], the packed front weights `front` (`pack_front_weights`),
    the self cache kc, vc [L, N, H, Tc, Dh] (slot `pos` of layer `layer`
    written in place), row_pad [N] -> (self_out, k_new, v_new)
    [N, H, 1, Dh]. `keep` ([Tc] bool), where given, also masks the slots
    it is False at: how the planted faults of `kernels/agreement.py` drop
    a slot."""
    H = kc.shape[2]
    q, k_new, v_new = front_qkv_plain(layer, x, front, H)
    kc[layer, :, :, pos] = k_new[:, :, 0]
    vc[layer, :, :, pos] = v_new[:, :, 0]
    valid = valid_slots(pos, row_pad, kc.shape[3])
    if keep is not None:
        valid = valid & keep
    out = attend(qk_scaled(q), qk_scaled(kc[layer]), vc[layer], valid)
    return out, k_new, v_new


def front_int_args(layer: int, N: int, D: int, H: int, Tc: int,
                   pos: int) -> Tuple[int, ...]:
    """The int arguments of `wdt_fused_front`, in order: the shape, the step
    and the [D, 3D] product's split (`tail.skinny_plan`)."""
    return (int(layer), N, D, H, Tc, int(pos), *skinny_plan(N, D, 3 * D, ln=True))


def fused_front_layer(
    layer: int, pos: int, row_pad: Optional[torch.Tensor], x: torch.Tensor,
    front: Dict[str, torch.Tensor], kc: torch.Tensor, vc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8. Same contract as `fused_front_layer_plain`; `row_pad` None means
    no pads."""
    N, S, D = x.shape
    if row_pad is None:
        row_pad = torch.zeros((N,), dtype=torch.int32, device=x.device)
    if x.device.type == "cpu":
        return fused_front_layer_plain(layer, pos, row_pad, x, front, kc, vc)
    name = "fused_front_layer"
    _require_cuda(name, x, kc, vc, *[front[key] for key in _FRONT_KEYS])
    row_pad = _int32_on(name, x.device, row_pad)
    L, Nc, H, Tc, Dh = kc.shape
    want = {"w": (L, D, 3 * D), "b": (L, 3 * D), "ln1_s": (L, D), "ln1_b": (L, D)}
    if (S != 1 or Nc != N or Dh != 64 or H * Dh != D or vc.shape != kc.shape
            or Tc > 448 or tuple(row_pad.shape) != (N,)
            or any(tuple(front[key].shape) != shape for key, shape in want.items())):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, kc {tuple(kc.shape)}, front "
            f"{ {key: tuple(front[key].shape) for key in _FRONT_KEYS} } (kernel takes "
            "S = 1, Dh = 64, Tc <= 448)")
    if not (0 <= layer < L and 0 <= pos < Tc):
        raise ValueError(f"{name}: layer {layer} / pos {pos} outside {L} / {Tc}")
    qkv = torch.empty((N, 3 * D), dtype=x.dtype, device=x.device)
    out = torch.empty((N, H, 1, Dh), dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.wdt_fused_front(
            x.data_ptr(), *[front[key].data_ptr() for key in _FRONT_KEYS],
            qkv.data_ptr(), kc.data_ptr(), vc.data_ptr(), row_pad.data_ptr(),
            out.data_ptr(), *front_int_args(layer, N, D, H, Tc, pos),
            kernels.stream_ptr(x.device)), name)
    fused_front_layer.launches += 1
    heads = qkv.view(N, 3, H, 1, Dh)
    return out, heads[:, 1], heads[:, 2]


fused_front_layer.launches = 0
