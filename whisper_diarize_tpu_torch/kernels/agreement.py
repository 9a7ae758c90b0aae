"""How a hand-written kernel is held against its plain PyTorch version in
bf16, the random inputs it is held on, and the planted faults the check
must reject.

Kernel and plain version round to bf16 in another order, so an element may
differ by a few units in the last place (ulp) of the value it lands on.
With `base` the tensor the kernel adds its result to (the residual x for
K3, nothing otherwise), the check asks of every element

    |got - ref| <= ULPS * ulp(max(|got|, |ref|, |base|)) + ATOL_RMS * rms(ref - base)

and of the whole tensor

    ||got - ref|| <= REL_L2 * ||ref - base||,

so a kernel is judged on the update it computes, not on the residual it
carries through. K3 rounds its running residual to bf16 after each of its
three updates, so an element may also carry a one-ulp flip of an
intermediate larger than its inputs and output: the ulp is taken at the
residual's magnitude as well, and ATOL_RMS is four unit roundoffs of the
update's rms. `random_blocks` draws every bias and layernorm parameter at
scale BIAS_SCALE, so a dropped bias or a wrong layer moves the update by
tens of percent; the `*_faults` generators build such results with the
plain versions, and `reject` fails unless the check refuses each of them.
K5 and K6 take int8 inputs: `quantize_cross_kv` and `quantize_tail_weights`
of such random tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch

ULPS = 4  # bf16 ulps at the element's magnitude (or its residual's)
ATOL_RMS = 2.0 ** -6  # four bf16 unit roundoffs of the update's rms
REL_L2 = 1e-2  # relative L2 error of the update
BIAS_SCALE = 0.5  # std of biases and layernorm shifts; layernorm scales are 1 + this


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x| (8 significant bits); 0 where x == 0."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, torch.zeros_like(m), torch.ldexp(torch.ones_like(m), e - 8))


@dataclasses.dataclass
class Agreement:
    max_abs_err: float
    worst: float  # max over elements of |got - ref| / elementwise bound
    rel_l2: float
    finite: bool

    @property
    def ok(self) -> bool:
        return self.finite and self.worst <= 1.0 and self.rel_l2 <= REL_L2

    def __str__(self) -> str:
        return (f"max_abs_err {self.max_abs_err:.4g}, worst {self.worst:.3g} of the "
                f"elementwise bound ({ULPS} ulp + {ATOL_RMS:.3g} rms), rel_l2 "
                f"{self.rel_l2:.3g} (tol {REL_L2:g}), finite {self.finite}")


def agreement(got: torch.Tensor, ref: torch.Tensor,
              base: Optional[torch.Tensor] = None) -> Agreement:
    g, r = got.float(), ref.float()
    upd = r if base is None else r - base.float()
    err = (g - r).abs()
    rms = upd.pow(2).mean().sqrt()
    mag = torch.maximum(g.abs(), r.abs())
    if base is not None:
        mag = torch.maximum(mag, base.float().abs())
    bound = ULPS * bf16_ulp(mag) + ATOL_RMS * rms
    tiny = torch.finfo(torch.float32).tiny
    return Agreement(
        max_abs_err=float(err.max()),
        worst=float((err / bound.clamp_min(tiny)).max()),
        rel_l2=float(err.norm() / upd.norm().clamp_min(tiny)),
        finite=bool(torch.isfinite(g).all()),
    )


def compare(tag: str, got: torch.Tensor, ref: torch.Tensor,
            base: Optional[torch.Tensor] = None) -> Agreement:
    """Print the agreement of kernel and plain version; raise on a miss."""
    a = agreement(got, ref, base)
    print(f"[kernels] {tag}: {a} -> {'ok' if a.ok else 'FAIL'}", flush=True)
    if not a.ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version ({a})")
    return a


def reject(tag: str, got: torch.Tensor, faulty: torch.Tensor,
           base: Optional[torch.Tensor] = None) -> Agreement:
    """The check must refuse a planted fault; raise if it lets one pass."""
    a = agreement(got, faulty, base)
    print(f"[kernels] planted fault {tag}: worst {a.worst:.3g}, rel_l2 "
          f"{a.rel_l2:.3g} -> {'caught' if not a.ok else 'MISSED'}", flush=True)
    if a.ok:
        raise AssertionError(f"planted fault {tag} passes the check ({a})")
    return a


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def randn(g: torch.Generator, device, *shape: int, scale: float = 1.0,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def random_blocks(L: int, D: int, g: torch.Generator, device,
                  dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The decoder weights K2 and K3 read, stacked `[L, Din, Dout]`: matrices
    at 1/sqrt(fan-in), biases and layernorm shifts at BIAS_SCALE, layernorm
    scales at 1 + BIAS_SCALE * N(0, 1)."""
    def w(din, dout):
        return randn(g, device, L, din, dout, scale=din ** -0.5, dtype=dtype)

    def b(n, mean=0.0):
        return (mean + randn(g, device, L, n, scale=BIAS_SCALE, dtype=torch.float32)).to(dtype)

    return {
        "o_w": w(D, D), "o_b": b(D), "ln2_s": b(D, 1.0), "ln2_b": b(D),
        "cq_w": w(D, D), "cq_b": b(D), "ck_w": w(D, D), "cv_w": w(D, D),
        "cv_b": b(D), "co_w": w(D, D), "co_b": b(D), "ln3_s": b(D, 1.0),
        "ln3_b": b(D), "fc1_w": w(D, 4 * D), "fc1_b": b(4 * D),
        "fc2_w": w(4 * D, D), "fc2_b": b(D),
    }


# ---------------------------------------------------------------------------
# planted faults, built with the plain versions
# ---------------------------------------------------------------------------

def k2_faults(xa, ck_w, cv_w, cv_b, n_heads: int
              ) -> Iterator[Tuple[str, int, torch.Tensor]]:
    """(name, index of k / v it replaces, faulty tensor)."""
    from ..ops.attn import cross_kv_build_plain

    k, v = cross_kv_build_plain(xa, ck_w, cv_w, torch.zeros_like(cv_b), n_heads)
    yield "K2 V bias dropped", 1, v
    yield "K2 K of the previous layer", 0, k.roll(1, dims=0)


def k1_faults(layer: int, q, k, v, ta_total) -> Iterator[Tuple[str, torch.Tensor]]:
    from ..ops.attn import cross_attn_layer_plain

    L, Dh = k.shape[0], q.shape[-1]
    yield "K1 wrong layer", cross_attn_layer_plain((layer + 1) % L, q, k, v, ta_total)
    yield "K1 q not scaled by Dh^-0.5", cross_attn_layer_plain(
        layer, (q.float() * Dh ** 0.5).to(q.dtype), k, v, ta_total)


def k4_faults(layer: int, q, pk, pv, dk, dv, anc_j, step: int, row_pad,
              prompt_len: int) -> Iterator[Tuple[str, torch.Tensor]]:
    """Planted on inputs with a random ancestry, step > 0 and non-zero row
    pads (each fault is the truth where those are trivial)."""
    from ..ops.attn import split_self_attn_layer_plain as plain

    B, K, _, Dh = q.shape
    own = torch.arange(K, dtype=anc_j.dtype, device=anc_j.device)
    yield "K4 ancestry ignored", plain(
        layer, q, pk, pv, dk, dv, own[None, :, None].expand_as(anc_j), step,
        row_pad, prompt_len)
    yield "K4 decode mask off by one (< step)", plain(
        layer, q, pk, pv, dk, dv, anc_j, step - 1, row_pad, prompt_len)
    yield "K4 row_pad ignored", plain(
        layer, q, pk, pv, dk, dv, anc_j, step, torch.zeros_like(row_pad), prompt_len)
    yield "K4 wrong layer", plain(
        (layer + 1) % pk.shape[0], q, pk, pv, dk, dv, anc_j, step, row_pad, prompt_len)
    yield "K4 q not scaled by Dh^-0.5", plain(
        layer, (q.float() * Dh ** 0.5).to(q.dtype), pk, pv, dk, dv, anc_j, step,
        row_pad, prompt_len)


def k3_faults(layer: int, x, self_out, blocks, k, v, beams: int, ta_total
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    from ..ops.tail import fused_tail_layer_plain

    for key in ("o_b", "cq_b", "co_b", "fc2_b"):
        dropped = dict(blocks, **{key: torch.zeros_like(blocks[key])})
        yield f"K3 {key} dropped", fused_tail_layer_plain(
            layer, x, self_out, dropped, k, v, beams, ta_total)
    yield "K3 wrong layer", fused_tail_layer_plain(
        (layer + 1) % k.shape[0], x, self_out, blocks, k, v, beams, ta_total)


def k5_faults(layer: int, q, k8, ks, v8, vs, ta_total
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of the int8 attention, each built on the plain version."""
    from ..ops.attn import cross_attn_layer_q8_plain as plain

    yield "K5 ks ignored", plain(layer, q, k8, torch.ones_like(ks), v8, vs, ta_total)
    yield "K5 another head's scales", plain(
        layer, q, k8, ks.roll(1, dims=2), v8, vs.roll(1, dims=2), ta_total)
    yield "K5 payload read as uint8", plain(
        layer, q, k8.view(torch.uint8), ks, v8.view(torch.uint8), vs, ta_total)
    # vs folded into the normalizer: sum(p * vs) instead of sum(p)
    Dh = q.shape[-1]
    qs = (q.float() * Dh ** -0.5).to(torch.bfloat16).float()
    s = torch.einsum("bqhd,bhtd->bhqt", qs, k8[layer, :, :, :ta_total].float())
    s = s * ks[layer, :, :, None, :ta_total]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = p * vs[layer, :, :, None, :ta_total]
    o = torch.einsum("bhqt,bhtd->bhqd", pv.to(torch.bfloat16).float(),
                     v8[layer, :, :, :ta_total].float())
    yield "K5 vs folded into the normalizer", (
        o / pv.sum(dim=-1, keepdim=True)).permute(0, 2, 1, 3).to(q.dtype)


def k6_faults(layer: int, x, self_out, blocks, k, v, beams: int, ta_total,
              ks=None, vs=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of the int8 tail in the form given: with int8 weights, the fc2
    row scale applied to the output columns (the column-scale epilogue
    reused) and cq's column scale dropped; with the int8 cache, ks ignored
    and vs folded in twice (into the scores as well)."""
    from ..ops.tail import fused_tail_layer_plain as plain

    if blocks["o_w"].dtype == torch.int8:
        D = x.shape[-1]
        deq = {m: blocks[m].float() * blocks[f"{m}s"][:, None, :]
               for m in ("o_w", "cq_w", "co_w", "fc1_w")}
        deq["fc2_w"] = blocks["fc2_w"].float() * blocks["fc2_ws"][:, None, :D]
        wrong = {key: t for key, t in blocks.items() if not key.endswith("_ws")}
        yield "K6 fc2 row scale applied to the output", plain(
            layer, x, self_out, dict(wrong, **deq), k, v, beams, ta_total, ks, vs)
        yield "K6 cq column scale dropped", plain(
            layer, x, self_out, dict(blocks, cq_ws=torch.ones_like(blocks["cq_ws"])),
            k, v, beams, ta_total, ks, vs)
    if ks is not None:
        yield "K6 ks ignored", plain(
            layer, x, self_out, blocks, k, v, beams, ta_total, torch.ones_like(ks), vs)
        yield "K6 vs applied to the scores too", plain(
            layer, x, self_out, blocks, k, v, beams, ta_total, ks * vs, vs)
