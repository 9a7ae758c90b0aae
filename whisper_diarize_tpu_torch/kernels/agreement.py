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

The f32 forms of K1-K6, K8 and K10 (`F32`, `F32_Q8`) are held the same way with f32
constants: the elementwise bound is ULPS_F32 f32 ulps at the element's (or
its residual's) magnitude plus ATOL_RMS_F32 of the update's rms, and the
whole tensor's relative L2 must stay under REL_L2_F32. The constants come
from the longest dot product, 4D = 5120 (fc2; D = 1280 for K2 and the
other products): a sum of n f32 terms with random signs, taken in another
order, lands about 2^-24 * sqrt(n / 2) of its terms' scale away, 3.0e-6
relative at n = 5120 even for a plain running sum; the kernels sum in
shorter chains and land closer (the H100's f32 forms lie 0 - 6e-7 from
their plain versions at large-v3 widths). REL_L2_F32 = 2^-17 (7.6e-6)
leaves 2.5x above that running-sum estimate; the elementwise term 2^-14 is
eight times it, the largest of ~10^7 such errors. Two faults must be
refused by at least 10x (`F32_REFUSAL`): the inputs rounded to TF32 (10
mantissa bits: 1.5e-4 - 6e-4 relative, 20x REL_L2_F32 and more), and the
bf16 form's rounding points (q * scale and p, or a product's output,
rounded to bf16: ~2e-3). K5 and K6's `kvq`
keep the TPU kernel's bf16 products (q * scale and p * vs), and a p that
lies within an f32 ulp of a bf16 rounding boundary may round the other way
in kernel and plain version. So does K6's query, which its K5 rounds to
bf16 from an f32 product that kernel and plain version sum in other
orders. At large-v3 widths (Ta 1500, 20 heads) such flips leave K5 and
K6 `kvq` up to 1.1e-5 from their float64 plain version (at N 8 and 40, Q
3 and 15, three seeds), while the faults land at 3.5e-4 (K6 kvq in TF32)
and above. `F32_Q8` takes K5's elementwise bf16 bound with REL_L2_Q8 =
2^-15 (3.1e-5): the faults are refused by 11x and more. A flip weighs
more in a narrow test (a few heads, tens of keys: 3.2e-5 at Ta 60), so
the tests hold the int8 forms at f32 at 1500 keys.

K7 computes in f32 and writes f32: it is held to an absolute bound instead
of the bf16 one (`F32_ATOL`, and the same relative L2), since a few bf16
ulps would let a wrong DFT span pass, or a kernel whose products take
TF32's 10-bit mantissas (`k7_faults` plants one).

The stream sums (K9b, K11) return one f32 scalar, held to its float64 value
(exact: the inputs are bf16): |got - ref| <= SUM_RTOL * sum|terms|, where
the terms are the max(x, s) (and K9b's v) it adds. A thread of K11a adds
some 250 values one after another at the tool's size, each addition off by
at most 2^-24 of the running sum, so 250 * 2^-24 < 2^-16 of sum|terms|
covers the worst case. The faults are planted on `stream_input`, zero-mean
values whose mean moves every 1 KB, at s = 0: each acts in every CTA and
moves the sum by far more than the tolerance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

ULPS = 4  # bf16 ulps at the element's magnitude (or its residual's)
ATOL_RMS = 2.0 ** -6  # four bf16 unit roundoffs of the update's rms
REL_L2 = 1e-2  # relative L2 error of the update
BIAS_SCALE = 0.5  # std of biases and layernorm shifts; layernorm scales are 1 + this
# K7's bound on the raw log10 mel (2.5e-4 after whisper's (x + 4) / 4). A
# DFT bin of small magnitude is a sum of 400 terms that cancel, and a low
# mel filter (one or two bins at 128 mels) carries its relative error into
# the log, so even f32 lies up to a few 1e-4 from the float64 value there
# (`chip_smoke.py` prints the distance for its input); TF32 products lie
# over a hundred times further from it (`k7_faults`).
F32_ATOL = 1e-3
SUM_RTOL = 2.0 ** -16  # of sum|terms|, for the stream sums (K9b, K11)
ULPS_F32 = 8  # f32 ulps at the element's magnitude (or its residual's)
ATOL_RMS_F32 = 2.0 ** -14  # of the update's rms, an element
REL_L2_F32 = 2.0 ** -17  # relative L2 error of the update
F32_REFUSAL = 10.0  # how far past the f32 check the f32 faults must land
REL_L2_Q8 = 2.0 ** -15  # K5 / K6 kvq at f32: bf16 flips of q or p * vs


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x| (8 significant bits); 0 where x == 0."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, torch.zeros_like(m), torch.ldexp(torch.ones_like(m), e - 8))


def f32_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of f32 numbers at |x| (24 significant bits); 0 where x == 0."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, torch.zeros_like(m), torch.ldexp(torch.ones_like(m), e - 24))


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """One check: `ulps` units in the last place (`ulp`) at the element's
    magnitude plus `atol_rms` of the update's rms an element, and the
    update's relative L2 error under `rel_l2`."""
    ulp: Callable[[torch.Tensor], torch.Tensor]
    ulps: float
    atol_rms: float
    rel_l2: float


BF16 = Tolerance(bf16_ulp, ULPS, ATOL_RMS, REL_L2)
F32 = Tolerance(f32_ulp, ULPS_F32, ATOL_RMS_F32, REL_L2_F32)
# K5 and K6 kvq at f32: bf16 products inside (elementwise bf16)
F32_Q8 = Tolerance(bf16_ulp, ULPS, ATOL_RMS, REL_L2_Q8)


@dataclasses.dataclass
class Agreement:
    max_abs_err: float
    worst: float  # max over elements of |got - ref| / elementwise bound
    rel_l2: float
    finite: bool
    rel_tol: float = REL_L2

    @property
    def ok(self) -> bool:
        return self.finite and self.worst <= 1.0 and self.rel_l2 <= self.rel_tol

    @property
    def excess(self) -> float:
        """How far past the check the result lies: the larger of `worst`
        and rel_l2 over its tolerance (inf where either is not finite, as
        against a fault that gives NaN)."""
        vals = (self.worst, self.rel_l2 / self.rel_tol)
        if not self.finite or not all(math.isfinite(v) for v in vals):
            return math.inf
        return max(vals)

    def __str__(self) -> str:
        return (f"max_abs_err {self.max_abs_err:.4g}, worst {self.worst:.3g} of the "
                f"elementwise bound, rel_l2 {self.rel_l2:.3g} (tol {self.rel_tol:g}), "
                f"finite {self.finite}")


def agreement(got: torch.Tensor, ref: torch.Tensor,
              base: Optional[torch.Tensor] = None,
              atol: Optional[float] = None, tol: Tolerance = BF16) -> Agreement:
    """The elementwise bound is `tol.ulps` ulps + `tol.atol_rms` of the
    update's rms, or `atol` where given (K7, an f32 kernel)."""
    g, r = got.float(), ref.float()
    upd = r if base is None else r - base.float()
    err = (g - r).abs()
    if atol is not None:
        bound = torch.full_like(err, atol)
    else:
        mag = torch.maximum(g.abs(), r.abs())
        if base is not None:
            mag = torch.maximum(mag, base.float().abs())
        bound = tol.ulps * tol.ulp(mag) + tol.atol_rms * upd.pow(2).mean().sqrt()
    tiny = torch.finfo(torch.float32).tiny
    return Agreement(
        max_abs_err=float(err.max()),
        worst=float((err / bound.clamp_min(tiny)).max()),
        rel_l2=float(err.norm() / upd.norm().clamp_min(tiny)),
        finite=bool(torch.isfinite(g).all()),
        rel_tol=tol.rel_l2,
    )


def compare(tag: str, got: torch.Tensor, ref: torch.Tensor,
            base: Optional[torch.Tensor] = None,
            atol: Optional[float] = None, tol: Tolerance = BF16) -> Agreement:
    """Print the agreement of kernel and plain version; raise on a miss."""
    a = agreement(got, ref, base, atol, tol)
    print(f"[kernels] {tag}: {a} -> {'ok' if a.ok else 'FAIL'}", flush=True)
    if not a.ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version ({a})")
    return a


def reject(tag: str, got: torch.Tensor, faulty: torch.Tensor,
           base: Optional[torch.Tensor] = None,
           atol: Optional[float] = None, tol: Tolerance = BF16,
           factor: float = 1.0) -> Agreement:
    """The check must refuse a planted fault, by `factor` (its `excess`)
    or more; raise if it does not."""
    a = agreement(got, faulty, base, atol, tol)
    caught = not a.ok and a.excess >= factor
    print(f"[kernels] planted fault {tag}: worst {a.worst:.3g}, rel_l2 "
          f"{a.rel_l2:.3g}, {a.excess:.3g}x the check -> "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    if not caught:
        raise AssertionError(f"planted fault {tag} passes the check, or is refused by "
                             f"less than {factor:g}x ({a})")
    return a


def _sum_line(got, ref, mass: float) -> Tuple[float, float]:
    err, tol = abs(float(got) - float(ref)), SUM_RTOL * mass
    return (err if math.isfinite(float(got)) else math.inf), tol


def compare_sum(tag: str, got: torch.Tensor, ref: torch.Tensor, mass: float) -> float:
    """Hold a stream sum to its float64 value `ref`; raise on a miss.
    Returns |got - ref|."""
    err, tol = _sum_line(got, ref, mass)
    ok = err <= tol
    print(f"[kernels] {tag}: got {float(got):.9g}, float64 {float(ref):.9g}, |err| "
          f"{err:.4g} (tol {tol:.4g} = 2^-16 of sum|terms|) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{tag}: the sum is {err:.4g} from its float64 value (tol {tol:.4g})")
    return err


def reject_sum(tag: str, got: torch.Tensor, faulty: torch.Tensor, mass: float) -> float:
    """The sum check must refuse a planted fault; raise if it lets one pass.
    Returns how many tolerances the fault moves the sum."""
    err, tol = _sum_line(got, faulty, mass)
    print(f"[kernels] planted fault {tag}: {err / tol:.3g} x the tolerance -> "
          f"{'caught' if err > tol else 'MISSED'}", flush=True)
    if err <= tol:
        raise AssertionError(f"planted fault {tag} passes the sum check")
    return err / tol


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

STREAM_OFFSETS = (1.5, -1.0, 0.5, -2.0, 1.0, -0.5, 0.5)  # sum 0


def stream_input(g: torch.Generator, device, *shape: int) -> torch.Tensor:
    """bf16 noise (std 0.5) plus an offset that moves every 512 elements
    (1 KB) through STREAM_OFFSETS: zero-mean overall, but which bytes a sum
    reads, and in which round, shows in its value."""
    n = math.prod(shape)
    x = torch.randn((n,), generator=g, device=device) * 0.5
    block = torch.arange(n, device=device) // 512 % len(STREAM_OFFSETS)
    x += torch.tensor(STREAM_OFFSETS, device=device)[block]
    return x.view(shape).to(torch.bfloat16)


def stream_terms(x: torch.Tensor, s: float) -> Tuple[torch.Tensor, float]:
    """K11's float64 value of sum(max(x, s)) and sum|terms|."""
    t = x.double().clamp_min(s)
    return t.sum(), float(t.abs().sum())


def kv_terms(layer: int, k: torch.Tensor, v: torch.Tensor, s: float
             ) -> Tuple[torch.Tensor, float]:
    """K9b's float64 value and sum|terms|."""
    kt, vt = k[layer].double().clamp_min(s), v[layer].double()
    return kt.sum() + vt.sum(), float(kt.abs().sum() + vt.abs().sum())

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


def random_front(L: int, D: int, g: torch.Generator, device,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """K8's packed front weights (`ops/front.py::pack_front_weights` layout)
    drawn as `random_blocks` draws its own: w [L, D, 3D] at 1/sqrt(D), the
    q and v biases and ln1's shift at BIAS_SCALE, ln1's scale at 1 +
    BIAS_SCALE * N(0, 1); k's third of "b" is zero (k has no bias)."""
    b = randn(g, device, L, 3 * D, scale=BIAS_SCALE, dtype=torch.float32)
    b[:, D:2 * D] = 0.0
    return {
        "w": randn(g, device, L, D, 3 * D, scale=D ** -0.5, dtype=dtype),
        "b": b.to(dtype),
        "ln1_s": (1.0 + randn(g, device, L, D, scale=BIAS_SCALE, dtype=torch.float32)).to(dtype),
        "ln1_b": randn(g, device, L, D, scale=BIAS_SCALE, dtype=dtype),
    }


# ---------------------------------------------------------------------------
# planted faults, built with the plain versions
# ---------------------------------------------------------------------------

def k2_faults(xa, ck_w, cv_w, cv_b, n_heads: int
              ) -> Iterator[Tuple[str, int, torch.Tensor]]:
    """(name, index of k / v it replaces, faulty tensor): the V bias dropped,
    K of the previous layer, and (B >= 2) one tile of the kernel's walk
    (`attn.cross_kv_tile`: the first rows and first two heads of stream 1's
    K, layer 0; the f32 form's tile rows for f32 xa) holding stream 0's
    values: a tile stored to the wrong stream."""
    from ..ops.attn import CROSS_KV_COLS, cross_kv_build_plain, cross_kv_rows

    k, v = cross_kv_build_plain(xa, ck_w, cv_w, torch.zeros_like(cv_b), n_heads)
    yield "K2 V bias dropped", 1, v
    yield "K2 K of the previous layer", 0, k.roll(1, dims=0)
    if xa.shape[0] >= 2:
        heads = CROSS_KV_COLS // 64
        rows = min(cross_kv_rows(xa.dtype == torch.float32), xa.shape[1])
        bad = k.clone()
        bad[0, 1, :heads, :rows] = k[0, 0, :heads, :rows]
        yield "K2 a tile written to the wrong stream", 0, bad


def _split_faults(tag: str, layer: int, q, k, v, ta_total, ks=None, vs=None,
                  rescale: bool = True) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of the key split (`attn.cross_attn_plan`, planted where it has
    two spans or more): the middle span dropped from the cluster's combine,
    and (`rescale`) every span's acc and l summed as they stand, without
    the exp(m - max m) rescale."""
    from ..ops.attn import combine_span_states, cross_attn_span_states

    states = cross_attn_span_states(layer, q, k, v, ta_total, ks=ks, vs=vs)
    if len(states) < 2:
        return
    yield f"{tag} a span dropped", combine_span_states(
        states[:len(states) // 2] + states[len(states) // 2 + 1:], q.dtype)
    if rescale:
        flat = [(a, torch.zeros_like(m), l) for a, m, l in states]
        yield f"{tag} spans combined without their rescale", combine_span_states(flat, q.dtype)


def k1_faults(layer: int, q, k, v, ta_total) -> Iterator[Tuple[str, torch.Tensor]]:
    from ..ops.attn import cross_attn_layer_plain

    L, Dh = k.shape[0], q.shape[-1]
    yield "K1 wrong layer", cross_attn_layer_plain((layer + 1) % L, q, k, v, ta_total)
    yield "K1 q not scaled by Dh^-0.5", cross_attn_layer_plain(
        layer, (q.float() * Dh ** 0.5).to(q.dtype), k, v, ta_total)
    yield from _split_faults("K1", layer, q, k, v, ta_total)


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


def _span_products(h: torch.Tensor, w: torch.Tensor, span_k: int):
    """The f32 partial products of h @ w over spans of span_k input rows."""
    hf, wf = h.float(), w.float()
    return [torch.matmul(hf[..., k0:k0 + span_k], wf[k0:k0 + span_k])
            for k0 in range(0, w.shape[0], span_k)]


def tail_split_faults(tag: str, layer: int, x, self_out, blocks, k, v, beams: int, ta_total,
                       ks=None, vs=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of K3 / K6's skinny GEMM split (`ops/tail.py::tail_plans`; `tag`
    names the kernel), built on
    the plain tail with its products summed span by span: fc2's middle span
    dropped from the combine, fc2's first span combined twice (planted
    where fc2 has two spans or more), and both layer norms' statistics
    taken over their product's first span only (where cq and fc1 have two
    spans or more)."""
    from ..ops.tail import fused_tail_layer_plain, tail_plans

    N, D = x.shape[0], x.shape[-1]
    plans = dict(zip(("o", "cq", "co", "fc1", "fc2"),
                     tail_plans(N, D, blocks["o_w"].dtype == torch.int8,
                                x.dtype == torch.float32)))
    a = (layer, x, self_out, blocks, k, v, beams, ta_total, ks, vs)

    def split_proj(slip):
        def proj(name, h, w, b, col_scale):
            parts = _span_products(h, w, plans[name].span_k)
            if name == "fc2":
                slip(parts)
            y = parts[0]
            for part in parts[1:]:
                y = y + part
            if col_scale is not None:
                y = y * col_scale.float()
            return y + b.float()
        return proj

    if plans["fc2"].n_split > 1:
        yield f"{tag} a span of fc2's split dropped", fused_tail_layer_plain(
            *a, proj=split_proj(lambda parts: parts.pop(len(parts) // 2)))
        yield f"{tag} fc2's first span combined twice", fused_tail_layer_plain(
            *a, proj=split_proj(lambda parts: parts.append(parts[0])))
    if plans["cq"].n_split > 1 and plans["fc1"].n_split > 1:
        def one_span(name, h, s, b):
            hf = h.float()
            part = hf[..., :plans["cq" if name == "ln2" else "fc1"].span_k]
            mu = part.mean(dim=-1, keepdim=True)
            var = (part - mu).pow(2).mean(dim=-1, keepdim=True)
            return ((hf - mu) * torch.rsqrt(var + 1e-5) * s.float() + b.float()).to(h.dtype)

        yield f"{tag} layer-norm statistics over one span only", fused_tail_layer_plain(
            *a, ln=one_span)


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
    yield from _split_faults("K5", layer, q, k8, v8, ta_total, ks, vs, rescale=False)


def k6_faults(layer: int, x, self_out, blocks, k, v, beams: int, ta_total,
              ks=None, vs=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of the int8 tail in the form given: with int8 weights, the fc2
    row scale applied to the output columns (the column-scale epilogue
    reused) and cq's column scale dropped; with the int8 cache, ks ignored
    and vs folded in twice (into the scores as well). The split's slips are
    `tail_split_faults`."""
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 explicit mantissa bits, ties away from
    zero as `cvt.rna.tf32.f32` rounds): what a tensor core's TF32 product
    reads."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_inputs(*args):
    """`args` with every f32 tensor among them (and every f32 tensor of a
    dict among them) rounded to TF32: what a product in TF32 reads."""
    def r(a):
        if isinstance(a, dict):
            return {key: r(t) for key, t in a.items()}
        if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            return tf32_round(a)
        return a
    return [r(a) for a in args]


def tf32x3_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in
    f32): how the f32 forms of K1, K2, K3 (with K6, K8) and K10 split each
    operand of their tensor-core products (`csrc/common.cuh::tf32_split`)."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 kernels' 3xTF32 product: lo_a hi_b + hi_a lo_b +
    hi_a hi_b summed in f32, lo_a lo_b dropped (a product of two TF32
    values is exact in f32; the sums run in the CPU's order, not the tensor
    core's)."""
    ah, al = tf32x3_split(a)
    bh, bl = tf32x3_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded to f32 toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _tc_chain(a: torch.Tensor, b: torch.Tensor, products: int, rz: bool) -> torch.Tensor:
    """a [..., k] @ b [k, n] as one chain of tensor-core products from zero:
    3xTF32 (`products` 3) or TF32 alone (hi hi', `products` 1). `rz`: a
    model of the accumulator, each k8 step's products (8-term dot products,
    taken exactly) added to it in turn and the sum rounded to f32 toward
    zero, as the tensor cores truncate; else the sums in the CPU's f32
    order."""
    if not rz:
        return tf32_round(a) @ tf32_round(b) if products == 1 else tf32x3_matmul(a, b)
    ah, al = tf32x3_split(a)
    bh, bl = tf32x3_split(b)
    terms = [(ah, bh)] if products == 1 else [(al, bh), (ah, bl), (ah, bh)]
    acc = torch.zeros(a.shape[:-1] + b.shape[1:], dtype=torch.float64, device=a.device)
    for s in range(0, b.shape[0], 8):
        for x, y in terms:
            acc = _f32_toward_zero(acc + x[..., s:s + 8].double() @ y[s:s + 8].double()).double()
    return acc.float()


def tf32x3_chains(a: torch.Tensor, b: torch.Tensor, chain: int, products: int = 3,
                  rz: bool = False) -> torch.Tensor:
    """a [..., K] @ b [K, n] in f32 as the f32 kernels' tensor cores take
    it: every `chain` k rows one chain of products from zero (`_tc_chain`),
    the chains' sums added in f32 in k order (on the CUDA cores)."""
    out = None
    for k0 in range(0, b.shape[0], chain):
        part = _tc_chain(a[..., k0:k0 + chain], b[k0:k0 + chain], products, rz)
        out = part if out is None else out + part
    return out


K2_SLOT = 32  # k rows a K2-f32 ring slot: one 128-byte swizzle row of f32


def k2_tf32x3_model(xa, ck_w, cv_w, cv_b, n_heads: int, chain: int = K2_SLOT,
                    products: int = 3, rz: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-f32 on the CPU in the card's order: per layer, xa @ ck_w and
    xa @ cv_w with each ring slot's (`chain`, 32 k rows) 3xTF32 products
    from zero, the slots' sums added in f32 in slot order, V's bias in f32,
    then the head split [L, B, H, Ta, Dh]. `chain` D is one running
    accumulator; `products` 1 plain TF32; `rz` the truncating accumulator
    (`tf32x3_chains`). For the tests and `chip_smoke.py` only: the plain
    version stays the reference."""
    L, D, HD = ck_w.shape
    B, Ta, _ = xa.shape
    x = xa.float().reshape(B * Ta, D)

    def heads(y):  # [B * Ta, HD] -> [B, H, Ta, Dh]
        return y.view(B, Ta, n_heads, HD // n_heads).permute(0, 2, 1, 3)

    k = torch.stack([heads(tf32x3_chains(x, ck_w[l].float(), chain, products, rz))
                     for l in range(L)])
    v = torch.stack([heads(tf32x3_chains(x, cv_w[l].float(), chain, products, rz)
                           + cv_b[l].float()) for l in range(L)])
    return k.contiguous(), v.contiguous()


def skinny_tf32x3_model(h: torch.Tensor, w: torch.Tensor, plan, products: int = 3,
                        rz: bool = False, running: bool = False) -> torch.Tensor:
    """One product of the f32 skinny GEMM (`csrc/tail.cu`) on the CPU in the
    card's order: h [..., Din] f32 @ w [Din, Dout] (f32, or int8: exact in
    TF32, its lo zero, so its third product adds nothing: a_lo w + a_hi w)
    on the split `plan` (`ops/tail.py::skinny_plan`). A span's rows go to
    the 4 // (bn // 32) warps that share a 32-column chunk, each taking
    4 // that many 16-row groups of every 64-row tile; each group's 3xTF32
    products start from zero and add to its warp's f32 partial tile by
    tile, the warps' partials add in warp order and the spans' in span
    order. `running`: each warp's partial one chain of products over its
    rows (no group from zero); `products`, `rz` as `tf32x3_chains`."""
    hf, wf = h.float(), w.float()
    ksplit = 4 // (plan.bn // 32)
    kg = 4 // ksplit
    Din = w.shape[0]
    total = None
    for k0 in range(0, Din, plan.span_k):
        tiles = min(plan.span_k, Din - k0) // 64
        span = None
        for q in range(ksplit):
            rows = torch.cat([torch.arange(16) + k0 + 64 * j + 16 * (kg * q + gi)
                              for j in range(tiles) for gi in range(kg)])
            part = tf32x3_chains(hf[..., rows], wf[rows], rows.numel() if running else 16,
                                 products, rz)
            span = part if span is None else span + part
        total = span if total is None else total + span
    return total


def skinny_tf32x3_proj(N: int, D: int, int8: bool = False, **kw) -> Callable:
    """`proj` for `ops/tail.py::fused_tail_layer_plain`: the tail's five
    products as `skinny_tf32x3_model` on their f32 plans
    (`tail_plans(N, D, int8, f32=True)`), then the column scale and the
    bias in f32: K3-f32's (K6-f32 `wq`'s) products in the card's order."""
    from ..ops.tail import tail_plans

    plans = dict(zip(("o", "cq", "co", "fc1", "fc2"), tail_plans(N, D, int8, f32=True)))

    def proj(name, h, w, b, col_scale):
        y = skinny_tf32x3_model(h, w, plans[name], **kw)
        if col_scale is not None:
            y = y * col_scale.float()
        return y + b.float()

    return proj


def _tf32x3_tiles(qs, kl, vl, t0: int, t1: int, tile: int = 64):
    """The f32 kernels' flash recurrence over keys [t0, t1) in `tile`-key
    steps with 3xTF32 products: qs [B, H, Q, Dh] (already scaled), kl / vl
    [B, H, T, Dh]; the running max moves once a step, p = exp(s - m) in
    f32, the normalizer sums p. Returns (acc, m, l)."""
    m = torch.full(qs.shape[:-1], -1e30, dtype=torch.float32, device=qs.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    for a in range(t0, t1, tile):
        t = slice(a, min(a + tile, t1))
        s = tf32x3_matmul(qs, kl[..., t, :].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + tf32x3_matmul(p, vl[..., t, :])
        m = m_new
    return acc, m, l


def k1_tf32x3_model(layer: int, q, k, v, ta_total=None) -> torch.Tensor:
    """K1-f32 on the CPU in the card's order: the key split of
    `attn.cross_attn_plan(f32=True)`, 64-key tiles with the running max
    moving once a tile, the cluster's combine (`attn.combine_span_states`),
    and both products in 3xTF32 (q * Dh^-0.5 split once). For the tests and
    `chip_smoke.py` only: the plain version stays the reference."""
    from ..ops.attn import combine_span_states, cross_attn_plan

    B, Q, H, Dh = q.shape
    ta = k.shape[3] if ta_total is None else int(ta_total)
    n_span, span_keys = cross_attn_plan(B, H, Q, ta, f32=True)
    qs = q.float().permute(0, 2, 1, 3) * Dh ** -0.5
    kl, vl = k[layer].float(), v[layer].float()
    return combine_span_states(
        [_tf32x3_tiles(qs, kl, vl, r * span_keys, min((r + 1) * span_keys, ta))
         for r in range(n_span)], q.dtype)


def k10_tf32x3_model(q, k, v, ta_total=None) -> torch.Tensor:
    """K10-f32 on the CPU in the card's order, both forms: q and k each
    times Dh^-0.25 in f32, one sweep of 64-key tiles with the running max
    moving once a tile, both products in 3xTF32, o / l. For the tests and
    `chip_smoke.py` only: the plain versions stay the reference."""
    from ..ops.attn import qk_scaled

    ta = q.shape[-2] if ta_total is None else int(ta_total)
    acc, _, l = _tf32x3_tiles(qk_scaled(q.float()), qk_scaled(k.float()), v.float(), 0, ta)
    return acc / l[..., None]


def split_attend(layer: int, q, k, v, ta_total, ks=None, vs=None) -> torch.Tensor:
    """The cross attention in the kernels' order (`attn.cross_attn_split_plain`):
    the tail's attention in the f32 check's reference for K6 `kvq`, whose K5
    rounds p * vs to bf16 against its span's running max."""
    from ..ops.attn import cross_attn_split_plain

    return cross_attn_split_plain(layer, q, k, v, ta_total, ks=ks, vs=vs)


def _bf16_products(name, h, w, b, col_scale):
    """A tail product rounded to bf16, as the bf16 form rounds it."""
    from ..ops.tail import _proj

    y = _proj(h, w, b, col_scale)
    return y.to(torch.bfloat16).to(y.dtype)


def k1_f32_faults(layer: int, q, k, v, ta_total) -> Iterator[Tuple[str, torch.Tensor]]:
    """The f32 forms' two faults for K1 (`F32_REFUSAL`): the inputs in TF32,
    and the bf16 form's rounding points (q * Dh^-0.5 and p to bf16)."""
    from ..ops.attn import cross_attn_layer_plain as plain

    yield "K1 TF32 inputs", plain(layer, *tf32_inputs(q, k, v), ta_total)
    yield "K1 bf16 rounding points", plain(layer, q, k, v, ta_total, rounding=torch.bfloat16)


def k2_f32_faults(xa, ck_w, cv_w, cv_b, n_heads: int
                  ) -> Iterator[Tuple[str, int, torch.Tensor]]:
    """(name, index of k / v it replaces, faulty tensor): the products in
    TF32, and the output rounded to bf16 (K2's one rounding point)."""
    from ..ops.attn import cross_kv_build_plain as plain

    tk, tv = plain(*tf32_inputs(xa, ck_w, cv_w, cv_b), n_heads)
    yield "K2 TF32 inputs (k)", 0, tk
    yield "K2 TF32 inputs (v)", 1, tv
    k, v = plain(xa, ck_w, cv_w, cv_b, n_heads)
    yield "K2 bf16 rounding point (k)", 0, k.to(torch.bfloat16).float()
    yield "K2 bf16 rounding point (v)", 1, v.to(torch.bfloat16).float()


def k4_f32_faults(layer: int, q, pk, pv, dk, dv, anc_j, step: int, row_pad,
                  prompt_len: int) -> Iterator[Tuple[str, torch.Tensor]]:
    """As `k1_f32_faults`, for K4."""
    from ..ops.attn import split_self_attn_layer_plain as plain

    yield "K4 TF32 inputs", plain(layer, *tf32_inputs(q, pk, pv, dk, dv), anc_j, step,
                                  row_pad, prompt_len)
    yield "K4 bf16 rounding points", plain(layer, q, pk, pv, dk, dv, anc_j, step, row_pad,
                                           prompt_len, rounding=torch.bfloat16)


def k5_f32_faults(layer: int, q, k8, ks, v8, vs, ta_total
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """K5's f32 form keeps the TPU kernel's bf16 products; its faults, on
    the split model (its f32 reference): q and the scales in TF32, and the
    output rounded to bf16 (the bf16 form's last rounding point)."""
    tq, tks, tvs = tf32_inputs(q, ks, vs)
    yield "K5 TF32 inputs", split_attend(layer, tq, k8, v8, ta_total, tks, tvs)
    yield "K5 bf16 rounding point (output)", split_attend(
        layer, q, k8, v8, ta_total, ks, vs).to(torch.bfloat16).float()


def tail_f32_faults(tag: str, layer: int, x, self_out, blocks, k, v, beams: int, ta_total,
                    ks=None, vs=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """The f32 forms' two faults for K3 / K6 (`tag`), on the tail's f32
    reference (`split_attend` over the int8 cache): every input in TF32, and
    the bf16 form's rounding points (each product's output rounded to bf16
    and, over an f32 cache, the attention's q * Dh^-0.5 and p)."""
    from ..ops.attn import cross_attn_layer_plain
    from ..ops.tail import fused_tail_layer_plain as plain

    attend = split_attend if ks is not None else None
    t = tf32_inputs(x, self_out, blocks, k, v, ks, vs)
    yield f"{tag} TF32 inputs", plain(layer, *t[:5], beams, ta_total, t[5], t[6],
                                      attend=attend)
    if ks is None:
        def attend(layer, q, k, v, ta_total, ks, vs):
            return cross_attn_layer_plain(layer, q, k, v, ta_total, rounding=torch.bfloat16)
    yield f"{tag} bf16 rounding points", plain(layer, x, self_out, blocks, k, v, beams,
                                               ta_total, ks, vs, proj=_bf16_products,
                                               attend=attend)


def k7_faults(audio: torch.Tensor, n_mels: int) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of the fused log-mel, on the plain version's pieces: the third
    DFT basis span (window samples 320..399) dropped, |re| + |im| taken for
    the power, and the DFT in TF32 (audio and bases rounded to TF32, f32
    sums: the precision K7 must not take); and one of the FFT's, on its walk
    (`mel.log_mel_fft_walk`): the real split's twiddle conjugated,
    e^(+2 pi i k / 400)."""
    from ..ops import mel

    tab, itab = (torch.from_numpy(t) for t in mel.fft_tables(n_mels))
    tab = tab.clone()
    tab[mel.T_W400 + 1:mel.T_W400 + 2 * (mel.FFT_N + 1):2] *= -1.0
    yield "K7 split twiddle conjugated", mel.log_mel_fft_walk(audio.float(), n_mels, tab, itab)

    a, b, c = mel._frame_rows(audio.float())
    c0, c1, c2, s0, s1, s2 = mel._bases(a.device)
    re, im = a @ c0 + b @ c1, a @ s0 + b @ s1
    yield "K7 third DFT span dropped", mel._mel_log10(re * re + im * im, n_mels)
    re, im = re + c @ c2, im + c @ s2
    yield "K7 |re| + |im| as the power", mel._mel_log10(re.abs() + im.abs(), n_mels)
    a, b, c = mel._frame_rows(tf32_round(audio))
    c0, c1, c2, s0, s1, s2 = (tf32_round(m) for m in mel._bases(a.device))
    re, im = a @ c0 + b @ c1 + c @ c2, a @ s0 + b @ s1 + c @ s2
    yield "K7 DFT in TF32", mel._mel_log10(re * re + im * im, n_mels)


def front_self_slot_dropped(layer: int, pos: int, row_pad, x, front, kc, vc):
    """`fused_front_layer` with a planted fault, in its plain version on the
    tensors' device: the step's own slot left out of its self-attention.
    Same arguments and effect on kc / vc; `row_pad` None means no pads."""
    from ..ops.front import fused_front_layer_plain

    if row_pad is None:
        row_pad = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
    return fused_front_layer_plain(layer, pos, row_pad, x, front, kc, vc,
                                   keep=torch.arange(kc.shape[3], device=kc.device) != pos)


def k8_faults(layer: int, pos: int, row_pad, x, front, kc, vc
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of the greedy front, judged on self_out; each built on clones
    of the caches. Planted at pos > 0 with some row_pad[n] > 0 (each fault
    is the truth where those are trivial)."""
    from ..ops import front as fr
    from ..ops.attn import _acc, qk_scaled

    def plain(rp=row_pad, weights=front, keep=None):
        return fr.fused_front_layer_plain(layer, pos, rp, x, weights, kc.clone(),
                                          vc.clone(), keep)[0]

    yield "K8 self slot omitted", front_self_slot_dropped(
        layer, pos, row_pad, x, front, kc.clone(), vc.clone())[0]
    yield "K8 newest cached row omitted", plain(
        keep=torch.arange(kc.shape[3], device=kc.device) != pos - 1)
    yield "K8 row_pad ignored", plain(rp=torch.zeros_like(row_pad))
    D = x.shape[-1]
    bias = front["b"].clone()
    bias[:, D:2 * D] = bias[:, :D]  # q's bias on k
    yield "K8 bias added to k", plain(weights=dict(front, b=bias))
    kl, vl = kc.clone(), vc.clone()
    fr.fused_front_layer_plain(layer, pos, row_pad, x, front, kl, vl)
    q = fr.front_qkv_plain(layer, x, front, kc.shape[2])[0]
    yield "K8 k not scaled by Dh^-0.25", fr.attend(
        qk_scaled(q), _acc(kl[layer]), vl[layer], fr.valid_slots(pos, row_pad, kc.shape[3]))


def k10_faults(q, k, v, ta_total: int, single_pass: bool
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of the encoder attention: the key padding left unmasked (keys
    zero-padded to the next multiple of 512, as the TPU kernel pads them,
    and all attended), the softmax taken over the query axis, and each
    64-key tile's P V taken against the V of the ring stage before it (the
    slot read before its copy landed: the previous tile's V, zeros for the
    first)."""
    from ..ops.attn import qk_scaled
    from ..ops.encoder_attn import encoder_self_attention_plain

    T = q.shape[-2]
    TP = -(-T // 512) * 512
    pad = [torch.nn.functional.pad(x, (0, 0, 0, TP - T)) for x in (q, k, v)]
    yield "K10 key padding not masked", encoder_self_attention_plain(
        *pad, TP, single_pass)[..., :T, :]
    s = torch.matmul(qk_scaled(q), qk_scaled(k)[..., :ta_total, :].transpose(-1, -2))
    p = torch.softmax(s, dim=-2).to(v.dtype)
    yield "K10 softmax over the query axis", torch.matmul(
        p.float(), v[..., :ta_total, :].float()).to(q.dtype)
    v_prev = torch.nn.functional.pad(v, (0, 0, 64, 0))[..., :T, :]
    yield "K10 V of the previous ring stage", encoder_self_attention_plain(
        q, k, v_prev, ta_total, single_pass)


def k8_f32_faults(layer: int, pos: int, row_pad, x, front, kc, vc
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The f32 form's two faults for K8 (`F32_REFUSAL`), judged on self_out
    and built on clones of the caches: every input in TF32, and the bf16
    form's rounding points (q and k each scaled by Dh^-0.25 and rounded to
    bf16, the weights bf16(p / l)). Planted at pos > 0: at pos 0 the one
    slot takes weight 1 and the bf16 fault is the truth."""
    from ..ops.front import fused_front_layer_plain as plain

    tx, tf, tk, tv = tf32_inputs(x, front, kc, vc)
    yield "K8 TF32 inputs", plain(layer, pos, row_pad, tx, tf, tk, tv)[0]
    yield "K8 bf16 rounding points", plain(layer, pos, row_pad, x, front, kc.clone(),
                                           vc.clone(), rounding=torch.bfloat16)[0]


def k10_f32_faults(q, k, v, ta_total: int, single_pass: bool
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The f32 form's two faults for K10 (`F32_REFUSAL`): q, k, v in TF32,
    and the bf16 form's rounding points (the scaled q and k rounded to
    bf16, p rounded before P V)."""
    from ..ops.encoder_attn import encoder_self_attention_plain as plain

    yield "K10 TF32 inputs", plain(*tf32_inputs(q, k, v), ta_total, single_pass)
    yield "K10 bf16 rounding points", plain(q, k, v, ta_total, single_pass,
                                            rounding=torch.bfloat16)


def k11a_faults(x: torch.Tensor, s: float, ctas: int) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of `stream_sum` over `ctas` CTAs, as float64 sums: s ignored,
    and the grid-stride loop's last pass dropped."""
    from ..ops.stream import grid_stride_pass

    yield "K11a s ignored", x.double().sum()
    t = x.double().clamp_min(s).flatten()
    whole, per = t.numel() // 8 * 8, grid_stride_pass(ctas)
    last = (-(-whole // per) - 1) * per
    yield "K11a last grid-stride pass dropped", t[:last].sum() + t[whole:].sum()


def k11b_faults(x: torch.Tensor, s: float, nbuf: int, stage_bytes: int, ctas: int
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of `stream_sum_pipelined` (`ops/stream.py::stage_shares`), as
    float64 sums: s ignored; each CTA's last stage dropped; every slot read
    without waiting for its barrier phase to flip, so that stage j sums the
    previous round's stage j - nbuf in its slot (nothing in the first
    round)."""
    from ..ops.stream import stage_shares

    yield "K11b s ignored", x.double().sum()
    t = x.double().clamp_min(s).flatten()
    whole, per = t.numel() // 8 * 8, stage_bytes // 2
    shares = stage_shares(t.numel(), stage_bytes, ctas)
    n_stage = shares[-1].stop
    stages = torch.nn.functional.pad(t[:whole], (0, n_stage * per - whole)).view(n_stage, per)
    sums, tail = stages.sum(dim=1), t[whole:].sum()
    def picked(idx):
        return sums[torch.tensor(idx, dtype=torch.long, device=sums.device)].sum()

    yield "K11b each CTA's last stage dropped", (
        sums.sum() - picked([r.stop - 1 for r in shares if len(r)]) + tail)
    yield "K11b slots read before their barrier phase flips", picked(
        [j - nbuf for r in shares for j in r if j - nbuf >= r.start]) + tail


def k9b_faults(layer: int, k: torch.Tensor, v: torch.Tensor, s: float
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of `kv_stream_sum`, as float64 sums: s ignored, and each CTA's
    (each (b, h) slab's) last 64-key tile dropped."""
    yield "K9b s ignored", k[layer].double().sum() + v[layer].double().sum()
    last = (k.shape[3] - 1) // 64 * 64
    yield "K9b each CTA's last tile dropped", (
        k[layer, :, :, :last].double().clamp_min(s).sum() + v[layer, :, :, :last].double().sum())


def k9_faults(layer: int, q, k, v, ta_total: int, flat: bool
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Slips of K1's forms (K9a / K9c / K9d), built on the plain version:
    the key padding unmasked (planted where Ta > ta_total), the wrong layer,
    and for the flat form (`flat`) the combine without its rescale: every
    span's acc and l summed as they stand, each span's p taken against its
    own max."""
    from ..ops.attn import KEY_TILE, cross_attn_layer_plain

    L, Ta, Dh = k.shape[0], k.shape[3], q.shape[-1]
    yield "K9 key padding unmasked", cross_attn_layer_plain(layer, q, k, v, Ta)
    yield "K9 wrong layer", cross_attn_layer_plain((layer + 1) % L, q, k, v, ta_total)
    if not flat:
        return
    qs = (q.float() * Dh ** -0.5).to(k.dtype).float()
    acc, l = 0.0, 0.0
    for t0 in range(0, min(Ta, ta_total), KEY_TILE):
        t = slice(t0, min(t0 + KEY_TILE, ta_total))
        sc = torch.einsum("bqhd,bhtd->bhqt", qs, k[layer, :, :, t].float())
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + torch.einsum("bhqt,bhtd->bhqd", p.to(v.dtype).float(),
                                 v[layer, :, :, t].float())
    yield "K9d spans combined without their rescale", (acc / l).permute(0, 2, 1, 3).to(q.dtype)
