"""The stream sums, each beside its plain PyTorch version: K11a
`stream_sum` and K11b `stream_sum_pipelined` (what a plain stream of bf16
bytes reaches on the card, two ways), and K9b `kv_stream_sum` (one layer of
the cross cache walked as K1 walks it, without the attention).

Counterpart of `tools/bench_dma.py` (`auto_sum`, `manual_sum`) and
`tools/bench_attn_kernel.py::_sum_6d`. Each returns the f32 scalar
sum of max(f32 x, s) (K9b: over k, plus the plain sum over v). The plain
versions sum in float64, exact for bf16 inputs, and round the result to f32.

Dispatch as in `ops/attn.py`: a wrapper runs its plain version only for a
tensor on the CPU; on a CUDA tensor it launches its kernel
(`csrc/stream_sum.cu`) or raises. Each counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

from typing import List

import torch

from .. import kernels
from .attn import _require_cuda

# the kernels' shapes, as `csrc/stream_sum.cu` fixes them
SUM_CTAS_PER_SM = 4  # K11a's grid: CTAs of SUM_THREADS an SM
SUM_THREADS = 256
SUM_UNROLL = 4  # 16-byte loads in flight per thread
MAX_NBUF = 8  # K11b's ring slots
# the block's shared memory (H100: 227 KB) less K11b's own static scratch
RING_BYTES = 232448 - 1024


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sum_out(device) -> torch.Tensor:
    return torch.empty((), dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# K11a: grid-stride stream sum
# --------------------------------------------------------------------------

def stream_sum_plain(x: torch.Tensor, s: float) -> torch.Tensor:
    """sum(max(x, s)) over every element of x, in float64, as f32."""
    return x.double().clamp_min(s).sum().float()


def stream_sum(x: torch.Tensor, s: float) -> torch.Tensor:
    """K11a. Same contract as `stream_sum_plain`; x any contiguous bf16
    tensor."""
    if x.device.type == "cpu":
        return stream_sum_plain(x, s)
    _require_cuda("stream_sum", x)
    ctas = SUM_CTAS_PER_SM * sm_count(x.device)
    partial = torch.empty((ctas,), dtype=torch.float32, device=x.device)
    out = _sum_out(x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.wdt_stream_sum(
            x.data_ptr(), x.numel(), float(s), partial.data_ptr(), ctas,
            out.data_ptr(), kernels.stream_ptr(x.device)), "stream_sum")
    stream_sum.launches += 1
    return out


stream_sum.launches = 0


def grid_stride_pass(ctas: int) -> int:
    """Elements K11a's grid of `ctas` CTAs covers in one pass of its loop
    (each thread SUM_UNROLL vectors of 8); pass p covers the p-th run of
    that many elements."""
    return ctas * SUM_THREADS * SUM_UNROLL * 8


# --------------------------------------------------------------------------
# K11b: the same sum through a ring of TMA bulk copies
# --------------------------------------------------------------------------

def _check_ring(nbuf: int, stage_bytes: int) -> None:
    if not (2 <= nbuf <= MAX_NBUF and stage_bytes >= 1024 and stage_bytes % 16 == 0
            and nbuf * stage_bytes <= RING_BYTES):
        raise ValueError(
            f"stream_sum_pipelined: nbuf {nbuf} (2..{MAX_NBUF}) x stage_bytes "
            f"{stage_bytes} (a multiple of 16, >= 1024) must fit in {RING_BYTES} bytes")


def stream_sum_pipelined_plain(x: torch.Tensor, s: float, nbuf: int,
                               stage_bytes: int) -> torch.Tensor:
    """`stream_sum_plain`; the ring's shape (checked) changes nothing."""
    _check_ring(nbuf, stage_bytes)
    return stream_sum_plain(x, s)


def stream_sum_pipelined(x: torch.Tensor, s: float, nbuf: int,
                         stage_bytes: int) -> torch.Tensor:
    """K11b. Same contract as `stream_sum_plain`: one CTA an SM streams its
    contiguous share of x through `nbuf` shared-memory stages of
    `stage_bytes` (`stage_shares`)."""
    if x.device.type == "cpu":
        return stream_sum_pipelined_plain(x, s, nbuf, stage_bytes)
    _check_ring(nbuf, stage_bytes)
    _require_cuda("stream_sum_pipelined", x)
    ctas = sm_count(x.device)
    partial = torch.empty((ctas,), dtype=torch.float32, device=x.device)
    out = _sum_out(x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.wdt_stream_sum_pipelined(
            x.data_ptr(), x.numel(), float(s), int(nbuf), int(stage_bytes),
            partial.data_ptr(), ctas, out.data_ptr(), kernels.stream_ptr(x.device)),
            "stream_sum_pipelined")
    stream_sum_pipelined.launches += 1
    return out


stream_sum_pipelined.launches = 0


def stage_shares(numel: int, stage_bytes: int, ctas: int) -> List[range]:
    """K11b's split of a bf16 array of `numel` elements over `ctas` CTAs:
    its whole 16-byte vectors are cut into stages of `stage_bytes` (the last
    may be short), and CTA c sums the stages of range c in order (the last
    CTA also sums the numel % 8 elements after them)."""
    n_stage = -(-(numel // 8 * 16) // stage_bytes)
    return [range(n_stage * c // ctas, n_stage * (c + 1) // ctas) for c in range(ctas)]


# --------------------------------------------------------------------------
# K9b: one layer of the cross cache, walked as K1 walks it
# --------------------------------------------------------------------------

def kv_stream_sum_plain(layer: int, k: torch.Tensor, v: torch.Tensor,
                        s: float) -> torch.Tensor:
    """sum(max(k[layer], s)) + sum(v[layer]) over k, v [L, B, H, Ta, Dh]
    (every position, padding included), in float64, as f32."""
    return (k[layer].double().clamp_min(s).sum() + v[layer].double().sum()).float()


def kv_stream_sum(layer: int, k: torch.Tensor, v: torch.Tensor, s: float) -> torch.Tensor:
    """K9b. Same contract as `kv_stream_sum_plain`; Dh = 64."""
    if k.device.type == "cpu":
        return kv_stream_sum_plain(layer, k, v, s)
    _require_cuda("kv_stream_sum", k, v)
    L, B, H, Ta, Dh = k.shape
    if Dh != 64 or v.shape != k.shape or not 0 <= layer < L:
        raise ValueError(f"kv_stream_sum: k {tuple(k.shape)} / v {tuple(v.shape)}, "
                         f"layer {layer} (kernel takes Dh = 64)")
    partial = torch.empty((B * H,), dtype=torch.float32, device=k.device)
    out = _sum_out(k.device)
    lib = kernels.library()
    with torch.cuda.device(k.device):
        kernels.check(lib.wdt_kv_stream_sum(
            k.data_ptr(), v.data_ptr(), B, H, Ta, int(layer), float(s),
            partial.data_ptr(), out.data_ptr(), kernels.stream_ptr(k.device)),
            "kv_stream_sum")
    kv_stream_sum.launches += 1
    return out


kv_stream_sum.launches = 0
