"""K2 (`csrc/cross_kv.cu`, `ops/attn.py::cross_kv_build`) timed on the card
at large-v3's shapes: L 32 decoder layers, B 8 streams of Ta 1500 frames,
D 1280, at the local head counts given (20: the whole model; 3 and 5: a
rank of a head split, whose halves end in the 64-column edge tile), in
bf16 and f32.

    python -m whisper_diarize_tpu_torch.tools.bench_cross_kv [--heads 20 3 5]

Each row: the kernel's CUDA-event ms of back-to-back calls and its profiled
device ms (`timing.time_ms`, `timing.device_ms`), the bound (xa, both
weights and the V bias read once, K and V written once; 4 L B Ta D HD
operations at the bf16 rate, or the 3xTF32 rate for f32), the device ms of
one `torch.addmm` of xa against every layer's [K | V] weights (the library
call), and the first 16 hex digits of a sha256 of K's and V's bytes.

The tool imports only entry points every version of the port since K2 has
(`ops/attn.py::cross_kv_build`, `tools/timing.py`), and its inputs come
from a fixed seed on the card, so the same file times an older checkout's
kernel beside this one's in one run on one card, and the digests show
whether the two give the same bits:

    PYTHONPATH=<older checkout> python whisper_diarize_tpu_torch/tools/bench_cross_kv.py --heads 20

It prints the card's name and power limit first and one JSON object last.
Raises without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from typing import Optional, Sequence

import torch

import whisper_diarize_tpu_torch
from whisper_diarize_tpu_torch.ops import attn
from whisper_diarize_tpu_torch.tools import timing

L, B, TA, D = 32, 8, 1500, 1280
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def row(H: int, dtype: torch.dtype, g: torch.Generator, dev: torch.device) -> dict:
    """K2 at H local heads: the kernel, its bound and the library call."""
    HD, es = 64 * H, torch.finfo(dtype).bits // 8
    xa = torch.randn((B, TA, D), generator=g, device=dev).to(dtype)
    ck, cv = (torch.randn((L, D, HD), generator=g, device=dev).mul_(D ** -0.5).to(dtype)
              for _ in range(2))
    cb = torch.randn((L, HD), generator=g, device=dev).mul_(0.5).to(dtype)

    def call():
        return attn.cross_kv_build(xa, ck, cv, cb, H)

    out = dict(sha256=digest(*call()), ms=timing.time_ms(call, iters=10),
               device_ms=timing.device_ms(call))
    wkv = torch.cat([ck, cv], dim=2).permute(1, 0, 2).reshape(D, L * 2 * HD).contiguous()
    bias_row = torch.cat([torch.zeros_like(cb), cb], dim=1).reshape(-1)
    x2 = xa.view(B * TA, D)
    out["library_device_ms"] = timing.device_ms(lambda: torch.addmm(bias_row, x2, wkv))
    out.update(timing.bound(
        B * TA * D * es + 2 * L * D * HD * es + L * HD * es + 2 * L * B * TA * HD * es,
        4 * L * B * TA * D * HD, timing.TF32X3_FLOPS if es == 4 else timing.BF16_FLOPS))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, nargs="+", default=[20, 3, 5])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_cross_kv: no CUDA device")
    dev = torch.device("cuda", 0)
    print(timing.card_line(dev), flush=True)
    rows = {}
    for name in DTYPES:
        for H in args.heads:
            g = torch.Generator(device=dev).manual_seed(0)
            r = rows[f"{name} H={H}"] = row(H, DTYPES[name], g, dev)
            print(f"K2 {name} H={H} (HD {64 * H}) L={L} B={B} Ta={TA} D={D}: {r['ms']:.4f} ms "
                  f"(device {r['device_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), addmm device {r['library_device_ms']:.4f} ms, "
                  f"sha256 {r['sha256']}", flush=True)
            torch.cuda.empty_cache()
    res = dict(package=whisper_diarize_tpu_torch.__file__, rows=rows)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
