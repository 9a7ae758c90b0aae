"""The f32 forms of the attention kernels timed at large-v3 widths on the
card: K1-f32 (cross attention of one layer) at B 8 with Q 1, 3, 15, 64 and
227 and at B 1 with Q 3, K3-f32 (the decoder tail, which runs K1-f32 inside)
at N 8 and 40, each call on the next layer, and K10-f32 (encoder
self-attention) in both forms at [8, 20, 1500, 64]; K1-f32 and K10-f32
beside `F.scaled_dot_product_attention` in f32 on the same inputs. TF32 is
off, so the library call and the plain products run in f32.

    python -m whisper_diarize_tpu_torch.tools.bench_f32_attn

It prints the card's name and power limit, one line a row and last one
JSON object: the package it timed and, by row, the CUDA-event ms of
back-to-back calls and the profiled device ms (`timing.time_ms`,
`timing.device_ms`; "library" rows for SDPA). The tool imports the package
by its absolute name and reads only entry points every version of the port
since the f32 forms has (the wrappers, `agreement.randn` / `random_blocks`,
`timing`), so the same file times an older checkout's kernels beside this
one's in one run on one card:

    PYTHONPATH=<older checkout> python whisper_diarize_tpu_torch/tools/bench_f32_attn.py

Raises without a card; `cases(torch.device("cpu"), ...)` builds the same
calls at a small size on the CPU (the tests).
"""

from __future__ import annotations

import itertools
import json
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

import whisper_diarize_tpu_torch
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, encoder_attn, tail
from whisper_diarize_tpu_torch.tools import timing

Case = Tuple[str, Callable[[], torch.Tensor], Optional[Callable[[], torch.Tensor]]]


def cases(dev: torch.device, L: int = 32, B: int = 8, H: int = 20, Ta: int = 1500,
          queries: Sequence[int] = (1, 3, 15, 64, 227), seed: int = 3) -> List[Case]:
    """(row name, the kernel's call, the library call or None) of every row,
    on inputs drawn from `seed`: a random f32 decoder stack of L layers at
    D = 64 H and its cross cache of B streams (K2-f32), queries at scale 2."""
    f32, D = torch.float32, 64 * H
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = ag.random_blocks(L, D, g, dev, dtype=f32)
    xa = ag.randn(g, dev, B, Ta, D, dtype=f32)
    k, v = attn.cross_kv_build(xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    del xa
    lay, out = L - 1, []
    for b, Q in [(B, Q) for Q in queries] + [(1, 3)]:
        kb, vb = (k, v) if b == B else (k[:, :1].contiguous(), v[:, :1].contiguous())
        q = ag.randn(g, dev, b, Q, H, 64, scale=2.0, dtype=f32)
        qt, kl, vl = q.transpose(1, 2), kb[lay], vb[lay]
        out.append((f"K1-f32 B={b} Q={Q}",
                    lambda q=q, kb=kb, vb=vb: attn.cross_attn_layer(lay, q, kb, vb, Ta),
                    lambda qt=qt, kl=kl, vl=vl: F.scaled_dot_product_attention(qt, kl, vl)))
    for beams in (1, 5):
        N = B * beams
        x = ag.randn(g, dev, N, 1, D, dtype=f32)
        so = ag.randn(g, dev, N, H, 1, 64, scale=0.3, dtype=f32)
        it = itertools.count()
        out.append((f"K3-f32 N={N}",
                    lambda x=x, so=so, beams=beams, it=it: tail.fused_tail_layer(
                        next(it) % L, x, so, blocks, k, v, beams, Ta), None))
    qe, ke, ve = (ag.randn(g, dev, B, H, Ta, 64, dtype=f32) for _ in range(3))
    for single_pass in (True, False):
        out.append((f"K10-f32 {'single pass' if single_pass else 'two pass'}",
                    lambda sp=single_pass: encoder_attn.encoder_self_attention(
                        qe, ke, ve, Ta, sp),
                    lambda: F.scaled_dot_product_attention(qe, ke, ve)))
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    del argv
    if not torch.cuda.is_available():
        raise SystemExit("bench_f32_attn: needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(timing.card_line(dev), flush=True)
    res = {"package": whisper_diarize_tpu_torch.__file__, "rows": {}}
    for name, fn, library in cases(dev):
        row = {"ms": timing.time_ms(fn), "device_ms": timing.device_ms(fn)}
        if library is not None:
            row.update(library_ms=timing.time_ms(library),
                       library_device_ms=timing.device_ms(library))
        res["rows"][name] = row
        print(f"[bench_f32_attn] {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
