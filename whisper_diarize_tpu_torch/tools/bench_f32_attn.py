"""The f32 forms of the attention kernels and of the GEMMs timed at
large-v3 widths on the card: K2-f32 (the cross K/V build, a GEMM of
every layer) at B 8 and L 32 and 4, beside `torch.addmm` in f32; K1-f32
(cross attention of one layer) at B 8 with Q 1, 3, 15, 64 and 227 and at B
1 with Q 3; K3-f32 (the decoder tail: five skinny GEMMs and K1-f32) at N 8
and 40, K6-f32 `kvq` and `wq+kvq` at N 40 and K8-f32 (the greedy front: a
skinny GEMM and its self-attention) at N 8 and 40, each call on the next
layer; K10-f32 (encoder self-attention) in both forms at
[8, 20, 1500, 64]; K1-f32 and K10-f32 beside
`F.scaled_dot_product_attention` in f32 on the same inputs; and K4 and
K4-f32 (the beam step's split-cache self-attention) at B 8, K 5, H 20, a
3-slot prompt, a 64-slot decode half at steps 0, 31 and 63 and a 224-slot
one at step 223, each call on the next layer. TF32 is off, so the library
calls and the plain products run in f32.

    python -m whisper_diarize_tpu_torch.tools.bench_f32_attn [--only K4 ...]

`--only` times just the rows whose names start with one of the prefixes.

It prints the card's name and power limit, one line a row and last one
JSON object: the package it timed and, by row, the CUDA-event ms of
back-to-back calls and the profiled device ms (`timing.time_ms`,
`timing.device_ms`; "library" rows for the library call); for the rows
that run the skinny GEMM (K3, K6, K8) also its share of the device ms,
`skinny_device_ms` (`timing.device_ms_by_kernel`). The tool imports the
package by its absolute name and reads only entry points every version of
the port since the f32 forms has (the wrappers, `attn.quantize_cross_kv`,
`tail.quantize_tail_weights`, `agreement.randn` / `random_blocks` /
`random_front`, `timing`; the K4 rows only `attn.split_self_attn_layer`,
which every version since the beam slice has), so the same file times an older checkout's
kernels beside this one's in one run on one card:

    PYTHONPATH=<older checkout> python whisper_diarize_tpu_torch/tools/bench_f32_attn.py

Raises without a card; `cases(torch.device("cpu"), ...)` builds the same
calls at a small size on the CPU (the tests).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

import whisper_diarize_tpu_torch
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, encoder_attn, front, tail
from whisper_diarize_tpu_torch.tools import timing

Case = Tuple[str, Callable[[], torch.Tensor], Optional[Callable[[], torch.Tensor]]]


def cases(dev: torch.device, L: int = 32, B: int = 8, H: int = 20, Ta: int = 1500,
          queries: Sequence[int] = (1, 3, 15, 64, 227), seed: int = 3,
          k2_layers: Sequence[int] = (32, 4), Tc: int = 48,
          k4_steps: Sequence[Tuple[int, int]] = ((64, 0), (64, 31), (64, 63), (224, 223)),
          ) -> List[Case]:
    """(row name, the kernel's call, the library call or None) of every row,
    on inputs drawn from `seed`: a random f32 decoder stack of L layers at
    D = 64 H and its cross cache of B streams (K2-f32 over the first
    `k2_layers` layers), queries at scale 2; K8's cache of Tc slots at
    position 19; K4's caches of K 5 beams, a 3-slot prompt and (Td, step)
    of `k4_steps`, in bf16 and f32, with a random ancestry and row pads."""
    f32, D = torch.float32, 64 * H
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = ag.random_blocks(L, D, g, dev, dtype=f32)
    xa = ag.randn(g, dev, B, Ta, D, dtype=f32)
    out = []
    for Lk in k2_layers:
        a = (xa, blocks["ck_w"][:Lk], blocks["cv_w"][:Lk], blocks["cv_b"][:Lk], H)
        wkv = torch.cat([a[1], a[2]], dim=2).permute(1, 0, 2).reshape(D, Lk * 2 * D).contiguous()
        bias = torch.cat([torch.zeros_like(a[3]), a[3]], dim=1).reshape(-1)
        out.append((f"K2-f32 L={Lk}", lambda a=a: attn.cross_kv_build(*a),
                    lambda bias=bias, wkv=wkv: torch.addmm(bias, xa.view(-1, D), wkv)))
    k, v = attn.cross_kv_build(xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    lay = L - 1
    for b, Q in [(B, Q) for Q in queries] + [(1, 3)]:
        kb, vb = (k, v) if b == B else (k[:, :1].contiguous(), v[:, :1].contiguous())
        q = ag.randn(g, dev, b, Q, H, 64, scale=2.0, dtype=f32)
        qt, kl, vl = q.transpose(1, 2), kb[lay], vb[lay]
        out.append((f"K1-f32 B={b} Q={Q}",
                    lambda q=q, kb=kb, vb=vb: attn.cross_attn_layer(lay, q, kb, vb, Ta),
                    lambda qt=qt, kl=kl, vl=vl: F.scaled_dot_product_attention(qt, kl, vl)))
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    q8w = tail.quantize_tail_weights(blocks)
    for beams in (1, 5):
        N = B * beams
        x = ag.randn(g, dev, N, 1, D, dtype=f32)
        so = ag.randn(g, dev, N, H, 1, 64, scale=0.3, dtype=f32)
        forms = [("K3-f32", blocks, (k, v, None, None))]
        if beams == 5:
            forms += [("K6-f32 kvq", blocks, (k8, v8, ks, vs)),
                      ("K6-f32 wq+kvq", q8w, (k8, v8, ks, vs))]
        for name, w, c in forms:
            it = itertools.count()
            out.append((f"{name} N={N}",
                        lambda x=x, so=so, w=w, c=c, beams=beams, it=it: tail.fused_tail_layer(
                            next(it) % L, x, so, w, c[0], c[1], beams, Ta, c[2], c[3]), None))
    del k8, ks, v8, vs, q8w
    fw = ag.random_front(L, D, g, dev, dtype=f32)
    for N in (B, 5 * B):
        x = ag.randn(g, dev, N, 1, D, dtype=f32)
        kc, vc = (ag.randn(g, dev, L, N, H, Tc, 64, dtype=f32) for _ in range(2))
        pads = torch.zeros((N,), dtype=torch.long, device=dev)
        it = itertools.count()
        out.append((f"K8-f32 N={N}",
                    lambda x=x, kc=kc, vc=vc, pads=pads, it=it: front.fused_front_layer(
                        next(it) % L, 19, pads, x, fw, kc, vc)[0], None))
    qe, ke, ve = (ag.randn(g, dev, B, H, Ta, 64, dtype=f32) for _ in range(3))
    for single_pass in (True, False):
        out.append((f"K10-f32 {'single pass' if single_pass else 'two pass'}",
                    lambda sp=single_pass: encoder_attn.encoder_self_attention(
                        qe, ke, ve, Ta, sp),
                    lambda: F.scaled_dot_product_attention(qe, ke, ve)))
    K, Tp = 5, 3
    for dtype, tag in ((torch.bfloat16, "K4"), (f32, "K4-f32")):
        q = ag.randn(g, dev, B, K, H, 64, scale=2.0, dtype=dtype)
        pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64, dtype=dtype) for _ in range(2))
        row_pad = torch.randint(0, 2, (B,), generator=g, device=dev, dtype=torch.int32)
        for Td in sorted({td for td, _ in k4_steps}):
            dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64, dtype=dtype) for _ in range(2))
            anc = torch.randint(0, K, (B, K, Td), generator=g, device=dev, dtype=torch.int32)
            for step in [s for td, s in k4_steps if td == Td]:
                it = itertools.count()
                out.append((f"{tag} Td={Td} step={step}",
                            lambda q=q, pk=pk, pv=pv, dk=dk, dv=dv, anc=anc, rp=row_pad, step=step,
                            it=it: attn.split_self_attn_layer(next(it) % L, q, pk, pv, dk, dv,
                                                              anc, step, rp, Tp), None))
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="bench_f32_attn")
    parser.add_argument("--only", nargs="+", default=None,
                        help="time only the rows whose names start with one of these")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_f32_attn: needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(timing.card_line(dev), flush=True)
    res = {"package": whisper_diarize_tpu_torch.__file__, "rows": {}}
    for name, fn, library in cases(dev):
        if args.only and not name.startswith(tuple(args.only)):
            continue
        row = {"ms": timing.time_ms(fn), "device_ms": timing.device_ms(fn)}
        if name.startswith(("K3", "K6", "K8")):  # the skinny GEMM's share
            row["skinny_device_ms"] = sum(ms for kernel, ms in timing.device_ms_by_kernel(
                fn).items() if "skinny" in kernel)
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
