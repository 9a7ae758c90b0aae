"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises (non-zero exit,
traceback) and no result line is printed:

1. device: name, torch / CUDA versions, `nvidia-smi` name and power limit;
2. build: compiles the hand-written kernels from `whisper_diarize_tpu_torch/
   csrc/` with nvcc (sm_90a) and prints the build time;
3. kernels: K1 (cross-attention), K2 (cross K/V build), K3 (decoder tail),
   K4 (split-cache self-attention of a beam step), K5 (cross-attention
   over the int8 cache) and K6 (the decoder tail with int8 weights and / or
   the int8 cache) against their plain PyTorch versions in bf16 at
   large-v3 widths (D 1280, 20 heads) and the shapes the main paths give
   them, K1-K3 on the 4-layer stack of large-v3-turbo and the 32-layer
   stack of large-v3, K4-K6 on the latter (see `phase_kernels`, `phase_k4`,
   `phase_int8_kernels`), with the tolerance of
   `whisper_diarize_tpu_torch/kernels/agreement.py` (a few bf16 ulps per
   element and 1e-2 relative L2 of the update), planted faults that the
   check must refuse (K2: a tile stored to the wrong stream among them;
   K3 / K6: the slips of their skinny GEMM's split, `agreement.
   tail_split_faults`), and times of kernel, plain version and the library
   call where one PyTorch call computes the same function (K1 and K5:
   `F.scaled_dot_product_attention`; K2: one `torch.addmm` of xa against
   every layer's [ck_w | cv_w] side by side, without the head split) after
   warm-up
   (K1 at B 8 with Q 1, 3, 4, 5, 15 and 64 and at B 1 with Q 3 and 5, K5
   at B 8 with Q 3, 5 and 15; each checked also at ta = 1493, no multiple
   of a span of its key split, `attn.cross_attn_plan`): CUDA
   events over back-to-back calls, and the profiled device time of their
   kernels (the union of their intervals), the median of three profiled
   windows that lost no kernel events (`timed`, `device_ms`); each beside
   its bound (`bound`); K1 and K3 are timed on the 32-layer stack only
   (their per-layer shapes are the same on both), K3, K6 and K8 each call
   on the next layer; then K7 (fused log-mel, f32, held to an absolute bound),
   K8 (greedy decoder front) and K10 (encoder self-attention, both forms;
   library call `F.scaled_dot_product_attention`) at the fused greedy
   path's shapes (`phase_fused_kernels`); then the diagnostic kernels, K11
   (stream sums of a bf16 array: grid-stride, and through a ring of TMA
   bulk copies) and K9 (K1's function presliced, with a constant layer and
   with the audio axis split; K9b, K1's bytes walked K1's way and summed)
   at every shape the diagnostic tools run them (K11 over 62.9 and 252 MB;
   K1 and K9 at the bench_attn_kernel tool's default shape and at K1's
   served one, on the tool's own inputs), the sums held to their float64
   value (`agreement.compare_sum`), with planted faults
   (`phase_probe_kernels`);
   then each diagnostic tool's `main()` on the card, a path of its own
   (`phase_tool`): `whisper_diarize_tpu_torch.tools.bench_dma` once (its
   two array sizes) and `...tools.bench_attn_kernel` at its shapes and at
   K1's served shape (B 8, Q 3, 32 layers);
4. reference: the greedy and the beam-5 path on the card (bf16, through the
   kernels) against the f32 plain path on the CPU on a small input (`tiny`
   preset), in bf16 and in the int8 forms (greedy with int8 cache and tail
   weights, beam 5 with the int8 cache) and the all-fused greedy path (K7,
   K10, K8); a beam run with the ancestry map ignored, an int8 beam run
   with the key scales ignored and a fused greedy run whose K8 leaves out
   the step's own slot must fail the check;
5. engine, greedy path: one `Engine` serves five requests (random
   `large-v3-turbo` weights, greedy, DTW word timestamps, the
   temperature-fallback ladder, batch 8, 32 tokens a window): a ~45 s
   whole-file request, a VAD request with random VAD weights, a second
   whole-file request, a 10 s one, and `transcribe_audio_batch` over eight
   10 s files;
6. engine, beam path (the Engine's default, `advanced=None`, beam 5): one
   `Engine` at random `large-v3` weights (32 decoder layers, ladder and DTW
   on, batch 8, 32 tokens a window: its depth is cut to keep the whole
   run near two minutes) serves a ~30 s whole-file request with
   language detection, a VAD request, and `transcribe_audio_batch` over
   eight 10 s files (B = 8, 40 beam rows);
7. engine, int8 beam path: a third `Engine` at random `large-v3` weights
   with `quantize_kv_cache=True` and the default beam 5 (64 tokens, the
   fallback ladder off: its sampling rungs over the int8 cache are phase
   8's loop) serves the ~30 s whole-file request with language detection
   and the batch of eight 10 s files;
8. int8 greedy path: a greedy `TranscribeStep` at `large-v3` width with
   `quantize_cross_kv` and `quantize_tail_weights` (the Engine has no knob
   for the int8 tail weights) takes one batch of 8 windows through
   `decode_with_fallback` (32 tokens a window);
9. the all-fused greedy path (`phase_fused_greedy`) at `large-v3` width on
   the third Engine's weights: one batch of 8 windows of 30 s through
   `mel.frontend` (K7), `encode(flash=True)` (K10), `build_cross_cache` (K2)
   and `greedy_decode` with the front attached (K8 and K3 a step, K1 at
   the prompt pass), 32 tokens, then one `sample_best_of` rung (best_of 5,
   temperature 0.2) on the same batch; wall seconds per stage.
10. engine, diarize path (`phase_diarize`): an `Engine` at random
   `large-v3-turbo` weights (greedy, DTW on, batch 8, `enable_diarize` with
   the "__random__" segmentation and CAM++ weights; depth cut: the fallback
   ladder off, 16 tokens a window) serves a ~30 s whole-file request and
   `transcribe_audio_batch` over four 10 s files, with the process-wide TF32
   flags at PyTorch's defaults; every segment must carry a `str` speaker
   id. Each request prints the segmentation seconds (`stage_s["segment"]`),
   the embedding seconds (`stage_s["embed"]`) and the windows decoded. Then
   the 30 s request's own audio goes through the kaldi fbank, the
   segmentation net and CAM++ on the card and in f32 on the CPU at the same
   weights (`models/net_check.py`: fbank 1e-3, log-probs 1e-3 with the
   argmax equal wherever the CPU's top-2 gap exceeds 1e-3, embeddings
   cosine >= 0.9999), and the planted faults (fbank without pre-emphasis,
   the BiLSTM's backward direction run forward, CAM++'s frame mask
   ignored) must fail that check.
   In 5-10 each request prints wall time, windows decoded and the launches
   it added; a request that decoded a window must have raised the count of
   every kernel of its path (`PATHS`; the tools of phase 3 are paths too).
   The counts are set to 0 just before each path and read just after;
11. with `--profile` only: the 45 s greedy request, the 30 s beam request,
   the 30 s int8 beam request, the fused greedy batch and the 30 s diarized
   request under torch.profiler (device busy time
   and kernel time by kind, also written to build/chip_smoke/profile.txt),
   then each diarization net alone on the 30 s request's audio (CUDA-event
   and profiled device time, `profile_diarize_nets`).
Each phase prints its wall seconds (`[time]`).

Then it prints one JSON line of per-kernel results (`launches` summed over
the paths' runs; for K1 and K5 also `launches_in_tail`, the launches the
fused tail K3 / K6 makes of them), the `nvidia-smi` name and power limit
line, and last
`{"ok": true, "device": {...}}`. It writes only under `build/` of the
checkout.
"""

from __future__ import annotations

import itertools
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import whisper_diarize_tpu_torch as wdt
from whisper_diarize_tpu_torch import kernels
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import whisper as wm
from whisper_diarize_tpu_torch.ops import attn, attn_probe, encoder_attn, front, mel, stream, tail
from whisper_diarize_tpu_torch.tools import bench_attn_kernel, bench_dma
from whisper_diarize_tpu_torch.tools.timing import (F32_FLOPS, attn_bound, bound, device_ms,
                                                    nvidia_smi_line, sum_bound, time_ms)

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
KERNELS = {
    "K1": dict(name="cross_attn_layer", fn=attn.cross_attn_layer,
               source="whisper_diarize_tpu_torch/csrc/cross_attn.cu",
               replaces="whisper_diarize_tpu/ops/pallas_attn.py:196"),
    "K2": dict(name="cross_kv_build", fn=attn.cross_kv_build,
               source="whisper_diarize_tpu_torch/csrc/cross_kv.cu",
               replaces="whisper_diarize_tpu/ops/pallas_attn.py:734"),
    "K3": dict(name="fused_tail_layer", fn=tail.fused_tail_layer,
               source="whisper_diarize_tpu_torch/csrc/tail.cu",
               replaces="whisper_diarize_tpu/ops/pallas_tail.py:508"),
    "K4": dict(name="split_self_attn_layer", fn=attn.split_self_attn_layer,
               source="whisper_diarize_tpu_torch/csrc/split_self.cu",
               replaces="whisper_diarize_tpu/ops/pallas_attn.py:489"),
    "K5": dict(name="cross_attn_layer_q8", fn=attn.cross_attn_layer_q8,
               source="whisper_diarize_tpu_torch/csrc/cross_attn.cu",
               replaces="whisper_diarize_tpu/ops/pallas_attn.py:308"),
    # the int8 forms of the tail wrapper count apart from its bf16 form
    "K6": dict(name="fused_tail_layer (int8 wq / kvq)", fn=tail.fused_tail_layer,
               count="launches_int8", source="whisper_diarize_tpu_torch/csrc/tail.cu",
               replaces="whisper_diarize_tpu/ops/pallas_tail.py:508"),
    "K7": dict(name="log_mel_fused", fn=mel.log_mel_fused,
               source="whisper_diarize_tpu_torch/csrc/mel.cu",
               replaces="tools/pallas_mel.py:117"),
    "K8": dict(name="fused_front_layer", fn=front.fused_front_layer,
               source="whisper_diarize_tpu_torch/csrc/front.cu",
               replaces="tools/pallas_front.py:193"),
    # one count for the family: the four wrappers' launches summed (K9a
    # :167, K9b :205, K9c :228, K9d :312; K9b's kernel is in stream_sum.cu)
    "K9": dict(name="cross_attn_presliced / kv_stream_sum / cross_attn_const_layer / "
                    "cross_attn_flat",
               fns=(attn_probe.cross_attn_presliced, stream.kv_stream_sum,
                    attn_probe.cross_attn_const_layer, attn_probe.cross_attn_flat),
               source="whisper_diarize_tpu_torch/csrc/cross_attn.cu",
               replaces="tools/bench_attn_kernel.py:167"),
    # one counter for both forms: single pass (:261), two pass (:276)
    "K10": dict(name="encoder_self_attention", fn=encoder_attn.encoder_self_attention,
                source="whisper_diarize_tpu_torch/csrc/encoder_attn.cu",
                replaces="tools/bench_encoder_attn.py:261"),
    # K11a auto_sum (:58) and K11b manual_sum (:107)
    "K11": dict(name="stream_sum / stream_sum_pipelined",
                fns=(stream.stream_sum, stream.stream_sum_pipelined),
                source="whisper_diarize_tpu_torch/csrc/stream_sum.cu",
                replaces="tools/bench_dma.py:58"),
}
# the numbers a kernel's timed row keeps for each shape it is timed at
SHAPE_KEYS = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
              "library_device_ms", "bound_ms", "bound_by")
PATHS = {"greedy": ("K1", "K2", "K3"), "beam": ("K1", "K2", "K3", "K4"),
         "int8-beam": ("K2", "K4", "K5", "K6"), "int8-greedy": ("K2", "K5", "K6"),
         "fused-greedy": ("K1", "K2", "K3", "K7", "K8", "K10"),
         "bench-dma": ("K11",), "bench-attn": ("K1", "K9"), "diarize": ("K1", "K2", "K3")}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| cuda {torch.version.cuda} | capability "
          f"{torch.cuda.get_device_capability(0)} | nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain references in f32
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.library()
    took = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kernels.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "C75" in ln or "warning" in ln]
    print(f"[build] kernels ready in {took:.2f} s (nvcc {kernels.build_seconds})",
          flush=True)
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)


def tail_bound(N: int, beams: int, D: int, Ta: int, wq: bool, kvq: bool) -> dict:
    """K3 / K6 for one layer: the five weights (11 D^2, bf16 or int8 with
    f32 scales), biases and layer norms (12 D bf16), x, self_out and the
    output (N x D bf16), the stream's cross K / V rows."""
    H, Bc = D // 64, N // beams
    weights = 11 * D * D * (1 if wq else 2) + (11 * D * 4 if wq else 0)
    cache = 2 * Bc * H * Ta * (64 + 4 if kvq else 128)
    return bound(weights + 12 * D * 2 + 3 * N * D * 2 + cache,
                 2 * N * 11 * D * D + 4 * N * H * Ta * 64)


def timed(tag: str, fn, plain, library=None, **extra) -> dict:
    """Kernel, plain version and (where one PyTorch call computes the same
    function) the library call: CUDA-event time of back-to-back calls and
    profiled device time, printed and returned."""
    t = dict(ms=time_ms(fn), plain_ms=time_ms(plain),
             device_ms=device_ms(fn), plain_device_ms=device_ms(plain),
             library_ms=None, library_device_ms=None, **extra)
    lib = ""
    if library is not None:
        t.update(library_ms=time_ms(library), library_device_ms=device_ms(library))
        lib = f", library {t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f})"
    b = f", bound {t['bound_ms']:.4f} ms ({t['bound_by']})" if "bound_ms" in t else ""
    print(f"[kernels] {tag} time {t['ms']:.4f} ms (device {t['device_ms']:.4f}), "
          f"plain {t['plain_ms']:.4f} ms (device {t['plain_device_ms']:.4f}){lib}{b}",
          flush=True)
    return t


def phase_kernels(preset: str, time_k1_k3: bool) -> dict:
    """K1/K2/K3 against their plain versions at the shapes the main paths
    give them, on the last layer of `preset`'s decoder stack (run for
    large-v3-turbo, 4 layers, the greedy path's model, and large-v3, 32
    layers, the beam path's). K2 is timed on both; K1 and K3, whose
    per-layer shapes the two share, where `time_k1_k3`. Every decode batch is padded to `batch_size`
    rows (`parallel.batching.pack_batch`), so the served paths run B = 8
    streams: K2 at B = 8; K1 at prefill with Q = beams x prompt = 3 (sot,
    language, task) at t = 0 and 15 (best_of 5 candidates) on the fallback
    ladder, Q = 4 (the prompt without timestamps) and 64 (a prompt with
    previous text), and inside K3 at Q = 1 (a greedy step) and 5 (a beam
    step), each also at ta_total = 1493 (no multiple of a span of the key
    split); K3 at N = 8 (greedy t = 0) and N = 40 (5 beams, or the
    ladder). The same at B = 1 (`batch_size=1`; K1 at Q 3, 5, 15). The tolerance is that of
    `kernels.agreement`; at B = 8 each kernel must also refuse its planted
    faults (a dropped bias, a wrong layer, an unscaled query)."""
    cfg = wm.PRESETS[preset]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D, H, L = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer
    Dh, Ta = cfg.head_dim, cfg.n_audio_ctx
    blocks = ag.random_blocks(L, D, g, dev)
    lay = L - 1
    at = f"L={L} layer={lay}"
    errs = {key: 0.0 for key in KERNELS}
    res, k1_rows = {}, {}

    def note(key, a):
        errs[key] = max(errs[key], a.max_abs_err)

    for B in (8, 1):
        main = B == 8
        xa = ag.randn(g, dev, B, Ta, D)
        args = (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
        k, v = attn.cross_kv_build(*args)
        pk, pv = attn.cross_kv_build_plain(*args)
        note("K2", ag.compare(f"K2 cross_kv_build k B={B} Ta={Ta} D={D} L={L}", k, pk))
        note("K2", ag.compare(f"K2 cross_kv_build v B={B} L={L}", v, pv))
        if main:
            for name, i, bad in ag.k2_faults(*args):
                ag.reject(name, (k, v)[i], bad)
            del pk, pv
            # the library yardstick: one GEMM of xa against every layer's
            # [ck_w | cv_w] side by side, the bias row added (no head split)
            wkv = torch.cat([blocks["ck_w"], blocks["cv_w"]], dim=2).permute(1, 0, 2).reshape(
                D, L * 2 * D).contiguous()
            bias_row = torch.cat([torch.zeros_like(blocks["cv_b"]), blocks["cv_b"]],
                                 dim=1).reshape(-1)
            x2 = xa.view(B * Ta, D)
            res["K2"] = timed(f"K2 B={B} L={L}", lambda: attn.cross_kv_build(*args),
                              lambda: attn.cross_kv_build_plain(*args),
                              library=lambda: torch.addmm(bias_row, x2, wkv),
                              shape=f"B={B} Ta={Ta} D={D} L={L}",
                              **bound(B * Ta * D * 2 + 2 * L * D * D * 2 + L * D * 2
                                      + 2 * L * B * Ta * D * 2, 4 * L * B * Ta * D * D))
            del wkv, bias_row
            torch.cuda.empty_cache()

        for Q in ((1, 3, 4, 5, 15, 64) if main else (3, 5, 15)):
            q = ag.randn(g, dev, B, Q, H, Dh, scale=2.0)
            for ta in (Ta, Ta - 7):  # Ta - 7: no multiple of a span
                a = (lay, q, k, v, ta)
                plan = attn.cross_attn_plan(B, H, Q, ta)
                note("K1", ag.compare(
                    f"K1 cross_attn_layer B={B} Q={Q} ta={ta} {at} (plan {tuple(plan)})",
                    attn.cross_attn_layer(*a), attn.cross_attn_layer_plain(*a)))
            a = (lay, q, k, v, Ta)
            if main and Q == 15:
                for name, bad in ag.k1_faults(*a):
                    ag.reject(name, attn.cross_attn_layer(*a), bad)
            if not time_k1_k3 or (not main and Q == 15):
                continue
            qt, kl, vl = q.transpose(1, 2), k[lay], v[lay]
            t = timed(f"K1 B={B} Q={Q} {at}", lambda: attn.cross_attn_layer(*a),
                      lambda: attn.cross_attn_layer_plain(*a),
                      library=lambda: F.scaled_dot_product_attention(qt, kl, vl),
                      shape=f"B={B} Q={Q} H={H} Ta={Ta} {at}",
                      **attn_bound(B, Q, H, Ta, 128))
            k1_rows[f"B={B} Q={Q}"] = {key: t[key] for key in SHAPE_KEYS}
            if main and Q == 3:
                res["K1"] = t

        for beams in (1, 5):
            N = B * beams
            x = ag.randn(g, dev, N, 1, D)
            so = ag.randn(g, dev, N, H, 1, Dh, scale=0.3)
            a = (lay, x, so, blocks, k, v, beams, Ta)
            got = tail.fused_tail_layer(*a)
            note("K3", ag.compare(f"K3 fused_tail_layer update B={B} N={N} beams={beams} {at}",
                                  got, tail.fused_tail_layer_plain(*a), base=x))
            if not main:
                continue
            if beams == 5:
                for name, bad in itertools.chain(ag.k3_faults(*a), ag.tail_split_faults("K3", *a)):
                    ag.reject(name, got, bad, base=x)
            if not time_k1_k3:
                continue
            # each call on the next layer, as a decode step reads them: one
            # layer's weights (36 MB) would otherwise stay in the 50 MB L2
            it, rest = itertools.count(), a[1:]
            t = timed(f"K3 N={N} {at}", lambda: tail.fused_tail_layer(next(it) % L, *rest),
                      lambda: tail.fused_tail_layer_plain(next(it) % L, *rest),
                      shape=f"N={N} beams={beams} D={D} L={L}",
                      **tail_bound(N, beams, D, Ta, False, False))
            res.setdefault("K3", t).setdefault("by_shape", {})[f"N={N}"] = {
                key: t[key] for key in SHAPE_KEYS}
            if beams == 5:
                res["K3"].update({key: t[key] for key in t if key != "by_shape"})
    for key in res:
        res[key]["max_abs_err"] = errs[key]
    if k1_rows:
        res["K1"]["by_shape"] = k1_rows
    return res, errs


def phase_kernels_all() -> dict:
    """`phase_kernels` for both presets: the large-v3 readings at the top,
    K2's large-v3-turbo one under "large-v3-turbo"; `max_abs_err` is the
    worst of both."""
    turbo, turbo_errs = phase_kernels("large-v3-turbo", time_k1_k3=False)
    res, _ = phase_kernels("large-v3", time_k1_k3=True)
    for key, t in res.items():
        t["max_abs_err"] = max(t["max_abs_err"], turbo_errs[key])
    res["K2"]["large-v3-turbo"] = turbo["K2"]
    torch.cuda.empty_cache()
    return res


def phase_k4() -> dict:
    """K4 against its plain version at large-v3 shapes: 32 layers, H 20,
    K 5 beams, B 8 (the served batch) and 1; prompts of 3 (sot, language,
    task) and 19 slots (a 16-slot previous-text bucket, random row pads);
    decode halves of 64 (64 tokens a window) and 224 (the default budget)
    slots; steps 0, mid and last; a random ancestry. The faults of
    `agreement.k4_faults` must fail the check at B 8, the 19-slot prompt and
    mid step. Times (`timed`) at the main path's shape (B 8, prompt 3,
    Td 64) at steps 0, 31 and 63, each call on the next layer so the caches
    come from device memory as in a decode step, not from L2."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    L, H, K, lay = 32, 20, 5, 17
    err, res = 0.0, {}
    for B in (8, 1):
        for Tp in (3, 19):
            for Td in (64, 224):
                q = ag.randn(g, dev, B, K, H, 64, scale=2.0)
                pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64) for _ in range(2))
                dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64) for _ in range(2))
                anc_j = torch.randint(0, K, (B, K, Td), generator=g, device=dev,
                                      dtype=torch.int32)
                row_pad = torch.zeros((B,), dtype=torch.int32, device=dev)
                if Tp > 3:  # left pads of a 16-slot bucket, one stream without text
                    row_pad = torch.randint(0, 17, (B,), generator=g, device=dev,
                                            dtype=torch.int32)
                    row_pad[0] = 16
                for step in (0, Td // 2 - 1, Td - 1):
                    a = (lay, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp)
                    got = attn.split_self_attn_layer(*a)
                    tag = f"K4 split_self_attn_layer B={B} K={K} Tp={Tp} Td={Td} step={step}"
                    err = max(err, ag.compare(tag, got, attn.split_self_attn_layer_plain(*a))
                              .max_abs_err)
                    if B == 8 and Tp == 19 and Td == 64 and step == Td // 2 - 1:
                        for name, bad in ag.k4_faults(*a):
                            ag.reject(name, got, bad)
                    if B == 8 and Tp == 3 and Td == 64:
                        it, rest = itertools.count(), a[1:]
                        # what this step reads: q and out, the prompt rows,
                        # the step + 1 decode rows of each beam, the ancestry
                        rows = B * H * Tp + B * K * H * (step + 1)
                        t = timed(f"K4 B={B} Tp={Tp} Td={Td} step={step}",
                                  lambda: attn.split_self_attn_layer(next(it) % L, *rest),
                                  lambda: attn.split_self_attn_layer_plain(next(it) % L, *rest),
                                  shape=f"B={B} K={K} H={H} Tp={Tp} Td={Td} step={step}",
                                  **bound(2 * B * K * H * 64 * 2 + rows * 64 * 2 * 2
                                          + B * K * Td * 4 + B * 4,
                                          4 * B * K * H * (Tp + step + 1) * 64))
                        if step == Td // 2 - 1:
                            res["K4"] = t
                del q, pk, pv, dk, dv
    res["K4"]["max_abs_err"] = err
    return res


def phase_int8_kernels() -> dict:
    """K5 and K6 against their plain versions on large-v3's 32-layer stack
    (last layer), B 8 streams, H 20, Ta 1500, the cross cache built by K2
    and quantized by `attn.quantize_cross_kv` (timed: plain PyTorch, as in
    the JAX package). K5 at Q = 3 (the beam prompt pass), 5 (a beam step),
    15 (the ladder's prompt pass, best_of 5) and 64 (a prompt with previous
    text), and at B 1, Q 3 and 5, each also at ta_total = 1493; its faults
    (`agreement.k5_faults`, a span of the key split dropped among them) at
    Q 15; timed at Q 3, 5 and 15 beside SDPA over the bf16 cache. K6
    in its three forms (`wq`, `kvq`, `wq+kvq`, weights from
    `quantize_tail_weights`) at N = 8 (greedy t = 0) and 40 (5 beams, or
    the ladder), its faults (`agreement.k6_faults`) at N = 40. Times
    (`timed`) at the main paths' shapes, each call on the next layer, as a
    decode step reads them: a layer's int8 cache (32.6 MB) and weights
    (18 MB) would otherwise stay in the 50 MB L2 cache between calls."""
    cfg = wm.PRESETS["large-v3"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    D, H, L, Ta = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer, cfg.n_audio_ctx
    lay = L - 1
    blocks = ag.random_blocks(L, D, g, dev)
    q8w = tail.quantize_tail_weights(blocks)
    errs, res = {"K5": 0.0, "K6": 0.0}, {}
    for B in (8, 1):
        xa = ag.randn(g, dev, B, Ta, D)
        k, v = attn.cross_kv_build(xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
        k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
        for Q in ((3, 5, 15, 64) if B == 8 else (3, 5)):
            q = ag.randn(g, dev, B, Q, H, 64, scale=2.0)
            for ta in (Ta, Ta - 7):  # Ta - 7: no multiple of a span
                a = (lay, q, k8, ks, v8, vs, ta)
                got = attn.cross_attn_layer_q8(*a)
                errs["K5"] = max(errs["K5"], ag.compare(
                    f"K5 cross_attn_layer_q8 B={B} Q={Q} ta={ta} L={L} layer={lay}", got,
                    attn.cross_attn_layer_q8_plain(*a)).max_abs_err)
            a = (lay, q, k8, ks, v8, vs, Ta)
            got = attn.cross_attn_layer_q8(*a)
            if B == 8 and Q == 15:
                for name, bad in ag.k5_faults(*a):
                    ag.reject(name, got, bad)
            if B == 8 and Q in (3, 5, 15):
                it, rest = itertools.count(), a[1:]
                qt = q.transpose(1, 2)
                t = timed(f"K5 B={B} Q={Q}",
                          lambda: attn.cross_attn_layer_q8(next(it) % L, *rest),
                          lambda: attn.cross_attn_layer_q8_plain(next(it) % L, *rest),
                          library=lambda: F.scaled_dot_product_attention(qt, k[lay], v[lay]),
                          shape=f"B={B} Q={Q} H={H} Ta={Ta} L={L}",
                          **attn_bound(B, Q, H, Ta, 64 + 4))
                res.setdefault("K5", t).setdefault("by_shape", {})[f"Q={Q}"] = {
                    key: t[key] for key in SHAPE_KEYS}
        if B == 8:
            qfn = lambda: attn.quantize_cross_kv(k, v)  # noqa: E731
            res["K5"]["quantize_cross_kv_ms"] = time_ms(qfn, iters=5, warmup=1)
            res["K5"]["quantize_cross_kv_device_ms"] = device_ms(qfn, iters=5, warmup=1)
            print(f"[kernels] quantize_cross_kv (plain PyTorch) B={B} L={L}: time "
                  f"{res['K5']['quantize_cross_kv_ms']:.4f} ms (device "
                  f"{res['K5']['quantize_cross_kv_device_ms']:.4f})", flush=True)
        for beams in (1, 5) if B == 8 else ():
            N = B * beams
            x = ag.randn(g, dev, N, 1, D)
            so = ag.randn(g, dev, N, H, 1, 64, scale=0.3)
            for form, wts, cache in (("wq+kvq", q8w, (k8, v8, ks, vs)),
                                     ("kvq", blocks, (k8, v8, ks, vs)),
                                     ("wq", q8w, (k, v, None, None))):
                a = (lay, x, so, wts, cache[0], cache[1], beams, Ta, cache[2], cache[3])
                got = tail.fused_tail_layer(*a)
                errs["K6"] = max(errs["K6"], ag.compare(
                    f"K6 fused_tail_layer {form} update N={N} beams={beams} L={L}", got,
                    tail.fused_tail_layer_plain(*a), base=x).max_abs_err)
                if N != 40:
                    continue
                for name, bad in itertools.chain(ag.k6_faults(*a),
                                                 ag.tail_split_faults("K6", *a)):
                    ag.reject(f"{name} ({form})", got, bad, base=x)
                it, rest = itertools.count(), a[1:]
                t = timed(f"K6 {form} N={N}",
                          lambda: tail.fused_tail_layer(next(it) % L, *rest),
                          lambda: tail.fused_tail_layer_plain(next(it) % L, *rest),
                          shape=f"{form} N={N} beams={beams} D={D} L={L}",
                          **tail_bound(N, beams, D, Ta, "wq" in form, "kvq" in form))
                res.setdefault("K6", t).setdefault("by_form", {})[form] = {
                    key: t[key] for key in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                            "bound_ms")}
        del xa, k, v, k8, ks, v8, vs
    for key in res:
        res[key]["max_abs_err"] = errs[key]
    torch.cuda.empty_cache()
    return res


def front_bound(N: int, D: int, pos: int, row_pad) -> dict:
    """K8 for one layer: the packed [D, 3D] weights, biases and ln1, x and
    self_out, the new K/V written, the valid cache rows (row_pad[n] .. pos)
    read as K and V."""
    rows = int((pos + 1 - row_pad.clamp(max=pos)).sum()) * (D // 64)
    return bound(3 * D * D * 2 + 5 * D * 2 + 4 * N * D * 2 + rows * 64 * 2 * 2,
                 2 * N * D * 3 * D + 4 * rows * 64)


def mel_bound(B: int, T: int, n_mels: int) -> dict:
    """K7: the audio read and the raw log-mel written (f32), and the
    operations log-mel needs a frame, not the dense DFT that K7 runs: the
    Hann window (400), a real 400-point FFT (2.5 N log2 N), the power (3 a
    bin), the filterbank's nonzero weights (2 each) and a log a mel, at the
    f32 rate."""
    frames = B * (T // 160)
    nnz = int(np.count_nonzero(mel.mel_filterbank(n_mels)))
    per_frame = 400 + 2.5 * 400 * math.log2(400) + 3 * 201 + 2 * nnz + n_mels
    return bound(B * T * 4 + frames * n_mels * 4, frames * per_frame, F32_FLOPS)


def phase_fused_kernels() -> dict:
    """K7, K8 and K10 against their plain versions at the fused greedy
    path's shapes (large-v3: 128 mels, D 1280, H 20, 32 layers), their
    planted faults refused. K7 on B 8 x 30 s of audio (f32, held to
    `agreement.F32_ATOL`). K8 at N 8 (greedy) and 40 (the best_of 5 rung)
    with a 48-slot cache (32 tokens after a 3-token prompt) at pos 3, 19
    and 34, without pads and with random pads (the faults at pos 19, with
    pads); each call on the next layer (a layer's weights are 9.8 MB), the
    caches cloned per call so kernel and plain version start alike. K10 in
    both forms at [8, 20, 1500, 64] with q, k at 0.5 (the faults: 36 padded
    keys must move the softmax) and 1.0; the library yardstick is
    `F.scaled_dot_product_attention` on the same q, k, v (scale 1/8: q and
    k each at 8^-0.5)."""
    cfg = wm.PRESETS["large-v3"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    D, H, L, Ta = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer, cfg.n_audio_ctx
    errs, res = {"K7": 0.0, "K8": 0.0, "K10": 0.0}, {}

    B, T = 8, 480000
    audio = torch.randn(B, T, generator=g, device=dev) * 0.1
    audio[:, 320000:] *= 0.01  # a quiet tail
    got = mel.log_mel_fused(audio, cfg.n_mels)
    plain = mel.log_mel_fused_plain(audio, cfg.n_mels)
    errs["K7"] = ag.compare(f"K7 log_mel_fused B={B} T={T} mels={cfg.n_mels}", got, plain,
                            atol=ag.F32_ATOL).max_abs_err
    exact = mel.log_mel_fused_plain(audio.double(), cfg.n_mels)
    print(f"[kernels] K7 max abs distance to the float64 log-mel: kernel "
          f"{float((got - exact).abs().max()):.4g}, plain f32 "
          f"{float((plain - exact).abs().max()):.4g} (F32_ATOL {ag.F32_ATOL:g})", flush=True)
    del plain, exact
    for name, bad in ag.k7_faults(audio, cfg.n_mels):
        ag.reject(name, got, bad, atol=ag.F32_ATOL)
    res["K7"] = timed(f"K7 B={B} T={T}", lambda: mel.log_mel_fused(audio, cfg.n_mels),
                      lambda: mel.log_mel_fused_plain(audio, cfg.n_mels),
                      shape=f"B={B} T={T} n_mels={cfg.n_mels}",
                      **mel_bound(B, T, cfg.n_mels))
    del audio, got

    fw = ag.random_front(L, D, g, dev)
    Tc, lay = 48, L - 1
    for N in (8, 40):
        x = ag.randn(g, dev, N, 1, D)
        kc, vc = (ag.randn(g, dev, L, N, H, Tc, 64) for _ in range(2))
        pads = torch.randint(0, 17, (N,), generator=g, device=dev)
        for pos in (3, 19, 34):
            for row_pad in (torch.zeros_like(pads), pads.clamp(max=pos)):
                a = (lay, pos, row_pad, x, fw)
                got = front.fused_front_layer(*a, kc.clone(), vc.clone())
                ref = front.fused_front_layer_plain(*a, kc.clone(), vc.clone())
                tag = f"K8 fused_front_layer N={N} Tc={Tc} pos={pos} pads={bool(row_pad.any())}"
                for what, x1, x2 in zip(("self_out", "k_new", "v_new"), got, ref):
                    errs["K8"] = max(errs["K8"], ag.compare(f"{tag} {what}", x1, x2).max_abs_err)
                if pos == 19 and row_pad.any():
                    for name, bad in ag.k8_faults(*a, kc, vc):
                        ag.reject(name, got[0], bad)
        it, zeros, pos = itertools.count(), torch.zeros_like(pads), 19
        t = timed(f"K8 N={N} pos={pos}",
                  lambda: front.fused_front_layer(next(it) % L, pos, zeros, x, fw, kc, vc),
                  lambda: front.fused_front_layer_plain(next(it) % L, pos, zeros, x, fw, kc, vc),
                  shape=f"N={N} D={D} Tc={Tc} pos={pos} L={L}",
                  **front_bound(N, D, pos, zeros))
        res.setdefault("K8", t).setdefault("by_shape", {})[f"N={N}"] = {
            key: t[key] for key in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                    "bound_ms")}
        del kc, vc
    del fw

    shape = (8, H, Ta, 64)
    for scale in (0.5, 1.0):
        q, k, v = (ag.randn(g, dev, *shape, scale=s) for s in (scale, scale, 1.0))
        for single_pass in (True, False):
            form = "single pass" if single_pass else "two pass"
            a = (q, k, v, Ta, single_pass)
            got = encoder_attn.encoder_self_attention(*a)
            errs["K10"] = max(errs["K10"], ag.compare(
                f"K10 encoder_self_attention {form} {list(shape)} q,k scale {scale}", got,
                encoder_attn.encoder_self_attention_plain(*a)).max_abs_err)
            if scale == 0.5:
                for name, bad in ag.k10_faults(*a):
                    ag.reject(f"{name} ({form})", got, bad)
                continue
            t = timed(f"K10 {form}", lambda: encoder_attn.encoder_self_attention(*a),
                      lambda: encoder_attn.encoder_self_attention_plain(*a),
                      library=lambda: F.scaled_dot_product_attention(q, k, v),
                      shape=f"{form} {list(shape)}",
                      **bound(4 * q.numel() * 2, 4 * shape[0] * H * Ta * Ta * 64))
            res.setdefault("K10", t).setdefault("by_form", {})[form] = {
                key: t[key] for key in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                        "library_ms", "bound_ms")}
    for key in res:
        res[key]["max_abs_err"] = errs[key]
    torch.cuda.empty_cache()
    return res


def check_attn_tool_shape(kw: dict, errs: dict) -> None:
    """Every kernel row of the bench_attn_kernel tool against its plain
    version on the tool's own inputs at one of its shapes
    (`bench_attn_kernel.setup` / `forms`, keyword arguments `kw`): K1, K9a
    over the layer and over its first 512 keys, K9c and K9d
    (`agreement.compare`); K11a over the layer's K and over its V, and K9b
    (`agreement.compare_sum`; the plain versions sum in float64). Raises on
    a miss; the
    worst errors go into `errs`."""
    lay = bench_attn_kernel.LAYER
    t = bench_attn_kernel.setup(torch.device("cuda"), **kw)
    at = (f"L={t.layers} B={t.batch} Q={t.queries} H={bench_attn_kernel.H} Ta={t.keys} "
          f"ta_total={t.ta} layer={lay}")
    for name, call, plain, _ in bench_attn_kernel.forms(t):
        if plain is None:  # the library row
            continue
        got, want = call(), plain()
        if name == "stream":
            for half, g1, w1, xs in zip("KV", got, want, (t.kl, t.vl)):
                errs["K11"] = max(errs["K11"], ag.compare_sum(
                    f"K11a stream_sum over the layer's {half} {at}", g1, w1,
                    ag.stream_terms(xs, 0.0)[1]))
        elif name == "stream+sum":
            errs["K9"] = max(errs["K9"], ag.compare_sum(
                f"K9b kv_stream_sum {at}", got, want, ag.kv_terms(lay, t.k, t.v, 0.0)[1]))
        else:
            key = "K1" if name == "cross_attn_layer" else "K9"
            errs[key] = max(errs[key], ag.compare(f"{key} {name} {at}", got,
                                                  want).max_abs_err)
    del t
    torch.cuda.empty_cache()


def phase_probe_kernels(res: dict) -> dict:
    """K9 and K11, the diagnostic tools' kernels, against their plain
    versions at every shape the tools run; their planted faults refused.
    K11 over each bench_dma array (48 and 192 tiles of [20, 64, 512] bf16,
    62.9 and 252 MB, `agreement.stream_input`: values whose mean moves every
    1 KB) at s = 0 and 0.3, K11b in every ring the tool runs, and at 62.9 MB
    a length that is no multiple of 8 or of a stage, held to the float64
    sum (`agreement.compare_sum`); the faults at 62.9 MB and s = 0. K9b over
    `stream_input` K/V of the bench_attn_kernel tool's default shape (L 4,
    B 16, H 20, 1536 keys, layer 1) with its faults; K9a, K9c and K9d at
    that shape (Q 1, 1500 keys unmasked) with theirs (`agreement.compare`:
    the key padding unmasked, the wrong layer, the spans combined without
    their rescale). Then every kernel row of the tool at both its shapes,
    the default and K1's served one (B 8, Q 3, L 32, 1500 keys), on the
    tool's own inputs (`check_attn_tool_shape`; K1 among them, whose worst
    error joins `res["K1"]`). Times (`timed`) at the tools' default shapes,
    `F.scaled_dot_product_attention` over the layer as the library call of
    the attention forms."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    errs, out = {"K1": 0.0, "K9": 0.0, "K11": 0.0}, {}
    sms = stream.sm_count(dev)
    rings = [(n, st) for n in bench_dma.NBUFS for st in bench_dma.STAGES]

    for tiles in sorted(bench_dma.SIZES, reverse=True):  # the tool's array last
        x = ag.stream_input(g, dev, tiles, bench_dma.H, bench_dma.DH, bench_dma.TT)
        main = tiles == bench_dma.TILES
        for xs in ((x, x.flatten()[:x.numel() - 16389]) if main else (x,)):
            for s in (0.0, 0.3):
                ref, mass = ag.stream_terms(xs, s)
                at = f"n={xs.numel()} s={s}"
                faults = main and xs is x and s == 0.0
                got = stream.stream_sum(xs, s)
                errs["K11"] = max(errs["K11"], ag.compare_sum(f"K11a stream_sum {at}", got,
                                                              ref, mass))
                if faults:
                    for name, bad in ag.k11a_faults(xs, s, stream.SUM_CTAS_PER_SM * sms):
                        ag.reject_sum(name, got, bad, mass)
                for nbuf, st in rings:
                    got = stream.stream_sum_pipelined(xs, s, nbuf, st)
                    errs["K11"] = max(errs["K11"], ag.compare_sum(
                        f"K11b stream_sum_pipelined nbuf={nbuf} stage={st} {at}", got, ref,
                        mass))
                    if faults and (nbuf, st) == rings[0]:
                        for name, bad in ag.k11b_faults(xs, s, nbuf, st, sms):
                            ag.reject_sum(f"{name} (nbuf {nbuf}, {st} B)", got, bad, mass)
        if not main:
            del x, xs
            torch.cuda.empty_cache()
    nbytes = x.numel() * 2
    nbuf, st = 4, bench_dma.STAGES[0]
    for form, fn, plain in (
            ("stream_sum", lambda: stream.stream_sum(x, 0.0),
             lambda: stream.stream_sum_plain(x, 0.0)),
            (f"stream_sum_pipelined nbuf={nbuf} stage={st}",
             lambda: stream.stream_sum_pipelined(x, 0.0, nbuf, st),
             lambda: stream.stream_sum_pipelined_plain(x, 0.0, nbuf, st))):
        t = timed(f"K11 {form} {nbytes / 1e6:.1f} MB", fn, plain,
                  shape=f"{tuple(x.shape)} bf16", **sum_bound(nbytes))
        out.setdefault("K11", t).setdefault("by_form", {})[form] = {
            key: t[key] for key in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                    "bound_ms")}
    del x, xs

    L, B, Q, H = bench_attn_kernel.L, bench_attn_kernel.B, bench_attn_kernel.Q, bench_attn_kernel.H
    Ta, ta, lay = bench_attn_kernel.KEYS, bench_attn_kernel.VALID, bench_attn_kernel.LAYER
    k, v = (ag.stream_input(g, dev, L, B, H, Ta, 64) for _ in range(2))
    ref, mass = ag.kv_terms(lay, k, v, 0.0)
    got = stream.kv_stream_sum(lay, k, v, 0.0)
    errs["K9"] = max(errs["K9"], ag.compare_sum(
        f"K9b kv_stream_sum L={L} B={B} H={H} Ta={Ta} layer={lay}", got, ref, mass))
    for name, bad in ag.k9b_faults(lay, k, v, 0.0):
        ag.reject_sum(name, got, bad, mass)
    layer_bytes = 2 * k[lay].numel() * 2
    t = timed(f"K9b kv_stream_sum {layer_bytes / 1e6:.1f} MB",
              lambda: stream.kv_stream_sum(lay, k, v, 0.0),
              lambda: stream.kv_stream_sum_plain(lay, k, v, 0.0),
              shape=f"L={L} B={B} H={H} Ta={Ta} layer={lay}", **sum_bound(layer_bytes))
    by_form = {"kv_stream_sum": t}
    del k, v

    q = ag.randn(g, dev, B, Q, H, 64, scale=2.0)
    k, v = (ag.randn(g, dev, L, B, H, Ta, 64) for _ in range(2))
    kl, vl = k[lay], v[lay]
    at = f"B={B} Q={Q} H={H} Ta={Ta} ta_total={ta} layer={lay}"
    forms = (
        ("cross_attn_presliced", attn_probe.cross_attn_presliced, (q, kl, vl, ta),
         attn_probe.cross_attn_presliced_plain, False),
        ("cross_attn_const_layer", attn_probe.cross_attn_const_layer, (q, k, v, ta),
         attn_probe.cross_attn_const_layer_plain, False),
        ("cross_attn_flat", attn_probe.cross_attn_flat, (lay, q, k, v, ta),
         attn_probe.cross_attn_flat_plain, True))
    for form, fn, a, plain, flat in forms:
        got = fn(*a)
        errs["K9"] = max(errs["K9"], ag.compare(f"K9 {form} {at}", got,
                                                plain(*a)).max_abs_err)
        for name, bad in ag.k9_faults(lay, q, k, v, ta, flat):
            ag.reject(f"{name} ({form})", got, bad)
        qt = q.transpose(1, 2)
        by_form[form] = timed(
            f"K9 {form} {at}", lambda: fn(*a), lambda: plain(*a),
            library=lambda: F.scaled_dot_product_attention(qt, kl[:, :, :ta], vl[:, :, :ta]),
            shape=at, **attn_bound(B, Q, H, ta, 128))
    del q, k, v, kl, vl
    torch.cuda.empty_cache()

    for kw in ({}, bench_attn_kernel.SERVED):
        check_attn_tool_shape(kw, errs)
    out["K9"] = dict(by_form["cross_attn_presliced"], by_form={
        form: {key: t[key] for key in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                       "library_ms", "bound_ms")}
        for form, t in by_form.items()})
    for key in out:
        out[key]["max_abs_err"] = errs[key]
    res["K1"]["max_abs_err"] = max(res["K1"]["max_abs_err"], errs["K1"])
    return out


def phase_tool(path: str, runs) -> dict:
    """One diagnostic tool on the card (`runs`: (main, keyword arguments),
    one a run); the launch counts are set to 0 just before and read just
    after, and every kernel of the path (`PATHS`) must have launched. Every
    row must carry a positive, finite time and device time. Returns the
    path's counts."""
    reset_counts()
    rows = [row for main, kw in runs for row in main(**kw)]
    torch.cuda.synchronize()
    added = counts()
    bad = [r["name"] for r in rows if not all(
        math.isfinite(r[key]) and r[key] > 0 for key in ("ms", "device_ms", "bound_ms"))]
    print(f"[tool {path}] {len(rows)} rows, launches {added}", flush=True)
    if bad:
        raise AssertionError(f"tool {path}: rows without a positive finite time: {bad}")
    _check_missing(f"tool {path}", path, added)
    torch.cuda.empty_cache()
    return added


def _teacher_forced(cpu, xa_b, prompt, toks):
    """The f32 CPU path's prepared logits [n, V] for the n tokens `toks`
    (sampling grammar without timestamps), each given the tokens before it:
    the prompt pass, then one single-token step a token, on the CPU step's
    weights and cross cache (int8 where its config says, as in its decode)."""
    from whisper_diarize_tpu_torch.ops import decode as dec

    cfg, P = cpu.cfg, len(prompt)
    cache = wm.init_self_cache(cfg, 1, torch.float32, "cpu", P + len(toks) + 16)
    cross = cpu.cross_cache(xa_b)
    logits = wm.decode_step(cpu.params, cfg, prompt[None], 0, cache, cross,
                            logits_at=(P - 1,))[:, 0]
    rows = []
    for t in range(len(toks)):
        rows.append(dec._prepare_logits(logits, cpu._suppress, cpu.sp, cpu.dc, t,
                                        *[None] * 4)[0])
        logits = wm.decode_step(cpu.params, cfg, toks[None, t:t + 1], P + t, cache,
                                cross, tail_q8=cpu.tail_q8)[:, 0]
    return torch.stack(rows)


def _greedy_gap(cpu, ref, prompt, res) -> float:
    """The worst, over the tokens the card picked (eot included), of the
    gap between the f32 CPU reference's best token and the card's token,
    teacher-forced on the same prefix, over max|logit|."""
    toks, lens = res.tokens.cpu(), res.lengths.cpu()
    worst = 0.0
    for b in range(toks.shape[0]):
        n = min(int(lens[b]) + 1, toks.shape[1])
        rows = _teacher_forced(cpu, ref[b:b + 1], prompt, toks[b, :n])
        gap = (rows.max(dim=-1).values - rows.gather(1, toks[b, :n, None])[:, 0]).max()
        worst = max(worst, float(gap) / float(rows[torch.isfinite(rows)].abs().max()))
    return worst


def _beam_error(cpu, ref, prompt, res) -> float:
    """The worst, over the streams of the beam result `res`, of |the sum
    log-probability it reports - the f32 CPU score of its tokens,
    teacher-forced| per token (eot included)."""
    toks, lens, reported = res.tokens.cpu(), res.lengths.cpu(), res.sum_logprob.float().cpu()
    err = 0.0
    for b in range(toks.shape[0]):
        n = min(int(lens[b]) + 1, toks.shape[1])
        rows = _teacher_forced(cpu, ref[b:b + 1], prompt, toks[b, :n])
        score = float(torch.log_softmax(rows, dim=-1).gather(1, toks[b, :n, None]).sum())
        err = max(err, abs(float(reported[b]) - score) / n)
    return err


def with_front(params, cfg) -> dict:
    """`params` with K8's front pack attached to the decoder."""
    return {**params, "decoder": {**params["decoder"],
                                  "front": front.pack_front_weights(params, cfg)}}


def fused_reference(params, cfg, tk, dc, audio: np.ndarray, cpu, ref: torch.Tensor,
                    prompt: torch.Tensor):
    """The all-fused greedy path on `params`' device (K7 -> encoder with
    K10 -> greedy with K8 and K3) against the f32 CPU step `cpu` and its
    encoder output `ref`: (encoder rel err, `_greedy_gap`, the gap of a run
    with K8's self slot dropped)."""
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    fused = with_front(params, cfg)
    step = TranscribeStep(fused, cfg, tk, decode_config=dc, strategy="greedy")
    frames = mel.frontend(torch.from_numpy(audio).to(step.device), cfg.n_mels)
    xa = wm.encode(fused, frames, cfg, flash=True)
    rel = float((xa.float().cpu() - ref).abs().max() / ref.abs().max())
    gap = _greedy_gap(cpu, ref, prompt, step.decode(xa, "en", "transcribe"))
    real = wm.fused_front_layer
    wm.fused_front_layer = ag.front_self_slot_dropped
    try:
        bad = step.decode(xa, "en", "transcribe")
    finally:
        wm.fused_front_layer = real
    return rel, gap, _greedy_gap(cpu, ref, prompt, bad)


def phase_reference() -> None:
    """The main paths on the card (bf16, through the kernels) against the
    f32 plain path on the CPU, on a small input: the `tiny` preset (Dh 64)
    with the JAX package's random init, two 10 s windows, 24 tokens without
    timestamps. The encoder output must agree within 5e-2 relative. Greedy
    (`_greedy_gap`): every token the card picks must be within 2e-2 *
    max|logit| of the best token of the CPU reference teacher-forced on the
    same prefix (bf16 may flip near-ties, nothing more). Beam 5
    (`_beam_error`): the sum log-probability the card reports for the
    hypothesis it chose must be within 2e-2 a token of the CPU's f32 score
    of the same tokens, and a beam run with a planted fault (the ancestry
    map ignored: every beam reads its own row's decode K/V) must fail that
    limit. Which hypothesis the card chooses is not compared: at random
    weights the logits are nearly flat and bf16 sends the search down other
    paths. The same checks for the int8 forms, against the f32 CPU path
    over the same int8 forms: greedy with `quantize_cross_kv` and
    `quantize_tail_weights`, beam 5 with `quantize_cross_kv`; the planted
    fault there is an int8 cache whose key scales are ignored (all 1). And
    the all-fused greedy path (`fused_reference`: K7, K10, K8) against the
    plain f32 greedy path, with the greedy check; a run whose K8 leaves the
    step's own slot out of its attention must fail it."""
    from whisper_diarize_tpu_torch.models import weights
    from whisper_diarize_tpu_torch.ops import decode as dec
    from whisper_diarize_tpu_torch.tokenizer import DebugTokenizer
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    cfg = wm.PRESETS["tiny"]
    tree = wm.init_params_np(cfg, seed=0)
    tk = DebugTokenizer()
    base = dec.DecodeConfig(max_tokens=24, with_timestamps=False, blank_id=32)
    configs = {  # (strategy, config) by name
        "greedy": ("greedy", base), "beam": ("beam_search", base),
        "int8-greedy": ("greedy", dec.DecodeConfig(
            max_tokens=24, with_timestamps=False, blank_id=32, quantize_cross_kv=True,
            quantize_tail_weights=True)),
        "int8-beam": ("beam_search", dec.DecodeConfig(
            max_tokens=24, with_timestamps=False, blank_id=32, quantize_cross_kv=True)),
    }
    params = {"card": weights.params_from_jax(tree, "cuda", torch.bfloat16),
              "ref": weights.params_from_jax(tree, "cpu", torch.float32)}
    steps = {(side, name): TranscribeStep(params[side], cfg, tk, decode_config=dc,
                                          strategy=strat)
             for side in params for name, (strat, dc) in configs.items()}
    rng = np.random.default_rng(5)
    audio = np.zeros((2, 480000), np.float32)
    audio[:, :160000] = rng.standard_normal((2, 160000)).astype(np.float32) * 0.1
    prompt = torch.tensor(tk.sot_sequence(language="en"))
    tol, out, ok = 2e-2, {}, True
    with torch.inference_mode():
        xa = {side: steps[side, "greedy"].encode(steps[side, "greedy"].mel(audio))
              for side in params}
        ref = xa["ref"]
        rel = float((xa["card"].float().cpu() - ref).abs().max() / ref.abs().max())
        ok &= rel <= 5e-2
        for name in configs:
            card, cpu = steps["card", name], steps["ref", name]
            res = card.decode(xa["card"], "en", "transcribe")
            if name.endswith("greedy"):
                out[name] = err = _greedy_gap(cpu, ref, prompt, res)
            else:
                out[name] = err = _beam_error(cpu, ref, prompt, res)
            ok &= err <= tol
            print(f"[reference] {name}: lengths {res.lengths.tolist()}, sum logprob "
                  f"{[round(x, 4) for x in res.sum_logprob.float().tolist()]}, worst "
                  f"{'card-token logit gap vs f32 CPU best, of max|logit|' if name.endswith('greedy') else '|card - f32 CPU score| a token'}"
                  f" {err:.4g} (tol {tol:g})", flush=True)
        rel_f, out["fused-greedy"], fault_f = fused_reference(
            params["card"], cfg, tk, base, audio, steps["ref", "greedy"], ref, prompt)
        ok &= rel_f <= 5e-2 and out["fused-greedy"] <= tol
        print(f"[reference] fused-greedy (K7, K10, K8): encoder rel err {rel_f:.4g} (tol "
              f"5e-2), worst card-token logit gap vs f32 CPU best, of max|logit| "
              f"{out['fused-greedy']:.4g} (tol {tol:g})", flush=True)
        # planted faults: each must fail its check
        real_step = wm.decode_step_split

        def ancestry_ignored(*a):
            anc = a[-1]
            own = torch.arange(anc.shape[0], device=anc.device)[:, None].expand_as(anc)
            return real_step(*a[:-1], own)

        wm.decode_step_split = ancestry_ignored
        try:
            bad = steps["card", "beam"].decode(xa["card"], "en", "transcribe")
        finally:
            wm.decode_step_split = real_step
        faults = {"ancestry ignored": _beam_error(steps["ref", "beam"], ref, prompt, bad)}
        card8 = steps["card", "int8-beam"]
        cross = card8.cross_cache(xa["card"])
        bad = card8.decode(xa["card"], "en", "transcribe",
                           cross=dict(cross, ks=torch.ones_like(cross["ks"])))
        faults["int8 key scales ignored"] = _beam_error(
            steps["ref", "int8-beam"], ref, prompt, bad)
        faults["fused greedy, K8 self slot dropped"] = fault_f
    for name, err in faults.items():
        ok &= err > tol
        print(f"[reference] planted fault, {name}: {err:.4g} "
              f"({'refused' if err > tol else 'NOT refused'})", flush=True)
    print(f"[reference] tiny preset, 2 x 10 s: encoder rel err {rel:.4g} (tol 5e-2); "
          f"{ {k: round(v, 5) for k, v in out.items()} } (tol {tol:g}) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card's main paths disagree with the f32 CPU reference, "
                             "or the check passed a planted fault")


def _write_wav(path: Path, seconds: float, seed: int) -> str:
    """Speech-like noise bursts: 1.5 s of shaped noise every 2 s."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    x = rng.standard_normal(n) * 0.02
    t = np.arange(n) / 16000.0
    env = (np.mod(t, 2.0) < 1.5).astype(np.float64)
    x += env * np.sin(2 * np.pi * 180.0 * t) * (0.3 + 0.2 * rng.standard_normal(n))
    wdt.write_wav(str(path), (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return str(path)


def _counted(spec: dict):
    return spec.get("fns", (spec.get("fn"),))


# K1 and K5 launched by the fused tail (K3 / K6), one a tail call, beside the
# launches of their own wrappers
IN_TAIL = {"K1 in K3 / K6": "cross_attn_launches", "K5 in K6": "cross_attn_q8_launches"}


def counts() -> dict:
    out = {k: sum(getattr(fn, spec.get("count", "launches")) for fn in _counted(spec))
           for k, spec in KERNELS.items()}
    out.update({k: getattr(tail.fused_tail_layer, attr) for k, attr in IN_TAIL.items()})
    return out


def in_tail(key: str, by_path: dict) -> dict:
    """K1's / K5's launches from inside the fused tail, summed and by path."""
    tag = next((t for t in IN_TAIL if t.startswith(f"{key} in")), None)
    if tag is None:
        return {}
    return {"launches_in_tail": sum(c[tag] for c in by_path.values()),
            "launches_in_tail_by_path": {p: c[tag] for p, c in by_path.items()}}


def reset_counts() -> None:
    for spec in KERNELS.values():
        for fn in _counted(spec):
            setattr(fn, spec.get("count", "launches"), 0)
    for attr in IN_TAIL.values():
        setattr(tail.fused_tail_layer, attr, 0)


def make_engine(model: str, **over):
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

    WORK.mkdir(parents=True, exist_ok=True)
    kw = dict(cache_dir=str(WORK / "cache"), whisper_model_path=f"__random__:{model}",
              vad_model_path="__random__", batch_size=8, enable_dtw=True,
              temperature_fallback=True, max_decode_tokens=64)
    return Engine(EngineConfig(**{**kw, **over}))


def greedy_requests():
    adv = wdt.AdvancedTranscribe(sampling_strategy="greedy")
    batch = [_write_wav(WORK / f"e{i}.wav", 10.0, 10 + i) for i in range(8)]
    return [
        ("whole-file 45 s", [_write_wav(WORK / "a.wav", 45.0, 1)],
         wdt.TranscribeOptions(enable_vad=False, lang="en", advanced=adv)),
        ("vad 20 s", [_write_wav(WORK / "b.wav", 20.0, 2)],
         wdt.TranscribeOptions(enable_vad=True, lang="en", advanced=adv)),
        ("whole-file 45 s (2nd)", [_write_wav(WORK / "c.wav", 45.0, 3)],
         wdt.TranscribeOptions(enable_vad=False, lang="en", advanced=adv)),
        ("whole-file 10 s", [_write_wav(WORK / "d.wav", 10.0, 4)],
         wdt.TranscribeOptions(enable_vad=False, lang="en", advanced=adv)),
        ("batch of 8 whole files, 10 s each", batch,
         wdt.TranscribeOptions(enable_vad=False, lang="en", advanced=adv)),
    ]


def beam_requests():
    """`advanced=None`: the Engine's default strategy, beam 5."""
    batch = [_write_wav(WORK / f"f{i}.wav", 10.0, 20 + i) for i in range(8)]
    return [
        ("beam whole-file 30 s, lang auto", [_write_wav(WORK / "g.wav", 30.0, 5)],
         wdt.TranscribeOptions(enable_vad=False, lang="auto")),
        ("beam vad 20 s", [_write_wav(WORK / "h.wav", 20.0, 6)],
         wdt.TranscribeOptions(enable_vad=True, lang="en")),
        ("beam batch of 8 whole files, 10 s each", batch,
         wdt.TranscribeOptions(enable_vad=False, lang="en")),
    ]


def int8_requests():
    """`quantize_kv_cache=True`, `advanced=None` (beam 5)."""
    batch = [_write_wav(WORK / f"i{i}.wav", 10.0, 30 + i) for i in range(8)]
    return [
        ("int8 beam whole-file 30 s, lang auto", [_write_wav(WORK / "j.wav", 30.0, 7)],
         wdt.TranscribeOptions(enable_vad=False, lang="auto")),
        ("int8 beam batch of 8 whole files, 10 s each", batch,
         wdt.TranscribeOptions(enable_vad=False, lang="en")),
    ]


def _check_missing(label: str, path: str, added: dict) -> None:
    missing = [k for k in PATHS[path] if added[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} were not launched: {added}")


def phase_engine(eng, path: str, requests, check_cues=None) -> dict:
    """Serve `requests` on `eng`; the launch counts are set to 0 just before
    and read just after. Every request that decoded a window must have
    launched every kernel of the path; `check_cues(label, cue_lists)` runs
    after each request where given. Returns the path's counts."""
    reset_counts()
    decoded_any = False
    for label, paths, opts in requests:
        before = counts()
        t0 = time.perf_counter()
        if len(paths) == 1:
            cue_lists = [eng.transcribe_audio(paths[0], opts)]
        else:
            cue_lists = eng.transcribe_audio_batch(paths, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        added = {k: n - before[k] for k, n in counts().items()}
        windows = eng.last_run["windows"]
        if len(cue_lists) != len(paths):
            raise AssertionError(f"{label}: {len(cue_lists)} results for {len(paths)} files")
        for c in (c for cues in cue_lists for c in cues):
            if not (math.isfinite(c.start) and math.isfinite(c.end) and c.end >= c.start >= 0):
                raise AssertionError(f"{label}: malformed cue {c}")
        if check_cues is not None:
            check_cues(label, cue_lists)
        print(f"[engine {path}] {label}: wall {wall:.3f} s, windows {windows}, cues "
              f"{sum(len(c) for c in cue_lists)}, launches added {added}, stages "
              f"{ {k: round(v, 3) for k, v in eng.last_run['stage_s'].items()} }",
              flush=True)
        if windows:
            decoded_any = True
            _check_missing(f"{label} ({windows} windows)", path, added)
    if not decoded_any:
        raise AssertionError(f"{path} path: no request decoded a window")
    return counts()


def phase_int8_step(eng) -> dict:
    """The int8 greedy path: a greedy `TranscribeStep` on `eng`'s loaded
    `large-v3` weights with `quantize_cross_kv` and `quantize_tail_weights`
    decodes one batch of 8 windows (speech-like noise, 30 s each) through
    `decode_with_fallback` (32 tokens, the whole ladder at random weights).
    The counts are set to 0 just before and read just after; K2, K5 and K6
    must have launched. Returns the path's counts."""
    from whisper_diarize_tpu_torch.ops import decode as dec
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    (params, cfg, tk), = eng._whisper_cache.values()
    step = TranscribeStep(params, cfg, tk, model_name="large-v3", decode_config=dec.DecodeConfig(
        max_tokens=32, blank_id=32, quantize_cross_kv=True, quantize_tail_weights=True),
        strategy="greedy")
    rng = np.random.default_rng(40)
    t = np.arange(480000) / 16000.0
    env = (np.mod(t, 2.0) < 1.5).astype(np.float32)
    audio = np.stack([(rng.standard_normal(480000) * 0.02 + env * np.sin(
        2 * np.pi * (150.0 + 10 * i) * t) * 0.3).astype(np.float32) for i in range(8)])
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        xa = step.encode(step.mel(audio))
        res, temps = step.decode_with_fallback(xa, "en", "transcribe")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    added = counts()
    lens = res.lengths.cpu()
    if not (torch.isfinite(res.avg_logprob).all() and (lens > 0).all()):
        raise AssertionError(f"int8 greedy step: lengths {lens.tolist()}, avg logprob "
                             f"{res.avg_logprob.tolist()}")
    print(f"[step int8-greedy] large-v3, 8 windows: wall {wall:.3f} s, lengths "
          f"{lens.tolist()}, final temperatures {temps.tolist()}, launches added {added}",
          flush=True)
    _check_missing("int8 greedy step", "int8-greedy", added)
    return added


def fused_setup(eng):
    """The fused greedy path's inputs on `eng`'s loaded weights: (params
    with the front attached, cfg, tokenizer, decode config, suppress mask,
    prompt [8, P], audio [8, 480000] of speech-like noise on the card)."""
    from whisper_diarize_tpu_torch.ops import decode as dec

    (params, cfg, tk), = eng._whisper_cache.values()
    dev = params["decoder"]["tok_emb"].device
    suppress = torch.from_numpy(dec.build_suppress_mask(
        tk.specials, cfg.n_vocab, tk.non_speech_tokens())).to(dev)
    prompt = torch.tensor([tk.sot_sequence(language="en")] * 8, device=dev)
    rng = np.random.default_rng(41)
    t = np.arange(480000) / 16000.0
    env = (np.mod(t, 2.0) < 1.5).astype(np.float32)
    audio = torch.from_numpy(np.stack([(rng.standard_normal(480000) * 0.02 + env * np.sin(
        2 * np.pi * (140.0 + 10 * i) * t) * 0.3).astype(np.float32)
        for i in range(8)])).to(dev)
    return (with_front(params, cfg), cfg, tk, dec.DecodeConfig(max_tokens=32, blank_id=32),
            suppress, prompt, audio)


def run_fused_greedy(setup, fused_stages: bool = True):
    """One batch through the fused greedy path: `mel.frontend` (K7),
    `encode(flash=True)` (K10), `build_cross_cache` (K2), `greedy_decode` with
    the front (K8 and K3 at every step, K1 at the prompt pass), then one
    `sample_best_of` rung (best_of 5, temperature 0.2, N 40) on the same
    cross cache. `fused_stages=False` runs the same batch with the plain
    stages in their place (`log_mel_spectrogram`, the encoder's compact
    attention, no front: `--profile`'s comparison). Returns (frames, xa,
    greedy result, rung result, wall seconds by stage)."""
    import dataclasses

    from whisper_diarize_tpu_torch.ops import decode as dec

    fused, cfg, tk, dc, suppress, prompt, audio = setup
    dev, P = audio.device, prompt.shape[1]
    frontend = mel.frontend if fused_stages else mel.log_mel_spectrogram
    if not fused_stages:
        fused = {**fused, "decoder": {k: v for k, v in fused["decoder"].items()
                                      if k != "front"}}
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    with torch.inference_mode():
        frames = frontend(audio, cfg.n_mels)
        mark()
        xa = wm.encode(fused, frames, cfg, flash=fused_stages)
        mark()
        cross = dec.build_cross_cache(fused, cfg, dc, xa)
        res = dec.greedy_decode(fused, cfg, dc, tk.specials, xa, prompt, P,
                                suppress_mask=suppress, cross=cross)
        mark()
        rung = dec.sample_best_of(fused, cfg, dataclasses.replace(dc, temperature=0.2),
                                  tk.specials, xa, prompt, P, best_of=5,
                                  generator=torch.Generator(device=dev).manual_seed(0),
                                  suppress_mask=suppress, cross=cross)
        mark()
    stages = dict(zip(("mel", "encode", "decode", "best_of 5 rung"),
                      (round(b - a, 3) for a, b in zip(marks, marks[1:]))))
    return frames, xa, res, rung, stages


def phase_fused_greedy(eng) -> dict:
    """The all-fused greedy path at large-v3 width on `eng`'s loaded
    weights (32 + 32 layers): one batch of 8 windows of 30 s, 32 tokens a
    window (`run_fused_greedy`). The counts are set to 0 just before and
    read just after; K1, K2, K3, K7, K8 and K10 must have launched. The
    frontend must equal the plain `log_mel_spectrogram` within
    `agreement.F32_ATOL` / 4 (its scale after the (x + 4) / 4); every
    output must be finite and of its shape. Prints wall seconds per stage.
    Returns the path's counts."""
    setup = fused_setup(eng)
    cfg, audio = setup[1], setup[-1]
    torch.cuda.synchronize()
    reset_counts()
    frames, xa, res, rung, stages = run_fused_greedy(setup)
    added = counts()
    mel_err = float((frames - mel.log_mel_spectrogram(audio, cfg.n_mels)).abs().max())
    finite = all(bool(torch.isfinite(x).all()) for x in (
        frames, xa, res.avg_logprob, res.token_probs, rung.avg_logprob, rung.token_probs))
    shapes = (tuple(frames.shape), tuple(xa.shape), tuple(res.tokens.shape),
              tuple(rung.tokens.shape))
    print(f"[path fused-greedy] large-v3, 8 windows of 30 s: wall by stage {stages} s; "
          f"shapes {shapes}; frontend vs plain max abs {mel_err:.3g}; greedy lengths "
          f"{res.lengths.tolist()}, rung lengths {rung.lengths.tolist()}; launches added "
          f"{added}", flush=True)
    want = ((8, cfg.n_mels, 3000), (8, cfg.n_audio_ctx, cfg.n_audio_state), (8, 32), (8, 32))
    if not finite or shapes != want or mel_err > ag.F32_ATOL / 4:
        raise AssertionError(f"fused greedy path: finite {finite}, shapes {shapes} "
                             f"(want {want}), frontend vs plain {mel_err}")
    _check_missing("fused greedy path", "fused-greedy", added)
    return added


def diarize_requests():
    """Greedy, `enable_diarize=True`."""
    opts = wdt.TranscribeOptions(enable_diarize=True, lang="en",
                                 advanced=wdt.AdvancedTranscribe(sampling_strategy="greedy"))
    batch = [_write_wav(WORK / f"k{i}.wav", 10.0, 50 + i) for i in range(4)]
    return [("diarize whole-file 30 s", [_write_wav(WORK / "l.wav", 30.0, 9)], opts),
            ("diarize batch of 4 files, 10 s each", batch, opts)]


def phase_diarize(eng, requests) -> dict:
    """The diarize path (phase 10 of the module docstring), with the
    process-wide TF32 flags at PyTorch's defaults for the phase: the
    requests, then the nets on the first request's audio against the f32
    CPU run at the same weights, with the planted faults. Returns the
    path's counts."""
    from whisper_diarize_tpu_torch.models import campplus, net_check, segmentation

    def check_cues(label, cue_lists):
        cues = [c for cl in cue_lists for c in cl]
        bad = [c for c in cues if not isinstance(c.speaker_id, str)]
        if bad or not cues:
            raise AssertionError(f"{label}: {len(cues)} cues, {len(bad)} without a speaker id")
        st = eng.last_run["stage_s"]
        print(f"[engine diarize] {label}: segmentation {st['segment']:.3f} s, embed "
              f"{st['embed']:.3f} s, windows {eng.last_run['windows']}, speakers "
              f"{sorted({c.speaker_id for c in cues})}", flush=True)

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        added = phase_engine(eng, "diarize", requests, check_cues)
        dev = torch.device("cuda")
        with torch.inference_mode():
            net_check.check(segmentation.init_params(0, dev), campplus.init_params(0, dev),
                            segmentation.init_params(0), campplus.init_params(0),
                            wdt.read_wav(requests[0][1][0]))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return added


def profile_diarize_nets(path: str) -> list:
    """`--profile`: each diarization net on one file's audio (its 10 s
    windows; a decode batch of 8 x 30 s, `net_check.stream_inputs`): CUDA-
    event time of back-to-back calls and profiled device time. Returns the
    printed lines."""
    from whisper_diarize_tpu_torch.models import campplus, net_check, segmentation

    dev = torch.device("cuda")
    seg, emb = segmentation.init_params(0, dev), campplus.init_params(0, dev)
    windows, audio, n_valid = net_check.stream_inputs(wdt.read_wav(path))
    windows, audio = windows.to(dev), audio.to(dev)
    nets = {f"segmentation forward, {len(windows)} windows of 10 s": (
                lambda: segmentation.forward(seg, windows), 1),
            "CAM++ embed_from_audio, 8 x 30 s": (
                lambda: campplus.embed_from_audio(emb, audio, n_valid), 2),
            "kaldi fbank, 8 x 30 s": (lambda: mel.kaldi_fbank(audio * 32768.0), 10)}
    lines = []
    with torch.inference_mode():
        for tag, (fn, iters) in nets.items():
            lines.append(f"{tag}: {time_ms(fn, iters=iters, warmup=1):.3f} ms a call (device "
                         f"{device_ms(fn, iters=iters, warmup=0):.3f} ms)")
            print(f"[profile] {lines[-1]}", flush=True)
    return lines


def _kernel_kind(name: str) -> str:
    if "split_self_kernel" in name:
        return "K4 split-cache self-attention"
    if "skinny_gemm" in name:
        return "K3 / K6 / K8 skinny GEMMs"
    if "front_attn_kernel" in name:
        return "K8 front self-attention"
    if "enc_attn_kernel" in name:
        return "K10 encoder self-attention"
    if "log_mel_kernel" in name:
        return "K7 log-mel"
    if "cross_attn_kernel" in name:  # one template: bf16 K/V (K1, K9) or int8 (K5)
        if "cross_attn_kernel<__nv_bfloat16" in name or "cross_attn_kernelI13__nv" in name:
            return "K1 attention (prefill, and inside K3)"
        return "K5 int8 attention (prefill, and inside K6)"
    if "cross_kv_kernel" in name:
        return "K2 cross K/V"
    if "sort" in name.lower():
        return "sorts (beam top-k)"
    if "copy" in name:
        return "dtype copies / casts"
    if "conv" in name.lower() or "fprop" in name or "cudnn" in name.lower():
        return "f32 convolutions (cuDNN: segmentation, CAM++)"
    if "f32f32" in name or "sgemm" in name or "gemvx" in name:
        return "f32 GEMM (vocabulary logits, diarization nets)"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "bf16 GEMM (encoder, q/k/v, prefill)"
    if "index" in name.lower() or "gather" in name or "scatter" in name:
        return "gathers / index (beam reindex, embeddings)"
    if "reduce" in name or "softmax" in name or "layer_norm" in name:
        return "reductions / softmax / layernorm"
    if "elementwise" in name or "Functor" in name:
        return "elementwise"
    return "other"


def engine_request(eng, path: str, opts):
    """One Engine request as `phase_profile` runs it: returns its summary."""
    def run() -> str:
        eng.transcribe_audio(path, opts)
        return (f"windows {eng.last_run['windows']}, stages "
                f"{ {k: round(v, 3) for k, v in eng.last_run['stage_s'].items()} }")
    return run


def phase_profile(label: str, run) -> list:
    """`--profile`: one request (`run()`, which returns its summary) three
    times unprofiled, then once under torch.profiler; the device's busy
    time (union of kernel intervals) and kernel time by kind. Returns the
    printed lines."""
    from torch.profiler import ProfilerActivity, profile

    lines = [f"{label}:"]
    for _ in range(3):
        t0 = time.perf_counter()
        summary = run()
        torch.cuda.synchronize()
        lines.append(f"unprofiled wall {time.perf_counter() - t0:.3f} s, {summary}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, cur = 0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if cur is None or s > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += 0 if cur is None else cur[1] - cur[0]
    total, count = {}, {}
    for e in kern:
        kind = _kernel_kind(e.name)
        total[kind] = total.get(kind, 0) + e.time_range.elapsed_us()
        count[kind] = count.get(kind, 0) + 1
    lines.append(f"profiled wall {wall:.3f} s; kernel time {sum(total.values()) / 1e6:.3f} s; "
                 f"busy (union) {busy / 1e6:.3f} s; kernels {len(kern)}")
    for kind in sorted(total, key=total.get, reverse=True):
        lines.append(f"  {kind:44s} {total[kind] / 1e3:10.1f} ms {count[kind]:8d} launches "
                     f"{100 * total[kind] / max(busy, 1):6.1f}% of busy")
    for ln in lines:
        print(f"[profile] {ln}", flush=True)
    return lines


def timed_phase(name: str, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    t0 = time.perf_counter()
    smi = phase_device()
    timed_phase("build", phase_build)
    res = timed_phase("kernels K1-K3", phase_kernels_all)
    res.update(timed_phase("kernels K4", phase_k4))
    res.update(timed_phase("kernels K5 K6", phase_int8_kernels))
    res.update(timed_phase("kernels K7 K8 K10", phase_fused_kernels))
    res.update(timed_phase("kernels K9 K11", phase_probe_kernels, res))
    by_path = {"bench-dma": timed_phase("tool bench-dma", phase_tool, "bench-dma",
                                        [(bench_dma.main, {})])}
    by_path["bench-attn"] = timed_phase("tool bench-attn", phase_tool, "bench-attn",
                                        [(bench_attn_kernel.main, {}),
                                         (bench_attn_kernel.main, bench_attn_kernel.SERVED)])
    timed_phase("reference", phase_reference)
    # depth: 32 tokens a window on the greedy paths and the bf16 beam
    # Engine; the int8 beam Engine runs without the fallback ladder, whose
    # sampling rungs the int8 greedy step drives through K5 and K6
    greedy_eng = make_engine("large-v3-turbo", max_decode_tokens=32)
    greedy = greedy_requests()
    by_path["greedy"] = timed_phase("engine greedy", phase_engine, greedy_eng, "greedy",
                                    greedy)
    beam_eng, beam = make_engine("large-v3", max_decode_tokens=32), beam_requests()
    by_path["beam"] = timed_phase("engine beam", phase_engine, beam_eng, "beam", beam)
    int8_eng = make_engine("large-v3", quantize_kv_cache=True, temperature_fallback=False)
    int8 = int8_requests()
    by_path["int8-beam"] = timed_phase("engine int8-beam", phase_engine, int8_eng,
                                       "int8-beam", int8)
    by_path["int8-greedy"] = timed_phase("step int8-greedy", phase_int8_step, int8_eng)
    by_path["fused-greedy"] = timed_phase("path fused-greedy", phase_fused_greedy, int8_eng)
    # depth: the ladder off and 16 tokens a window
    diar_eng = make_engine("large-v3-turbo", max_decode_tokens=16, temperature_fallback=False,
                           diarize_segment_model_path="__random__",
                           diarize_embedding_model_path="__random__", allow_random_weights=True)
    diar = diarize_requests()
    by_path["diarize"] = timed_phase("engine diarize", phase_diarize, diar_eng, diar)
    print(f"[time] all phases: {time.perf_counter() - t0:.1f} s", flush=True)
    if "--profile" in sys.argv[1:]:
        lines = phase_profile("greedy, large-v3-turbo, whole-file 45 s",
                              engine_request(greedy_eng, greedy[0][1][0], greedy[0][2]))
        lines += phase_profile("beam 5, large-v3, whole-file 30 s, lang auto",
                               engine_request(beam_eng, beam[0][1][0], beam[0][2]))
        lines += phase_profile("int8 beam 5, large-v3, whole-file 30 s, lang auto",
                               engine_request(int8_eng, int8[0][1][0], int8[0][2]))
        setup = fused_setup(int8_eng)
        for fused_stages in (True, False):
            lines += phase_profile(
                f"{'fused' if fused_stages else 'plain-stage'} greedy, large-v3, 8 windows "
                "of 30 s, 32 tokens + a best_of 5 rung",
                lambda: f"stages {run_fused_greedy(setup, fused_stages)[-1]}")
        lines += phase_profile("diarize greedy, large-v3-turbo, whole-file 30 s",
                               engine_request(diar_eng, diar[0][1][0], diar[0][2]))
        lines += profile_diarize_nets(diar[0][1][0])
        (WORK / "profile.txt").write_text("\n".join(lines) + "\n")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    print(json.dumps({"kernels": [
        {"name": spec["name"], "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"],
         "launches": sum(c[key] for c in by_path.values()),
         **{k: res[key][k] for k in keys},
         "launches_by_path": {p: c[key] for p, c in by_path.items()},
         **in_tail(key, by_path),
         **{k: v for k, v in res[key].items() if k not in keys}}
        for key, spec in KERNELS.items()]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
