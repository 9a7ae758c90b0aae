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
   (K1 at B 8 with Q 1, 3, 4, 5, 8 (the verify pass at gamma 8), 15 and 64
   and at B 1 with Q 3 and 5, K5
   at B 8 with Q 3, 5 and 15; each checked also at ta = 1493, no multiple
   of a span of its key split, `attn.cross_attn_plan`): CUDA
   events over back-to-back calls, and the profiled device time of their
   kernels (the union of their intervals), the median of three profiled
   windows that lost no kernel events (`timed`, `device_ms`); each beside
   its bound (`bound`); K1 and K3 are timed on the 32-layer stack only
   (their per-layer shapes are the same on both), K3, K6 and K8 each call
   on the next layer; then K7 (fused log-mel, f32, held to an absolute bound,
   one kernel a call, the same bits from two calls; library: the cuFFT
   route, several calls, `bench_f32_attn.cufft_log_mel`),
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
   K1's served shape (B 8, Q 3, 32 layers), then the port's counterparts of
   the two JAX tools that launch K8 and K10, each a path of its own:
   `...tools.bench_encoder_attn` (large-v3, B 16: the whole encoder with
   full, no-attn and flash-custom (K10) attention) and
   `...tools.bench_megakernel` (large-v3, B 16, its full budgets, each
   variant in this process so that its launches count: greedy `tail` (K3)
   and `tail+front` (K8 + K3), beam `tail` (K4 + K3)); then the five decode
   breakdown tools (`breakdown_phases`, each in this process at large-v3,
   batch 16, budgets 32 and 64, best of 1 after a warm-up, a path of its
   own):
   `...tools.bench_decode_breakdown` ("decode-breakdown": mel, K7, encode,
   prefill and its parts, greedy_run, model_only with and without K8,
   sample_only; the last step's picks with K8 within 2e-2 x max|logit| of
   the best logit without, the margin rule of `TOKEN_GAP`),
   `bench_beam_breakdown` ("beam-breakdown", every part),
   `bench_layer_variants` ("layer-variants"; v1b's picks, the torch tail
   with K1, by the same rule against v0's logits, K3), `bench_beam_variants`
   ("beam-variants") and `bench_quant_kv` ("quant-kv": K5 and K6 in the q8
   variants); in every row the times and launches finite, the launches a
   step whole and >= 0, the device time a step >= 0, and the longer
   budget's call (or the one call), profiled, busy no longer than
   `PROFILER_ALLOWANCE` x its unprofiled wall (`_check_rows`; the wall
   slopes are reported, not held: the host moves them far more than the
   device time);
   and the f32 forms of
   K1-K6, K8 and K10 (`phase_f32_kernels`, "kernels f32": K1 at B 8, Q 1 /
   3 / 15 / 64 / 227 and B 1, K2 at L 4 and 32, K3 at N 8 and 40, K4 at steps 0,
   31, 63, K5 at Q 3 and 15, K6 `kvq` and `wq+kvq` at N 40, K8 at N 8 and
   40 at pos 3, 19, 34 with and without pads, K10 in both forms at [8, 20,
   1500, 64]) against their f32 plain versions with TF32 off by the f32
   check (`agreement.F32`, `F32_Q8`), the TF32 and bf16-rounding faults
   refused by 10x and more, timed beside SDPA (K1, K5, K10) and
   `torch.addmm` (K2) in f32, bound at the 3xTF32 rate (`TF32X3_FLOPS`);
   K1-f32, K2-f32 (L 4), K3-f32 and K10-f32, which compute in 3xTF32 on
   the tensor cores, also print their distance to their CPU order's model
   (`model_distance`); then K2 at the local head counts a head split leaves
   a rank, 1, 3 and 5 (`phase_k2_heads`, "kernels K2 local heads": each
   half's 64-column edge tile; L 32, B 8, D 1280, both forms), its C tile
   walk equal to its mirror, against its plain version with its faults
   (the edge tile unwritten or written with its neighbour head among them),
   timed at HD 192 and 320 beside its bound and `torch.addmm`, and K1, K4
   and K5 on those head counts;
4. reference: the greedy and the beam-5 path on the card (bf16, through the
   kernels) against the f32 plain path on the CPU on a small input (`tiny`
   preset), in bf16 and in the int8 forms (greedy with int8 cache and tail
   weights, beam 5 with the int8 cache) and the all-fused greedy path (K7,
   K10, K8), that path also at f32 on the card (K10-f32, K8-f32, K3-f32,
   K1-f32); a beam run with the ancestry map ignored, an int8 beam run
   with the key scales ignored and a fused greedy run whose K8 leaves out
   the step's own slot (bf16 and f32) must fail the check;
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
   id. Each request prints the host seconds of its segmentation and
   embedding spans (`last_run["stage_s"]["segment"]`, `["embed"]`), its
   device-to-host reads (`last_run["counters"]["host_sync"]`) and the
   windows decoded. Then
   the 30 s request's own audio goes through the kaldi fbank, the
   segmentation net and CAM++ on the card and in f32 on the CPU at the same
   weights (`models/net_check.py`: fbank 1e-3, log-probs 1e-3 with the
   argmax equal wherever the CPU's top-2 gap exceeds 1e-3, embeddings
   cosine >= 0.9999), and the planted faults (fbank without pre-emphasis,
   the BiLSTM's backward direction run forward, CAM++'s frame mask
   ignored) must fail that check.
   In 5-14, 16 and 17 each request prints wall time, windows decoded and the launches
   it added; a request that decoded a window must have raised the count of
   every kernel of its path (`PATHS`; the tools of phase 3 are paths too).
   The counts are set to 0 just before each path and read just after;
11. engine, speculative path (`phase_speculative`): an `Engine` at random
   `large-v3` weights (32 + 32 layers, greedy, DTW on, the ladder off, 32
   tokens a window) with `draft_model_path` a small random draft that the
   port's `save_params` wrote under build/chip_smoke/ (large-v3's
   vocabulary and 128 mel bins, D 384, 2 + 2 layers; `draft_snapshot`)
   serves a 30 s whole-file request and a batch of eight 10 s files, first
   with the draft removed, then with it (`speculative_greedy_run` wrapped to
   count rounds); it prints rounds, tokens a round and both wall times.
   Every emitted token must pass the margin check on the card (`spec_gap`:
   within 2e-2 x max|logit| of its position's best token, the target
   teacher-forced over the emitted tokens), and the planted fault,
   `sim_accept=1.0` with that unrelated draft, must fail it;
12. `tools/bench_speculative.py`'s `main()` (`phase_bench_spec`, path
   "bench-spec"): rows greedy, self-g4, turbo-a1.0-g4 and turbo-a0.8-g4,
   each once after a warm-up at large-v3, batch 16, 64 tokens; self-g4
   must need fewer rounds than tokens; greedy and self-g4 pass the margin
   check;
13. checkpoint files (`phase_ggml`, path "ggml"): a q5_0 GGML file and an
   OpenAI `.pt` file at the `tiny` preset through an Engine on the card and
   through the CLI (`__main__.main`); the loaded params must equal the CPU
   load cast to bf16 and cues must come out.
   The reference phase (4) also holds speculative greedy at the `tiny`
   preset, with a self-draft and an unrelated random draft, to the f32 CPU
   greedy decode;
14. engine f32 (`phase_engine_f32`): Engines with `dtype="float32"`
   (32 tokens a window) serve a large-v3 beam-5 30 s request (lang auto,
   ladder on), a large-v3-turbo greedy request with the ladder, a
   `quantize_kv_cache` beam request and a speculative request with the
   2-layer draft written in f32, each its own path of the f32 forms; each
   request's first decode's tokens are teacher-forced on the card and on
   the f32 CPU port (max|logit difference| <= 1e-4 x max|logit|), the bf16
   Engine's logits (a planted fault) must miss that bound, and the beam
   request's encoder output must match the f32 CPU encoder; then, on that
   request's f32 large-v3 weights, the all-fused greedy path at f32 (path
   "f32-fused-greedy": `run_fused_greedy` through K7, K10-f32, K2-f32,
   K8-f32 + K3-f32 a step and K1-f32 at the prompt pass, each required to
   launch; `f32_fused_checks`: the encoder output against
   `encode(flash=False)` within F32_LOGIT_GAP of its max, unmasked padded
   keys refused; the greedy tokens by the margin check against the same
   batch without the front, and stream 0's tokens teacher-forced with K8-f32
   and with the plain front, within F32_LOGIT_GAP, K8's dropped self slot
   refused);
15. train (`phase_train`, after the tool phases): `training.
   make_train_step` at large-v3-turbo width in f32 (TF32 at PyTorch's
   defaults), B 4 (B 2 if 4 runs out of memory), 64 target tokens, 5 AdamW
   steps on one random batch: the loss finite and falling from step 1 to
   step 5, ms a step and peak memory beside the card's name and power
   limit; then a 2 + 2 layer model at turbo widths, one step on the card
   (IEEE f32 products) against the same step on the CPU (loss and global
   gradient norm within TRAIN_REL, each leaf's update within TRAIN_UPDATE
   relative L2);
16. mesh 1 x 1 (`phase_mesh_one_rank`, after the beam Engine): a one-rank
   NCCL mesh Engine serves the beam-5 large-v3 30 s request and the greedy
   turbo 45 s request; its cues and every decode's tokens and
   log-probabilities equal the no-mesh Engine's bit for bit; K1-K4's
   launches printed (paths "mesh-1x1-beam", "mesh-1x1-greedy");
17. two ranks (`phase_two_ranks`, last): one spawn of two gloo ranks
   sharing the card serves a short beam-5 large-v3 request (two 10 s files,
   weights of the JAX init's distribution) on mesh (1, 2) (10 heads a rank
   for K1, K2 and K4) and on (2, 1), in bf16 and in f32; each rank's
   tokens equal the no-mesh run's, avg_logprob within MESH_LOGPROB (bf16)
   or MESH_LOGPROB_F32 (paths "mesh-1x2", "mesh-2x1", "mesh-1x2-f32",
   "mesh-2x1-f32": the ranks' launches); the bf16 (1, 2) request once
   more with its collectives timed (count, seconds, the device's wait
   before them, against its wall), and 500 all-reduces of its [10, 1280]
   f32 activation back to back, on the card and on the host; then
   `dryrun_multigpu(2, "cuda")`
   (path "dryrun-1x2": K5-f32 under the head split among them); the spawn
   also serves a tiny.en-shaped beam-5 request on (1, 2), 3 decoder heads a
   rank (K2's edge tile), held to its no-mesh run (path
   "mesh-1x2-3-heads");
18. dtw (`phase_dtw`, after mesh 1 x 1): the on-device DTW's kernel
   (`csrc/dtw.cu`, `ops/dtw.py::dtw_anchor_frames_batch`) against its plain
   version, anchors equal exactly, at B 8 x Ta 1500 on costs that
   `alignment_cost_batch` makes of real `alignment_cross_attn` maps at
   large-v3 widths (N 32 and 64, the Engine's shapes at 32 and 64 tokens,
   N 224, and N 440, the largest), on 0 / 1 costs with many ties, with rows
   at n_tok 1 and at n_frames < Ta, and at N 33 and 100 with rows at n_tok
   32, 33, 64 and 65 (the warps' handoff at its edges); the kernel's plan
   (`wdt_dtw_plan`) equal to its mirror `dtw_plan`; the planted fault (ties
   prefer up over the diagonal) must move anchors; the kernel timed (N 32,
   64, 224 and 440; ns an anti-diagonal) beside one call of the plain
   version, the port's host native DP on the same costs and the bound by
   bytes. A beam-5 large-v3 Engine
   ("__random__:large-v3:1", 32 tokens, ladder off) serves a 30 s request
   once to warm up, then on the default path and with `WDT_HOST_DTW=1`: the cues and the anchors
   must be identical, the default path must launch the kernel and the host
   path must not; both walls and the alignment stage's peak memory are
   printed. Then `python -m whisper_diarize_tpu_torch.tools.run_config 4`
   (in this process: `run_config.main`) on that 30 s WAV at
   "__random__:large-v3:1", 32 tokens, and the `transcribe` example at
   "__random__:tiny:1" on the card, paths "run-config-4" and
   "example-transcribe" (K1-K4 and the DTW kernel), the report line printed;
   then `python -m whisper_diarize_tpu_torch.tools.bench_longform` in this
   process (`phase_longform`, path "longform": K1-K4 and DTW): 3 minutes of
   one stream at large-v3, beam 5, 64 tokens, after 30 s of warm-up, the
   serial seek loop with the rolling prompt and the resume journal; its
   report line printed, exit 0, and the seconds between segments (the last
   gap left out) no more than 3x as long in the run's last third as in its
   first;
19. with `--profile` only: the 45 s greedy request, the 30 s beam request,
   the 30 s int8 beam request, the fused greedy batch and the 30 s diarized
   request under torch.profiler (device busy time
   and kernel time by kind, also written to build/chip_smoke/profile.txt),
   then each diarization net alone on the 30 s request's audio (CUDA-event
   and profiled device time, `profile_diarize_nets`), then the speculative
   30 s request with and without its draft.
Each phase prints its wall seconds (`[time]`).

Then it prints one JSON line of per-kernel results (the DTW kernel, which
replaces no TPU kernel, as "DTW"; `launches` summed over
the paths' runs; for K1 and K5 also `launches_in_tail`, the launches the
fused tail K3 / K6 makes of them; the f32 forms as "K1-f32" .. "K6-f32",
"K8-f32" and "K10-f32",
whose wrappers' `launches` count in the bf16 rows too), the `nvidia-smi` name and power limit
line, and last
`{"ok": true, "device": {...}}`. It writes only under `build/` of the
checkout.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
from whisper_diarize_tpu_torch.ops import (attn, attn_probe, beam_graph, encoder_attn, front,
                                           mel, stream, tail)
from whisper_diarize_tpu_torch.ops import dtw as dtw_ops
from whisper_diarize_tpu_torch.ops.prng import Threefry
from whisper_diarize_tpu_torch.tokenizer import DebugTokenizer
from whisper_diarize_tpu_torch.tools import (bench_attn_kernel, bench_beam_breakdown,
                                             bench_beam_variants, bench_decode_breakdown,
                                             bench_dma, bench_encoder_attn, bench_f32_attn,
                                             bench_layer_variants, bench_megakernel,
                                             bench_quant_kv, bench_speculative)
from whisper_diarize_tpu_torch.tools.timing import (BF16_FLOPS, F32_FLOPS, TF32X3_FLOPS,
                                                    attn_bound, bound, device_ms,
                                                    device_ms_by_kernel, nvidia_smi_line,
                                                    sum_bound, time_ms)

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
    "DTW": dict(name="dtw_anchor_frames_batch", fn=dtw_ops.dtw_anchor_frames_batch,
                source="whisper_diarize_tpu_torch/csrc/dtw.cu",
                replaces="whisper_diarize_tpu/ops/dtw.py:213",
                note="not a TPU kernel: the JAX package runs the DTW DP and walk as "
                     "XLA loops (lax.scan); one launch here"),
}
# the f32 forms of K1 - K6, K8 and K10, counted apart (each wrapper's
# `launches` counts both of its forms)
KERNELS.update({f"{key}-f32": dict(KERNELS[key], name=f"{KERNELS[key]['name']} [f32]",
                                   count=count)
                for key, count in (("K1", "launches_f32"), ("K2", "launches_f32"),
                                   ("K3", "launches_f32"), ("K4", "launches_f32"),
                                   ("K5", "launches_f32"), ("K6", "launches_int8_f32"),
                                   ("K8", "launches_f32"), ("K10", "launches_f32"))})
# the numbers a kernel's timed row keeps for each shape it is timed at
SHAPE_KEYS = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
              "library_device_ms", "bound_ms", "bound_by")
PATHS = {"greedy": ("K1", "K2", "K3"), "beam": ("K1", "K2", "K3", "K4"),
         "int8-beam": ("K2", "K4", "K5", "K6"), "int8-greedy": ("K2", "K5", "K6"),
         "fused-greedy": ("K1", "K2", "K3", "K7", "K8", "K10"),
         "bench-dma": ("K11",), "bench-attn": ("K1", "K9"), "diarize": ("K1", "K2", "K3"),
         "speculative": ("K1", "K2", "K3"), "bench-spec": ("K1", "K2", "K3"),
         "ggml": ("K1", "K2", "K3"),
         "f32-beam": ("K1-f32", "K2-f32", "K3-f32", "K4-f32"),
         "f32-greedy": ("K1-f32", "K2-f32", "K3-f32"),
         "f32-int8-beam": ("K2-f32", "K4-f32", "K5-f32", "K6-f32"),
         "f32-speculative": ("K1-f32", "K2-f32", "K3-f32"),
         "f32-fused-greedy": ("K1-f32", "K2-f32", "K3-f32", "K7", "K8-f32", "K10-f32"),
         "bench-encoder-attn": ("K10",), "bench-megakernel": ("K1", "K2", "K3", "K4", "K8"),
         "mesh-1x1-greedy": ("K1", "K2", "K3"), "mesh-1x1-beam": ("K1", "K2", "K3", "K4"),
         "mesh-1x2": ("K1", "K2", "K4"), "mesh-2x1": ("K1", "K2", "K3", "K4"),
         "mesh-1x2-f32": ("K1-f32", "K2-f32", "K4-f32"), "mesh-1x2-3-heads": ("K1", "K2", "K4"),
         "mesh-2x1-f32": ("K1-f32", "K2-f32", "K3-f32", "K4-f32"),
         "dryrun-1x2": ("K1-f32", "K2-f32", "K4-f32", "K5-f32"),
         "dtw": ("K1", "K2", "K3", "K4", "DTW"), "run-config-4": ("K1", "K2", "K3", "K4", "DTW"),
         "example-transcribe": ("K1", "K2", "K3", "K4", "DTW"),
         "decode-breakdown": ("K1", "K2", "K3", "K7", "K8"),
         "beam-breakdown": ("K1", "K2", "K3", "K4"), "layer-variants": ("K1", "K2", "K3"),
         "beam-variants": ("K1", "K2", "K3", "K4"),
         "quant-kv": ("K1", "K2", "K3", "K4", "K5", "K6"),
         "longform": ("K1", "K2", "K3", "K4", "DTW")}
# the margin check of a decode on the card: every emitted token within
# TOKEN_GAP x max|logit| of its position's best token (`_greedy_gap`,
# `spec_gap`)
TOKEN_GAP = 2e-2


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


def tail_bound(N: int, beams: int, D: int, Ta: int, wq: bool, kvq: bool,
               es: int = 2) -> dict:
    """K3 / K6 for one layer: the five weights (11 D^2, bf16 or int8 with
    f32 scales), biases and layer norms (12 D), x, self_out and the output
    (N x D), the stream's cross K / V rows; `es` bytes an activation (2, or
    4 for the f32 forms, whose float weights and cache are f32 too and whose
    products run at the 3xTF32 rate, `TF32X3_FLOPS`, but for K5's bf16
    ones)."""
    H, Bc = D // 64, N // beams
    weights = 11 * D * D * (1 if wq else es) + (11 * D * 4 if wq else 0)
    cache = 2 * Bc * H * Ta * (64 + 4 if kvq else 64 * es)
    nbytes = weights + 12 * D * es + 3 * N * D * es + cache
    if es == 2:
        return bound(nbytes, 2 * N * 11 * D * D + 4 * N * H * Ta * 64)
    attn = 4 * N * H * Ta * 64  # at the bf16 rate over the int8 cache (K5)
    return bound(nbytes, 2 * N * 11 * D * D + (0 if kvq else attn), TF32X3_FLOPS)


def f32_attn_bound(B: int, Q: int, H: int, Ta: int, kv_row_bytes: int) -> dict:
    """K1 / K5's f32 forms: q in and out [B, Q, H, 64] f32, one layer's Ta
    K and V rows (`kv_row_bytes` a row: 256 f32, 64 + 4 int8 with its
    scale); the products at the 3xTF32 rate (K1) or K5's bf16 rate."""
    return bound(2 * B * Q * H * 64 * 4 + 2 * B * H * Ta * kv_row_bytes,
                 4 * B * H * Q * Ta * 64, TF32X3_FLOPS if kv_row_bytes == 256 else BF16_FLOPS)


def model_distance(tag: str, got: torch.Tensor, model: torch.Tensor) -> None:
    """Print how far an f32 kernel's result lies from its 3xTF32 model (the
    same products and order on the card's f32 units, `agreement.
    k1_tf32x3_model` / `k2_tf32x3_model` / `k10_tf32x3_model`, the tail's
    products by `skinny_tf32x3_proj`): what the tensor cores' own
    accumulation adds. Read, not checked: the plain version is the
    reference."""
    a = ag.agreement(got, model, tol=ag.F32)
    print(f"[kernels] {tag} vs its 3xTF32 model: rel_l2 {a.rel_l2:.3g}, worst "
          f"{a.worst:.3g} of the f32 bound", flush=True)


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
                              shape=f"B={B} Ta={Ta} D={D} L={L}", **k2_bound(B, Ta, D, D, L, 2))
            del wkv, bias_row
            torch.cuda.empty_cache()

        for Q in ((1, 3, 4, 5, 8, 15, 64) if main else (3, 5, 15)):
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
    come from device memory as in a decode step, not from L2. First the
    kernel's staging plan (`wdt_split_self_plan`) must equal its mirror
    `attn.split_self_plan` at every prompt and step run here, both dtypes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    L, H, K, lay = 32, 20, 5, 17
    lib, plan = kernels.library(), (ctypes.c_int * 4)()
    for f32, P, step in itertools.product((0, 1), (3, 19), range(224)):
        mirror = attn.split_self_plan(K, P, P, step, bool(f32))
        if lib.wdt_split_self_plan(K, P, step, f32, plan) != 0 or tuple(plan) != mirror:
            raise AssertionError(f"K4 plan at prompt {P}, step {step}, f32 {f32}: C "
                                 f"{tuple(plan)}, mirror {mirror}")
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
                        # the step and prompt length in device memory, as
                        # the decode passes them (an int costs a fill a call)
                        it, rest = itertools.count(), _on_device(a[1:])
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


def phase_f32_kernels() -> dict:
    """The f32 forms of K1-K6 against their f32 plain versions on the card
    (TF32 off, `phase_device`) at large-v3 widths by the f32 check
    (`agreement.F32`; `F32_Q8` for K5 and K6 `kvq`, whose products stay
    bf16 and whose plain version is the kernels' split model,
    `agreement.split_attend`): K1 at B 8 with Q 1, 3, 15, 64, 227 and at B 1
    (Q 3), each also at ta 1493; K2 at L 4 and 32 (B 8); K3 at N 8 and 40;
    K4 at B 8, K 5, prompt 3, 64 decode slots, steps 0, 31, 63; K5 at Q 3
    and 15; K6 `kvq` and `wq+kvq` at N 40. At each shape the two f32 faults
    (`agreement.*_f32_faults`: TF32 inputs, the bf16 form's rounding points)
    must be refused by `F32_REFUSAL` or more, and the earlier faults of each
    kernel (K1 at Q 15, K2 at L 4, K3 / K6 at N 40, K4 at step 31, K5 at Q
    15) too. Times (`timed`): kernel, plain version and the library call
    (K1, K5: SDPA in f32; K2: `torch.addmm` in f32), each beside its f32
    bound; K3, K4, K5 and K6 each call on the next layer. Then the f32
    forms of K8 and K10 at `phase_fused_kernels`' shapes: K8 at N 8 and 40
    with a 48-slot cache at pos 3, 19 and 34, with and without pads (its
    faults at pos 19 with pads, judged on self_out; k_new and v_new by the
    check), each timed call on the next layer; K10 in both forms at
    [8, 20, 1500, 64], q and k at 0.5 (the faults) and 1.0 (timed, beside
    SDPA in f32). Returns the results under "K1-f32" .. "K6-f32", "K8-f32"
    and "K10-f32"."""
    cfg = wm.PRESETS["large-v3"]
    dev = torch.device("cuda")
    f32, tol, refuse = torch.float32, ag.F32, ag.F32_REFUSAL
    g = torch.Generator(device=dev).manual_seed(3)
    D, H, L, Ta = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer, cfg.n_audio_ctx
    lay = L - 1
    errs = {f"K{i}-f32": 0.0 for i in (1, 2, 3, 4, 5, 6, 8, 10)}
    res = {}

    def check(key, tag, got, ref, faults=(), base=None, tol=tol):
        errs[key] = max(errs[key], ag.compare(tag, got, ref, base=base, tol=tol).max_abs_err)
        for name, bad in faults:
            new = "TF32" in name or "bf16" in name
            ag.reject(f"{name} (f32)", got, bad, base=base, tol=tol,
                      factor=refuse if new else 1.0)

    def keep(key, shape, t):
        res.setdefault(key, dict(t)).setdefault("by_shape", {})[shape] = {
            k: t[k] for k in SHAPE_KEYS}

    blocks = ag.random_blocks(L, D, g, dev, dtype=f32)
    xa = ag.randn(g, dev, 8, Ta, D, dtype=f32)
    for Lk in (4, L):  # K2 (L 32)
        a = (xa, blocks["ck_w"][:Lk], blocks["cv_w"][:Lk], blocks["cv_b"][:Lk], H)
        k, v = attn.cross_kv_build(*a)
        pk, pv = attn.cross_kv_build_plain(*a)
        faults = list(itertools.chain(ag.k2_f32_faults(*a), ag.k2_faults(*a))) if Lk < L else []
        for i, (got, ref) in enumerate(((k, pk), (v, pv))):
            check("K2-f32", f"K2-f32 {'kv'[i]} B=8 L={Lk}", got, ref,
                  [(n, bad) for n, j, bad in faults if j == i])
        if Lk < L:
            for i, m in enumerate(ag.k2_tf32x3_model(*a)):
                model_distance(f"K2-f32 {'kv'[i]} B=8 L={Lk}", (k, v)[i], m)
        del pk, pv, faults
        wkv = torch.cat([a[1], a[2]], dim=2).permute(1, 0, 2).reshape(D, Lk * 2 * D).contiguous()
        bias_row = torch.cat([torch.zeros_like(a[3]), a[3]], dim=1).reshape(-1)
        x2 = xa.view(-1, D)
        t = timed(f"K2-f32 B=8 L={Lk}", lambda: attn.cross_kv_build(*a),
                  lambda: attn.cross_kv_build_plain(*a),
                  library=lambda: torch.addmm(bias_row, x2, wkv), shape=f"L={Lk}",
                  **k2_bound(8, Ta, D, D, Lk, 4))
        keep("K2-f32", f"L={Lk}", t)
        if Lk == L:
            res["K2-f32"].update({k: t[k] for k in SHAPE_KEYS})
        del wkv, bias_row
    torch.cuda.empty_cache()

    for B in (8, 1):  # K1 on the L 32 cache (B 1: stream 0's slab)
        kb, vb = (k, v) if B == 8 else (k[:, :1].contiguous(), v[:, :1].contiguous())
        for Q in ((1, 3, 15, 64, 227) if B == 8 else (3,)):
            q = ag.randn(g, dev, B, Q, H, 64, scale=2.0, dtype=f32)
            for ta in (Ta, Ta - 7):
                a = (lay, q, kb, vb, ta)
                faults = ag.k1_f32_faults(*a) if ta == Ta else ()
                if ta == Ta and B == 8 and Q == 15:
                    faults = itertools.chain(faults, ag.k1_faults(*a))
                got = attn.cross_attn_layer(*a)
                check("K1-f32", f"K1-f32 B={B} Q={Q} ta={ta}", got,
                      attn.cross_attn_layer_plain(*a), faults)
                model_distance(f"K1-f32 B={B} Q={Q} ta={ta}", got, ag.k1_tf32x3_model(*a))
            a = (lay, q, kb, vb, Ta)
            qt, kl, vl = q.transpose(1, 2), kb[lay], vb[lay]
            t = timed(f"K1-f32 B={B} Q={Q}", lambda: attn.cross_attn_layer(*a),
                      lambda: attn.cross_attn_layer_plain(*a),
                      library=lambda: F.scaled_dot_product_attention(qt, kl, vl),
                      shape=f"B={B} Q={Q}", **f32_attn_bound(B, Q, H, Ta, 256))
            keep("K1-f32", f"B={B} Q={Q}", t)
            if B == 8 and Q == 3:
                res["K1-f32"].update({k: t[k] for k in SHAPE_KEYS})

    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    for Q in (3, 15):  # K5 over the int8 cache, f32 q / out
        q = ag.randn(g, dev, 8, Q, H, 64, scale=2.0, dtype=f32)
        for ta in (Ta, Ta - 7):
            a = (lay, q, k8, ks, v8, vs, ta)
            faults = ag.k5_f32_faults(*a) if ta == Ta else ()
            if ta == Ta and Q == 15:
                faults = itertools.chain(faults, ag.k5_faults(*a))
            check("K5-f32", f"K5-f32 Q={Q} ta={ta}", attn.cross_attn_layer_q8(*a),
                  ag.split_attend(lay, q, k8, v8, ta, ks, vs), faults, tol=ag.F32_Q8)
        it, rest = itertools.count(), (q, k8, ks, v8, vs, Ta)
        qt = q.transpose(1, 2)
        t = timed(f"K5-f32 Q={Q}", lambda: attn.cross_attn_layer_q8(next(it) % L, *rest),
                  lambda: attn.cross_attn_layer_q8_plain(next(it) % L, *rest),
                  library=lambda: F.scaled_dot_product_attention(qt, k[lay], v[lay]),
                  shape=f"B=8 Q={Q}", **f32_attn_bound(8, Q, H, Ta, 64 + 4))
        keep("K5-f32", f"Q={Q}", t)
        if Q == 3:
            res["K5-f32"].update({k: t[k] for k in SHAPE_KEYS})

    q8w = tail.quantize_tail_weights(blocks)
    for beams in (1, 5):  # K3, and K6 at N 40
        N = 8 * beams
        x = ag.randn(g, dev, N, 1, D, dtype=f32)
        so = ag.randn(g, dev, N, H, 1, 64, scale=0.3, dtype=f32)
        forms = [("K3-f32", "", blocks, (k, v, None, None))]
        if N == 40:
            forms += [("K6-f32", "kvq", blocks, (k8, v8, ks, vs)),
                      ("K6-f32", "wq+kvq", q8w, (k8, v8, ks, vs))]
        for key, form, w, c in forms:
            a = (lay, x, so, w, c[0], c[1], beams, Ta, c[2], c[3])
            kvq = c[2] is not None
            faults = ag.tail_f32_faults(key[:2], *a)
            if N == 40:
                old = ag.k6_faults(*a) if kvq else ag.k3_faults(*a[:8])
                faults = itertools.chain(faults, old, ag.tail_split_faults(key[:2], *a))
            attend = ag.split_attend if kvq else None
            got = tail.fused_tail_layer(*a)
            check(key, f"{key} {form} N={N}".replace("  ", " "), got,
                  tail.fused_tail_layer_plain(*a, attend=attend), faults, base=x,
                  tol=ag.F32_Q8 if kvq else tol)
            if not form:
                model_distance(f"K3-f32 N={N}", got, tail.fused_tail_layer_plain(
                    *a, proj=ag.skinny_tf32x3_proj(N, D),
                    attend=lambda l, q, k_, v_, ta, ks_, vs_: ag.k1_tf32x3_model(l, q, k_, v_, ta)))
            it, rest = itertools.count(), a[1:]
            t = timed(f"{key} {form} N={N}".replace("  ", " "),
                      lambda: tail.fused_tail_layer(next(it) % L, *rest),
                      lambda: tail.fused_tail_layer_plain(next(it) % L, *rest),
                      shape=f"{form} N={N}".strip(),
                      **tail_bound(N, beams, D, Ta, form.startswith("wq"), kvq, es=4))
            keep(key, f"{form} N={N}".strip(), t)
            if N == 40 and form in ("", "kvq"):
                res[key].update({k: t[k] for k in SHAPE_KEYS})
    del k, v, k8, ks, v8, vs, blocks, q8w, xa
    torch.cuda.empty_cache()

    B, K, Tp, Td = 8, 5, 3, 64  # K4
    q = ag.randn(g, dev, B, K, H, 64, scale=2.0, dtype=f32)
    pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64, dtype=f32) for _ in range(2))
    dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64, dtype=f32) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, device=dev, dtype=torch.int32)
    row_pad = torch.randint(0, 2, (B,), generator=g, device=dev, dtype=torch.int32)
    for step in (0, 31, 63):
        a = (lay, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp)
        faults = ag.k4_f32_faults(*a)
        if step == 31:
            faults = itertools.chain(faults, ag.k4_faults(*a))
        check("K4-f32", f"K4-f32 step={step}", attn.split_self_attn_layer(*a),
              attn.split_self_attn_layer_plain(*a), faults)
        it, rest = itertools.count(), _on_device(a[1:])
        rows = B * H * Tp + B * K * H * (step + 1)
        t = timed(f"K4-f32 step={step}", lambda: attn.split_self_attn_layer(next(it) % L, *rest),
                  lambda: attn.split_self_attn_layer_plain(next(it) % L, *rest),
                  shape=f"step={step}",
                  **bound(2 * B * K * H * 64 * 4 + rows * 64 * 4 * 2 + B * K * Td * 4 + B * 4,
                          4 * B * K * H * (Tp + step + 1) * 64, TF32X3_FLOPS))
        keep("K4-f32", f"step={step}", t)
        if step == 31:
            res["K4-f32"].update({k: t[k] for k in SHAPE_KEYS})
    del q, pk, pv, dk, dv

    fw = ag.random_front(L, D, g, dev, dtype=f32)  # K8 at phase_fused_kernels' shapes
    Tc = 48
    for N in (8, 40):
        x = ag.randn(g, dev, N, 1, D, dtype=f32)
        kc, vc = (ag.randn(g, dev, L, N, H, Tc, 64, dtype=f32) for _ in range(2))
        pads = torch.randint(0, 17, (N,), generator=g, device=dev)
        for pos in (3, 19, 34):
            for row_pad in (torch.zeros_like(pads), pads.clamp(max=pos)):
                a = (lay, pos, row_pad, x, fw)
                got = front.fused_front_layer(*a, kc.clone(), vc.clone())
                ref = front.fused_front_layer_plain(*a, kc.clone(), vc.clone())
                tag = f"K8-f32 N={N} Tc={Tc} pos={pos} pads={bool(row_pad.any())}"
                for what, x1, x2 in zip(("k_new", "v_new"), got[1:], ref[1:]):
                    check("K8-f32", f"{tag} {what}", x1, x2)
                faults = ()
                if pos == 19 and row_pad.any():
                    faults = itertools.chain(ag.k8_f32_faults(*a, kc, vc),
                                             ag.k8_faults(*a, kc, vc))
                check("K8-f32", f"{tag} self_out", got[0], ref[0], faults)
        it, zeros, pos = itertools.count(), torch.zeros_like(pads), 19
        t = timed(f"K8-f32 N={N} pos={pos}",
                  lambda: front.fused_front_layer(next(it) % L, pos, zeros, x, fw, kc, vc),
                  lambda: front.fused_front_layer_plain(next(it) % L, pos, zeros, x, fw, kc, vc),
                  shape=f"N={N}", **front_bound(N, D, pos, zeros, es=4))
        keep("K8-f32", f"N={N}", t)
        if N == 8:
            res["K8-f32"].update({k: t[k] for k in SHAPE_KEYS})
        del kc, vc
    del fw
    torch.cuda.empty_cache()

    shape = (8, H, Ta, 64)  # K10 at the encoder's shape
    for scale in (0.5, 1.0):
        q, k, v = (ag.randn(g, dev, *shape, scale=s, dtype=f32) for s in (scale, scale, 1.0))
        for single_pass in (True, False):
            form = "single pass" if single_pass else "two pass"
            a = (q, k, v, Ta, single_pass)
            faults = ()
            if scale == 0.5:
                faults = itertools.chain(ag.k10_f32_faults(*a), ag.k10_faults(*a))
            got = encoder_attn.encoder_self_attention(*a)
            check("K10-f32", f"K10-f32 {form} {list(shape)} q,k scale {scale}", got,
                  encoder_attn.encoder_self_attention_plain(*a), faults)
            model_distance(f"K10-f32 {form} q,k scale {scale}", got,
                           ag.k10_tf32x3_model(q, k, v, Ta))
            if scale == 0.5:
                continue
            t = timed(f"K10-f32 {form}", lambda: encoder_attn.encoder_self_attention(*a),
                      lambda: encoder_attn.encoder_self_attention_plain(*a),
                      library=lambda: F.scaled_dot_product_attention(q, k, v),
                      shape=form, **bound(4 * q.numel() * 4, 4 * shape[0] * H * Ta * Ta * 64,
                                          TF32X3_FLOPS))
            keep("K10-f32", form, t)
            if single_pass:
                res["K10-f32"].update({k: t[k] for k in SHAPE_KEYS})
        del q, k, v
        torch.cuda.empty_cache()
    for key in res:
        res[key]["max_abs_err"] = errs[key]
    torch.cuda.empty_cache()
    return res


K2_LOCAL_HEADS = (1, 3, 5)  # a rank's decoder heads: base.en / 8, tiny.en / 2, large-v3 / 4


def k2_bound(B: int, Ta: int, D: int, HD: int, L: int, es: int) -> dict:
    """K2 at HD = H * 64 columns a half: xa read once, both weights and the
    V bias, K and V written; 4 L B Ta D HD operations (bf16, or 3xTF32 at
    `es` 4)."""
    return bound(B * Ta * D * es + 2 * L * D * HD * es + L * HD * es + 2 * L * B * Ta * HD * es,
                 4 * L * B * Ta * D * HD, TF32X3_FLOPS if es == 4 else BF16_FLOPS)


def phase_k2_heads() -> dict:
    """K2 at the local head counts a head split leaves a rank (`K2_LOCAL_HEADS`:
    1 and 5 need the 64-column edge tile of each half, 3 too) at large-v3's
    D 1280, Ta 1500, L 32, B 8, in bf16 and f32: first the C tile walk
    (`wdt_cross_kv_tile`) equal to its mirror `attn.cross_kv_tile` at every
    tile (and at 20 heads, the whole model), then the kernel against its
    plain version by the agreement check, its faults refused (the edge tile
    left unwritten or written with its neighbour head among them; the f32
    ones by `F32_REFUSAL`), two calls the same bits, and timed at 3 and 5
    heads (HD 192 and 320) beside the bound and one `torch.addmm` of xa
    against [ck_w | cv_w]. On each head count's cache: K1 (Q 5, a beam
    step's queries), K5 over its int8 form (bf16: the plain version; f32:
    the split model, `F32_Q8`) and K4 (K 5, prompt 3, 64 decode slots, step
    31) against their plain versions, as the head split runs them. Returns
    {"K2" | "K2-f32": {"rows": {...}, "max_abs_err": x}, "K1" ...: {...}}."""
    cfg = wm.PRESETS["large-v3"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    D, L, Ta, B, lay = cfg.n_text_state, cfg.n_text_layer, cfg.n_audio_ctx, 8, cfg.n_text_layer - 1
    lib, out = kernels.library(), (ctypes.c_int * 6)()
    for H, f32 in itertools.product(K2_LOCAL_HEADS + (cfg.n_text_head,), (0, 1)):
        n = attn.cross_kv_tiles(L, B, Ta, 64 * H, bool(f32))
        for i in range(n):
            want = (*attn.cross_kv_tile(i, L, B, Ta, 64 * H, bool(f32)), n)
            if lib.wdt_cross_kv_tile(i, L, B, Ta, H, f32, out) != 0 or tuple(out) != want:
                raise AssertionError(f"K2 walk H={H} f32={f32} tile {i}: C {tuple(out)}, "
                                     f"mirror {want}")
        if lib.wdt_cross_kv_tile(n, L, B, Ta, H, f32, out) == 0:
            raise AssertionError(f"K2 walk H={H} f32={f32}: tile {n} is past the walk")
        print(f"[kernels] K2 tile walk H={H} f32={f32}: {n} tiles, C equal to the mirror",
              flush=True)
    res = {key: {"rows": {}, "max_abs_err": 0.0}
           for key in ("K2", "K2-f32", "K1", "K1-f32", "K4", "K4-f32", "K5", "K5-f32")}

    def check(key, tag, got, ref, tol, faults=()):
        a = ag.compare(tag, got, ref, tol=tol)
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], a.max_abs_err)
        for name, bad in faults:
            new = "TF32" in name or "bf16" in name
            ag.reject(f"{name} ({tag})", got, bad, tol=tol, factor=ag.F32_REFUSAL if new else 1.0)

    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        sfx, tol, es = ("-f32", ag.F32, 4) if f32 else ("", ag.BF16, 2)
        xa = ag.randn(g, dev, B, Ta, D, dtype=dtype)
        for H in K2_LOCAL_HEADS:
            HD = 64 * H
            ck, cv = (ag.randn(g, dev, L, D, HD, scale=D ** -0.5, dtype=dtype) for _ in range(2))
            cb = ag.randn(g, dev, L, HD, scale=ag.BIAS_SCALE, dtype=torch.float32).to(dtype)
            a = (xa, ck, cv, cb, H)
            k, v = attn.cross_kv_build(*a)
            k2, v2 = attn.cross_kv_build(*a)
            if not (torch.equal(k, k2) and torch.equal(v, v2)):
                raise AssertionError(f"K2{sfx} H={H}: two calls differ")
            del k2, v2
            ref = attn.cross_kv_build_plain(*a)
            faults = list(ag.k2_faults(*a)) + (list(ag.k2_f32_faults(*a)) if f32 else [])
            names = [n for n, _, _ in faults]
            if "K2 the edge tile left unwritten" not in names and H % 2:
                raise AssertionError(f"K2 H={H}: no edge-tile fault planted")
            for i in range(2):
                check(f"K2{sfx}", f"K2{sfx} {'kv'[i]} H={H} (HD {HD}) B={B} Ta={Ta} L={L}",
                      (k, v)[i], ref[i], tol, [(n, bad) for n, j, bad in faults if j == i])
            del ref, faults
            if H > 1:
                wkv = torch.cat([ck, cv], dim=2).permute(1, 0, 2).reshape(D, L * 2 * HD)
                wkv = wkv.contiguous()
                bias_row = torch.cat([torch.zeros_like(cb), cb], dim=1).reshape(-1)
                x2 = xa.view(B * Ta, D)
                t = timed(f"K2{sfx} H={H} (HD {HD}) B={B} L={L}", lambda: attn.cross_kv_build(*a),
                          lambda: attn.cross_kv_build_plain(*a),
                          library=lambda: torch.addmm(bias_row, x2, wkv),
                          shape=f"H={H} HD={HD} B={B} Ta={Ta} D={D} L={L}",
                          **k2_bound(B, Ta, D, HD, L, es))
                res[f"K2{sfx}"]["rows"][f"H={H}"] = {k_: t[k_] for k_ in SHAPE_KEYS}
                del wkv, bias_row
            # K1 (a beam step's 5 queries) and K5 over the int8 form of this cache
            q = ag.randn(g, dev, B, 5, H, 64, scale=2.0, dtype=dtype)
            check(f"K1{sfx}", f"K1{sfx} H={H} B={B} Q=5", attn.cross_attn_layer(lay, q, k, v, Ta),
                  attn.cross_attn_layer_plain(lay, q, k, v, Ta), tol)
            k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
            q8 = (lay, q, k8, ks, v8, vs, Ta)
            check(f"K5{sfx}", f"K5{sfx} H={H} B={B} Q=5", attn.cross_attn_layer_q8(*q8),
                  ag.split_attend(lay, q, k8, v8, Ta, ks, vs) if f32
                  else attn.cross_attn_layer_q8_plain(*q8), ag.F32_Q8 if f32 else tol)
            del k, v, k8, ks, v8, vs, ck, cv, cb
            # K4: a beam-5 step over this many heads (2 layers)
            K, Tp, Td = 5, 3, 64
            qs = ag.randn(g, dev, B, K, H, 64, scale=2.0, dtype=dtype)
            pk, pv = (ag.randn(g, dev, 2, B, H, Tp, 64, dtype=dtype) for _ in range(2))
            dk, dv = (ag.randn(g, dev, 2, B * K, H, Td, 64, dtype=dtype) for _ in range(2))
            anc = torch.randint(0, K, (B, K, Td), generator=g, device=dev, dtype=torch.int32)
            pad = torch.zeros((B,), dtype=torch.int32, device=dev)
            s4 = (1, qs, pk, pv, dk, dv, anc, 31, pad, Tp)
            check(f"K4{sfx}", f"K4{sfx} H={H} B={B} K={K} step=31",
                  attn.split_self_attn_layer(*s4), attn.split_self_attn_layer_plain(*s4), tol)
            torch.cuda.empty_cache()
        del xa
    torch.cuda.empty_cache()
    return res


def front_bound(N: int, D: int, pos: int, row_pad, es: int = 2) -> dict:
    """K8 for one layer: the packed [D, 3D] weights, biases and ln1, x and
    self_out, the new K/V written, the valid cache rows (row_pad[n] .. pos)
    read as K and V; `es` bytes a value (4: the f32 form, its products at
    the 3xTF32 rate)."""
    rows = int((pos + 1 - row_pad.clamp(max=pos)).sum()) * (D // 64)
    return bound((3 * D * D + 5 * D + 4 * N * D + rows * 64 * 2) * es,
                 2 * N * D * 3 * D + 4 * rows * 64, BF16_FLOPS if es == 2 else TF32X3_FLOPS)


def mel_bound(B: int, T: int, n_mels: int) -> dict:
    """K7: the audio read and the raw log-mel written (f32), and the
    operations log-mel needs a frame: the Hann window (400), a real
    400-point FFT (2.5 N log2 N), the power (3 a bin), the filterbank's
    nonzero weights (2 each) and a log a mel, at the f32 rate. (K7 runs the
    FFT and the power in float64: at the data sheet's 34 TFLOP/s those take
    7.1 us at B 8 x 30 s, still under the bytes' 8.3 us.)"""
    frames = B * (T // 160)
    nnz = int(np.count_nonzero(mel.mel_filterbank(n_mels)))
    per_frame = 400 + 2.5 * 400 * math.log2(400) + 3 * 201 + 2 * nnz + n_mels
    return bound(B * T * 4 + frames * n_mels * 4, frames * per_frame, F32_FLOPS)


def phase_fused_kernels() -> dict:
    """K7, K8 and K10 against their plain versions at the fused greedy
    path's shapes (large-v3: 128 mels, D 1280, H 20, 32 layers), their
    planted faults refused. K7 on B 8 x 30 s of audio (f32, held to
    `agreement.F32_ATOL`; one kernel a call, two calls the same bits; its
    distance to the float64 log-mel printed beside the plain f32 version's
    and the cuFFT route's; library: the cuFFT route, several calls). K8 at
    N 8 (greedy) and 40 (the best_of 5 rung) with a 48-slot cache (32
    tokens after a 3-token prompt) at pos 3, 19 and 34, without pads and
    with random pads (the faults at pos 19, with pads); each call on the
    next layer (a layer's weights are 9.8 MB), the
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
    window = torch.hann_window(400, device=dev)
    fb = torch.from_numpy(mel.mel_filterbank(cfg.n_mels)).to(dev)
    route = bench_f32_attn.cufft_log_mel(audio, window, fb).transpose(-1, -2)
    print(f"[kernels] K7 max abs distance to the float64 log-mel: kernel "
          f"{float((got - exact).abs().max()):.4g}, plain f32 "
          f"{float((plain - exact).abs().max()):.4g}, cuFFT route "
          f"{float((route - exact).abs().max()):.4g} (F32_ATOL {ag.F32_ATOL:g})", flush=True)
    del plain, exact, route
    for name, bad in ag.k7_faults(audio, cfg.n_mels):
        ag.reject(name, got, bad, atol=ag.F32_ATOL)
    if not torch.equal(got, mel.log_mel_fused(audio, cfg.n_mels)):
        raise AssertionError("K7: two calls gave different bits")
    launched = device_ms_by_kernel(lambda: mel.log_mel_fused(audio, cfg.n_mels))
    print(f"[kernels] K7 kernels a call: {sorted(launched)}", flush=True)
    if len(launched) != 1:
        raise AssertionError(f"K7: a call launched {sorted(launched)}, not one kernel")
    res["K7"] = timed(f"K7 B={B} T={T}", lambda: mel.log_mel_fused(audio, cfg.n_mels),
                      lambda: mel.log_mel_fused_plain(audio, cfg.n_mels),
                      library=lambda: bench_f32_attn.cufft_log_mel(audio, window, fb),
                      library_calls="several: the cuFFT route (torch.stft, |.|^2, the "
                                    "filterbank product, log10)",
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


def phase_tool(path: str, runs, keys=("ms", "device_ms", "bound_ms")) -> dict:
    """One tool on the card (`runs`: (main, keyword arguments), one a run);
    the launch counts are set to 0 just before and read just after, and
    every kernel of the path (`PATHS`) must have launched. Every row must
    carry a positive, finite value under each of `keys` (the diagnostic
    tools: time, device time and bound). Returns the path's counts."""
    reset_counts()
    rows = [row for main, kw in runs for row in main(**kw)]
    torch.cuda.synchronize()
    added = counts()
    bad = [r for r in rows if not all(
        math.isfinite(r[key]) and r[key] > 0 for key in keys)]
    print(f"[tool {path}] {len(rows)} rows, launches {added}", flush=True)
    if bad:
        raise AssertionError(f"tool {path}: rows without a positive finite time: {bad}")
    _check_missing(f"tool {path}", path, added)
    torch.cuda.empty_cache()
    return added


# timed calls a budget of the breakdown tools' phases here, after a warm-up
# one (the tools take 5): one keeps the five phases near 300 s of the run
BREAKDOWN_REPEAT = 1
# the profiler lengthens the kernels of a call the card runs end to end:
# the encoder reads 482.9 ms profiled against 479.3 ms by CUDA events
# (0.7%, NVIDIA H100 80GB HBM3, 700.00 W); a profiled call's busy time is
# held within this factor of the same call's unprofiled wall
PROFILER_ALLOWANCE = 1.05


# a breakdown row's keys: its wall and device ms and launches a step, and
# its (device, wall) ms of whole calls, profiled busy time against the
# unprofiled wall
ROW_KEYS = dict(wall="wall_ms", device="device_ms", launches="launches",
                calls=(("device_long_ms", "wall_long_ms"),))


def _row_faults(r: dict, wall: str, device: str, launches: str, calls) -> list:
    """What a breakdown row breaks of `_check_rows`'s rules."""
    faults = [k for k in (wall, device, launches, *(k for c in calls for k in c))
              if r[k] is None or not math.isfinite(r[k])]
    if faults:
        return [f"not finite: {faults}"]
    if r[launches] < 0 or r[launches] != round(r[launches]):
        faults.append(f"launches a step {r[launches]} not whole and >= 0")
    if r.get("phase", "").strip() == "residual":
        # prefill less its parts, each timed and profiled on its own: its
        # times are differences of separate calls' and may fall below 0
        return faults
    if r[device] < 0:
        faults.append(f"device {r[device]} ms a step < 0")
    faults += [f"{d} {r[d]:.3f} > {PROFILER_ALLOWANCE} x {w} {r[w]:.3f}"
               for d, w in calls if r[d] > PROFILER_ALLOWANCE * r[w]]
    return faults


def _check_rows(path: str, rows, keys=ROW_KEYS) -> None:
    """Every row of a breakdown tool: its wall, device time and launches a
    step finite, its launches a step whole and >= 0 (each step launches
    the same kernels) and its device time a step >= 0; and each whole call
    it profiled (the longer budget's, or the one call) busy, the union of
    its kernels' intervals, no longer than `PROFILER_ALLOWANCE` x the same
    call's unprofiled wall. The wall slopes and the busy share are
    reported, not held: a slope is the difference of two calls and carries
    the host's noise in both. `residual` (prefill less its parts) is held
    to finite values and whole launches only."""
    bad = [(r.get("phase", r.get("variant")), f) for r in rows
           for f in _row_faults(r, **keys)]
    if bad:
        raise AssertionError(f"tool {path}: rows that break the checks: {bad}")


def phase_breakdown(path: str, run, rows_of, keys=ROW_KEYS, check=None) -> dict:
    """One breakdown tool's `main()` on the card at large-v3 and batch 16,
    in this process: the launch counts set to 0 just before and read just
    after, every kernel of the path (`PATHS`) launched; the rows checked
    by `_check_rows`, then `check(result)` where given. Returns the path's
    counts."""
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    added = counts()
    rows = rows_of(out)
    print(f"[tool {path}] {len(rows)} rows, launches {added}", flush=True)
    _check_rows(path, rows, keys)
    if check is not None:
        check(out)
    _check_missing(f"tool {path}", path, added)
    del out
    torch.cuda.empty_cache()
    return added


def _gap_check(tag: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """The margin rule (`TOKEN_GAP`) between two paths' logits at one step
    (`bench_decode_breakdown.token_gap`)."""
    gap = bench_decode_breakdown.token_gap(got, ref)
    print(f"[tool] {tag}: token gap {gap:.3g} x max|logit| (tol {TOKEN_GAP:g}; max |logit "
          f"diff| / max |logit| {float((got - ref).abs().max() / ref.abs().max()):.3g})",
          flush=True)
    if not gap <= TOKEN_GAP:
        raise AssertionError(f"{tag}: logit gap {gap} > {TOKEN_GAP}")


def breakdown_runs(rep: int) -> dict:
    """`phase_breakdown`'s arguments for each of the five breakdown tools
    (`tools/bench_decode_breakdown.py`, `bench_beam_breakdown`,
    `bench_layer_variants`, `bench_beam_variants`, `bench_quant_kv`) at
    large-v3, batch 16, budgets 32 and 64, best of `rep`, each in this
    process, by path."""
    return {
        "decode-breakdown": dict(
            run=lambda: bench_decode_breakdown.main(smoke=False, repeat=rep),
            rows_of=lambda o: o.rows,
            check=lambda o: _gap_check("model_only +front vs model_only, last step",
                                       o.logits["model_only +front"][1],
                                       o.logits["model_only"][1])),
        "beam-breakdown": dict(
            run=lambda: bench_beam_breakdown.main(smoke=False, repeat=rep, inline=True),
            rows_of=list),
        "layer-variants": dict(
            run=lambda: bench_layer_variants.main(smoke=False, repeat=rep),
            rows_of=lambda o: o.rows,
            check=lambda o: _gap_check("v1b unfused vs v0 baseline, last step",
                                       o.out["v1b unfused"][1], o.out["v0 baseline"][1])),
        "beam-variants": dict(
            run=lambda: bench_beam_variants.main(smoke=False, repeat=rep, inline=True),
            rows_of=list),
        "quant-kv": dict(
            run=lambda: bench_quant_kv.main(smoke=False, repeat=rep, inline=True),
            rows_of=list, keys=dict(wall="ms_per_step", device="device_ms_per_step",
                                    launches="launches_per_step",
                                    calls=(("t64_device_ms", "t64_ms"),
                                           ("init_device_ms", "init_ms")))),
    }


def breakdown_phases() -> dict:
    """The five breakdown tools on the card (`breakdown_runs`, best of
    `BREAKDOWN_REPEAT`), each a phase and a path of its own."""
    return {path: timed_phase(f"tool {path}", lambda kw=kw, path=path: phase_breakdown(
        path, **kw)) for path, kw in breakdown_runs(BREAKDOWN_REPEAT).items()}


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
    plain f32 greedy path, with the greedy check, in bf16 and at f32 on the
    card (the f32 forms of K10, K8, K3 and K1: its encoder output and its
    tokens' logit gaps within F32_LOGIT_GAP, f32 on both sides); a run whose
    K8 leaves the step's own slot out of its attention must fail the check,
    in either dtype."""
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
    tol, out, ok = TOKEN_GAP, {}, True
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
        # the same path at f32 on the card (K7, K10-f32, K8-f32, K3-f32, K1-f32)
        rel_32, out["fused-greedy f32"], fault_32 = fused_reference(
            weights.params_from_jax(tree, "cuda", torch.float32), cfg, tk, base, audio,
            steps["ref", "greedy"], ref, prompt)
        tol32 = F32_LOGIT_GAP  # f32 on both sides: the card's tokens are the CPU's best
        ok &= rel_32 <= tol32 and out["fused-greedy f32"] <= tol32 < fault_32
        print(f"[reference] fused-greedy f32 (K7, K10-f32, K8-f32): encoder rel err "
              f"{rel_32:.4g}, worst card-token logit gap vs f32 CPU best, of max|logit| "
              f"{out['fused-greedy f32']:.4g} (tol {tol32:g} each); planted fault, K8-f32 self "
              f"slot dropped: {fault_32:.4g} ({'refused' if fault_32 > tol32 else 'NOT refused'})",
              flush=True)
        # speculative greedy (the draft's steps on K3, the verify pass on K1
        # at Q = 4) with a self-draft and an unrelated random draft, held to
        # the f32 CPU greedy decode by the greedy check
        from whisper_diarize_tpu_torch.ops import speculative

        card = steps["card", "greedy"]
        other = weights.params_from_jax(wm.init_params_np(cfg, seed=99), "cuda", torch.bfloat16)
        drafts = {"speculative self-draft": (params["card"], xa["card"]),
                  "speculative unrelated draft": (other, wm.encode(other, card.mel(audio), cfg))}
        for name, (pd, xd) in drafts.items():
            res, rounds = speculative.speculative_greedy_run(
                params["card"], cfg, pd, cfg, base, tk.specials, xa["card"], xd,
                prompt[None].repeat(2, 1).cuda(), len(prompt), card._suppress, gamma=4)
            out[name] = err = _greedy_gap(steps["ref", "greedy"], ref, prompt, res)
            ok &= err <= tol
            print(f"[reference] {name}: lengths {res.lengths.tolist()}, rounds {int(rounds)}, "
                  f"worst card-token logit gap vs f32 CPU best, of max|logit| {err:.4g} "
                  f"(tol {tol:g})", flush=True)
        del other, drafts
        # planted faults: each must fail its check
        real_step = wm.decode_step_split

        def ancestry_ignored(*a, **k):
            anc = a[-1]
            own = torch.arange(anc.shape[0], device=anc.device)[:, None].expand_as(anc)
            return real_step(*a[:-1], own, **k)

        # the eager step: a captured beam graph replays the real forward
        real_engages = beam_graph.engages
        wm.decode_step_split, beam_graph.engages = ancestry_ignored, lambda *a: False
        try:
            bad = steps["card", "beam"].decode(xa["card"], "en", "transcribe")
        finally:
            wm.decode_step_split, beam_graph.engages = real_step, real_engages
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
IN_TAIL = {"K1 in K3 / K6": "cross_attn_launches", "K5 in K6": "cross_attn_q8_launches",
           "K1-f32 in K3-f32 / K6-f32": "cross_attn_launches_f32",
           "K5-f32 in K6-f32": "cross_attn_q8_launches_f32"}


def _on_device(k4_args: tuple) -> tuple:
    """K4's arguments after the layer with the step and the prompt's length
    as device int32s (the kernel reads them there)."""
    q, pk, pv, dk, dv, anc, step, row_pad, prompt_len = k4_args
    at = lambda v: torch.tensor([v], dtype=torch.int32, device=q.device)  # noqa: E731
    return q, pk, pv, dk, dv, anc, at(step), row_pad, at(prompt_len)


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
              f"{sum(len(c) for c in cue_lists)}, launches added {added}, host syncs "
              f"{eng.last_run['counters'].get('host_sync', 0)}, stage host s "
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
                                  generator=Threefry(0),
                                  suppress_mask=suppress, cross=cross)
        mark()
    stages = dict(zip(("mel", "encode", "decode", "best_of 5 rung"),
                      (round(b - a, 3) for a, b in zip(marks, marks[1:]))))
    return frames, xa, res, rung, stages


def phase_fused_greedy(eng, path: str = "fused-greedy") -> dict:
    """The all-fused greedy path at large-v3 width on `eng`'s loaded
    weights (32 + 32 layers): one batch of 8 windows of 30 s, 32 tokens a
    window (`run_fused_greedy`). The counts are set to 0 just before and
    read just after; the kernels of `path` must have launched (K1, K2, K3,
    K7, K8 and K10, or at f32 their f32 forms and K7). The frontend must
    equal the plain `log_mel_spectrogram` within `agreement.F32_ATOL` / 4
    (its scale after the (x + 4) / 4); every output must be finite and of
    its shape. Prints wall seconds per stage. On f32 weights, then
    `f32_fused_checks`. Returns the path's counts."""
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
    print(f"[path {path}] large-v3, 8 windows of 30 s: wall by stage {stages} s; "
          f"shapes {shapes}; frontend vs plain max abs {mel_err:.3g}; greedy lengths "
          f"{res.lengths.tolist()}, rung lengths {rung.lengths.tolist()}; launches added "
          f"{added}", flush=True)
    want = ((8, cfg.n_mels, 3000), (8, cfg.n_audio_ctx, cfg.n_audio_state), (8, 32), (8, 32))
    if not finite or shapes != want or mel_err > ag.F32_ATOL / 4:
        raise AssertionError(f"{path} path: finite {finite}, shapes {shapes} "
                             f"(want {want}), frontend vs plain {mel_err}")
    _check_missing(f"{path} path", path, added)
    if xa.dtype == torch.float32:
        f32_fused_checks(setup, frames, xa, res)
    return added


def f32_fused_checks(setup, frames, xa, res) -> None:
    """The f32 fused greedy path's output, on the card with TF32 off,
    against the same weights without its fused stages:
    - the encoder output (K10-f32 in every layer) against
      `encode(flash=False)` (the plain f32 attention) within F32_LOGIT_GAP
      of its max; an encoder whose attention leaves the keys past T
      unmasked (zero-padded to a multiple of 512, a planted fault) must
      miss;
    - the greedy tokens (K8-f32 and K3-f32 a step) by the margin check
      (`spec_gap`) against the same batch decoded without the front,
      within F32_LOGIT_GAP x max|logit| (TOKEN_GAP is bf16's: f32 on both
      sides leaves only ties);
    - stream 0's emitted tokens teacher-forced with the front and without
      (`_teacher_logits`: K8-f32 against the plain f32 front at every
      step), max|logit difference| within F32_LOGIT_GAP x max|logit|; the
      same with K8's self slot dropped (a planted fault) must miss. At
      random large-v3 weights that fault leaves the greedy tokens as they
      were, so the margin check alone cannot see it."""
    fused, cfg, tk, dc, suppress, prompt, _ = setup
    plain = {**fused, "decoder": {k: v for k, v in fused["decoder"].items() if k != "front"}}
    T = cfg.n_audio_ctx
    TP = -(-T // 512) * 512

    def unmasked(q, k, v):
        pad = [F.pad(t, (0, 0, 0, TP - T)) for t in (q, k, v)]
        return encoder_attn.encoder_self_attention_plain(*pad, TP)[..., :T, :]

    with torch.inference_mode():
        ref = wm.encode(plain, frames, cfg)
        scale = float(ref.abs().max())
        enc = float((xa - ref).abs().max()) / scale
        enc_fault = float((wm.encode(plain, frames, cfg, attn=unmasked) - ref).abs().max()) / scale
        del ref
        gap = spec_gap(plain, cfg, dc, tk.specials, suppress, xa, prompt, res)
        n = min(int(res.lengths[0]) + 1, res.tokens.shape[1])
        args = (cfg, dc, xa[:1], prompt[:1], None, res.tokens[0, :n])
        base = _teacher_logits(plain, *args)
        lscale = float(base.abs().max())
        logit = float((_teacher_logits(fused, *args) - base).abs().max()) / lscale
        real = wm.fused_front_layer
        wm.fused_front_layer = ag.front_self_slot_dropped
        try:
            bad = _teacher_logits(fused, *args)
        finally:
            wm.fused_front_layer = real
        logit_fault = float((bad - base).abs().max()) / lscale
    tol = F32_LOGIT_GAP
    ok = enc <= tol < enc_fault and gap <= tol and logit <= tol < logit_fault
    print(f"[path f32-fused-greedy] encoder (K10-f32) vs encode(flash=False) {enc:.3g} of its "
          f"max (planted fault, padded keys unmasked: {enc_fault:.3g}); greedy tokens vs the "
          f"batch without the front, worst logit gap {gap:.4g} of max|logit|; stream 0's "
          f"{n} tokens teacher-forced with K8-f32 vs the plain front, max|logit difference| "
          f"{logit:.3g} of max|logit| (planted fault, K8's self slot dropped: "
          f"{logit_fault:.3g}); tol {tol:g} each -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"f32 fused greedy path: encoder {enc} (fault {enc_fault}), "
                             f"margin {gap}, logits {logit} (fault {logit_fault})")


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
        print(f"[engine diarize] {label}: host s: segmentation {st['segment']:.3f}, embed "
              f"{st['embed']:.3f}, host syncs {eng.last_run['counters'].get('host_sync', 0)}, "
              f"windows {eng.last_run['windows']}, speakers "
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


def spec_gap(params, cfg, dc, sp, suppress, xa, prompt, res) -> float:
    """The margin check of a decode on `params`' device: the emitted tokens
    of `res` teacher-forced through the target in one pass (the prompt and
    every emitted token but the last), and over every emitted token (eot
    included) the worst gap between its position's best prepared logit and
    the token's, over that position's max|prepared logit|. The grammar
    state is replayed from the emitted tokens, as the decode advanced it."""
    from whisper_diarize_tpu_torch.ops import decode as dec
    from whisper_diarize_tpu_torch.ops import speculative

    toks, lens = res.tokens, res.lengths
    B, T = toks.shape
    n, P = min(int(lens.max()) + 1, T), prompt.shape[1]
    cache = wm.init_self_cache(cfg, B, xa.dtype, xa.device, P + n)
    seq = torch.cat([prompt, toks[:, :n - 1]], dim=1)
    with torch.inference_mode():
        logits = wm.decode_step(params, cfg, seq, 0, cache, dec.build_cross_cache(
            params, cfg, dc, xa), logits_at=tuple(range(P - 1, P + n - 1)))
        g = dict(last_was_ts=torch.zeros_like(lens, dtype=torch.bool),
                 penult_was_ts=torch.zeros_like(lens, dtype=torch.bool),
                 max_ts_tok=torch.full_like(lens, sp.timestamp_begin),
                 ts_seen=torch.zeros_like(lens, dtype=torch.bool))
        worst = torch.zeros((), device=xa.device)
        for t in range(n):
            li = dec._prepare_logits(logits[:, t], suppress, sp, dc, t,
                                     *(g[k] for k in speculative.GRAMMAR))
            tok, live = toks[:, t], t <= lens  # emitted at t, eot included
            scale = torch.where(torch.isfinite(li), li.abs(), 0.0).amax(dim=-1)
            gap = (li.amax(dim=-1) - li.gather(1, tok[:, None])[:, 0]) / scale
            worst = torch.maximum(worst, torch.where(live, gap, 0.0).max())
            g = speculative._advance_grammar(g, tok, live, sp)
    return float(worst)


def _emitted(res) -> torch.Tensor:
    """Tokens each row emitted: its length, plus the eot where one fits."""
    return res.lengths + (res.lengths < res.tokens.shape[1]).long()


def draft_snapshot() -> str:
    """A small random draft for large-v3 written by the port's
    `save_params`: large-v3's vocabulary (51866) and 128 mel bins, D 384
    (Dh 64, as the kernels take), 2 + 2 layers."""
    import dataclasses

    from whisper_diarize_tpu_torch.models import weights

    cfg = dataclasses.replace(wm.PRESETS["large-v3"], n_audio_state=384, n_audio_head=6,
                              n_audio_layer=2, n_text_state=384, n_text_head=6, n_text_layer=2)
    path = WORK / "draft"
    weights.save_params(weights.params_from_jax(wm.init_params_np(cfg, seed=11), "cpu",
                                                torch.float32), cfg, path)
    return str(path)


def speculative_requests():
    """Greedy; two requests of uniform prompts (speculation engages)."""
    opts = wdt.TranscribeOptions(enable_vad=False, lang="en",
                                 advanced=wdt.AdvancedTranscribe(sampling_strategy="greedy"))
    batch = [_write_wav(WORK / f"m{i}.wav", 10.0, 60 + i) for i in range(8)]
    return [("speculative whole-file 30 s", [_write_wav(WORK / "n.wav", 30.0, 12)], opts),
            ("speculative batch of 8 whole files, 10 s each", batch, opts)]


def phase_speculative(eng, requests) -> dict:
    """The speculative path: `eng` (a large-v3 target with `draft_model_path`)
    serves `requests` with `speculative_greedy_run` wrapped to count its
    rounds and keep its inputs (`phase_engine`: the counts set to 0 just
    before, K1-K3 must launch); the rounds must not be zero. Prints rounds,
    tokens a round (the longest row's) and the wall time against the same
    requests with the draft removed (the same Engine, run before). Every
    call's emitted tokens must pass `spec_gap` on the card, and a run of the
    first call's inputs with `sim_accept=1.0` (the unrelated draft's
    proposals all taken: tokens the target did not choose) must fail it.
    Returns the path's counts."""
    from whisper_diarize_tpu_torch.ops import speculative

    def serve():
        t0 = time.perf_counter()
        for _, paths, opts in requests:
            eng.transcribe_audio_batch(paths, opts)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    draft, eng.cfg.draft_model_path = eng.cfg.draft_model_path, None
    plain_wall = serve()
    eng.cfg.draft_model_path = draft
    calls, real = [], speculative.speculative_greedy_run

    def counted(*a, **k):
        res, rounds = real(*a, **k)
        calls.append((a, k, res, int(rounds)))
        return res, rounds

    speculative.speculative_greedy_run = counted
    try:
        t0 = time.perf_counter()
        added = phase_engine(eng, "speculative", requests)
        spec_wall = time.perf_counter() - t0
    finally:
        speculative.speculative_greedy_run = real
    rounds = sum(c[3] for c in calls)
    emitted = sum(int(_emitted(c[2]).sum()) for c in calls)
    per_round = sum(int(_emitted(c[2]).max()) for c in calls) / max(rounds, 1)
    print(f"[engine speculative] {len(calls)} speculative windows: rounds {rounds}, tokens "
          f"emitted {emitted}, tokens a round (longest row) {per_round:.3f}; wall {spec_wall:.3f} "
          f"s with the draft (the draft's first load included), {plain_wall:.3f} s without",
          flush=True)
    if not calls or rounds == 0:
        raise AssertionError(f"speculative path: {len(calls)} calls, {rounds} rounds")
    gaps = [spec_gap(a[0], a[1], a[4], a[5], a[10], a[6], a[8], res) for a, _, res, _ in calls]
    a, k, _, _ = calls[0]
    bad, _ = real(*a, **dict(k, sim_accept=1.0))
    fault = spec_gap(a[0], a[1], a[4], a[5], a[10], a[6], a[8], bad)
    print(f"[engine speculative] worst emitted-token logit gap vs the card's teacher-forced "
          f"best, of max|logit|: {max(gaps):.4g} (tol {TOKEN_GAP:g}); planted fault, "
          f"sim_accept=1.0: {fault:.4g} ({'refused' if fault > TOKEN_GAP else 'NOT refused'})",
          flush=True)
    if max(gaps) > TOKEN_GAP or not fault > TOKEN_GAP:
        raise AssertionError(f"speculative path: gaps {gaps}, planted fault {fault}")
    return added


def phase_bench_spec() -> dict:
    """`tools/bench_speculative.py`'s `main()` once at four of its rows
    (greedy, self-g4, turbo-a1.0-g4, turbo-a0.8-g4: the other two, which
    only move the acceptance, are cut to keep the run's length; large-v3
    target at batch 16, 64 tokens; one warm-up and one timed call a row);
    the counts set to 0 just before and read just after. The self-g4 row
    must need fewer rounds than its 64 tokens, and the rows that keep
    exactness (greedy, self-g4) must pass `spec_gap`; the gap of
    turbo-a1.0-g4 (every proposal of the turbo draft taken) is printed. Returns
    the path's counts."""
    reset_counts()
    b = bench_speculative.main(rows=("greedy", "self-g4", "turbo-a1.0-g4", "turbo-a0.8-g4"),
                               repeat=1)
    torch.cuda.synchronize()
    added = counts()
    gaps = {name: spec_gap(b.params, b.cfg, b.dc, b.sp, b.suppress, b.xa, b.prompt,
                           b.results[name])
            for name in ("greedy", "self-g4", "turbo-a1.0-g4")}
    rows = {r["row"]: r for r in b.rows}
    print(f"[tool bench-spec] {len(b.rows)} rows, launches {added}; emitted-token logit gaps "
          f"{ {k: round(v, 5) for k, v in gaps.items()} } (tol {TOKEN_GAP:g} for greedy and "
          "self-g4; turbo-a1.0-g4 breaks exactness by design)", flush=True)
    steps = b.dc.max_tokens
    if not (rows["self-g4"]["rounds"] < steps and gaps["greedy"] <= TOKEN_GAP
            and gaps["self-g4"] <= TOKEN_GAP
            and all(math.isfinite(r["decode_ms"]) and r["decode_ms"] > 0 for r in b.rows)):
        raise AssertionError(f"bench-spec: rows {b.rows}, gaps {gaps}")
    _check_missing("tool bench-spec", "bench-spec", added)
    del b
    torch.cuda.empty_cache()
    return added


def phase_ggml() -> dict:
    """Checkpoint files on the card: the `tiny` preset (the JAX package's
    random init, the token embedding biased towards printable bytes so the
    byte-level vocabulary decodes text) written as a q5_0 GGML file and as an
    OpenAI `.pt` file; each goes through an Engine on the card (greedy, DTW
    on, ladder off, 32 tokens) and through the CLI (`__main__.main`,
    `--greedy`, JSON to a file). The Engine's params must equal the CPU load
    cast to bf16, and cues must come out of both. The counts set to 0 just
    before, K1-K3 must launch. Returns the path's counts."""
    from whisper_diarize_tpu_torch.__main__ import main as cli
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig
    from whisper_diarize_tpu_torch.models import ggml, weights

    cfg = wm.PRESETS["tiny"]
    tree = wm.init_params_np(cfg, seed=0)
    emb = tree["decoder"]["tok_emb"]
    emb[33:127] *= np.random.default_rng(0).uniform(2.0, 4.0, (94, 1)).astype(np.float32)
    emb[256:50257] = 0.0  # ids between the bytes and eot
    sd = weights.openai_state_dict(weights.params_from_jax(tree, "cpu", torch.float32))
    dims = {k: getattr(cfg, k) for k in (
        "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
        "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer", "n_mels")}
    files = {"ggml q5_0": str(WORK / "ggml-tiny-q5_0.bin"), "openai .pt": str(WORK / "tiny.pt")}
    ggml.write_ggml(files["ggml q5_0"], sd, dims, np.zeros((cfg.n_mels, 201), np.float32),
                    [bytes([i]) for i in range(256)], quantize="q5_0")
    torch.save({"dims": dims, "model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               files["openai .pt"])
    wav = _write_wav(WORK / "o.wav", 20.0, 13)
    opts = wdt.TranscribeOptions(enable_vad=False, lang="en",
                                 advanced=wdt.AdvancedTranscribe(sampling_strategy="greedy"))
    reset_counts()
    for label, path in files.items():
        eng = Engine(EngineConfig(cache_dir=str(WORK / "cache"), whisper_model_path=path,
                                  vad_model_path="__random__", batch_size=8, enable_dtw=True,
                                  temperature_fallback=False, max_decode_tokens=32))
        cues = eng.transcribe_audio(wav, opts)
        (params, _, tk), = eng._whisper_cache.values()
        cpu = (ggml.load_ggml(path, "cpu")[0] if label.startswith("ggml")
               else weights.load_openai_pt(path, "cpu")[0])
        flat, want = weights._flatten(params), weights._flatten(cpu)
        diff = [k for k in want if not torch.equal(flat[k].cpu(), want[k].to(torch.bfloat16))]
        out = WORK / f"cli-{label.split()[0]}.json"
        rc = cli(["transcribe", wav, "--model-dir", path, "--cache-dir", str(WORK / "cache"),
                  "--greedy", "--max-tokens", "32", "--no-vad", "--quiet",
                  "--vad-model", "__random__", "-o", str(out)])
        cli_cues = json.loads(out.read_text())
        print(f"[ggml] {label}: tokenizer {type(tk).__name__}, params differing from the CPU "
              f"load cast to bf16: {diff}; Engine cues {len(cues)}, CLI rc {rc}, cues "
              f"{len(cli_cues)}; first {cues[0].text[:40] if cues else None!r}", flush=True)
        if diff or not cues or rc != 0 or not cli_cues:
            raise AssertionError(f"{label}: params differ {diff}, cues {len(cues)}, "
                                 f"CLI rc {rc}, CLI cues {len(cli_cues)}")
    torch.cuda.synchronize()
    added = counts()
    _check_missing("checkpoint files", "ggml", added)
    return added


# the f32 Engine against the f32 CPU port: max|logit difference| over
# max|logit| of the emitted tokens teacher-forced (`phase_engine_f32`);
# the bf16 Engine's logits must lie beyond it
F32_LOGIT_GAP = 1e-4


def _tree(x, fn):
    """`fn` on every tensor of a nested dict of params."""
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _teacher_logits(params, cfg, dc, xa, prompt, row_pad, toks) -> torch.Tensor:
    """Raw f32 logits [n, V] of one stream (xa [1, Ta, D], prompt [1, P])
    for its n emitted tokens `toks`, each given the tokens before it: the
    prompt pass, then one single-token step a token (`decode_step`: on the
    card K1 at the prompt pass, K3 or K6 a step), over the cross cache `dc`
    selects (int8 with `quantize_cross_kv`), on `params`' device and dtype."""
    from whisper_diarize_tpu_torch.ops import decode as dec

    P = prompt.shape[1]
    dt = params["decoder"]["tok_emb"].dtype
    cross = dec.build_cross_cache(params, cfg, dc, xa.to(dt))
    cache = wm.init_self_cache(cfg, 1, dt, xa.device, P + len(toks) + 1)
    rows = [wm.decode_step(params, cfg, prompt, 0, cache, cross, row_pad=row_pad,
                           logits_at=(P - 1,))[:, 0]]
    for t in range(len(toks) - 1):
        rows.append(wm.decode_step(params, cfg, toks[None, t:t + 1], P + t, cache, cross,
                                   row_pad=row_pad)[:, 0])
    return torch.cat(rows).float()


class _SplitK5OnCpu:
    """On the CPU, K5's plain version replaced by its split model (the
    card's order: p * vs rounded to bf16 against each 64-key tile's running
    max, `attn.cross_attn_split_plain`), in the wrapper and in the tail."""

    def __enter__(self):
        self.saved = attn.cross_attn_layer_q8_plain, tail.cross_attn_layer_q8_plain

        def split(layer, q, k8, ks, v8, vs, ta_total=None):
            return attn.cross_attn_split_plain(layer, q, k8, v8, ta_total, ks=ks, vs=vs)

        attn.cross_attn_layer_q8_plain = tail.cross_attn_layer_q8_plain = split

    def __exit__(self, *exc):
        attn.cross_attn_layer_q8_plain, tail.cross_attn_layer_q8_plain = self.saved


def f32_requests():
    """(path, Engine settings, request) of the f32 Engine phase."""
    greedy = wdt.AdvancedTranscribe(sampling_strategy="greedy")
    return [
        ("f32-beam", dict(model="large-v3"),
         ("f32 beam whole-file 30 s, lang auto", [_write_wav(WORK / "p.wav", 30.0, 14)],
          wdt.TranscribeOptions(enable_vad=False, lang="auto"))),
        ("f32-greedy", dict(model="large-v3-turbo"),
         ("f32 greedy whole-file 20 s, ladder on", [_write_wav(WORK / "q.wav", 20.0, 15)],
          wdt.TranscribeOptions(enable_vad=False, lang="en", advanced=greedy))),
        ("f32-int8-beam", dict(model="large-v3", quantize_kv_cache=True,
                               temperature_fallback=False),
         ("f32 int8 beam whole-file 10 s", [_write_wav(WORK / "r.wav", 10.0, 16)],
          wdt.TranscribeOptions(enable_vad=False, lang="en"))),
        ("f32-speculative", dict(model="large-v3", temperature_fallback=False, draft=True),
         ("f32 speculative whole-file 10 s", [_write_wav(WORK / "s.wav", 10.0, 17)],
          wdt.TranscribeOptions(enable_vad=False, lang="en", advanced=greedy))),
    ]


def phase_engine_f32() -> dict:
    """Engines with `dtype="float32"` on the card (32 tokens a window): a
    large-v3 beam-5 request at full width (32 + 32 layers, 30 s, lang auto,
    the ladder on), a large-v3-turbo greedy request with the ladder, a
    `quantize_kv_cache` beam request at large-v3 and a speculative request
    at large-v3 with the phase's 2-layer draft written in f32
    (`draft_snapshot`); each its own path (`phase_engine`: the counts set to
    0 just before, the f32 forms of its kernels must launch). The first
    decode call of each request is kept (`TranscribeStep.decode` wrapped):
    its first stream's emitted tokens (eot included) are teacher-forced on
    the card (`_teacher_logits`) and on the f32 CPU port at the same weights
    and encoder output (the int8 request with K5's split model on the CPU,
    the card's order of bf16 rounding), and max|logit difference| must stay
    within F32_LOGIT_GAP x max|logit|; the same tokens teacher-forced on the
    card in bf16 (params and encoder output cast: the bf16 Engine's logits)
    must not. The beam request's first window's encoder output must also
    agree with the f32 CPU encoder on the same mel within F32_LOGIT_GAP of
    its max (TF32 convolutions would not). Returns counts by path."""
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    real_decode, real_encode = TranscribeStep.decode, TranscribeStep.encode
    calls, encoded = [], []

    def decode(self, xa, language, task, *a, **k):
        res = real_decode(self, xa, language, task, *a, **k)
        if not calls:
            prev = a[0] if a else k.get("prev_tokens")
            calls.append((self, xa, self._build_prompt(xa.shape[0], language, task, prev), res))
        return res

    def encode(self, mel):
        xa = real_encode(self, mel)
        if not encoded:
            encoded.append((mel[:1], xa[:1]))
        return xa

    by_path, gaps = {}, {}
    for path, over, request in f32_requests():
        over = dict(over)
        model = over.pop("model")
        if over.pop("draft", False):
            over["draft_model_path"] = draft_snapshot()
        eng = make_engine(model, dtype="float32", max_decode_tokens=32, **over)
        calls.clear()
        TranscribeStep.decode, TranscribeStep.encode = decode, encode
        try:
            by_path[path] = phase_engine(eng, path, [request])
        finally:
            TranscribeStep.decode, TranscribeStep.encode = real_decode, real_encode
        step, xa, (prompt, _, _, row_pad), res = calls[0]
        n = min(int(res.lengths[0]) + 1, res.tokens.shape[1])
        toks, rp = res.tokens[0, :n], None if row_pad is None else row_pad[:1]
        params, cfg, dc = step.params, step.cfg, step.dc
        with torch.inference_mode():
            card = _teacher_logits(params, cfg, dc, xa[:1], prompt[:1], rp, toks)
            bf16 = _teacher_logits(_tree(params, lambda t: t.to(torch.bfloat16)
                                         if t.is_floating_point() else t),
                                   cfg, dc, xa[:1], prompt[:1], rp, toks)
            cpu_params = _tree(params, lambda t: t.cpu())
            with _SplitK5OnCpu():
                ref = _teacher_logits(cpu_params, cfg, dc, xa[:1].cpu(), prompt[:1].cpu(),
                                      None if rp is None else rp.cpu(), toks.cpu())
            scale = float(ref.abs().max())
            gap = float((card.cpu() - ref).abs().max()) / scale
            fault = float((bf16.cpu() - ref).abs().max()) / scale
            line = ""
            if path == "f32-beam":
                mel, xa_card = encoded[0]
                xa_cpu = wm.encode(cpu_params, mel.cpu(), cfg)
                enc = float((xa_card.cpu() - xa_cpu).abs().max() / xa_cpu.abs().max())
                gaps["encoder"] = enc
                line = f"; encoder output vs f32 CPU {enc:.3g} of its max"
            del cpu_params
        gaps[path] = gap
        print(f"[engine f32] {path}: {n} tokens teacher-forced, max|logit - f32 CPU| "
              f"{gap:.3g} x max|logit| (tol {F32_LOGIT_GAP:g}); planted fault, the bf16 "
              f"Engine's logits: {fault:.3g} ({'refused' if fault > F32_LOGIT_GAP else 'NOT refused'})"
              f"{line}", flush=True)
        if not (gap <= F32_LOGIT_GAP < fault and gaps.get("encoder", 0.0) <= F32_LOGIT_GAP):
            raise AssertionError(f"f32 Engine, {path}: logit gap {gap}, bf16 fault {fault}, "
                                 f"encoder {gaps.get('encoder')}")
        if path == "f32-beam":  # the fused greedy path on the same f32 weights
            by_path["f32-fused-greedy"] = timed_phase(
                "path f32-fused-greedy", phase_fused_greedy, eng, "f32-fused-greedy")
        del eng, step, xa, res, params, card, bf16, ref
        calls.clear()
        torch.cuda.empty_cache()
    return by_path


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
    if "cross_attn_f32_kernel" in name:
        return "K1 f32 attention (prefill, and inside K3 f32)"
    if "cross_kv_f32_kernel" in name:
        return "K2 f32 cross K/V"
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
        return (f"windows {eng.last_run['windows']}, host syncs "
                f"{eng.last_run['counters'].get('host_sync', 0)}, stage host s "
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


# --------------------------------------------------------------------------
# meshes and training
# --------------------------------------------------------------------------

# the two ranks' decodes against the no-mesh one on the same card: tokens
# equal; avg_logprob within MESH_LOGPROB in bf16 (the head split sums o /
# co / fc2 partials of each rank in f32 and runs the un-fused tail, where
# one device runs K3; the data split runs B 1 a rank, other plans and GEMM
# tiles) and MESH_LOGPROB_F32 in f32 (IEEE torch products against K3-f32's
# 3xTF32)
MESH_LOGPROB = 2e-2
COLLECTIVE_LOOP = 500  # all-reduces a loop of `phase_two_ranks`
MESH_LOGPROB_F32 = 1e-4
# the 2 + 2 layer training step, card (IEEE f32 products, `exact_f32`) vs CPU
# f32: loss and global gradient norm within TRAIN_REL relative; each leaf's
# update p - p0 within TRAIN_UPDATE relative L2 of the CPU's and every
# element within 2 lr of it (Adam's update of a ~0 gradient is the sign of
# rounding noise, as in tests/test_torch_training.py)
TRAIN_REL = 1e-4
TRAIN_UPDATE = 1e-2


def _same_decodes(got: dict, ref: dict) -> bool:
    """Every decode's tokens, lengths and log-probabilities bit for bit."""
    return len(got["decodes"]) == len(ref["decodes"]) > 0 and all(
        np.array_equal(a[k], b[k]) for a, b in zip(got["decodes"], ref["decodes"]) for k in a)


def phase_mesh_one_rank(requests) -> dict:
    """`EngineConfig(mesh_shape=(1, 1))` (a one-rank NCCL group): each
    (path, model, greedy, wavs) request is served by an Engine with no mesh
    and then by a mesh Engine of the same config (batch 8, 32 tokens, DTW and
    the fallback ladder on; `parallel/dryrun.py::_job_engine`). The same
    kernels on the same rows: the cues and every decode's tokens and
    log-probabilities must be equal bit for bit. The counts are set to 0 just
    before the mesh request and read just after; the path's kernels must have
    launched. Returns each path's counts."""
    import torch.distributed as dist

    from whisper_diarize_tpu_torch.parallel import dryrun

    out = {}
    try:
        for path, model, greedy, wavs in requests:
            kw = dict(wavs=wavs, cache=str(WORK / "cache"), greedy=greedy, use_gpu=True,
                      snapshot=f"__random__:{model}", batch_size=8, max_decode_tokens=32,
                      enable_dtw=True, temperature_fallback=True)
            ref = dryrun.mesh_rank(0, 1, [("ref", "engine", None, kw)])["ref"]
            reset_counts()
            got = dryrun.mesh_rank(0, 1, [("mesh", "engine", (1, 1), kw)])["mesh"]
            out[path] = counts()
            same = got["cues"] == ref["cues"] and _same_decodes(got, ref)
            print(f"[mesh 1x1] {path} ({model}, {'greedy' if greedy else 'beam 5'}, "
                  f"{len(wavs)} file(s)): {dist.get_backend()} world {dist.get_world_size()}, "
                  f"wall {got['wall']:.3f} s (no mesh {ref['wall']:.3f} s), decodes "
                  f"{len(got['decodes'])}, cues {sum(map(len, got['cues']))}, launches "
                  f"{ {k: out[path][k] for k in ('K1', 'K2', 'K3', 'K4')} }, cues and "
                  f"decodes equal to the no-mesh Engine's bit for bit: {same}", flush=True)
            if not same:
                raise AssertionError(f"mesh 1x1 {path}: differs from the no-mesh Engine")
            _check_missing(f"mesh 1x1 {path}", path, out[path])
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def _mesh_counts(launches: dict, f32: bool) -> dict:
    """A rank's launches (kernel id -> count, `dryrun._kernel_wrappers`) as
    a path's counts: the f32 forms' keys where the run was f32."""
    out = {k: 0 for k in counts()}
    for k, n in launches.items():
        if k == "K1 in K3":
            k = "K1-f32 in K3-f32 / K6-f32" if f32 else "K1 in K3 / K6"
        elif f32:
            k = f"{k}-f32"
        out[k] = n
    return out


def phase_two_ranks() -> dict:
    """Two ranks on the one card (gloo over CUDA tensors: NCCL refuses two
    ranks on one device). One spawn runs a large-v3 beam-5 request (two 10
    s files in one batch of 2, 32 tokens, DTW on, ladder off) on mesh
    (1, 2) (10 heads a rank for K1, K2 and K4) and on (2, 1) (one row a
    rank), in bf16 and in f32, on weights of the JAX init's distribution
    ("__random__:large-v3:0": the pattern of "__random__:large-v3" makes
    logits tie exactly, so tie-breaks, not faults, decide its tokens); this
    process serves each with no mesh first. Each rank's decode must give the
    no-mesh tokens and avg_logprob within MESH_LOGPROB (bf16) or
    MESH_LOGPROB_F32, and both ranks the same cues. The bf16 (1, 2) request
    is served once more with its collectives timed
    (`parallel/mesh.py::timed_collectives`): their count, seconds and the
    device's wait before them against that request's wall. Then
    `dryrun_multigpu(2, "cuda")` (mesh (1, 2), f32 at the dry run's small
    model): a TP AdamW step, a greedy decode over the int8 cross cache (K5
    under the head split) and a beam-3 decode on the card. The same spawn
    serves a tiny.en-shaped beam-5 request on (1, 2) ("__random__:tiny.en:0",
    bf16: 6 decoder heads, 3 a rank, so K2's 64-column edge tile), held to
    its no-mesh run the same way. Returns the rank 0 launches as paths
    "mesh-1x2", "mesh-2x1", "mesh-1x2-f32", "mesh-2x1-f32",
    "mesh-1x2-3-heads" and "dryrun-1x2"."""
    from whisper_diarize_tpu_torch.parallel import dryrun

    WORK.mkdir(parents=True, exist_ok=True)
    wavs = [_write_wav(WORK / f"m{i}.wav", 10.0, 40 + i) for i in range(2)]
    refs, jobs = {}, []
    for dtype in ("bfloat16", "float32"):
        kw = dict(wavs=wavs, cache=str(WORK / "cache"), greedy=False, use_gpu=True,
                  snapshot="__random__:large-v3:0", batch_size=2, max_decode_tokens=32,
                  temperature_fallback=False, enable_dtw=True, dtype=dtype)
        refs[dtype] = ref = dryrun.mesh_rank(0, 1, [("ref", "engine", None, kw)])["ref"]
        print(f"[two ranks] {dtype} no mesh: wall {ref['wall']:.3f} s, launches "
              f"{ref['launches']}", flush=True)
        if not ref["decodes"]:
            raise AssertionError("two ranks: the no-mesh request decoded nothing")
        jobs += [((dtype, dtype, shape, False), "engine", shape, kw)
                 for shape in ((1, 2), (2, 1))]
        if dtype == "bfloat16":
            jobs.append(((dtype, dtype, (1, 2), True), "engine", (1, 2),
                         dict(kw, time_collectives=True)))
    # tiny.en's 6 decoder heads over 2 ranks: 3 a rank, K2's 64-column edge
    # tile on each (bf16, beam 5, the same two files)
    kw = dict(kw, snapshot="__random__:tiny.en:0", dtype="bfloat16")
    refs["tiny.en"] = ref = dryrun.mesh_rank(0, 1, [("ref", "engine", None, kw)])["ref"]
    print(f"[two ranks] tiny.en no mesh: wall {ref['wall']:.3f} s, launches "
          f"{ref['launches']}", flush=True)
    if not ref["decodes"]:
        raise AssertionError("two ranks: the tiny.en no-mesh request decoded nothing")
    jobs.append((("tiny.en", "bfloat16", (1, 2), False), "engine", (1, 2), kw))
    # the head split's all-reduce alone, back to back: a [10, 1280] f32
    # tensor (beam 5 x 2 rows of large-v3) on the card and on the host
    cfg = wm.PRESETS["large-v3"]
    loops = [(f"all-reduces {device}", "collectives", (1, 2),
              dict(cfg=cfg, n=COLLECTIVE_LOOP, rows=10, device=device))
             for device in ("cuda", "cpu")]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = dryrun.run_ranks(dryrun.mesh_rank, 2, jobs + loops, backend="gloo", timeout=600)
    print(f"[two ranks] spawn of 2 gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, _, _, kw in loops:
        for r, o in enumerate(outs):
            c = o[name]
            print(f"[two ranks] {name} (mesh (1, 2), [{kw['rows']}, {cfg.n_text_state}] f32, "
                  f"{c['calls']} back to back) rank {r}: {c['seconds'] / c['calls'] * 1e3:.4f} "
                  f"ms each", flush=True)
    # a job's label: the large-v3 request's dtype, or "tiny.en"
    suffix = {"bfloat16": "", "float32": "-f32", "tiny.en": "-3-heads"}
    by_path = {}
    for name, _, _, _ in jobs:
        label, dtype, shape, timed = name
        ref, tol = refs[label], MESH_LOGPROB_F32 if dtype == "float32" else MESH_LOGPROB
        for r, o in enumerate(outs):
            got = o[name]
            if timed:
                c = got["collectives"]
                print(f"[two ranks] {label} mesh {shape} rank {r}, collectives timed: wall "
                      f"{got['wall']:.3f} s, {c['calls']} collectives, {c['seconds']:.3f} s "
                      f"in them, {c['device_wait_s']:.3f} s of device wait before them",
                      flush=True)
            (dg,), (dr,) = got["decodes"], ref["decodes"]
            same = bool(np.array_equal(dg["tokens"], dr["tokens"])
                        and np.array_equal(dg["lengths"], dr["lengths"]))
            gap = float(np.abs(dg["avg_logprob"] - dr["avg_logprob"]).max())
            print(f"[two ranks] {label} mesh {shape} rank {r}: wall {got['wall']:.3f} s, "
                  f"launches {got['launches']}, tokens equal to no mesh: {same}, max "
                  f"|avg_logprob gap| {gap:.3e} (tol {tol}), cues equal to no mesh: "
                  f"{got['cues'] == ref['cues']}", flush=True)
            if not same or gap > tol:
                raise AssertionError(f"{label} mesh {shape} rank {r}: the decode differs "
                                     "from the no-mesh one")
            if got["cues"] != outs[0][name]["cues"]:
                raise AssertionError(f"{label} mesh {shape}: the ranks' cues differ")
        if timed:
            continue
        path = f"mesh-{shape[0]}x{shape[1]}{suffix[label]}"
        by_path[path] = _mesh_counts(outs[0][name]["launches"], dtype == "float32")
        _check_missing(f"two ranks {label} {shape}", path, by_path[path])
    t0 = time.perf_counter()
    first = dryrun.dryrun_multigpu(2, "cuda")
    print(f"[two ranks] dryrun_multigpu(2, cuda): {time.perf_counter() - t0:.1f} s, launches "
          f"{first['launches']}", flush=True)
    by_path["dryrun-1x2"] = _mesh_counts(first["launches"], True)
    _check_missing("dryrun_multigpu(2, cuda)", "dryrun-1x2", by_path["dryrun-1x2"])
    return by_path


def _train_inputs(cfg, B: int, S: int, seed: int, device):
    rng = np.random.default_rng(seed)
    mel_in = torch.from_numpy(rng.standard_normal((B, cfg.n_mels, 3000)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.n_vocab, (B, S + 1)))
    mask = torch.ones((B, S))
    mask[-1, S // 2:] = 0.0  # rows of different lengths
    return mel_in.to(device), tokens.to(device), mask.to(device)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def phase_train() -> dict:
    """`training.make_train_step` on the card: large-v3-turbo at full width
    in f32 (TF32 flags at PyTorch's defaults), B 4 (B 2 where 4 runs out of
    memory), 64 target tokens, 5 AdamW steps on one repeated random batch
    from weights of the JAX init's distribution (`init_params_normal`, not
    the benchmark's pattern, whose loss at init lies far above ln V): the
    loss finite and step 5 below step 1; ms a step (steps 2-5) and peak
    memory. Then a 2 + 2 layer model at
    turbo widths: one step on the card (`exact_f32`) against the same step on
    the CPU in f32 (TRAIN_REL, TRAIN_UPDATE)."""
    from whisper_diarize_tpu_torch import training
    from whisper_diarize_tpu_torch.models import weights as weights_mod
    from whisper_diarize_tpu_torch.utils import exact_f32

    dev = torch.device("cuda")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    cfg = wm.PRESETS["large-v3-turbo"]
    out = {}
    try:
        for B in (4, 2):
            params = opt_state = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                params = weights_mod.init_params_normal(cfg, dev, torch.float32, seed=0)
                optimizer = training.make_optimizer()
                opt_state = optimizer.init(params)
                step = training.make_train_step(cfg, optimizer)
                batch = _train_inputs(cfg, B, 64, 0, dev)
                losses, ms = [], []
                for _ in range(5):
                    t0 = time.perf_counter()
                    params, opt_state, loss = step(params, opt_state, *batch)
                    losses.append(float(loss))
                    ms.append((time.perf_counter() - t0) * 1e3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                break
            except torch.cuda.OutOfMemoryError as e:
                print(f"[train] turbo B {B}: out of memory ({str(e)[:120]}), trying B 2",
                      flush=True)
                if B == 2:
                    raise
        del params, opt_state
        torch.cuda.empty_cache()
        step_ms = float(np.median(ms[1:]))
        print(f"[train] large-v3-turbo f32 (TF32: matmul off, cuDNN on), B {B}, 64 target "
              f"tokens, 5 AdamW steps: losses {[round(x, 5) for x in losses]}, "
              f"{step_ms:.1f} ms a step (median of steps 2-5; step 1 {ms[0]:.1f} ms), peak "
              f"{peak:.2f} GiB allocated, {nvidia_smi_line()}", flush=True)
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"train: losses {losses} are not finite and falling")
        out.update(train_B=B, train_ms_per_step=step_ms, train_peak_gib=peak,
                   train_losses=losses)

        small = dataclasses.replace(cfg, n_audio_layer=2, n_text_layer=2)
        cpu_params = wm.init_params(small, seed=0)
        p0 = {k: v.clone() for k, v in _leaves(cpu_params)}
        card_params = _tree(cpu_params, lambda t: t.to(dev, copy=True))
        results = {}
        for where, params, device in (("cpu", cpu_params, torch.device("cpu")),
                                      ("card", card_params, dev)):
            optimizer = training.make_optimizer()
            opt_state = optimizer.init(params)
            step = training.make_train_step(small, optimizer)
            with exact_f32():
                t0 = time.perf_counter()
                params, _, loss = step(params, opt_state, *_train_inputs(small, 2, 16, 1, device))
                norm = float(training.global_grad_norm(params))
            results[where] = (float(loss), norm, {k: v.detach().cpu()
                                                  for k, v in _leaves(params)},
                              time.perf_counter() - t0)
        (lc, nc, pc, tc), (lg, ng, pg, tg) = results["cpu"], results["card"]
        worst = max(((torch.linalg.vector_norm((pg[k] - p0[k]) - (pc[k] - p0[k]))
                      / torch.linalg.vector_norm(pc[k] - p0[k]).clamp_min(1e-30)).item(), k)
                    for k in pc)
        elem = max(((pg[k] - pc[k]).abs().max().item(), k) for k in pc)
        print(f"[train] 2 + 2 layers at turbo widths, one step, card vs CPU f32: loss "
              f"{lg:.7f} vs {lc:.7f}, grad norm {ng:.6f} vs {nc:.6f}, worst update rel L2 "
              f"{worst[0]:.2e} ({worst[1]}), worst element {elem[0]:.2e} ({elem[1]}); "
              f"card {tg:.2f} s, CPU {tc:.2f} s", flush=True)
        lr = training.make_optimizer().lr
        if (abs(lg - lc) > TRAIN_REL * abs(lc) or abs(ng - nc) > TRAIN_REL * abs(nc)
                or worst[0] > TRAIN_UPDATE or elem[0] > 2 * lr):
            raise AssertionError("train: the card's step differs from the CPU's")
        out.update(small_loss_gap=abs(lg - lc), small_norm_gap=abs(ng - nc),
                   small_update_rel=worst[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return out


def _dtw_inputs(params, cfg, heads, B: int, N: int, seed: int, prefixes=()):
    """Costs [B, S, Ta] f32 from `alignment_cost_batch` of real
    `alignment_cross_attn` maps: B windows of speech-like noise encoded, N
    random text tokens after the timing pass's sot sequence. Returns
    (cost, sot_len, peak bytes of the reduction, {n: cost of the first n
    tokens' maps} for n in `prefixes`: the decoder is causal, so a prefix's
    maps are the prefix of the maps)."""
    rng = np.random.default_rng(seed)
    tk = DebugTokenizer(num_languages=cfg.num_languages)
    sot = tk.sot_sequence(language="en")
    t = np.arange(480000) / 16000.0
    audio = rng.standard_normal((B, 480000)) * 0.02 + (np.mod(t, 2.0) < 1.5) * np.sin(
        2 * np.pi * 180.0 * t) * (0.3 + 0.2 * rng.standard_normal((B, 480000)))
    with torch.no_grad():
        audio_t = torch.from_numpy(np.clip(audio, -1, 1).astype(np.float32)).cuda()
        xa = wm.encode(params, mel.log_mel_spectrogram(audio_t, n_mels=cfg.n_mels), cfg)
        toks = rng.integers(33, 127, size=(B, N))
        seq = torch.from_numpy(np.concatenate([np.tile(sot, (B, 1)), toks], 1)).cuda()
        qk = wm.alignment_cross_attn(params, cfg, seq, xa, heads)
        del xa
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        nf = torch.full((B,), 1500, device="cuda")
        nr = torch.full((B,), len(sot) + N + 1, device="cuda").clamp(max=seq.shape[1])
        cost = dtw_ops.alignment_cost_batch(qk, nf, nr)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        pre = {n: dtw_ops.alignment_cost_batch(
            qk[:, :, : len(sot) + n], nf, nr.clamp(max=len(sot) + n)).contiguous()
            for n in prefixes}
    return cost.contiguous(), len(sot), peak, pre


def _dtw_bound(n_tok, n_frames, B: int, N: int) -> dict:
    """The least time for the DP + walk: each valid cell's cost read once
    (4 bytes), the anchors written once, ~4 f32 operations a cell."""
    cells = float((n_tok.clamp(min=1) * n_frames.clamp(min=1)).sum())
    return bound(4 * cells + 4 * B * N + 8 * B, 4 * cells, F32_FLOPS)


def _host_dp_ms(cost: torch.Tensor, n_tok, n_frames, sot_len: int) -> tuple:
    """The port's host path on the same costs: (fetch + DP ms, DP ms), the
    native DP of `anchor_times_from_cost` per row, best of three."""
    nt, nf = n_tok.tolist(), n_frames.tolist()
    fetch, dp = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = cost.cpu().numpy()
        t1 = time.perf_counter()
        for b in range(host.shape[0]):
            dtw_ops.anchor_times_from_cost(np.ascontiguousarray(
                host[b, sot_len: sot_len + nt[b], : nf[b]]), nt[b])
        t2 = time.perf_counter()
        fetch.append((t2 - t0) * 1e3)
        dp.append((t2 - t1) * 1e3)
    return min(fetch), min(dp)


def _up_first(diag, up, left):
    """Planted fault: ties prefer up over the diagonal."""
    return torch.where((up <= diag) & (up <= left), dtw_ops.CODE_UP,
                       torch.where(diag <= left, dtw_ops.CODE_DIAG, dtw_ops.CODE_LEFT))


def _dtw_checks(params, cfg) -> dict:
    """The kernel against its plain version, anchors equal exactly, at
    large-v3 widths (B 8, Ta 1500, float costs of real alignment maps) at
    N 32 and 64 (the Engine's shapes at 32 and 64 tokens), 224 and 440 (the
    largest), on integer costs with many ties, with rows at n_tok 1 and at
    n_frames < Ta, at N 33 and 100 with rows at n_tok 32, 33, 64 and 65 (the
    warps' handoff at its edges); the kernel's plan equal to its mirror;
    the up-first fault refused; times (ns an anti-diagonal) beside the
    bound, one call of the plain version and the host DP."""
    heads = wm.alignment_heads_for("large-v3", cfg)
    B, Ta = 8, 1500
    mixed_tok = torch.tensor([224, 1, 100, 224, 37, 1, 200, 5])
    mixed_frames = torch.tensor([1500, 700, 1500, 1, 333, 1500, 1499, 12])
    edge_tok = torch.tensor([100, 32, 33, 64, 65, 1, 97, 31])
    cases, rows = [], {}
    for N, seed in ((224, 60), (440, 61)):
        cost, sot_len, peak, pre = _dtw_inputs(params, cfg, heads, B, N, seed,
                                               (32, 64) if N == 224 else ())
        print(f"[dtw] alignment_cost_batch at B {B}, K {len(heads)}, S {cost.shape[1]}, "
              f"Ta {Ta}: peak {peak / 2**20:.1f} MiB above its inputs (the [B, K, S, Ta, 7] "
              f"median gather: {B * len(heads) * cost.shape[1] * Ta * 7 * 4 / 2**20:.1f} MiB)",
              flush=True)
        full = (torch.full((B,), N), torch.full((B,), Ta))
        cases.append((f"float N={N}", cost, sot_len, *full, True))
        cases.append((f"float N={N} mixed rows", cost, sot_len,
                      mixed_tok.clamp(max=N), mixed_frames, False))
        if N == 224:
            for n, c in pre.items():
                cases.append((f"float N={n}", c, sot_len, torch.full((B,), n),
                              torch.full((B,), Ta), True))
            cases.append(("float N=100 handoff edges", cost[:, : sot_len + 100].contiguous(),
                          sot_len, edge_tok, mixed_frames, False))
    g = torch.Generator(device="cuda").manual_seed(62)
    # costs 0 or 1, 2% ones: the accumulated costs tie at most cells
    ties = (torch.rand((B, 4 + 224, Ta), generator=g, device="cuda") < 0.02).float()
    cases.append(("integer ties N=224", ties, 4, torch.full((B,), 224), torch.full((B,), Ta),
                  False))
    cases.append(("integer ties mixed rows", ties, 4, mixed_tok, mixed_frames, False))
    cases.append(("integer ties N=33", ties[:, : 4 + 33].contiguous(), 4,
                  torch.tensor([33, 32, 1, 17, 33, 31, 2, 33]), mixed_frames, False))
    errs, lib, plan = 0, kernels.library(), (ctypes.c_int * 5)()
    for tag, cost, sot_len, n_tok, n_frames, time_it in cases:
        nt, nf = n_tok.cuda(), n_frames.cuda()
        N, Ta_c = cost.shape[1] - sot_len, cost.shape[2]
        if (lib.wdt_dtw_plan(N, Ta_c, plan) != 0
                or tuple(plan) != dtw_ops.dtw_plan(N, Ta_c)):
            raise AssertionError(f"dtw {tag}: the kernel's plan {tuple(plan)} is not its mirror "
                                 f"{dtw_ops.dtw_plan(N, Ta_c)}")
        got = dtw_ops.dtw_anchor_frames_batch(cost, nt, nf, sot_len)
        ref = dtw_ops.dtw_anchor_frames_plain(cost, nt, nf, sot_len)
        torch.cuda.synchronize()
        diff = int((got.long() - ref.long()).abs().max())
        errs = max(errs, diff)
        print(f"[dtw] {tag}: kernel vs plain max |frame difference| {diff}", flush=True)
        if diff:
            raise AssertionError(f"dtw {tag}: the kernel's anchors differ from the plain version")
        if tag in ("integer ties N=224", "integer ties mixed rows"):
            bad = dtw_ops.dtw_anchor_frames_plain(cost, nt, nf, sot_len, _up_first)
            if torch.equal(bad, got):
                raise AssertionError(f"dtw {tag}: the check passed the up-first fault")
            print(f"[dtw] {tag}: the up-first fault is refused "
                  f"({int((bad != got).sum())} anchors moved)", flush=True)
        if time_it:
            t = dict(ms=time_ms(lambda: dtw_ops.dtw_anchor_frames_batch(cost, nt, nf, sot_len)),
                     device_ms=device_ms(
                         lambda: dtw_ops.dtw_anchor_frames_batch(cost, nt, nf, sot_len)),
                     plain_ms=time_ms(lambda: dtw_ops.dtw_anchor_frames_plain(
                         cost, nt, nf, sot_len), iters=1, warmup=0),
                     library_ms=None, **_dtw_bound(n_tok, n_frames, B, N))
            t["host_fetch_dp_ms"], t["host_dp_ms"] = _host_dp_ms(cost, n_tok, n_frames, sot_len)
            t["ns_per_diagonal"] = t["device_ms"] * 1e6 / (N + Ta - 1)
            print(f"[kernels] DTW B={B} N={N} Ta={Ta}: time {t['ms']:.4f} ms (device "
                  f"{t['device_ms']:.4f}, {t['ns_per_diagonal']:.1f} ns an anti-diagonal), "
                  f"plain {t['plain_ms']:.4f} ms, host native DP "
                  f"{t['host_dp_ms']:.4f} ms ({t['host_fetch_dp_ms']:.4f} ms with the cost's "
                  f"fetch), bound {t['bound_ms']:.6f} ms ({t['bound_by']})", flush=True)
            rows[f"N={N}"] = t
    res = dict(rows["N=224"], max_abs_err=errs, by_shape=rows)
    torch.cuda.empty_cache()
    return res


def phase_dtw() -> tuple:
    """The on-device DTW ("dtw"): one beam-5 large-v3 Engine (weights of the
    JAX init's distribution, "__random__:large-v3:1", so tokens do not tie;
    depth: 32 tokens a window, the ladder off) serves a 30 s whole-file
    request with lang auto once to warm up, then on the default path (DP + backtrack by the
    kernel) and again with WDT_HOST_DTW=1 (the host DP): cues and words
    must be equal; both walls and the alignment stage's peak device memory
    are printed. Then the kernel checks (`_dtw_checks`) on that Engine's
    weights, `tools/run_config.py` config 4 on a 30 s WAV at
    "__random__:large-v3:1" (32 tokens) and the `transcribe` example on
    "__random__:tiny:1", each a path whose counts are set to 0 just before
    and read just after. Returns (the kernel's row, the paths' counts)."""
    import contextlib
    import io
    import os

    from whisper_diarize_tpu_torch.examples import transcribe as ex_transcribe
    from whisper_diarize_tpu_torch.tools import run_config
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    by_path = {}
    eng = make_engine("large-v3", whisper_model_path="__random__:large-v3:1",
                      max_decode_tokens=32, temperature_fallback=False)
    wav = _write_wav(WORK / "dtw.wav", 30.0, 50)
    opts = wdt.TranscribeOptions(enable_vad=False, lang="auto")
    align, anchors = [], []
    orig = TranscribeStep.start_alignment

    def measured(self, *a, **k):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        thunk = orig(self, *a, **k)
        torch.cuda.synchronize()
        align.append(dict(peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
                          enqueue_s=time.perf_counter() - t0))
        if thunk is None:
            return None

        def kept():
            out = thunk()
            anchors.append(out)
            return out
        return kept

    cues, rows = {}, {}
    eng.transcribe_audio(wav, opts)  # warm-up: the Engine's first request
    TranscribeStep.start_alignment = measured
    try:
        for path, host in (("dtw", False), ("dtw-host", True)):
            if host:
                os.environ["WDT_HOST_DTW"] = "1"
            reset_counts()
            align.clear()
            anchors.clear()
            t0 = time.perf_counter()
            cues[path] = eng.transcribe_audio(wav, opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            os.environ.pop("WDT_HOST_DTW", None)
            added = counts()
            rows[path] = [r for out in anchors for r in out]
            print(f"[dtw] beam 5 large-v3 30 s, {'WDT_HOST_DTW=1' if host else 'default'}: "
                  f"wall {wall:.3f} s, windows {eng.last_run['windows']}, cues "
                  f"{len(cues[path])}, words {sum(len(c.words or []) for c in cues[path])}, "
                  f"alignment stage {[{k: round(v, 4) for k, v in a.items()} for a in align]}, "
                  f"DTW launches {added['DTW']}", flush=True)
            if host:
                if added["DTW"]:
                    raise AssertionError("dtw: WDT_HOST_DTW=1 launched the DTW kernel")
            else:
                _check_missing("dtw default path", "dtw", added)
                by_path["dtw"] = added
    finally:
        TranscribeStep.start_alignment = orig
        os.environ.pop("WDT_HOST_DTW", None)
    same = [c.to_dict() for c in cues["dtw"]] == [c.to_dict() for c in cues["dtw-host"]]
    aligned = [r for r in rows["dtw"] if r is not None]
    same_anchors = len(rows["dtw"]) == len(rows["dtw-host"]) and all(
        (a is None and b is None) or (a is not None and b is not None and np.array_equal(a, b))
        for a, b in zip(rows["dtw"], rows["dtw-host"]))
    print(f"[dtw] default and WDT_HOST_DTW=1: cues and words identical {same}, anchors of "
          f"{len(aligned)} rows ({sum(map(len, aligned))} tokens) identical {same_anchors}",
          flush=True)
    if not (same and same_anchors and aligned):
        raise AssertionError("dtw: the two alignment paths differ, or aligned no row")
    (params, cfg, _), = eng._whisper_cache.values()
    row = _dtw_checks(params, cfg)
    del eng, params
    torch.cuda.empty_cache()

    os.environ["WDT_VAD_MODEL"] = "__random__"
    try:
        reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run_config.main(["4", wav, "--model-dir", "__random__:large-v3:1",
                                  "--cache-dir", str(WORK / "cache"), "--max-tokens", "32"])
        torch.cuda.synchronize()
        by_path["run-config-4"] = counts()
        report = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"[dtw] run_config 4 (rc {rc}): {json.dumps(report)}", flush=True)
        if rc != 0 or not report["xRT"] > 0:
            raise AssertionError(f"run_config 4: rc {rc}, report {report}")
        _check_missing("run_config 4", "run-config-4", by_path["run-config-4"])
        torch.cuda.empty_cache()
        reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.chdir(WORK):
            ex_transcribe.main([wav, "--model-dir", "__random__:tiny:1", "--max-tokens", "32",
                                "--no-vad"])
        by_path["example-transcribe"] = counts()
        last = out.getvalue().strip().splitlines()[-1]
        print(f"[dtw] example transcribe on the card: {last}", flush=True)
        if not last.endswith("cues written to segments.json"):
            raise AssertionError(f"example transcribe: {last}")
        _check_missing("example transcribe", "example-transcribe", by_path["example-transcribe"])
    finally:
        os.environ.pop("WDT_VAD_MODEL", None)
    return row, by_path


LONGFORM_ARGS = ["--minutes", "3", "--warmup-minutes", "0.5", "--model", "large-v3",
                 "--beam", "5"]


def phase_longform() -> dict:
    """`python -m whisper_diarize_tpu_torch.tools.bench_longform` in this
    process (its `main`, so that the launches count): a 3-minute stream at
    large-v3 (weights of the JAX init's distribution, seed 0), beam 5, 64
    tokens a window, after a 30 s warm-up stream, on
    the serial seek path (one window at a time, the rolling prompt, the
    resume journal under build/chip_smoke/longform, DTW). The counts are set
    to 0 just before and read just after; K1 - K4 and the DTW kernel must
    have launched. The tool's report line is printed; it must exit 0 with
    finite numbers, a window for each 30 s. The tool's deciles hold one gap
    each at this length, and its last gap is ~0 s (the last segment reaches
    the caller with the one before it), so its 3x guard cannot fail here:
    the phase records when each segment reaches the caller and holds the
    last third of the gaps before the last to 3x the first third's mean."""
    import contextlib
    import io
    import shutil

    from whisper_diarize_tpu_torch.tools import bench_longform

    work = WORK / "longform"
    shutil.rmtree(work, ignore_errors=True)  # a journal left over would replay
    buf = io.StringIO()
    walls, real = [], bench_longform.Callbacks

    def recorded(new_segment_callback=None, **kw):
        def seen(segment):
            walls.append(time.perf_counter())
            new_segment_callback(segment)
        return real(new_segment_callback=seen, **kw)

    bench_longform.Callbacks = recorded
    reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench_longform.main(LONGFORM_ARGS, workdir=str(work))
    finally:
        bench_longform.Callbacks = real
    added = counts()
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"[longform] {' '.join(LONGFORM_ARGS)}: rc {rc}, report {line}", flush=True)
    print(f"[longform] launches {added}", flush=True)
    report = json.loads(line)
    if rc != 0 or report["windows"] < 6 or not all(math.isfinite(report[k]) for k in (
            "value", "wall_s", "first_decile_s_per_window", "last_decile_s_per_window",
            "peak_device_mib")):
        raise AssertionError(f"longform: rc {rc}, report {report}")
    gaps = np.diff(walls)[:-1]
    third = len(gaps) // 3
    first, last = float(gaps[:third].mean()), float(gaps[-third:].mean())
    print(f"[longform] s between segments (the last gap, "
          f"{float(np.diff(walls)[-1]):.4f} s, left out): {np.round(gaps, 4).tolist()}; first "
          f"third {first:.4f}, last third {last:.4f}", flush=True)
    if last > bench_longform.GROWTH_GUARD * first:
        raise AssertionError(f"longform: the seconds a window grew from {first:.4f} to "
                             f"{last:.4f} over the run")
    _check_missing("longform", "longform", added)
    shutil.rmtree(work, ignore_errors=True)
    return added


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
    res.update(timed_phase("kernels f32", phase_f32_kernels))
    for key, t in timed_phase("kernels K2 local heads", phase_k2_heads).items():
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], t["max_abs_err"])
        if t["rows"]:
            res[key]["by_local_heads"] = t["rows"]
    res.update(timed_phase("kernels K7 K8 K10", phase_fused_kernels))
    res.update(timed_phase("kernels K9 K11", phase_probe_kernels, res))
    by_path = {"bench-dma": timed_phase("tool bench-dma", phase_tool, "bench-dma",
                                        [(bench_dma.main, {})])}
    by_path["bench-attn"] = timed_phase("tool bench-attn", phase_tool, "bench-attn",
                                        [(bench_attn_kernel.main, {}),
                                         (bench_attn_kernel.main, bench_attn_kernel.SERVED)])
    by_path["bench-encoder-attn"] = timed_phase(
        "tool bench-encoder-attn", phase_tool, "bench-encoder-attn",
        [(bench_encoder_attn.main, {})], ("ms",))
    by_path["bench-megakernel"] = timed_phase(
        "tool bench-megakernel", phase_tool, "bench-megakernel",
        [(bench_megakernel.main, dict(inline=True, smoke=False))], ("ms_per_step", "t64_ms"))
    by_path.update(breakdown_phases())
    train = timed_phase("train", phase_train)
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
    by_path.update(timed_phase("mesh 1x1", phase_mesh_one_rank, [
        ("mesh-1x1-beam", "large-v3", False, beam[0][1]),
        ("mesh-1x1-greedy", "large-v3-turbo", True, greedy[0][1])]))
    res["DTW"], dtw_paths = timed_phase("dtw", phase_dtw)
    by_path.update(dtw_paths)
    by_path["longform"] = timed_phase("longform", phase_longform)
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
    # depth: the ladder off and 32 tokens a window
    spec_eng = make_engine("large-v3", max_decode_tokens=32, temperature_fallback=False,
                           draft_model_path=draft_snapshot())
    spec = speculative_requests()
    by_path["speculative"] = timed_phase("engine speculative", phase_speculative, spec_eng,
                                         spec)
    by_path["bench-spec"] = timed_phase("tool bench-spec", phase_bench_spec)
    by_path["ggml"] = timed_phase("ggml", phase_ggml)
    torch.cuda.empty_cache()
    by_path.update(timed_phase("engine f32", phase_engine_f32))
    torch.cuda.empty_cache()
    by_path.update(timed_phase("two ranks", phase_two_ranks))
    print(f"[train] summary: {json.dumps(train)}", flush=True)
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
        lines += phase_profile("speculative greedy, large-v3 + the 2-layer draft, whole-file 30 s",
                               engine_request(spec_eng, spec[0][1][0], spec[0][2]))
        draft, spec_eng.cfg.draft_model_path = spec_eng.cfg.draft_model_path, None
        lines += phase_profile("greedy, large-v3, whole-file 30 s (the same Engine, no draft)",
                               engine_request(spec_eng, spec[0][1][0], spec[0][2]))
        spec_eng.cfg.draft_model_path = draft
        (WORK / "profile.txt").write_text("\n".join(lines) + "\n")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    print(json.dumps({"kernels": [
        {"name": spec["name"], "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], **({"note": spec["note"]} if "note" in spec else {}),
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
