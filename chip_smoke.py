"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises (non-zero exit,
traceback) and no result line is printed:

1. device: name, torch / CUDA versions, `nvidia-smi` name and power limit;
2. build: compiles the hand-written kernels from `whisper_diarize_tpu_torch/
   csrc/` with nvcc (sm_90a) and prints the build time;
3. kernels: K1 (cross-attention), K2 (cross K/V build), K3 (decoder tail)
   and K4 (split-cache self-attention of a beam step) against their plain
   PyTorch versions in bf16 at large-v3 widths (D 1280, 20 heads) and the
   shapes the main paths give them, K1-K3 on the 4-layer stack of
   large-v3-turbo and the 32-layer stack of large-v3 (see `phase_kernels`,
   `phase_k4`), with
   the tolerance of `whisper_diarize_tpu_torch/kernels/agreement.py` (a few
   bf16 ulps per element and 1e-2 relative L2 of the update), planted
   faults that the check must refuse, and times of kernel and plain
   version after warm-up: CUDA events over back-to-back calls, and the
   profiled device time of their kernels (`timed`);
4. reference: the greedy and the beam-5 path on the card (bf16, through the
   kernels) against the f32 plain path on the CPU on a small input (`tiny`
   preset); a beam run with the ancestry map ignored must fail the check;
5. engine, greedy path: one `Engine` serves five requests (random
   `large-v3-turbo` weights, greedy, DTW word timestamps, the
   temperature-fallback ladder, batch 8): a ~45 s whole-file request, a VAD
   request with random VAD weights, a second whole-file request, a 10 s
   one, and `transcribe_audio_batch` over eight 10 s files;
6. engine, beam path (the Engine's default, `advanced=None`, beam 5): one
   `Engine` at random `large-v3` weights (32 decoder layers, ladder and DTW
   on, batch 8, 64 tokens a window) serves a ~30 s whole-file request with
   language detection, a VAD request, and `transcribe_audio_batch` over
   eight 10 s files (B = 8, 40 beam rows).
   In 5 and 6 each request prints wall time, windows decoded and the
   launches it added; a request that decoded a window must have raised the
   count of every kernel of its path (K1-K3 greedy, K1-K4 beam). The
   counts are set to 0 just before each path and read just after;
7. with `--profile` only: the 45 s greedy request and the 30 s beam request
   under torch.profiler (device busy time and kernel time by kind, also
   written to build/chip_smoke/profile.txt).

Then it prints one JSON line of per-kernel results (`launches` summed over
the two paths' runs), the `nvidia-smi` name and power limit line, and last
`{"ok": true, "device": {...}}`. It writes only under `build/` of the
checkout.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import whisper_diarize_tpu_torch as wdt
from whisper_diarize_tpu_torch import kernels
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import whisper as wm
from whisper_diarize_tpu_torch.ops import attn, tail

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
}
PATHS = {"greedy": ("K1", "K2", "K3"), "beam": ("K1", "K2", "K3", "K4")}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
             if "registers" in ln or "spill" in ln]
    print(f"[build] kernels ready in {took:.2f} s (nvcc {kernels.build_seconds})",
          flush=True)
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: the summed durations of the kernels it
    launches (torch.profiler), without the gaps in which the device waits
    for the host. Where the host issues calls slower than the device runs
    them, `time_ms` measures the host and this the kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kern) / iters / 1e3


def timed(tag: str, fn, plain, **extra) -> dict:
    """Kernel and plain version: CUDA-event time of back-to-back calls and
    profiled device time, printed and returned."""
    t = dict(ms=time_ms(fn), plain_ms=time_ms(plain),
             device_ms=device_ms(fn), plain_device_ms=device_ms(plain), **extra)
    print(f"[kernels] {tag} time {t['ms']:.4f} ms (device {t['device_ms']:.4f}), "
          f"plain {t['plain_ms']:.4f} ms (device {t['plain_device_ms']:.4f})", flush=True)
    return t


def phase_kernels(preset: str) -> dict:
    """K1/K2/K3 against their plain versions at the shapes the main paths
    give them, on the last layer of `preset`'s decoder stack (run for
    large-v3-turbo, 4 layers, the greedy path's model, and large-v3, 32
    layers, the beam path's). Every decode batch is padded to `batch_size`
    rows (`parallel.batching.pack_batch`), so the served paths run B = 8
    streams: K2 at B = 8; K1 at prefill with Q = beams x prompt = 3 (sot,
    language, task) at t = 0 and 15 (best_of 5 candidates) on the fallback
    ladder, Q = 4 (the prompt without timestamps) and 64 (a prompt with
    previous text); K3 at N = 8 (greedy t = 0) and N = 40 (5 beams, or the
    ladder). The same at B = 1 (`batch_size=1`). The tolerance is that of
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
    res = {}

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
            res["K2"] = timed(f"K2 B={B} L={L}", lambda: attn.cross_kv_build(*args),
                              lambda: attn.cross_kv_build_plain(*args),
                              shape=f"B={B} Ta={Ta} D={D} L={L}")

        for Q in ((3, 4, 15, 64) if main else (3, 15)):
            q = ag.randn(g, dev, B, Q, H, Dh, scale=2.0)
            a = (lay, q, k, v, Ta)
            note("K1", ag.compare(f"K1 cross_attn_layer B={B} Q={Q} {at}",
                                  attn.cross_attn_layer(*a), attn.cross_attn_layer_plain(*a)))
            if not main:
                continue
            if Q == 15:
                for name, bad in ag.k1_faults(*a):
                    ag.reject(name, attn.cross_attn_layer(*a), bad)
            t = timed(f"K1 B={B} Q={Q} {at}", lambda: attn.cross_attn_layer(*a),
                      lambda: attn.cross_attn_layer_plain(*a), shape=f"B={B} Q={Q} H={H} Ta={Ta} {at}")
            if Q == 3:
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
                for name, bad in ag.k3_faults(*a):
                    ag.reject(name, got, bad, base=x)
            t = timed(f"K3 N={N} {at}", lambda: tail.fused_tail_layer(*a),
                      lambda: tail.fused_tail_layer_plain(*a), shape=f"N={N} beams={beams} D={D} {at}")
            if beams == 5:
                res["K3"] = t
    for key in res:
        res[key]["max_abs_err"] = errs[key]
    return res


def phase_kernels_all() -> dict:
    """`phase_kernels` for both presets: the large-v3-turbo readings at the
    top (as before the beam path existed), the large-v3 ones under
    "large-v3"; `max_abs_err` is the worst of both."""
    res = phase_kernels("large-v3-turbo")
    for key, t in phase_kernels("large-v3").items():
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], t["max_abs_err"])
        res[key]["large-v3"] = t
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
                        t = timed(f"K4 B={B} Tp={Tp} Td={Td} step={step}",
                                  lambda: attn.split_self_attn_layer(next(it) % L, *rest),
                                  lambda: attn.split_self_attn_layer_plain(next(it) % L, *rest),
                                  shape=f"B={B} K={K} H={H} Tp={Tp} Td={Td} step={step}")
                        if step == Td // 2 - 1:
                            res["K4"] = t
                del q, pk, pv, dk, dv
    res["K4"]["max_abs_err"] = err
    return res


def _teacher_forced(cpu, cfg, xa_b, prompt, toks, dc):
    """The f32 CPU path's prepared logits [n, V] for the n tokens `toks`
    (sampling grammar without timestamps), each given the tokens before it."""
    from whisper_diarize_tpu_torch.ops import decode as dec

    seq = torch.cat([prompt, toks])[None]
    cache = wm.init_self_cache(cfg, 1, torch.float32, "cpu", len(seq[0]) + 16)
    logits = wm.decode_step(cpu.params, cfg, seq, 0, cache, wm.cross_kv(cpu.params, xa_b, cfg))[0]
    return torch.stack([
        dec._prepare_logits(logits[len(prompt) - 1 + t][None], cpu._suppress,
                            cpu.sp, dc, t, *[None] * 4)[0]
        for t in range(len(toks))])


def _beam_error(cpu, cfg, ref, prompt, dc, res) -> float:
    """The worst, over the streams of the beam result `res`, of |the sum
    log-probability it reports - the f32 CPU score of its tokens,
    teacher-forced| per token (eot included)."""
    toks, lens, reported = res.tokens.cpu(), res.lengths.cpu(), res.sum_logprob.float().cpu()
    err = 0.0
    for b in range(toks.shape[0]):
        n = min(int(lens[b]) + 1, toks.shape[1])
        rows = _teacher_forced(cpu, cfg, ref[b:b + 1], prompt, toks[b, :n], dc)
        score = float(torch.log_softmax(rows, dim=-1).gather(1, toks[b, :n, None]).sum())
        err = max(err, abs(float(reported[b]) - score) / n)
    return err


def phase_reference() -> None:
    """The main paths on the card (bf16, through the kernels) against the
    f32 plain path on the CPU, on a small input: the `tiny` preset (Dh 64)
    with the JAX package's random init, two 10 s windows, 24 tokens without
    timestamps. The encoder output must agree within 5e-2 relative. Greedy:
    every token the card picks must be within 2e-2 * max|logit| of the best
    token of the CPU reference teacher-forced on the same prefix (bf16 may
    flip near-ties, nothing more). Beam 5 (`_beam_error`): the sum
    log-probability the card reports for the hypothesis it chose must be
    within 2e-2 a token of the CPU's f32 score of the same tokens, and a
    beam run with a planted fault (the ancestry map ignored: every beam
    reads its own row's decode K/V) must fail that limit. Which hypothesis
    the card chooses is not compared: at random weights the logits are
    nearly flat and bf16 sends the search down other paths."""
    from whisper_diarize_tpu.tokenizer import DebugTokenizer
    from whisper_diarize_tpu_torch.models import weights
    from whisper_diarize_tpu_torch.ops import decode as dec
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    cfg = wm.PRESETS["tiny"]
    tree = wm.init_params_np(cfg, seed=0)
    tk = DebugTokenizer()
    dc = dec.DecodeConfig(max_tokens=24, with_timestamps=False, blank_id=32)
    params = {"card": weights.params_from_jax(tree, "cuda", torch.bfloat16),
              "ref": weights.params_from_jax(tree, "cpu", torch.float32)}
    steps = {(side, strat): TranscribeStep(params[side], cfg, tk, decode_config=dc,
                                           strategy=strat)
             for side in params for strat in ("greedy", "beam_search")}
    rng = np.random.default_rng(5)
    audio = np.zeros((2, 480000), np.float32)
    audio[:, :160000] = rng.standard_normal((2, 160000)).astype(np.float32) * 0.1
    cpu = steps["ref", "greedy"]
    prompt = torch.tensor(tk.sot_sequence(language="en"))
    with torch.inference_mode():
        xa = {side: steps[side, "greedy"].encode(steps[side, "greedy"].mel(audio))
              for side in params}
        ref = xa["ref"]
        rel = float((xa["card"].float().cpu() - ref).abs().max() / ref.abs().max())
        res = steps["card", "greedy"].decode(xa["card"], "en", "transcribe")
        toks, lens = res.tokens.cpu(), res.lengths.cpu()
        worst = 0.0
        for b in range(2):
            n = min(int(lens[b]) + 1, toks.shape[1])  # text tokens + eot
            rows = _teacher_forced(cpu, cfg, ref[b:b + 1], prompt, toks[b, :n], dc)
            gap = (rows.max(dim=-1).values - rows.gather(1, toks[b, :n, None])[:, 0]).max()
            worst = max(worst, float(gap) / float(rows[torch.isfinite(rows)].abs().max()))
        beam = steps["card", "beam_search"].decode(xa["card"], "en", "transcribe")
        beam_err = _beam_error(cpu, cfg, ref, prompt, dc, beam)
        real_step = wm.decode_step_split

        def ancestry_ignored(*a):
            anc = a[-1]
            own = torch.arange(anc.shape[0], device=anc.device)[:, None].expand_as(anc)
            return real_step(*a[:-1], own)

        wm.decode_step_split = ancestry_ignored
        try:
            bad = steps["card", "beam_search"].decode(xa["card"], "en", "transcribe")
        finally:
            wm.decode_step_split = real_step
        bad_err = _beam_error(cpu, cfg, ref, prompt, dc, bad)
    ok = rel <= 5e-2 and worst <= 2e-2 and beam_err <= 2e-2 < bad_err
    print(f"[reference] tiny preset, 2 x 10 s: encoder rel err {rel:.4g} (tol 5e-2); "
          f"greedy tokens {lens.tolist()}, worst card-token logit gap vs f32 CPU best "
          f"{worst:.4g} of max|logit| (tol 2e-2); beam-5 lengths {beam.lengths.tolist()}, "
          f"sum logprob {beam.sum_logprob.float().tolist()}, worst |card - f32 CPU score| "
          f"per token {beam_err:.4g} (tol 2e-2); planted fault, ancestry ignored: "
          f"{bad_err:.4g} ({'refused' if bad_err > 2e-2 else 'NOT refused'}) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card's main paths disagree with the f32 CPU reference, "
                             "or the beam check passed a planted fault")


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


def counts() -> dict:
    return {k: spec["fn"].launches for k, spec in KERNELS.items()}


def make_engine(model: str):
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

    WORK.mkdir(parents=True, exist_ok=True)
    return Engine(EngineConfig(
        cache_dir=str(WORK / "cache"), whisper_model_path=f"__random__:{model}",
        vad_model_path="__random__", batch_size=8, enable_dtw=True,
        temperature_fallback=True, max_decode_tokens=64))


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


def phase_engine(eng, path: str, requests) -> dict:
    """Serve `requests` on `eng`; the launch counts are set to 0 just before
    and read just after. Every request that decoded a window must have
    launched every kernel of the path. Returns the path's counts."""
    for k in KERNELS.values():
        k["fn"].launches = 0
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
        print(f"[engine {path}] {label}: wall {wall:.3f} s, windows {windows}, cues "
              f"{sum(len(c) for c in cue_lists)}, launches added {added}, stages "
              f"{ {k: round(v, 3) for k, v in eng.last_run['stage_s'].items()} }",
              flush=True)
        if windows:
            decoded_any = True
            missing = [k for k in PATHS[path] if added[k] <= 0]
            if missing:
                raise AssertionError(f"{label}: decoded {windows} windows but "
                                     f"{missing} were not launched: {added}")
    if not decoded_any:
        raise AssertionError(f"{path} path: no request decoded a window")
    return counts()


def _kernel_kind(name: str) -> str:
    if "split_self_kernel" in name:
        return "K4 split-cache self-attention"
    if "skinny_gemm" in name:
        return "K3 skinny GEMMs"
    if "cross_attn_kernel" in name:
        return "K1 attention (prefill, and inside K3)"
    if "cross_kv_kernel" in name:
        return "K2 cross K/V"
    if "sort" in name.lower():
        return "sorts (beam top-k)"
    if "copy" in name:
        return "dtype copies / casts"
    if "f32f32" in name or "sgemm" in name or "gemvx" in name:
        return "f32 GEMM (vocabulary logits)"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "bf16 GEMM (encoder, q/k/v, prefill)"
    if "index" in name.lower() or "gather" in name or "scatter" in name:
        return "gathers / index (beam reindex, embeddings)"
    if "reduce" in name or "softmax" in name or "layer_norm" in name:
        return "reductions / softmax / layernorm"
    if "elementwise" in name or "Functor" in name:
        return "elementwise"
    return "other"


def phase_profile(eng, label: str, path: str, opts) -> list:
    """`--profile`: one request three times unprofiled, then once under
    torch.profiler; the device's busy time (union of kernel intervals) and
    kernel time by kind. Returns the printed lines."""
    from torch.profiler import ProfilerActivity, profile

    lines = [f"{label}:"]
    for _ in range(3):
        t0 = time.perf_counter()
        eng.transcribe_audio(path, opts)
        torch.cuda.synchronize()
        lines.append(f"unprofiled wall {time.perf_counter() - t0:.3f} s, windows "
                     f"{eng.last_run['windows']}, stages "
                     f"{ {k: round(v, 3) for k, v in eng.last_run['stage_s'].items()} }")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.transcribe_audio(path, opts)
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


def main() -> None:
    smi = phase_device()
    phase_build()
    res = phase_kernels_all()
    res.update(phase_k4())
    phase_reference()
    greedy_eng, greedy = make_engine("large-v3-turbo"), greedy_requests()
    by_path = {"greedy": phase_engine(greedy_eng, "greedy", greedy)}
    beam_eng, beam = make_engine("large-v3"), beam_requests()
    by_path["beam"] = phase_engine(beam_eng, "beam", beam)
    if "--profile" in sys.argv[1:]:
        lines = phase_profile(greedy_eng, "greedy, large-v3-turbo, whole-file 45 s",
                              greedy[0][1][0], greedy[0][2])
        lines += phase_profile(beam_eng, "beam 5, large-v3, whole-file 30 s, lang auto",
                               beam[0][1][0], beam[0][2])
        (WORK / "profile.txt").write_text("\n".join(lines) + "\n")
    print(json.dumps({"kernels": [
        {"name": spec["name"], "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"],
         "launches": sum(c[key] for c in by_path.values()),
         "launches_by_path": {p: c[key] for p, c in by_path.items()}, **res[key]}
        for key, spec in KERNELS.items()]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
