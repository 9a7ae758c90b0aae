"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises (non-zero exit,
traceback) and no result line is printed:

1. device: name, torch / CUDA versions, `nvidia-smi` name and power limit;
2. build: compiles the hand-written kernels from `whisper_diarize_tpu_torch/
   csrc/` with nvcc (sm_90a) and prints the build time;
3. kernels: K1 (cross-attention), K2 (cross K/V build) and K3 (decoder tail)
   against their plain PyTorch versions in bf16 at large-v3-turbo widths
   and the shapes the main path gives them (see `phase_kernels`), with the
   tolerance of `whisper_diarize_tpu_torch/kernels/agreement.py` (a few
   bf16 ulps per element and 1e-2 relative L2 of the update), planted
   faults that the check must refuse, and CUDA-event times of kernel and
   plain version after warm-up;
4. reference: the main path on the card (bf16, through the kernels) against
   the f32 plain path on the CPU on a small input (`tiny` preset);
5. engine: one `Engine` serves five requests through the port's main path
   (random `large-v3-turbo` weights, greedy, DTW word timestamps, the
   temperature-fallback ladder, batch 8): a ~45 s whole-file request, a VAD
   request with random VAD weights, a second whole-file request, a 10 s
   one, and `transcribe_audio_batch` over eight 10 s files. Each prints
   wall time, windows decoded and the K1/K2/K3 launch counts it added; a
   request that decoded a window must have raised all three;
6. with `--profile` only: the 45 s request under torch.profiler (device
   busy time and kernel time by kind, also written to
   build/chip_smoke/profile.txt).

Then it prints one JSON line of per-kernel results, the `nvidia-smi` name and
power limit line, and last `{"ok": true, "device": {...}}`. It writes only
under `build/` of the checkout.
"""

from __future__ import annotations

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
}


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


def phase_kernels() -> dict:
    """K1/K2/K3 against their plain versions at the shapes the main path
    gives them. Every decode batch is padded to `batch_size` rows
    (`parallel.batching.pack_batch`), so the served path runs B = 8 streams:
    K2 at B = 8; K1 at prefill with Q = beams x prompt = 3 (sot, language,
    task) at t = 0 and 15 (best_of 5 candidates) on the fallback ladder,
    Q = 4 (the prompt without timestamps) and 64 (a prompt with previous
    text); K3 at N = 8 (t = 0) and N = 40 (ladder). The same at B = 1
    (`batch_size=1`). The tolerance is that of
    `kernels.agreement`; at B = 8 each kernel must also refuse its planted
    faults (a dropped bias, a wrong layer, an unscaled query)."""
    cfg = wm.PRESETS["large-v3-turbo"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D, H, L = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer
    Dh, Ta = cfg.head_dim, cfg.n_audio_ctx
    blocks = ag.random_blocks(L, D, g, dev)
    lay = L - 1
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
        note("K2", ag.compare(f"K2 cross_kv_build v B={B}", v, pv))
        if main:
            for name, i, bad in ag.k2_faults(*args):
                ag.reject(name, (k, v)[i], bad)
            ms = time_ms(lambda: attn.cross_kv_build(*args))
            plain_ms = time_ms(lambda: attn.cross_kv_build_plain(*args))
            print(f"[kernels] K2 B={B} time {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            res["K2"] = dict(ms=ms, plain_ms=plain_ms, shape=f"B={B} Ta={Ta} D={D} L={L}")

        for Q in ((3, 4, 15, 64) if main else (3, 15)):
            q = ag.randn(g, dev, B, Q, H, Dh, scale=2.0)
            a = (lay, q, k, v, Ta)
            note("K1", ag.compare(f"K1 cross_attn_layer B={B} Q={Q}",
                                  attn.cross_attn_layer(*a), attn.cross_attn_layer_plain(*a)))
            if not main:
                continue
            if Q == 15:
                for name, bad in ag.k1_faults(*a):
                    ag.reject(name, attn.cross_attn_layer(*a), bad)
            ms = time_ms(lambda: attn.cross_attn_layer(*a))
            plain_ms = time_ms(lambda: attn.cross_attn_layer_plain(*a))
            print(f"[kernels] K1 B={B} Q={Q} time {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            if Q == 3:
                res["K1"] = dict(ms=ms, plain_ms=plain_ms, shape=f"B={B} Q={Q} H={H} Ta={Ta}")

        for beams in (1, 5):
            N = B * beams
            x = ag.randn(g, dev, N, 1, D)
            so = ag.randn(g, dev, N, H, 1, Dh, scale=0.3)
            a = (lay, x, so, blocks, k, v, beams, Ta)
            got = tail.fused_tail_layer(*a)
            note("K3", ag.compare(f"K3 fused_tail_layer update B={B} N={N} beams={beams}",
                                  got, tail.fused_tail_layer_plain(*a), base=x))
            if not main:
                continue
            if beams == 5:
                for name, bad in ag.k3_faults(*a):
                    ag.reject(name, got, bad, base=x)
            ms = time_ms(lambda: tail.fused_tail_layer(*a))
            plain_ms = time_ms(lambda: tail.fused_tail_layer_plain(*a))
            print(f"[kernels] K3 N={N} time {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            if beams == 5:
                res["K3"] = dict(ms=ms, plain_ms=plain_ms, shape=f"N={N} beams={beams} D={D}")
    for key in res:
        res[key]["max_abs_err"] = errs[key]
    return res


def phase_reference() -> None:
    """The main path on the card (bf16, K1/K2/K3) against the f32 plain path
    on the CPU, on a small input: the `tiny` preset (Dh 64) with the JAX
    package's random init, one 10 s window, greedy without timestamps.
    The encoder output must agree within 5e-2 relative, and every token the
    card picks must be within 2e-2 * max|logit| of the best token of the CPU
    reference teacher-forced on the same token prefix (bf16 may flip
    near-ties, nothing more)."""
    from whisper_diarize_tpu.tokenizer import DebugTokenizer
    from whisper_diarize_tpu_torch.models import weights
    from whisper_diarize_tpu_torch.ops import decode as dec
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    cfg = wm.PRESETS["tiny"]
    tree = wm.init_params_np(cfg, seed=0)
    tk = DebugTokenizer()
    dc = dec.DecodeConfig(max_tokens=24, with_timestamps=False, blank_id=32)
    steps = {dev: TranscribeStep(weights.params_from_jax(tree, dev, dt), cfg, tk,
                                 decode_config=dc)
             for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32))}
    rng = np.random.default_rng(5)
    audio = np.zeros((2, 480000), np.float32)
    audio[:, :160000] = rng.standard_normal((2, 160000)).astype(np.float32) * 0.1
    with torch.inference_mode():
        xa = {d: s.encode(s.mel(audio)) for d, s in steps.items()}
        ref = xa["cpu"]
        rel = float((xa["cuda"].float().cpu() - ref).abs().max() / ref.abs().max())
        res = steps["cuda"].decode(xa["cuda"], "en", "transcribe")
        toks, lens = res.tokens.cpu(), res.lengths.cpu()
        cpu = steps["cpu"]
        prompt = torch.tensor(tk.sot_sequence(language="en"))
        worst = 0.0
        for b in range(2):
            n = min(int(lens[b]) + 1, toks.shape[1])  # text tokens + eot
            seq = torch.cat([prompt, toks[b, :n]])[None]
            cache = wm.init_self_cache(cfg, 1, torch.float32, "cpu", len(seq[0]) + 16)
            logits = wm.decode_step(cpu.params, cfg, seq, 0, cache,
                                    wm.cross_kv(cpu.params, ref[b:b + 1], cfg))[0]
            for t in range(n):
                row = dec._prepare_logits(
                    logits[len(prompt) - 1 + t][None], cpu._suppress, tk.specials,
                    dc, t, *[None] * 4)[0]
                gap = float(row.max() - row[toks[b, t]]) / float(logits.abs().max())
                worst = max(worst, gap)
    ok = rel <= 5e-2 and worst <= 2e-2
    print(f"[reference] tiny preset, 2 x 10 s: encoder rel err {rel:.4g} (tol 5e-2); "
          f"tokens {lens.tolist()}; worst card-token logit gap vs f32 CPU best "
          f"{worst:.4g} of max|logit| (tol 2e-2) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card's main path disagrees with the f32 CPU reference")


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


def make_engine():
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

    WORK.mkdir(parents=True, exist_ok=True)
    return Engine(EngineConfig(
        cache_dir=str(WORK / "cache"),
        whisper_model_path="__random__:large-v3-turbo",
        vad_model_path="__random__",
        batch_size=8, enable_dtw=True, temperature_fallback=True,
        max_decode_tokens=64,
    ))


def phase_engine(eng) -> None:
    adv = wdt.AdvancedTranscribe(sampling_strategy="greedy")
    batch = [_write_wav(WORK / f"e{i}.wav", 10.0, 10 + i) for i in range(8)]
    requests = [
        ("whole-file 45 s", [_write_wav(WORK / "a.wav", 45.0, 1)], False),
        ("vad 20 s", [_write_wav(WORK / "b.wav", 20.0, 2)], True),
        ("whole-file 45 s (2nd)", [_write_wav(WORK / "c.wav", 45.0, 3)], False),
        ("whole-file 10 s", [_write_wav(WORK / "d.wav", 10.0, 4)], False),
        ("batch of 8 whole files, 10 s each", batch, False),
    ]
    for k in KERNELS.values():  # count only the main path from here on
        k["fn"].launches = 0
    decoded_any = False
    for label, paths, vad in requests:
        before = counts()
        opts = wdt.TranscribeOptions(enable_vad=vad, lang="en", advanced=adv)
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
        print(f"[engine] {label}: wall {wall:.3f} s, windows {windows}, cues "
              f"{sum(len(c) for c in cue_lists)}, launches added {added}, stages "
              f"{ {k: round(v, 3) for k, v in eng.last_run['stage_s'].items()} }",
              flush=True)
        if windows:
            decoded_any = True
            if min(added.values()) <= 0:
                raise AssertionError(f"{label}: decoded {windows} windows but a "
                                     f"kernel was not launched: {added}")
    if not decoded_any:
        raise AssertionError("no request decoded a window")


def _kernel_kind(name: str) -> str:
    if "skinny_gemm" in name:
        return "K3 skinny GEMMs"
    if "cross_attn_kernel" in name:
        return "K1 attention (prefill, and inside K3)"
    if "cross_kv_kernel" in name:
        return "K2 cross K/V"
    if "copy" in name:
        return "dtype copies / casts"
    if "f32f32" in name or "sgemm" in name or "gemvx" in name:
        return "f32 GEMM (vocabulary logits)"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "bf16 GEMM (encoder, q/k/v, prefill)"
    if "reduce" in name or "softmax" in name or "layer_norm" in name:
        return "reductions / softmax / layernorm"
    if "elementwise" in name or "Functor" in name:
        return "elementwise"
    return "other"


def phase_profile(eng) -> None:
    """`--profile`: the 45 s whole-file request three times unprofiled, then
    once under torch.profiler; prints the device's busy time (union of
    kernel intervals) and kernel time by kind, and writes the table to
    build/chip_smoke/profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    adv = wdt.AdvancedTranscribe(sampling_strategy="greedy")
    opts = wdt.TranscribeOptions(enable_vad=False, lang="en", advanced=adv)
    path = str(WORK / "a.wav")
    lines = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.transcribe_audio(path, opts)
        torch.cuda.synchronize()
        lines.append(f"unprofiled wall {time.perf_counter() - t0:.3f} s, stages "
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
        lines.append(f"  {kind:40s} {total[kind] / 1e3:10.1f} ms {count[kind]:8d} launches "
                     f"{100 * total[kind] / max(busy, 1):6.1f}% of busy")
    (WORK / "profile.txt").write_text("\n".join(lines) + "\n")
    for ln in lines:
        print(f"[profile] {ln}", flush=True)


def main() -> None:
    smi = phase_device()
    phase_build()
    res = phase_kernels()
    phase_reference()
    eng = make_engine()
    phase_engine(eng)
    launches = counts()
    if "--profile" in sys.argv[1:]:
        phase_profile(eng)
    print(json.dumps({"kernels": [
        {"name": spec["name"], "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], "launches": launches[key], **res[key]}
        for key, spec in KERNELS.items()]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
