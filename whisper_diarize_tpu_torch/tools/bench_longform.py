"""One long synthetic stream through `Engine.transcribe_audio`: the port's
long-form measurement (counterpart of `tools/bench_longform.py`).

The Engine's serial seek path at length: one stream, so the WindowScheduler
hands out one window at a time and each next window's start depends on the
previous decode (whisper.cpp's seek loop); the rolling prompt carried from
window to window (`sequential_prompt`), the per-window resume journal
(`resume_dir`), DTW word alignment and the formatting all inside the
measurement. Reports xRT, the seconds a window in the first and last
deciles of the run (the host glue must scale linearly in windows), the
host seconds of the Engine's stages (`last_run["stage_s"]`: the request's
span totals, each stage's enqueue and host work, not its device time),
peak host memory and peak device memory.

    python -m whisper_diarize_tpu_torch.tools.bench_longform [--minutes 60]
        [--model large-v3] [--beam 5] [--max-tokens 64] [--seed 0] [--no-seek]
        [--random-seek] [--warmup-minutes 2]
    python -m whisper_diarize_tpu_torch.tools.bench_longform --device cpu \\
        --minutes 2 --model tiny --max-tokens 4 --beam 1 --warmup-minutes 0

The weights are random, of the JAX init's distribution, from `--seed`
("__random__:<model>:<seed>"), not the JAX tool's pattern weights
("__random__:<model>"): on the card, large-v3's pattern weights decode
every window to an empty segment at its start, and the seek then moves by
its 1 s minimum, so that an hour is 3,600 windows instead of 120.

Runs on CUDA device 0 and raises without a card unless `--device cpu` is
given. Random weights would end every window at once, so the end-of-text
token is suppressed, and so are the timestamps between <|0.00|> and the
window's last (random timestamps drive pathological partial seeks where a
trained checkpoint advances a window fully); the temperature-fallback
ladder is off (random log-probabilities trip it on every window).
`--random-seek` keeps the random timestamps and the ladder, to stress the
seek guard itself. A warm-up stream first (`--warmup-minutes`, 0 for none)
keeps first-use costs (the kernels' build, the allocator's growth) out of
the timed run.

Prints one JSON line, last. Exits 1 when the last decile's seconds a window
exceed 3x the first's (per-window time grew superlinearly).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..audio import write_wav
from ..engine import Engine, EngineConfig
from ..ops import decode as dec
from ..types import AdvancedTranscribe, Callbacks, TranscribeOptions
from . import timing

GROWTH_GUARD = 3.0  # last decile's seconds a window over the first's


def _stream(rng: np.random.Generator, minutes: float) -> np.ndarray:
    return (rng.standard_normal(int(16000 * 60 * minutes)) * 6000).astype(np.int16)


def main(argv: Optional[Sequence[str]] = None, workdir: Optional[str] = None) -> int:
    """Run the tool; returns the exit code. `workdir` keeps the WAVs, the
    model cache and the resume journal there (a second call on the same
    directory replays the journal); by default a temporary directory,
    removed at the end."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--minutes", type=float, default=60.0)
    p.add_argument("--model", default="large-v3")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--seed", type=int, default=0, help="the audio's and the weights' seed")
    p.add_argument("--no-seek", action="store_true",
                   help="fixed 30 s strides instead of decode-driven seek")
    p.add_argument("--random-seek", action="store_true",
                   help="keep random timestamps (pathological partial seeks) and the "
                        "temperature-fallback ladder")
    p.add_argument("--warmup-minutes", type=float, default=2.0,
                   help="transcribe a short throwaway stream first (0: none)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("bench_longform runs on CUDA device 0 and none is available; "
                           "pass --device cpu for the CPU path")
    device_line = timing.nvidia_smi_line() if on_card else "cpu"

    orig_mask = dec.build_suppress_mask

    def patched(sp, n_vocab, extra_suppress=None):
        extra = list(extra_suppress or []) + [sp.eot]
        if not args.random_seek:
            # keep <|0.00|> (forced at step 0) and the window's last
            # timestamp, so that every full window advances fully
            extra += list(range(sp.timestamp_begin + 1, sp.timestamp_begin + 1500))
        return orig_mask(sp, n_vocab, extra)

    td = workdir or tempfile.mkdtemp(prefix="wdt_longform_")
    os.makedirs(td, exist_ok=True)
    dec.build_suppress_mask = patched  # TranscribeStep reads it as dec.build_suppress_mask
    try:
        rng = np.random.default_rng(args.seed)
        wav = os.path.join(td, "long.wav")
        write_wav(wav, _stream(rng, args.minutes))
        eng = Engine(EngineConfig(
            use_gpu=on_card, gpu_device=0 if on_card else None,
            cache_dir=os.path.join(td, "cache"),
            whisper_model_path=f"__random__:{args.model}:{args.seed}",
            vad_model_path="__random__",  # never read (VAD off); no download
            enable_dtw=True,
            batch_size=8,
            max_decode_tokens=args.max_tokens,
            temperature_fallback=bool(args.random_seek),
            allow_random_weights=True,
            sequential_prompt=True,
            long_form_seek=not args.no_seek,
            resume_dir=os.path.join(td, "resume"),
        ))
        opts = TranscribeOptions(
            model=args.model, lang="en", enable_vad=False,
            advanced=AdvancedTranscribe(
                sampling_strategy=None if args.beam > 1 else "greedy",
                best_of_or_beam_size=args.beam))
        # the cadence a window: when each segment reaches the caller
        seg_walls: list = []
        cb = Callbacks(new_segment_callback=lambda s: seg_walls.append(time.perf_counter()))
        if args.warmup_minutes > 0:
            wwav = os.path.join(td, "warm.wav")
            write_wav(wwav, _stream(rng, args.warmup_minutes))
            eng.transcribe_audio(wwav, opts)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cues = eng.transcribe_audio(wav, opts, callbacks=cb)
        if on_card:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        stage_s = dict(eng.last_run.get("stage_s", {}))
        peak_device_mib = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else None
    finally:
        dec.build_suppress_mask = orig_mask
        if workdir is None:
            shutil.rmtree(td, ignore_errors=True)

    audio_seconds = args.minutes * 60.0
    gaps = np.diff(np.array(seg_walls)) if len(seg_walls) > 2 else np.array([])
    decile = max(len(gaps) // 10, 1)
    first_dec = float(gaps[:decile].mean()) if len(gaps) else None
    last_dec = float(gaps[-decile:].mean()) if len(gaps) else None
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    report = {
        "metric": (f"xRT longform {args.model} 1-stream "
                   f"{'beam' + str(args.beam) if args.beam > 1 else 'greedy'}"
                   f"{args.max_tokens} {args.minutes:g}min"),
        "value": audio_seconds / elapsed,
        "unit": "x realtime",
        "windows": len(seg_walls),
        "cues": len(cues),
        "wall_s": elapsed,
        "first_decile_s_per_window": first_dec,
        "last_decile_s_per_window": last_dec,
        "peak_rss_mb": peak_rss_mb,
        "stage_s": stage_s,
        "peak_device_mib": peak_device_mib,
        "device": device_line,
    }
    print(json.dumps(report), flush=True)
    # host glue must scale linearly in windows: the last decile may not be
    # systematically slower than the first (3x: seek sizes vary a window
    # with random timestamps)
    if first_dec and last_dec and last_dec > GROWTH_GUARD * first_dec:
        print("WARN: per-window time grew superlinearly", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
