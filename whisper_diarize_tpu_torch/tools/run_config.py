"""Run one of the five eval configurations on the port (counterpart of the
repository's `evals/run_config.py`, on the port's own Engine and
`evals.py`).

Configs:
  1  Whisper base.en greedy, VAD-only segmentation
  2  Whisper small.en + DTW word timestamps + subtitle formatting
  3  Whisper medium + Silero VAD + diarization (segmentation/embeddings/clustering)
  4  Whisper large-v3 beam=5, long-form chunked decode, auto language detect
  5  Batched multi-stream: large-v3-turbo + diarization over 16 parallel WAVs

Usage:
  python -m whisper_diarize_tpu_torch.tools.run_config 1 audio.wav [--ref-text ref.txt]
      [--model-dir DIR] [--cpu]
  python -m whisper_diarize_tpu_torch.tools.run_config 5 wav_dir/ [--model-dir DIR] [--cpu]

Runs on CUDA device 0 (and raises without a card) unless `--cpu` is given.
`--model-dir` takes a snapshot directory, a GGML or OpenAI `.pt` file, or
"__random__:<preset>[:seed]" (random weights at a preset's geometry). The
VAD and diarization weights come from $WDT_VAD_MODEL, $WDT_SEG_MODEL and
$WDT_EMB_MODEL (a path or "__random__").

Prints one JSON line: xRT (audio seconds per wall second) always; WER when
--ref-text is given; word-timestamp MAE when --ref-words is given (JSON
[[text, start, end], ...] in seconds); DER and its parts, and the speakers
found, when --ref-rttm is given (RTTM: "SPEAKER file 1 start dur <NA> <NA>
speaker <NA> <NA>").
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from ..audio import read_wav
from ..engine import Engine, EngineConfig
from ..evals import Turn, der, wer, word_timestamp_mae
from ..types import AdvancedTranscribe, TranscribeOptions

CONFIGS = {
    1: dict(model="base.en", strategy="greedy", vad=True, diarize=False, dtw=False, lang="en"),
    2: dict(model="small.en", strategy=None, vad=True, diarize=False, dtw=True, lang="en"),
    3: dict(model="medium", strategy=None, vad=True, diarize=True, dtw=True, lang="auto"),
    4: dict(model="large-v3", strategy=None, beam=5, vad=True, diarize=False, dtw=True,
            lang="auto"),
    5: dict(model="large-v3-turbo", strategy=None, vad=True, diarize=True, dtw=True,
            lang="auto", batch=16),
}


def read_rttm(path: str):
    """The SPEAKER lines of an RTTM file as Turns."""
    turns = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "SPEAKER":
                start, dur = float(parts[3]), float(parts[4])
                turns.append(Turn(parts[7], start, start + dur))
    return turns


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m whisper_diarize_tpu_torch.tools.run_config")
    p.add_argument("config", type=int, choices=sorted(CONFIGS))
    p.add_argument("audio", help="WAV file (configs 1-4) or directory (config 5)")
    p.add_argument("--model-dir", default=None,
                   help='snapshot dir, GGML / .pt file, or "__random__:<preset>[:seed]"')
    p.add_argument("--cache-dir", default="./cache")
    p.add_argument("--ref-text", default=None)
    p.add_argument("--ref-words", default=None,
                   help="JSON [[text, start, end], ...] reference word timings "
                        "-> word-timestamp MAE (target <= 20 ms)")
    p.add_argument("--ref-rttm", default=None)
    p.add_argument("--max-tokens", type=int, default=224)
    p.add_argument("--diarize-threshold", type=float, default=None,
                   help="embedding-cluster cosine threshold (default 0.5); the "
                        "offline DER golden raises it to split untrained-embedding "
                        "clusters")
    p.add_argument("--max-speakers", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions); default: CUDA device 0")
    args = p.parse_args(argv)
    c = CONFIGS[args.config]

    eng = Engine(EngineConfig(
        cache_dir=args.cache_dir,
        whisper_model_path=args.model_dir,
        enable_dtw=c["dtw"],
        batch_size=c.get("batch", 8),
        max_decode_tokens=args.max_tokens,
        vad_model_path=os.environ.get("WDT_VAD_MODEL"),
        diarize_segment_model_path=os.environ.get("WDT_SEG_MODEL"),
        diarize_embedding_model_path=os.environ.get("WDT_EMB_MODEL"),
        use_gpu=not args.cpu,
    ))
    opts = TranscribeOptions(
        model=c["model"],
        lang=c["lang"],
        enable_vad=c["vad"] and not c["diarize"],
        enable_diarize=c["diarize"] or None,
        max_speakers=args.max_speakers,
        advanced=AdvancedTranscribe(
            sampling_strategy=c.get("strategy"),
            best_of_or_beam_size=c.get("beam"),
            diarize_threshold=args.diarize_threshold,
        ),
    )

    if args.config == 5:
        wavs = sorted(glob.glob(os.path.join(args.audio, "*.wav")))[:16]
    else:
        wavs = [args.audio]

    audio_seconds = sum(len(read_wav(w)) / 16000.0 for w in wavs)
    t0 = time.perf_counter()
    all_cues = [eng.transcribe_audio(w, opts) for w in wavs]
    elapsed = time.perf_counter() - t0

    report = {
        "config": args.config,
        "model": c["model"],
        "files": len(wavs),
        "audio_seconds": round(audio_seconds, 2),
        "wall_seconds": round(elapsed, 3),
        "xRT": round(audio_seconds / elapsed, 2),
    }
    if args.ref_text:
        hyp = " ".join(cue.text.replace("\n", " ") for cue in all_cues[0])
        with open(args.ref_text) as f:
            ref = f.read()
        report["wer"] = round(wer(ref, hyp), 4)
    if args.ref_words:
        with open(args.ref_words) as f:
            ref_words = [tuple(w) for w in json.load(f)]
        hyp_words = [(w.text, w.start, w.end) for cue in all_cues[0] for w in (cue.words or [])]
        mae = word_timestamp_mae(ref_words, hyp_words)
        report["word_mae_s"] = None if mae is None else round(mae, 4)
        report["word_mae_aligned"] = mae is not None
    if args.ref_rttm:
        hyp_turns = [Turn(cue.speaker_id or "?", cue.start, cue.end) for cue in all_cues[0]]
        report["der"] = {k: round(v, 4)
                         for k, v in der(read_rttm(args.ref_rttm), hyp_turns).items()}
        report["speakers_found"] = len({t.speaker for t in hyp_turns if t.speaker != "?"})
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
