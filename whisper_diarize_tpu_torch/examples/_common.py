"""Shared helpers for the port's examples.

Every example that transcribes accepts `--model-dir` (a local snapshot, a
GGML or `.pt` file, or "__random__:<preset>[:seed]") so it runs with no
network; without it, models are fetched through the ModelManager. It runs
on CUDA device 0 (and raises without a card) unless `--cpu` is given.

`python -m whisper_diarize_tpu_torch.examples._common make-fixture /tmp/fx`
writes a tiny random-weight snapshot and a test WAV for offline runs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("audio", nargs="?", default="example.wav", help="mono 16 kHz WAV")
    p.add_argument("--model", default="base", help="whisper model name")
    p.add_argument("--model-dir", default=None,
                   help='local snapshot dir, GGML / .pt file or "__random__:<preset>" (offline)')
    p.add_argument("--cache-dir", default="./cache")
    p.add_argument("--lang", default="auto")
    p.add_argument("--no-vad", action="store_true")
    p.add_argument("--diarize", action="store_true")
    p.add_argument("--dtw", action="store_true", default=True)
    p.add_argument("--greedy", action="store_true", help="greedy instead of beam-5")
    p.add_argument("--max-tokens", type=int, default=224)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU; default: CUDA device 0")
    return p


def make_engine(args, **over):
    """The Engine of an example's flags (`over`: more EngineConfig fields):
    the card unless `--cpu`; an offline run (`--model-dir`, or
    WDT_OFFLINE=1) takes random VAD and diarization weights unless
    WDT_VAD_MODEL / WDT_SEG_MODEL / WDT_EMB_MODEL name them, and says so."""
    from ..engine import Engine, EngineConfig

    cfg = EngineConfig(
        cache_dir=args.cache_dir,
        whisper_model_path=args.model_dir,
        enable_dtw=args.dtw,
        batch_size=getattr(args, "batch", 8),
        max_decode_tokens=getattr(args, "max_tokens", 224),
        use_gpu=not getattr(args, "cpu", False),
        **over,
    )
    offline = args.model_dir is not None or os.environ.get("WDT_OFFLINE") == "1"
    rand_default = "__random__" if offline else None
    if offline:
        print(
            "[examples] offline run: VAD/diarization nets use RANDOM weights "
            "unless WDT_VAD_MODEL / WDT_SEG_MODEL / WDT_EMB_MODEL are set — "
            "segmentation quality will be noise",
            file=sys.stderr,
        )
    if args.diarize:
        cfg.diarize_segment_model_path = os.environ.get("WDT_SEG_MODEL", rand_default)
        cfg.diarize_embedding_model_path = os.environ.get("WDT_EMB_MODEL", rand_default)
    cfg.vad_model_path = os.environ.get("WDT_VAD_MODEL", rand_default)
    return Engine(cfg)


def make_options(args):
    from ..types import AdvancedTranscribe, TranscribeOptions

    advanced = (AdvancedTranscribe(sampling_strategy="greedy")
                if getattr(args, "greedy", False) else None)
    return TranscribeOptions(
        model=args.model,
        lang=args.lang,
        enable_vad=not args.no_vad and not args.diarize,
        enable_diarize=args.diarize or None,
        advanced=advanced,
    )


def make_fixture(path: str) -> None:
    """Write a tiny random snapshot (`path`/snap) and a 4 s test WAV
    (`path`/example.wav)."""
    import torch

    from ..audio import write_wav
    from ..models import weights
    from ..models import whisper as wm

    cfg = wm.WhisperConfig(
        n_mels=80, n_vocab=51865,
        n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
        n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
    )
    os.makedirs(path, exist_ok=True)
    params = weights.init_params_normal(cfg, torch.device("cpu"), torch.float32, seed=0)
    weights.save_params(params, cfg, os.path.join(path, "snap"))
    rng = np.random.default_rng(0)
    x = np.zeros(16000 * 4, np.int16)
    x[16000: 16000 * 3] = (rng.standard_normal(16000 * 2) * 6000).astype(np.int16)
    write_wav(os.path.join(path, "example.wav"), x)
    print(f"fixture written: {path}/snap + {path}/example.wav")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 2 and argv[0] == "make-fixture":
        make_fixture(argv[1])


if __name__ == "__main__":
    main()
