"""Command-line interface of the PyTorch port:
`python -m whisper_diarize_tpu_torch <command>` (counterpart of
`whisper_diarize_tpu/__main__.py`, the same commands and flags).

`transcribe` turns a WAV into subtitle-cue JSON (or SRT), `models` lists or
deletes cached models, `translate` translates text. `transcribe` runs on
CUDA device 0 unless given `--cpu` (`EngineConfig(use_gpu=False)`: f32
through the kernels' plain versions). `--model-dir` takes a snapshot
directory, a GGML file or an OpenAI `.pt` file; `--draft-model-dir`
engages speculative greedy decoding. There is no `bench` command: the JAX
one runs the JAX package's benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_transcribe(sub):
    p = sub.add_parser("transcribe", help="transcribe a mono 16 kHz WAV")
    p.add_argument("audio")
    p.add_argument("--model", default="base")
    p.add_argument("--model-dir", default=None,
                   help="local snapshot dir, GGML file or OpenAI .pt file")
    p.add_argument("--cache-dir", default="./cache")
    p.add_argument("--lang", default="auto")
    p.add_argument("--task", choices=["transcribe", "translate"], default="transcribe")
    p.add_argument("--translate-to", default=None, help="Google-translate target")
    p.add_argument("--no-vad", action="store_true")
    p.add_argument("--diarize", action="store_true")
    p.add_argument("--max-speakers", type=int, default=None)
    p.add_argument("--vad-model", default=None,
                   help="Silero VAD weights: converted .npz or the "
                        "reference's ggml-silero-v5.1.2.bin (default: "
                        "download from ggml-org/whisper-vad)")
    p.add_argument("--seg-model", default=None,
                   help="segmentation weights: .npz or segmentation-3.0.onnx")
    p.add_argument("--emb-model", default=None,
                   help="speaker-embedding weights: .npz or "
                        "wespeaker_en_voxceleb_CAM++.onnx")
    p.add_argument("--random-weights", action="store_true",
                   help="allow RANDOM weights when VAD/diarization models "
                        "can't load (architecture-only runs; outputs are "
                        "untrained noise)")
    p.add_argument("--no-dtw", action="store_true")
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-tokens", type=int, default=224)
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--resume-dir", default=None)
    p.add_argument("--sequential-prompt", action="store_true",
                   help="reference-parity rolling previous-text prompts")
    p.add_argument("--no-seek", action="store_true",
                   help="hard 30 s cuts instead of whisper.cpp seek advance")
    p.add_argument("--mesh", default=None, metavar="DxM",
                   help="multi-GPU inference mesh, e.g. 4x1 (data x model): run "
                        "under torchrun --nproc-per-node D*M (NCCL; gloo with "
                        "--cpu); global rank 0 writes the output")
    p.add_argument("--draft-model-dir", default=None,
                   help="local snapshot of a smaller vocab-compatible model "
                        "for speculative greedy decoding (exact output)")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="speculative proposals per verification pass")
    p.add_argument("--max-lines", type=int, default=None)
    p.add_argument("--max-chars-per-line", type=int, default=None)
    p.add_argument("-o", "--output", default="-", help="output JSON ('-' = stdout)")
    p.add_argument("--srt", action="store_true", help="emit SRT instead of JSON")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU in f32 (default: CUDA device 0)")


def _format_srt(cues) -> str:
    from .subtitles import to_srt

    return to_srt(cues)


def cmd_transcribe(args) -> int:
    from .engine import Engine, EngineConfig
    from .formatting import FormattingOverrides
    from .types import AdvancedTranscribe, Callbacks, TranscribeOptions, segments_to_json

    mesh_shape = None
    if args.mesh:
        d, m = args.mesh.lower().split("x")
        mesh_shape = (int(d), int(m))
    cfg = EngineConfig(
        use_gpu=not args.cpu,
        cache_dir=args.cache_dir,
        whisper_model_path=args.model_dir,
        enable_dtw=not args.no_dtw,
        batch_size=args.batch,
        max_decode_tokens=args.max_tokens,
        resume_dir=args.resume_dir,
        sequential_prompt=args.sequential_prompt,
        long_form_seek=not args.no_seek,
        mesh_shape=mesh_shape,
        draft_model_path=args.draft_model_dir,
        speculative_gamma=args.spec_gamma,
        vad_model_path=args.vad_model,
        diarize_segment_model_path=args.seg_model,
        diarize_embedding_model_path=args.emb_model,
        allow_random_weights=args.random_weights,
    )
    opts = TranscribeOptions(
        model=args.model,
        lang=args.lang,
        offset=args.offset,
        whisper_to_english=(args.task == "translate"),
        translate_target=args.translate_to,
        enable_vad=not args.no_vad and not args.diarize,
        enable_diarize=args.diarize or None,
        max_speakers=args.max_speakers,
        advanced=AdvancedTranscribe(
            sampling_strategy="greedy" if args.greedy else None,
            best_of_or_beam_size=args.beam_size,
        ),
    )
    overrides = FormattingOverrides(
        max_lines=args.max_lines, max_chars_per_line=args.max_chars_per_line
    )
    cb = None
    if not args.quiet:
        cb = Callbacks(
            progress=lambda pct, kind, label: print(
                f"\r[{kind.value}] {pct:3d}% {label}", end="", file=sys.stderr
            )
        )
    engine = Engine(cfg)
    cues = engine.transcribe_audio(args.audio, opts, overrides, cb)
    if engine.mesh is not None and engine.mesh.rank != 0:
        return 0  # every rank holds the same cues; rank 0 writes them
    if not args.quiet:
        print(file=sys.stderr)
    out = _format_srt(cues) if args.srt else json.dumps(
        segments_to_json(cues), indent=2, ensure_ascii=False
    )
    if args.output == "-":
        print(out)
    else:
        with open(args.output, "w") as f:
            f.write(out)
    return 0


def cmd_models(args) -> int:
    from . import delete_cached_model, list_cached_models

    if args.action == "list":
        for m in list_cached_models(args.cache_dir):
            print(m)
        return 0
    ok = delete_cached_model(args.cache_dir, args.model)
    print(f"deleted: {ok}")
    return 0 if ok else 1


def cmd_translate(args) -> int:
    from .translate import translate_text

    print(translate_text(args.text, args.src, args.dst))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="whisper_diarize_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_transcribe(sub)

    pm = sub.add_parser("models", help="manage the model cache")
    pm.add_argument("action", choices=["list", "delete"])
    pm.add_argument("model", nargs="?")
    pm.add_argument("--cache-dir", default="./cache")

    pt = sub.add_parser("translate", help="translate text (network required)")
    pt.add_argument("text")
    pt.add_argument("src")
    pt.add_argument("dst")

    args = parser.parse_args(argv)
    if args.command == "transcribe":
        return cmd_transcribe(args)
    if args.command == "models":
        return cmd_models(args)
    if args.command == "translate":
        return cmd_translate(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
