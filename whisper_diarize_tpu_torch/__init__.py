"""whisper_diarize_tpu_torch — the PyTorch/CUDA port of whisper_diarize_tpu.

Runs on one NVIDIA Hopper card (hand-written CUDA kernels for the decoder's
cross attention over a bf16 or an int8 cache, cross K/V build, layer tail
with bf16 or int8 weights and beam-step self-attention, `csrc/`) or, with
`EngineConfig(use_gpu=False)`, on the CPU through the kernels' plain PyTorch
versions. The JAX package `whisper_diarize_tpu` stays the reference; the
port imports nothing of it and keeps its own copies of the host modules
(types, tokenizer, formatting, audio, native, utils, subtitles, translate,
model_manager, evals), so the public surface below has the same names and
behaviour.

Ported so far: transcription by beam search (the default, beam 5) and
greedy decoding (`AdvancedTranscribe(sampling_strategy="greedy")`), with the
temperature-fallback ladder, DTW word timestamps, the VAD and whole-file
branches, cue formatting, the int8 decode path
(`EngineConfig(quantize_kv_cache=True)`, `DecodeConfig(quantize_cross_kv=...,
quantize_tail_weights=...)`), and speaker diarization
(`TranscribeOptions(enable_diarize=True)`: the pyannote segmentation net,
CAM++ embeddings on the kaldi fbank, the reference's ONNX weight files
converted on first use, a `speaker_id` on every segment). Device meshes,
speculative decoding and GGML / OpenAI `.pt` checkpoints raise
NotImplementedError (see ROADMAP.md).
"""

from __future__ import annotations

from .types import (
    AdvancedTranscribe,
    Callbacks,
    DiarizeOptions,
    ProgressType,
    Segment,
    SpeechSegment,
    TranscribeOptions,
    WordTimestamp,
    segments_to_json,
)
from .formatting import (
    FormattingOverrides,
    PostProcessConfig,
    ScriptProfile,
    VadMaskOracle,
    NoSilence,
    SilenceOracle,
    apply_overrides,
    process_segments,
)
from .utils import (
    calculate_dtw_mem_size,
    cs_to_s,
    get_translate_languages,
    get_whisper_languages,
    round_to_places,
)
from .audio import read_wav, write_wav

__version__ = "0.1.0"

_LAZY = {
    "Engine": ("whisper_diarize_tpu_torch.engine", "Engine"),
    "EngineConfig": ("whisper_diarize_tpu_torch.engine", "EngineConfig"),
    "ModelManager": ("whisper_diarize_tpu_torch.model_manager", "ModelManager"),
    "get_segments": ("whisper_diarize_tpu_torch.vad", "get_segments"),
    "translate_text": ("whisper_diarize_tpu_torch.translate", "translate_text"),
    "translate_segments": ("whisper_diarize_tpu_torch.translate", "translate_segments"),
    "to_srt": ("whisper_diarize_tpu_torch.subtitles", "to_srt"),
    "to_vtt": ("whisper_diarize_tpu_torch.subtitles", "to_vtt"),
    "to_txt": ("whisper_diarize_tpu_torch.subtitles", "to_txt"),
    "wer": ("whisper_diarize_tpu_torch.evals", "wer"),
    "der": ("whisper_diarize_tpu_torch.evals", "der"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'whisper_diarize_tpu_torch' has no attribute {name!r}")


def list_cached_models(cache_dir) -> list:
    from .engine import Engine, EngineConfig

    return Engine(EngineConfig(cache_dir=str(cache_dir), use_gpu=False)).list_cached_models()


def delete_cached_model(cache_dir, model_name: str) -> bool:
    from .engine import Engine, EngineConfig

    return Engine(EngineConfig(cache_dir=str(cache_dir), use_gpu=False)).delete_cached_model(
        model_name)
