"""Utility helpers and language tables.

The PyTorch port's own copy of `whisper_diarize_tpu/utils/__init__.py`;
the port imports nothing of the JAX package.

Mirrors the reference's `src/utils.rs`: `calculate_dtw_mem_size`
(`utils.rs:3-49`), `round_to_places` (`utils.rs:51-54`), `cs_to_s`
(`utils.rs:57-59`), `get_translate_languages` (`utils.rs:62-72`) and
`get_whisper_languages` (`utils.rs:75-87`). `default_device` is the port's
rule for public entry points that take a device; `exact_f32` holds f32
products in f32 on the card whatever the process-wide TF32 flags say.
"""

from __future__ import annotations

import contextlib
from typing import List

__all__ = [
    "calculate_dtw_mem_size",
    "round_to_places",
    "cs_to_s",
    "get_translate_languages",
    "get_whisper_languages",
    "default_device",
    "exact_f32",
]


def default_device(device, what: str):
    """The caller's device, or CUDA device 0 when none is given (an entry
    point runs on the card unless asked for the CPU); raises without one."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on CUDA device 0 by default and none is "
                           "available; pass device=\"cpu\" for the CPU")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls (cuBLAS) and convolutions (cuDNN) inside the block run in
    f32, never TF32, whatever the process-wide flags say (PyTorch lets cuDNN
    take TF32 by default); the flags are restored on exit. The diarization
    nets and the kaldi fbank keep the JAX package's f32 semantics with it."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def calculate_dtw_mem_size(num_samples: int) -> int:
    """Estimate a DTW working-set size in bytes for banded DTW alignment.

    Behavior matches `src/utils.rs:3-49`: 160-sample (10 ms) frames, band
    of 96/128/160 frames by audio length (<=150 s / <=450 s / >450 s),
    4 float32 lanes plus an int32 backtrack budget, 24 MB baseline,
    clamped to [24 MB, 768 MB] and aligned up to 8 MB.
    """
    FRAME_SAMPLES = 160
    num_frames = (num_samples + FRAME_SAMPLES - 1) // FRAME_SAMPLES

    BYTES_F32 = 4
    BYTES_I32 = 4
    LANES = 4

    if num_frames <= 15_000:
        band_frames = 96
    elif num_frames <= 45_000:
        band_frames = 128
    else:
        band_frames = 160

    dp_bytes = num_frames * band_frames * LANES * BYTES_F32
    bt_bytes = num_frames * BYTES_I32

    base_bytes = 24 * 1024 * 1024
    total = base_bytes + dp_bytes + bt_bytes

    min_bytes = 24 * 1024 * 1024
    max_bytes = 768 * 1024 * 1024
    clamped = min(max(total, min_bytes), max_bytes)

    ALIGN = 8 * 1024 * 1024
    return (clamped + ALIGN - 1) & ~(ALIGN - 1)


def round_to_places(value: float, places: int) -> float:
    """Round half-away-from-zero like Rust's f64::round (`utils.rs:51-54`).

    Python's built-in round() is banker's rounding, so do it manually.
    """
    factor = 10.0 ** places
    x = value * factor
    import math

    return math.floor(x + 0.5) / factor if x >= 0 else math.ceil(x - 0.5) / factor


def cs_to_s(cs: int) -> float:
    """Centiseconds -> seconds (`utils.rs:57-59`)."""
    return cs * 0.01


def get_translate_languages() -> List[str]:
    """Target codes for the Google Translate post-pass (`utils.rs:62-72`)."""
    return [
        "af", "sq", "am", "ar", "hy", "az", "eu", "be", "bn", "bs", "bg", "ca",
        "ceb", "ny", "zh", "zh-TW", "co", "hr", "cs", "da", "nl", "en", "eo",
        "et", "tl", "fi", "fr", "fy", "gl", "ka", "de", "el", "gu", "ht", "ha",
        "haw", "he", "hi", "hmn", "hu", "is", "ig", "id", "ga", "it", "ja",
        "jv", "kn", "kk", "km", "rw", "ko", "ku", "ky", "lo", "la", "lv", "lt",
        "lb", "mk", "mg", "ms", "ml", "mt", "mi", "mr", "mn", "my", "ne", "no",
        "or", "ps", "fa", "pl", "pt", "pa", "ro", "ru", "sm", "gd", "sr", "st",
        "sn", "sd", "si", "sk", "sl", "so", "es", "su", "sw", "sv", "tg", "ta",
        "te", "th", "tr", "uk", "ur", "ug", "uz", "vi", "cy", "xh", "yi", "yo",
        "zu",
    ]


def get_whisper_languages() -> List[str]:
    """Whisper language codes including "auto" (`utils.rs:75-87`)."""
    return [
        "auto",
        "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
        "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
        "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
        "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
        "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
        "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
        "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
        "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
        "ba", "jw", "su", "yue",
    ]
