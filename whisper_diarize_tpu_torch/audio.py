"""Strict WAV I/O.

The PyTorch port's own copy of `whisper_diarize_tpu/audio.py`;
the port imports nothing of the JAX package.

Mirrors the reference's audio layer (the reference crate's `src/audio.rs:4-38`):
`read_wav` rejects non-mono, non-integer, non-16 kHz, non-16-bit input;
`write_wav` always writes 16 kHz / 16-bit / mono PCM.

Implemented on the stdlib `wave` module + numpy; a C++ fast path for
decode/convert lives in `native/` and is used automatically when built
(see `native.py`).
"""

from __future__ import annotations

import wave

import numpy as np

SAMPLE_RATE = 16_000


class AudioFormatError(ValueError):
    pass


def read_wav(path: str) -> np.ndarray:
    """Read a mono 16 kHz 16-bit PCM WAV file into an int16 numpy array.

    Validation order and messages follow `src/audio.rs:10-20`. Uses the
    native C++ reader (`native/wdt_native.cpp`) when built.
    """
    from . import native

    if native.is_available():
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        out = native.read_wav(path)
        if out is not None:
            return out
    try:
        reader = wave.open(path, "rb")
    except FileNotFoundError:
        raise
    except Exception as e:  # malformed header etc.
        raise AudioFormatError(f"failed to read file: {e}") from e
    with reader:
        channels = reader.getnchannels()
        if channels != 1:
            raise AudioFormatError(
                f"expected mono audio file and found {channels} channels!"
            )
        if reader.getcomptype() != "NONE":
            raise AudioFormatError("expected integer sample format")
        if reader.getframerate() != SAMPLE_RATE:
            raise AudioFormatError("expected 16KHz sample rate")
        if reader.getsampwidth() != 2:
            raise AudioFormatError("expected 16 bits per sample")
        frames = reader.readframes(reader.getnframes())
    return np.frombuffer(frames, dtype="<i2").astype(np.int16, copy=False)


def write_wav(path: str, samples: np.ndarray) -> None:
    """Write int16 samples as mono 16 kHz 16-bit PCM (`src/audio.rs:26-38`)."""
    samples = np.asarray(samples, dtype=np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(samples.astype("<i2").tobytes())


def int16_to_float32(samples: np.ndarray) -> np.ndarray:
    """i16 PCM -> f32 in [-1, 1), matching whisper.cpp's
    `convert_integer_to_float_audio` (divide by 32768), used at
    `src/transcribe.rs:380-381` and `src/vad.rs:11-12`."""
    return np.asarray(samples, dtype=np.float32) / 32768.0


def float32_to_int16(samples: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0 - 1.0 / 32768.0)
    return (x * 32768.0).astype(np.int16)
