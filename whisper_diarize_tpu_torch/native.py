"""ctypes bindings to the native runtime (native/libwdt_native.so).

The PyTorch port's own copy of `whisper_diarize_tpu/native.py`;
the port imports nothing of the JAX package.

Native counterparts of the reference's non-Rust components (SURVEY.md §2.4):
the hound WAV loader and whisper.cpp's host-side DTW. Everything here is a
*fast path* — every function has a pure-Python/numpy fallback so the package
works unbuilt; `is_available()` reports which path is active.

Build with `make -C native` (g++, no external deps); the library is looked
up next to the package and in `$WDT_NATIVE_PATH`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_WAV_ERRORS = {
    -1: "failed to read file",
    -2: "failed to read file: not a RIFF/WAVE file",
    -3: "expected mono audio file",
    -4: "expected integer sample format",
    -5: "expected 16KHz sample rate",
    -6: "expected 16 bits per sample",
    -7: "failed to read file: no data chunk",
}


def _candidates():
    here = Path(__file__).resolve().parent
    yield here.parent / "native" / "libwdt_native.so"
    yield here / "libwdt_native.so"
    env = os.environ.get("WDT_NATIVE_PATH")
    if env:
        yield Path(env)


def _try_build() -> None:
    """Best-effort build when g++ is present and the source tree is local."""
    src_dir = Path(__file__).resolve().parent.parent / "native"
    if not (src_dir / "wdt_native.cpp").exists():
        return
    try:
        subprocess.run(
            ["make", "-C", str(src_dir)],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        pass


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    for path in list(_candidates()):
        if path.exists():
            break
    else:
        _try_build()
    for path in _candidates():
        if path.exists():
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                continue
            lib.wav_info.restype = ctypes.c_int
            lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.wav_read.restype = ctypes.c_int
            lib.wav_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
            lib.wav_write.restype = ctypes.c_int
            lib.wav_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
            lib.pcm_i16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.pcm_f32_to_i16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.dtw_full.restype = ctypes.c_int64
            lib.dtw_full.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.dtw_banded.restype = ctypes.c_int64
            lib.dtw_banded.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.dtw_band_for_frames.restype = ctypes.c_int32
            lib.dtw_band_for_frames.argtypes = [ctypes.c_int64]
            _LIB = lib
            break
    return _LIB


def is_available() -> bool:
    return load() is not None


def read_wav(path: str) -> Optional[np.ndarray]:
    """Native strict WAV read; None when the library is unavailable.
    Raises the same validation errors as `audio.read_wav`."""
    lib = load()
    if lib is None:
        return None
    from .audio import AudioFormatError

    n = ctypes.c_int64(0)
    rc = lib.wav_info(path.encode(), ctypes.byref(n))
    if rc != 0:
        raise AudioFormatError(_WAV_ERRORS.get(rc, f"wav error {rc}"))
    out = np.empty(n.value, np.int16)
    rc = lib.wav_read(path.encode(), out.ctypes.data, n.value)
    if rc != 0:
        raise AudioFormatError(_WAV_ERRORS.get(rc, f"wav error {rc}"))
    return out


def write_wav(path: str, samples: np.ndarray) -> bool:
    lib = load()
    if lib is None:
        return False
    samples = np.ascontiguousarray(samples, np.int16)
    rc = lib.wav_write(path.encode(), samples.ctypes.data, samples.size)
    return rc == 0


def pcm_i16_to_f32(samples: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.int16)
    out = np.empty(samples.size, np.float32)
    lib.pcm_i16_to_f32(samples.ctypes.data, out.ctypes.data, samples.size)
    return out


def dtw_path(x: np.ndarray, band: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native host DTW (banded when band != 0, or the reference band when
    band < 0); None when unavailable."""
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n, m = x.shape
    ti = np.empty(n + m, np.int32)
    tj = np.empty(n + m, np.int32)
    if band == 0:
        length = lib.dtw_full(x.ctypes.data, n, m, ti.ctypes.data, tj.ctypes.data)
    else:
        length = lib.dtw_banded(
            x.ctypes.data, n, m, max(band, -1) if band > 0 else 0,
            ti.ctypes.data, tj.ctypes.data,
        )
    if length < 0:
        return None
    return ti[:length].astype(np.int64), tj[:length].astype(np.int64)
