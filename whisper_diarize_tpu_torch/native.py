"""ctypes bindings to the native runtime (`native/wdt_native.cpp`).

The PyTorch port's own copy of `whisper_diarize_tpu/native.py`;
the port imports nothing of the JAX package.

Native counterparts of the reference's non-Rust components (SURVEY.md §2.4):
the hound WAV loader and whisper.cpp's host-side DTW. Everything here is a
*fast path* — every function has a pure-Python/numpy fallback so the package
works unbuilt; `is_available()` reports which path is active.

The port builds its own copy of the library from `native/wdt_native.cpp`
with `g++` (no external deps) on first use, into
`<checkout>/build/whisper_diarize_tpu_torch/native/` (or the directory in
`$WDT_TORCH_NATIVE_DIR`), named by a hash of the source. It never writes
`native/libwdt_native.so`, the JAX package's build. Processes that load at
once share one build: the compile runs under an exclusive `flock` of the
directory's lock file, into a temporary name that `os.replace` moves into
place, so no process ever loads a half-written file. `$WDT_NATIVE_PATH`
names a prebuilt library to load instead.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "wdt_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "whisper_diarize_tpu_torch" / "native"

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


def build_dir() -> Path:
    env = os.environ.get("WDT_TORCH_NATIVE_DIR")
    return Path(env) if env else _BUILD_DIR


def build() -> Optional[Path]:
    """The port's build of the native library, compiled on first call (see
    the module docstring); None where the source or `g++` is missing or the
    compile fails."""
    if not _SOURCE.exists():
        return None
    src = _SOURCE.read_bytes()
    out_dir = build_dir()
    so = out_dir / f"libwdt_native-{hashlib.sha1(src).hexdigest()[:16]}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while this one waited
            return so
        tmp = out_dir / f".{so.name}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17", "-Wall",
               "-shared", str(_SOURCE), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    return so


def _candidates():
    env = os.environ.get("WDT_NATIVE_PATH")
    if env:
        yield Path(env)
    built = build()
    if built is not None:
        yield built


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
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
