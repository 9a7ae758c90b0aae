"""GGML checkpoint files, `ggml-{model}.bin` (counterpart of
`whisper_diarize_tpu/models/ggml.py`): the reference crate's own model
format, whisper.cpp's. A user migrating from the reference holds such files;
`load_ggml` reads one into the port's params (weights, hparams, and the
embedded vocabulary, enough for a decode-capable `tokenizer.VocabTokenizer`
without any HF files), onto CUDA device 0 unless given a device.

File layout (whisper.cpp `models/convert-pt-to-ggml.py`):

  int32 magic 0x67676d6c ("ggml")
  int32 x11 hparams: n_vocab, n_audio_ctx, n_audio_state, n_audio_head,
        n_audio_layer, n_text_ctx, n_text_state, n_text_head, n_text_layer,
        n_mels, ftype (1 = f16 weights)
  int32 n_mel, int32 n_fft, f32[n_mel*n_fft] mel filters
  int32 n_tokens, then per token: int32 byte_len, raw bytes
  tensors until EOF: int32 n_dims, int32 name_len, int32 ttype
        int32[n_dims] ne (REVERSED numpy shape), name bytes,
        payload (dtype per the ggml_type enum `ttype`), no padding

Tensor names are the OpenAI checkpoint names (`encoder.blocks.0.attn...`),
so conversion reuses `weights.convert_openai_params`. GGML stores conv
biases as [n, 1]; the converter flattens them back.

Quantized files (`ggml-{model}-q5_0.bin` and the like, from whisper.cpp's
quantize tool): all five block formats dequantize here (32-element blocks,
fp16 scale [+ fp16 min for the `_1` types, + 4 high-bit bytes for the `q5`
types]). They carry `GGML_QNT_VERSION * 1000 + ftype` in the header's
ftype slot, which `read_ggml` splits back out as hparams["qnt_version"].
`write_ggml(quantize=...)` mirrors the quantize tool (2-D tensors except
the positional embeddings / [n,1] conv biases) to build such files. The
arithmetic is numpy, the JAX package's own.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List, Tuple

import numpy as np
import torch

from ..utils import default_device
from . import weights as weights_mod
from . import whisper as wm

GGML_MAGIC = 0x67676D6C
GGML_QNT_VERSION = 2  # whisper.cpp quantize stamps qntvr*1000 into ftype
_QK = 32  # ggml quantization block length (all the types below)

# ggml_type enum values as stored per tensor (ggml.h)
GGML_TYPE_F32, GGML_TYPE_F16 = 0, 1
GGML_TYPE_Q4_0, GGML_TYPE_Q4_1 = 2, 3
GGML_TYPE_Q5_0, GGML_TYPE_Q5_1, GGML_TYPE_Q8_0 = 6, 7, 8

# model-level ggml_ftype enum (header field) per quantized type
_FTYPE_OF_QTYPE = {
    GGML_TYPE_Q4_0: 2, GGML_TYPE_Q4_1: 3,
    GGML_TYPE_Q8_0: 7, GGML_TYPE_Q5_0: 8, GGML_TYPE_Q5_1: 9,
}
_QTYPE_BY_NAME = {
    "q4_0": GGML_TYPE_Q4_0, "q4_1": GGML_TYPE_Q4_1,
    "q5_0": GGML_TYPE_Q5_0, "q5_1": GGML_TYPE_Q5_1,
    "q8_0": GGML_TYPE_Q8_0,
}


class GGMLFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Block (de)quantization — faithful to ggml-quants.c (`quantize_row_*_ref` /
# `dequantize_row_*`): 32-element blocks, fp16 scale d (plus fp16 min m for
# q4_1/q5_1, plus a uint32 of 5th bits for q5_0/q5_1). The low nibbles of
# byte j hold element j, the high nibbles element j+16.
# ---------------------------------------------------------------------------


def _fp16_col(blocks: np.ndarray, off: int) -> np.ndarray:
    """fp16 scalar at byte offset `off` of every block -> f32 [nb, 1]."""
    return (
        blocks[:, off:off + 2].copy().view("<f2").astype(np.float32)
    )


def _u32_col(blocks: np.ndarray, off: int) -> np.ndarray:
    """uint32 at byte offset `off` of every block -> [nb, 1]."""
    return blocks[:, off:off + 4].copy().view("<u4").astype(np.uint32)


def _dequant_q4_0(blocks: np.ndarray) -> np.ndarray:
    d = _fp16_col(blocks, 0)
    qs = blocks[:, 2:18]
    lo = (qs & 0x0F).astype(np.float32) - 8.0
    hi = (qs >> 4).astype(np.float32) - 8.0
    return np.concatenate([lo, hi], axis=1) * d


def _dequant_q4_1(blocks: np.ndarray) -> np.ndarray:
    d, m = _fp16_col(blocks, 0), _fp16_col(blocks, 2)
    qs = blocks[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return np.concatenate([lo, hi], axis=1) * d + m


def _q5_bits(blocks: np.ndarray, qh_off: int, qs_off: int):
    """Shared q5 payload decode -> (lo5, hi5) int arrays [nb, 16]."""
    qh = _u32_col(blocks, qh_off)  # [nb, 1]
    qs = blocks[:, qs_off:qs_off + 16]
    j = np.arange(16, dtype=np.uint32)[None, :]
    xh0 = ((qh >> j) << 4) & 0x10  # bit j -> 5th bit of element j
    xh1 = (qh >> (j + 12)) & 0x10  # bit j+16 -> 5th bit of element j+16
    lo = (qs & 0x0F).astype(np.uint32) | xh0
    hi = (qs >> 4).astype(np.uint32) | xh1
    return lo, hi


def _dequant_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _fp16_col(blocks, 0)
    lo, hi = _q5_bits(blocks, 2, 6)
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0
    return vals * d


def _dequant_q5_1(blocks: np.ndarray) -> np.ndarray:
    d, m = _fp16_col(blocks, 0), _fp16_col(blocks, 2)
    lo, hi = _q5_bits(blocks, 4, 8)
    return np.concatenate([lo, hi], axis=1).astype(np.float32) * d + m


def _dequant_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _fp16_col(blocks, 0)
    qs = blocks[:, 2:34].copy().view(np.int8).astype(np.float32)
    return qs * d


# ttype -> (bytes per 32-element block, dequantizer)
_QUANT_TYPES = {
    GGML_TYPE_Q4_0: (18, _dequant_q4_0),
    GGML_TYPE_Q4_1: (20, _dequant_q4_1),
    GGML_TYPE_Q5_0: (22, _dequant_q5_0),
    GGML_TYPE_Q5_1: (24, _dequant_q5_1),
    GGML_TYPE_Q8_0: (34, _dequant_q8_0),
}


def _signed_absmax(x: np.ndarray) -> np.ndarray:
    """Per-block value with the largest magnitude, KEEPING ITS SIGN
    (ggml's `max` in quantize_row_q4_0/q5_0) -> [nb, 1]."""
    idx = np.argmax(np.abs(x), axis=1)
    return x[np.arange(x.shape[0]), idx][:, None]


def _store_f16(d: np.ndarray) -> np.ndarray:
    """f32 [nb, 1] -> raw fp16 bytes [nb, 2]."""
    return d.astype("<f2").view(np.uint8).reshape(-1, 2)


def _inv(d: np.ndarray) -> np.ndarray:
    return np.where(d != 0.0, np.divide(
        1.0, d, out=np.ones_like(d), where=d != 0.0), 0.0)


def _nibble_pack(q: np.ndarray) -> np.ndarray:
    """[nb, 32] uint8 (values < 32; bit 4 dropped) -> [nb, 16] packed."""
    return ((q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)).astype(np.uint8)


def _q5_high_bits(q: np.ndarray) -> np.ndarray:
    """[nb, 32] 5-bit values -> uint32 high-bit word as raw bytes [nb, 4]."""
    bit = ((q >> 4) & 1).astype(np.uint32)
    j = np.arange(32, dtype=np.uint32)[None, :]
    qh = np.bitwise_or.reduce(bit << j, axis=1).astype("<u4")
    return qh.view(np.uint8).reshape(-1, 4)


def _quant_q4_0(x: np.ndarray) -> np.ndarray:
    mx = _signed_absmax(x)
    d = mx / -8.0
    q = np.clip(np.floor(x * _inv(d) + 8.5), 0, 15).astype(np.uint8)
    return np.concatenate([_store_f16(d), _nibble_pack(q)], axis=1)


def _quant_q4_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1, keepdims=True)
    d = (x.max(axis=1, keepdims=True) - mn) / 15.0
    q = np.clip(np.floor((x - mn) * _inv(d) + 0.5), 0, 15).astype(np.uint8)
    return np.concatenate(
        [_store_f16(d), _store_f16(mn), _nibble_pack(q)], axis=1)


def _quant_q5_0(x: np.ndarray) -> np.ndarray:
    mx = _signed_absmax(x)
    d = mx / -16.0
    q = np.clip(np.floor(x * _inv(d) + 16.5), 0, 31).astype(np.uint8)
    return np.concatenate(
        [_store_f16(d), _q5_high_bits(q), _nibble_pack(q)], axis=1)


def _quant_q5_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1, keepdims=True)
    d = (x.max(axis=1, keepdims=True) - mn) / 31.0
    q = np.clip(np.floor((x - mn) * _inv(d) + 0.5), 0, 31).astype(np.uint8)
    return np.concatenate(
        [_store_f16(d), _store_f16(mn), _q5_high_bits(q), _nibble_pack(q)],
        axis=1)


def _quant_q8_0(x: np.ndarray) -> np.ndarray:
    d = np.abs(x).max(axis=1, keepdims=True) / 127.0
    xi = x * _inv(d)
    # roundf: half away from zero (np.round would be half-to-even)
    q = np.trunc(xi + np.copysign(0.5, xi)).astype(np.int8)
    return np.concatenate([_store_f16(d), q.view(np.uint8)], axis=1)


_QUANTIZERS = {
    GGML_TYPE_Q4_0: _quant_q4_0, GGML_TYPE_Q4_1: _quant_q4_1,
    GGML_TYPE_Q5_0: _quant_q5_0, GGML_TYPE_Q5_1: _quant_q5_1,
    GGML_TYPE_Q8_0: _quant_q8_0,
}


def quantize_blocks(x: np.ndarray, qtype: int) -> np.ndarray:
    """Quantize a flat f32 array (len % 32 == 0) -> raw block bytes."""
    flat = np.ascontiguousarray(x, np.float32).reshape(-1, _QK)
    return _QUANTIZERS[qtype](flat)


def dequantize_blocks(raw: np.ndarray, qtype: int, count: int) -> np.ndarray:
    """Raw block bytes -> flat f32 array of `count` elements."""
    bs, fn = _QUANT_TYPES[qtype]
    return fn(raw.reshape(-1, bs)).reshape(-1)[:count].astype(np.float32)


def _read_i32(f: BinaryIO, n: int = 1):
    data = f.read(4 * n)
    if len(data) < 4 * n:
        raise GGMLFormatError("truncated ggml file")
    vals = struct.unpack(f"<{n}i", data)
    return vals[0] if n == 1 else vals


def read_ggml(path) -> Tuple[Dict[str, np.ndarray], Dict[str, int],
                             np.ndarray, List[bytes]]:
    """Parse a ggml whisper file.

    Returns (tensors by OpenAI name, hparams dict, mel filters [n_mel,
    n_fft//2+1], vocab byte strings by id)."""
    with open(path, "rb") as f:
        magic = _read_i32(f)
        if magic != GGML_MAGIC:
            raise GGMLFormatError(
                f"not a ggml file (magic 0x{magic & 0xFFFFFFFF:08x})"
            )
        names = ("n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
                 "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head",
                 "n_text_layer", "n_mels", "ftype")
        hparams = dict(zip(names, _read_i32(f, len(names))))
        # quantized files stamp qnt_version*1000 + ftype (whisper.cpp
        # examples/quantize); split it back out
        hparams["qnt_version"] = hparams["ftype"] // 1000
        hparams["ftype"] = hparams["ftype"] % 1000

        n_mel, n_fft = _read_i32(f, 2)
        filters = np.frombuffer(
            f.read(4 * n_mel * n_fft), dtype="<f4"
        ).reshape(n_mel, n_fft).copy()

        n_tokens = _read_i32(f)
        vocab: List[bytes] = []
        for _ in range(n_tokens):
            ln = _read_i32(f)
            vocab.append(f.read(ln))

        tensors: Dict[str, np.ndarray] = {}
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            n_dims, name_len, ttype = struct.unpack("<3i", head)
            if not (0 < n_dims <= 4) or not (0 < name_len < 512):
                raise GGMLFormatError("corrupt tensor header")
            ne = _read_i32(f, n_dims)
            ne = (ne,) if n_dims == 1 else ne
            name = f.read(name_len).decode("utf-8")
            shape = tuple(reversed(ne))  # ggml ne order -> numpy shape
            count = int(np.prod(shape))
            if ttype == GGML_TYPE_F16:
                raw = np.frombuffer(f.read(2 * count), dtype="<f2")
                if raw.size != count:
                    raise GGMLFormatError(f"truncated tensor {name}")
            elif ttype == GGML_TYPE_F32:
                raw = np.frombuffer(f.read(4 * count), dtype="<f4")
                if raw.size != count:
                    raise GGMLFormatError(f"truncated tensor {name}")
            elif ttype in _QUANT_TYPES:
                # quantized along ne[0]; whisper.cpp only quantizes tensors
                # with ne[0] % 32 == 0, so flat block order == row-major
                if count % _QK != 0:
                    raise GGMLFormatError(
                        f"quantized tensor {name} has {count} elements "
                        f"(not a multiple of the block length {_QK})")
                bs, _fn = _QUANT_TYPES[ttype]
                payload = np.frombuffer(
                    f.read(count // _QK * bs), dtype=np.uint8)
                if payload.size != count // _QK * bs:
                    raise GGMLFormatError(f"truncated tensor {name}")
                raw = dequantize_blocks(payload, ttype, count)
            else:
                raise GGMLFormatError(
                    f"unsupported ggml tensor type {ttype} for {name} "
                    "(supported: f32, f16, q4_0, q4_1, q5_0, q5_1, q8_0)")
            tensors[name] = raw.reshape(shape).astype(np.float32)
    return tensors, hparams, filters, vocab


def load_ggml(path, device=None, dtype=torch.float32) -> Tuple[
    Dict[str, Any], wm.WhisperConfig, List[bytes]
]:
    """GGML file -> (the port's params on `device`, config, vocab byte
    table); CUDA device 0 unless given a device (raises without a card)."""
    device = default_device(device, "load_ggml")
    tensors, hparams, _filters, vocab = read_ggml(path)
    cfg = weights_mod._dims_to_config(hparams)
    tree = weights_mod.convert_openai_params(tensors, cfg)
    return weights_mod.params_from_jax(tree, device, dtype), cfg, vocab


# the quantize tool's skip list (whisper.cpp examples/quantize/quantize.cpp
# `to_skip`): [n,1] conv biases and the positional embeddings stay fp
_QUANT_SKIP = (
    "encoder.conv1.bias", "encoder.conv2.bias",
    "encoder.positional_embedding", "decoder.positional_embedding",
)


def write_ggml(path, tensors: Dict[str, np.ndarray], hparams: Dict[str, int],
               filters: np.ndarray, vocab: List[bytes],
               use_f16: bool = True, quantize: str | None = None) -> None:
    """Write a ggml whisper file (round-trip tests + re-export).

    `quantize` ("q4_0"/"q4_1"/"q5_0"/"q5_1"/"q8_0") mirrors whisper.cpp's
    quantize tool: 2-D tensors except `_QUANT_SKIP` become quantized blocks
    and the header ftype carries GGML_QNT_VERSION*1000 + the model ftype."""
    qtype = None
    if quantize is not None:
        if quantize not in _QTYPE_BY_NAME:
            raise ValueError(
                f"unknown quantize type {quantize!r} "
                f"(one of {sorted(_QTYPE_BY_NAME)})")
        qtype = _QTYPE_BY_NAME[quantize]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", GGML_MAGIC))
        for k in ("n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
                  "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head",
                  "n_text_layer", "n_mels"):
            f.write(struct.pack("<i", int(hparams[k])))
        if qtype is not None:
            header_ftype = GGML_QNT_VERSION * 1000 + _FTYPE_OF_QTYPE[qtype]
        else:
            header_ftype = 1 if use_f16 else 0
        f.write(struct.pack("<i", header_ftype))
        filters = np.asarray(filters, "<f4")
        f.write(struct.pack("<ii", filters.shape[0], filters.shape[1]))
        f.write(filters.tobytes())
        f.write(struct.pack("<i", len(vocab)))
        for tok in vocab:
            f.write(struct.pack("<i", len(tok)))
            f.write(tok)
        for name, data in tensors.items():
            data = np.asarray(data, np.float32)
            # mirror the upstream convert script: conv biases become [n, 1]
            if name in ("encoder.conv1.bias", "encoder.conv2.bias"):
                data = data.reshape(-1, 1)
            nb = name.encode("utf-8")
            if (qtype is not None and data.ndim == 2
                    and name not in _QUANT_SKIP
                    and data.shape[-1] % _QK == 0):
                f.write(struct.pack("<3i", data.ndim, len(nb), qtype))
                for d in reversed(data.shape):
                    f.write(struct.pack("<i", d))
                f.write(nb)
                f.write(quantize_blocks(data, qtype).tobytes())
                continue
            # 1-D tensors and layernorms stay f32 upstream; f16 elsewhere
            f16 = use_f16 and data.ndim >= 2 and "ln" not in name
            f.write(struct.pack("<3i", data.ndim, len(nb), 1 if f16 else 0))
            for d in reversed(data.shape):
                f.write(struct.pack("<i", d))
            f.write(nb)
            f.write(data.astype("<f2" if f16 else "<f4").tobytes())
