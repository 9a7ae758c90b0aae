"""Voice activity detection: Silero probabilities -> speech segments
(counterpart of `whisper_diarize_tpu/vad.py`).

The host policy (hysteresis state machine with whisper.cpp's defaults as the
reference configures them, padding, centisecond quantization, merging of
gaps < 200 ms, int16 slicing) is the JAX package's, copied because that
module imports the JAX network; the probabilities come from the PyTorch
Silero network (`models/silero_vad.py`) on the caller's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .audio import int16_to_float32
from .models import silero_vad
from .types import SpeechSegment
from .utils import default_device

SAMPLE_RATE = 16_000
MERGE_GAP_S = 0.200  # `vad.rs:50`
MAX_BATCH_SAMPLES = 64_000_000  # device-batch bound: ~256 MB f32 per copy


@dataclass
class VadParams:
    """whisper.cpp VAD parameter surface (`vad.rs:21-28`)."""

    threshold: float = 0.5
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 100  # reference override (`vad.rs:22`)
    speech_pad_ms: int = 30
    max_speech_duration_s: float = float("inf")


def segments_from_probs(
    probs: np.ndarray,  # [n_chunks] speech probability per 512-sample chunk
    n_samples: int,
    params: Optional[VadParams] = None,
) -> List[Tuple[float, float]]:
    """Hysteresis state machine -> [(start_s, end_s)] with centisecond
    quantization, matching whisper.cpp's segments_from_samples output shape
    consumed at `vad.rs:31-43`."""
    p = params or VadParams()
    neg_threshold = max(0.01, p.threshold - 0.15)
    window = silero_vad.CHUNK
    min_speech = int(p.min_speech_duration_ms * SAMPLE_RATE / 1000)
    min_silence = int(p.min_silence_duration_ms * SAMPLE_RATE / 1000)
    pad = int(p.speech_pad_ms * SAMPLE_RATE / 1000)
    max_speech = (
        float("inf")
        if np.isinf(p.max_speech_duration_s)
        else int(p.max_speech_duration_s * SAMPLE_RATE)
    )

    segs: List[List[int]] = []
    triggered = False
    start = 0
    temp_end = 0
    for i, prob in enumerate(np.asarray(probs, np.float64)):
        pos = i * window
        if prob >= p.threshold and temp_end:
            temp_end = 0
        if prob >= p.threshold and not triggered:
            triggered = True
            start = pos
            continue
        if triggered and (pos - start) > max_speech:
            segs.append([start, pos])
            triggered = False
            temp_end = 0
            continue
        if prob < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end < min_silence:
                continue
            end = temp_end
            if end - start > min_speech:
                segs.append([start, end])
            triggered = False
            temp_end = 0
    if triggered and n_samples - start > min_speech:
        segs.append([start, n_samples])

    # pad segments, clamping into the gap midpoint when neighbors collide
    out: List[Tuple[float, float]] = []
    for k, (s, e) in enumerate(segs):
        s = max(0, s - pad)
        e = min(n_samples, e + pad)
        if k > 0:
            prev_e = segs[k - 1][1]
            if s < prev_e + pad:
                mid = (prev_e + segs[k][0]) // 2
                s = max(s, mid)
                if out:
                    ps, pe = out[-1]
                    out[-1] = (ps, min(pe, mid / SAMPLE_RATE))
        out.append((s / SAMPLE_RATE, e / SAMPLE_RATE))
    # centisecond quantization (whisper.cpp reports centiseconds)
    return [
        (round(s * 100.0) / 100.0, round(e * 100.0) / 100.0)
        for s, e in out
        if e > s
    ]


def merge_close_segments(mask: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge ranges separated by < 200 ms, extending the last range's end and
    including the bridged silence (`vad.rs:49-63`)."""
    merged: List[List[float]] = []
    for st, en in mask:
        if merged and (st - merged[-1][1]) < MERGE_GAP_S:
            merged[-1][1] = max(en, merged[-1][1])
        else:
            merged.append([st, en])
    return [(s, e) for s, e in merged]


def slice_segments(
    ranges: List[Tuple[float, float]], int_samples: np.ndarray
) -> List[SpeechSegment]:
    """Slice int16 samples per merged range, clamped at 16 kHz, dropping
    empty/inverted ranges (`vad.rs:66-81`)."""
    n = len(int_samples)
    out: List[SpeechSegment] = []
    for start_sec, end_sec in ranges:
        start_idx = int(np.clip(round(start_sec * SAMPLE_RATE), 0, n))
        end_idx = int(np.clip(round(end_sec * SAMPLE_RATE), 0, n))
        samples = int_samples[start_idx:end_idx] if end_idx > start_idx else np.empty(0, np.int16)
        if end_sec > start_sec and samples.size:
            out.append(SpeechSegment(start=start_sec, end=end_sec, samples=samples))
    return out


def load_vad_params(vad_model: Any, device=None, allow_random: bool = False):
    """Silero weights from a params dict, a path (.npz, or the reference's
    `ggml-silero-v5.1.2.bin`, converted and cached on first use), the
    "__random__" sentinel or None (random weights), on `device`: CUDA
    device 0 unless given one (raises without a card); a params dict is
    returned as it is."""
    if not isinstance(vad_model, (str, type(None))):
        return vad_model
    device = default_device(device, "load_vad_params")
    if vad_model is None:
        return silero_vad.init_params(device=device)
    from .models import convert as convert_mod

    tree = convert_mod._load_with(
        vad_model, "silero-vad", silero_vad.init_params_np,
        silero_vad.load_params_np, {"ggml": convert_mod.silero_npz_from_ggml},
        allow_random)
    return silero_vad.params_from_jax(tree, device)


def get_segments(
    vad_model: Any,
    int_samples: np.ndarray,
    params: Optional[VadParams] = None,
    device=None,
) -> Tuple[List[Tuple[float, float]], List[SpeechSegment]]:
    """Full VAD pass: i16 mono 16 kHz samples -> (raw_mask, merged_segments).
    `device` defaults to CUDA device 0; pass "cpu" for the CPU."""
    return get_segments_batch(vad_model, [int_samples], params, device)[0]


def get_segments_batch(
    vad_model: Any,
    streams: List[np.ndarray],
    params: Optional[VadParams] = None,
    device=None,
) -> List[Tuple[List[Tuple[float, float]], List[SpeechSegment]]]:
    """Multi-stream VAD: streams run through Silero as length-sorted
    [S, T] batches of at most MAX_BATCH_SAMPLES padded samples; rows are
    independent, so each stream's result equals `get_segments`. `device`
    defaults to CUDA device 0; pass "cpu" for the CPU."""
    device = default_device(device, "VAD")
    model_params = load_vad_params(vad_model, device)
    arrays = [np.asarray(x) for x in streams]
    lengths = [len(x) for x in arrays]
    if not lengths or max(lengths) == 0:
        return [([], []) for _ in arrays]
    order = sorted((i for i in range(len(arrays)) if lengths[i]),
                   key=lambda i: -lengths[i])
    probs_by_stream: dict = {}
    g0 = 0
    while g0 < len(order):
        group_max = lengths[order[g0]]
        g1 = g0 + 1
        while g1 < len(order) and (g1 - g0 + 1) * group_max <= MAX_BATCH_SAMPLES:
            g1 += 1
        group = order[g0:g1]
        batch = np.zeros((len(group), group_max), np.float32)
        for r, i in enumerate(group):
            batch[r, : lengths[i]] = int16_to_float32(arrays[i])
        with torch.inference_mode():
            probs = silero_vad.speech_probs(
                model_params, torch.from_numpy(batch).to(device)).cpu().numpy()
        for r, i in enumerate(group):
            probs_by_stream[i] = probs[r]
        g0 = g1

    out = []
    for i, x in enumerate(arrays):
        n_chunks = -(-lengths[i] // silero_vad.CHUNK)
        p_i = probs_by_stream.get(i)
        mask = (segments_from_probs(p_i[:n_chunks], lengths[i], params)
                if p_i is not None else [])
        mask = sorted([r for r in mask if r[1] > r[0]], key=lambda r: r[0])
        out.append((mask, slice_segments(merge_close_segments(mask), x)))
    return out
