"""How the diarization nets on the card are held against their f32 run on
the CPU, and the planted faults that check must refuse.

No TPU kernel lies in the kaldi fbank, the segmentation net or CAM++: they
are plain PyTorch on either device, in f32 (cuDNN and cuBLAS without TF32,
`utils.exact_f32`), so the card's run differs from the CPU's only in the
order of f32 sums. The check, on one stream's own audio:

* fbank (int16-scale input, natural log): |card - CPU| <= FBANK_ATOL;
* segmentation log-probs: |card - CPU| <= LOGPROB_ATOL, and the per-frame
  powerset argmax equal wherever the CPU's top-2 gap exceeds
  DECISION_MARGIN (a nearer tie may flip without a fault);
* CAM++ embeddings: cosine(card, CPU) >= EMB_MIN_COS for every row.

The faults (`diarize_faults`): the fbank without pre-emphasis, the BiLSTM's
backward direction run forward in time, CAM++'s frame mask ignored (every
row taken as valid to its end). Each must fail the check.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import mel
from . import campplus, segmentation

FBANK_ATOL = 1e-3
LOGPROB_ATOL = 1e-3
DECISION_MARGIN = 1e-3
EMB_MIN_COS = 0.9999
N_SAMPLES = 480_000  # a decode window, 30 s


def stream_inputs(samples: np.ndarray, batch: int = 8) -> Tuple[torch.Tensor, torch.Tensor, list]:
    """One i16 stream -> (windows [NW, 160000]: its 10 s segmentation
    windows, the last zero-padded; audio [batch, 480000] f32 in [-1, 1]:
    a decode batch whose row j holds the stream from 10 j s on, at most
    30 (batch - j) / batch s of it, zero-padded; n_valid [batch])."""
    x = np.asarray(samples, np.float32) / 32768.0
    W = segmentation.WINDOW_SAMPLES
    nw = max(1, -(-len(x) // W))
    windows = np.zeros((nw * W,), np.float32)
    windows[:len(x)] = x
    audio = np.zeros((batch, N_SAMPLES), np.float32)
    n_valid = []
    for j in range(batch):
        span = x[j * W: j * W + N_SAMPLES * (batch - j) // batch]
        audio[j, :len(span)] = span
        n_valid.append(len(span))
    return torch.from_numpy(windows.reshape(nw, W)), torch.from_numpy(audio), n_valid


def outputs(seg_params: Dict[str, Any], emb_params: Dict[str, Any], windows: torch.Tensor,
            audio: torch.Tensor, n_valid) -> Dict[str, torch.Tensor]:
    """The three nets' outputs on the params' device: fbank of the decode
    batch [B, frames, 80], segmentation log-probs [NW, 589, 7], CAM++
    embeddings [B, 192]."""
    dev = seg_params["cls"]["w"].device
    audio = audio.to(dev)
    return {"fbank": mel.kaldi_fbank(audio * 32768.0),
            "log_probs": segmentation.forward(seg_params, windows.to(dev)),
            "embeddings": campplus.embed_from_audio(emb_params, audio, n_valid)}


def agreement(kind: str, got: torch.Tensor, ref: torch.Tensor) -> Tuple[bool, str]:
    """(ok, summary) of one output against its CPU reference."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    finite = bool(torch.isfinite(got).all())
    if kind == "embeddings":
        cos = float(F.cosine_similarity(got, ref, dim=-1).min())
        return finite and cos >= EMB_MIN_COS, f"min cosine {cos:.7f} (limit {EMB_MIN_COS})"
    err = float((got - ref).abs().max())
    if kind == "fbank":
        return finite and err <= FBANK_ATOL, f"max_abs_err {err:.3g} (tol {FBANK_ATOL})"
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > DECISION_MARGIN
    flips = int((got.argmax(-1) != ref.argmax(-1))[sure].sum())
    ok = finite and err <= LOGPROB_ATOL and flips == 0
    return ok, (f"max_abs_err {err:.3g} (tol {LOGPROB_ATOL}), argmax flips {flips} of "
                f"{int(sure.sum())} frames with a gap > {DECISION_MARGIN}")


def compare(tag: str, kind: str, got: torch.Tensor, ref: torch.Tensor) -> str:
    ok, line = agreement(kind, got, ref)
    print(f"[diarize] {tag}: {line} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{tag}: the card disagrees with the f32 CPU run ({line})")
    return line


def reject(tag: str, kind: str, got: torch.Tensor, faulty: torch.Tensor) -> str:
    ok, line = agreement(kind, faulty, got)
    print(f"[diarize] planted fault {tag}: {line} -> {'MISSED' if ok else 'caught'}",
          flush=True)
    if ok:
        raise AssertionError(f"planted fault {tag} passes the check ({line})")
    return line


@contextlib.contextmanager
def planted(module, name: str, value):
    """`module.name` replaced by `value` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def diarize_faults(seg_params, emb_params, windows: torch.Tensor, audio: torch.Tensor,
                   n_valid) -> Iterator[Tuple[str, str, torch.Tensor]]:
    """(tag, kind, faulty output) on the params' device."""
    dev = seg_params["cls"]["w"].device
    audio = audio.to(dev)
    with planted(mel, "KALDI_PREEMPHASIS", 0.0):
        yield "fbank without pre-emphasis", "fbank", mel.kaldi_fbank(audio * 32768.0)
    with planted(segmentation, "_time_reversed", lambda x, dim: x):
        yield ("BiLSTM backward direction run forward", "log_probs",
               segmentation.forward(seg_params, windows.to(dev)))
    yield ("CAM++ frame mask ignored", "embeddings",
           campplus.embed_from_audio(emb_params, audio, [audio.shape[1]] * audio.shape[0]))


def check(seg_params, emb_params, seg_ref, emb_ref, samples: np.ndarray,
          batch: int = 8) -> Dict[str, str]:
    """The nets at (seg_params, emb_params) against the same weights on the
    CPU (seg_ref, emb_ref) on one stream's audio, then the planted faults.
    Raises on a disagreement or a missed fault; returns the printed lines."""
    windows, audio, n_valid = stream_inputs(samples, batch)
    got = outputs(seg_params, emb_params, windows, audio, n_valid)
    ref = outputs(seg_ref, emb_ref, windows, audio, n_valid)
    lines = {kind: compare(kind, kind, got[kind], ref[kind]) for kind in got}
    for tag, kind, faulty in diarize_faults(seg_params, emb_params, windows, audio, n_valid):
        lines[tag] = reject(tag, kind, got[kind], faulty)
    return lines
