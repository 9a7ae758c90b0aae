"""Silero-VAD v5 network in PyTorch (counterpart of
`whisper_diarize_tpu/models/silero_vad.py`).

Per 512-sample chunk with 64 samples of carried left context:
[context ‖ chunk] -> reflect-pad 64 on the left -> STFT basis matmul
(4 frames x 258 rows: real / imaginary halves) -> magnitude -> 4 x
(Conv1d k3 pad 1 + ReLU), strides (1, 2, 2, 1), channels 129 -> 128 -> 64
-> 64 -> 128 -> LSTM cell (128), state carried across chunks -> ReLU ->
linear 128 -> 1 -> sigmoid.

The chunk features and the LSTM input projection run for all chunks at
once; only the recurrence is a loop over chunks. Parameters: the JAX
package's values with the convs as torch `[out, in, k]` and the fused LSTM
weight split into torch's `w_ih [4H, in]` / `w_hh [4H, H]`
(`params_from_jax`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
CHUNK = 512  # samples per VAD frame (32 ms)
CONTEXT = 64  # left context carried from the previous chunk
N_FFT = 256
HOP = 128
N_BINS = N_FFT // 2 + 1  # 129
STFT_PAD = 64
N_FRAMES = (CONTEXT + CHUNK + STFT_PAD - N_FFT) // HOP + 1  # 4
HIDDEN = 128
_ENC_CHANNELS = [(N_BINS, 128), (128, 64), (64, 64), (64, 128)]
_ENC_STRIDES = (1, 2, 2, 1)
_KERNEL = 3


@functools.lru_cache(maxsize=1)
def _default_stft_basis() -> np.ndarray:
    """Hann-windowed DFT basis [N_FFT, 2 * N_BINS] (stand-in for the
    checkpoint's forward_basis_buffer)."""
    n = np.arange(N_FFT)[:, None]
    k = np.arange(N_BINS)[None, :]
    ang = -2.0 * np.pi * n * k / N_FFT
    win = np.hanning(N_FFT)[:, None]
    return np.concatenate([np.cos(ang) * win, np.sin(ang) * win], axis=1).astype(np.float32)


def init_params_np(seed: int = 0) -> Dict[str, Any]:
    """Random weights in the JAX package's layout, from the same numpy draws
    as `whisper_diarize_tpu.models.silero_vad.init_params`."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout, k):
        return {
            "w": (rng.standard_normal((k, cin, cout)) * (k * cin) ** -0.5).astype(np.float32),
            "b": np.zeros((cout,), np.float32),
        }

    return {
        "stft": _default_stft_basis(),
        "enc": [conv(cin, cout, _KERNEL) for cin, cout in _ENC_CHANNELS],
        "lstm": {
            "w": (rng.standard_normal((2 * HIDDEN, 4 * HIDDEN)) * HIDDEN ** -0.5).astype(np.float32),
            "b": np.zeros((4 * HIDDEN,), np.float32),
        },
        "head": {
            "w": (rng.standard_normal((HIDDEN, 1)) * HIDDEN ** -0.5).astype(np.float32),
            "b": np.zeros((1,), np.float32),
        },
    }


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX-layout Silero weights -> port tensors (f32): convs WIO ->
    [out, in, k]; the fused LSTM [in + hidden, 4H] -> w_ih / w_hh."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    lstm_w = np.asarray(tree["lstm"]["w"], np.float32)
    n_in = lstm_w.shape[0] - HIDDEN
    return {
        "stft": t(tree["stft"]),
        "enc": [{"w": t(np.asarray(blk["w"]).transpose(2, 1, 0).copy()), "b": t(blk["b"])}
                for blk in tree["enc"]],
        "lstm": {"w_ih": t(lstm_w[:n_in].T.copy()), "w_hh": t(lstm_w[n_in:].T.copy()),
                 "b": t(tree["lstm"]["b"])},
        "head": {"w": t(tree["head"]["w"]), "b": t(tree["head"]["b"])},
    }


def init_params(seed: int = 0, device="cpu") -> Dict[str, Any]:
    return params_from_jax(init_params_np(seed), device)


def load_params_np(path: str) -> Dict[str, Any]:
    """Converted Silero weights (.npz: stft_basis, enc{i}_w/b, lstm_w/b,
    head_w/b) in the JAX layout."""
    z = np.load(path)
    return {
        "stft": z["stft_basis"] if "stft_basis" in z.files else _default_stft_basis(),
        "enc": [{"w": z[f"enc{i}_w"], "b": z[f"enc{i}_b"]} for i in range(len(_ENC_CHANNELS))],
        "lstm": {"w": z["lstm_w"], "b": z["lstm_b"]},
        "head": {"w": z["head_w"], "b": z["head_b"]},
    }


def load_params(path: str, device="cpu") -> Dict[str, Any]:
    return params_from_jax(load_params_np(path), device)


def speech_probs(params: Dict[str, Any], audio: torch.Tensor) -> torch.Tensor:
    """audio [B, T] (or [T]) f32 in [-1, 1] -> speech probability per
    512-sample chunk [B, ceil(T / 512)] (the tail chunk zero-padded)."""
    if audio.ndim == 1:
        audio = audio[None]
    audio = audio.float()
    B, T = audio.shape
    n = -(-T // CHUNK)
    x = F.pad(audio, (CONTEXT, n * CHUNK - T))
    chunks = x[:, CONTEXT:].reshape(B, n, CHUNK)
    ctx_idx = (torch.arange(n, device=x.device)[:, None] * CHUNK
               + torch.arange(CONTEXT, device=x.device)[None, :])
    stacked = torch.cat([x[:, ctx_idx], chunks], dim=-1).reshape(B * n, 1, -1)
    padded = F.pad(stacked, (STFT_PAD, 0), mode="reflect")[:, 0]  # [B*n, 640]
    idx = (torch.arange(N_FRAMES, device=x.device)[:, None] * HOP
           + torch.arange(N_FFT, device=x.device)[None, :])
    spec = padded[:, idx] @ params["stft"]  # [B*n, 4, 258]
    re, im = spec[..., :N_BINS], spec[..., N_BINS:]
    h = torch.sqrt(re * re + im * im + 1e-12).transpose(1, 2)  # [B*n, 129, 4]
    for blk, stride in zip(params["enc"], _ENC_STRIDES):
        h = F.relu(F.conv1d(h, blk["w"], blk["b"], stride=stride, padding=1))
    e = h[:, :, 0].reshape(B, n, HIDDEN)
    lstm = params["lstm"]
    xi = e @ lstm["w_ih"].t() + lstm["b"]  # [B, n, 4H], gates i, f, g, o
    hs = torch.zeros((B, HIDDEN), device=x.device)
    cs = torch.zeros((B, HIDDEN), device=x.device)
    outs = []
    for t in range(n):
        z = xi[:, t] + hs @ lstm["w_hh"].t()
        i, f, g, o = z.chunk(4, dim=-1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        hs = torch.sigmoid(o) * torch.tanh(cs)
        outs.append(hs)
    hseq = torch.stack(outs, dim=1)  # [B, n, H]
    return torch.sigmoid(F.relu(hseq) @ params["head"]["w"] + params["head"]["b"])[..., 0]
