"""Whisper log-mel spectrogram in PyTorch (counterpart of
`whisper_diarize_tpu/ops/mel.py::log_mel_spectrogram`).

Same geometry as openai-whisper (n_fft 400, hop 160, periodic Hann, center
reflect padding, last frame dropped, power mel, log10, clamp to max - 8,
(x + 4) / 4) and the same DFT-as-matmul form with the same numpy bases: the
Hann-windowed real DFT is split into three 160-row thirds so the hop-160
framing is three accumulated matmuls over contiguous row views, in f32.
No kernel: mel is a small share of a window's time.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters [n_mels, n_fft//2+1]
    (librosa's `filters.mel` defaults, as in openai-whisper's asset)."""
    fmax = fmax if fmax is not None else sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(0.0), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _split_hann_bases():
    """(C0, C1, C2, S0, S1, S2): the Hann-windowed DFT bases [400, 201] cut
    into 160-row thirds (the last zero-padded to 160 rows)."""
    n_bins = N_FFT // 2 + 1
    n = np.arange(N_FFT)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * n * k / N_FFT
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))  # periodic
    C = (np.cos(ang) * win[:, None]).astype(np.float32)
    S = (np.sin(ang) * win[:, None]).astype(np.float32)

    def third(M, j):
        part = M[j * HOP_LENGTH: (j + 1) * HOP_LENGTH]
        pad = np.zeros((HOP_LENGTH - part.shape[0], M.shape[1]), M.dtype)
        return np.ascontiguousarray(np.concatenate([part, pad]))

    return tuple(third(C, j) for j in range(3)) + tuple(third(S, j) for j in range(3))


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio f32 in [-1, 1], [T] or [B, T] -> [n_mels, T // 160] (or batched)."""
    audio = audio.float()
    squeeze = audio.ndim == 1
    x = audio[None] if squeeze else audio
    B = x.shape[0]
    n_frames = x.shape[-1] // HOP_LENGTH
    pad = N_FFT // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    total_rows = n_frames + 2
    need = total_rows * HOP_LENGTH
    x = F.pad(x, (0, max(0, need - x.shape[-1])))[:, :need]
    rows = x.reshape(B, total_rows, HOP_LENGTH)
    a, b, c = rows[:, 0:n_frames], rows[:, 1:n_frames + 1], rows[:, 2:n_frames + 2]
    c0, c1, c2, s0, s1, s2 = (torch.from_numpy(m).to(x.device) for m in _split_hann_bases())
    re = a @ c0 + b @ c1 + c @ c2  # [B, F, 201]
    im = a @ s0 + b @ s1 + c @ s2
    power = re * re + im * im
    fb = torch.from_numpy(mel_filterbank(n_mels).T.copy()).to(x.device)
    log_spec = torch.log10(torch.clamp(power @ fb, min=1e-10))
    maxv = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = (torch.maximum(log_spec, maxv - 8.0) + 4.0) / 4.0
    out = log_spec.transpose(-1, -2)  # [B, n_mels, F]
    return out[0] if squeeze else out
