"""Whisper log-mel spectrogram in PyTorch (counterpart of
`whisper_diarize_tpu/ops/mel.py::log_mel_spectrogram`), and K7, the fused
log-mel kernel (counterpart of `tools/pallas_mel.py::log_mel_pallas` and its
`frontend`).

Same geometry as openai-whisper (n_fft 400, hop 160, periodic Hann, center
reflect padding, last frame dropped, power mel, log10, clamp to max - 8,
(x + 4) / 4) and the same DFT-as-matmul form with the same numpy bases: the
Hann-windowed real DFT is split into three 160-row thirds so the hop-160
framing is three accumulated matmuls over contiguous row views, in f32.

`log_mel_fused` computes the raw log10 mel energies [B, F, n_mels] that the
TPU kernel writes: on a CUDA tensor K7 (`csrc/mel.cu`, f32 on the CUDA
cores, never TF32), on a CPU tensor its plain version `log_mel_fused_plain`
(the matmuls above). `frontend` adds the clamp and the scaling outside the
kernel, as the TPU version leaves them to XLA. `log_mel_spectrogram` is the
plain path on every device. `log_mel_fused.launches` counts K7's launches.

`kaldi_fbank` is the Kaldi-style log-mel fbank that feeds the CAM++
speaker-embedding net (counterpart of the JAX `kaldi_fbank`): 25 ms / 10 ms
snip-edges frames, per-frame DC removal, pre-emphasis 0.97, the Povey
window, a 512-point real DFT as one f32 matmul against the bases cut to a
frame's 400 rows, 80 HTK-mel bands, natural log floored at f32 epsilon. No
TPU kernel computes it; it runs as plain PyTorch on either device, its
products held in f32 on the card (`utils.exact_f32`).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..utils import exact_f32
from .attn import _require_cuda

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


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE,
                   fmin: float = 0.0, fmax: Optional[float] = None, htk: bool = False,
                   norm_slaney: bool = True) -> np.ndarray:
    """Triangular mel filters [n_mels, n_fft//2+1]. The defaults are librosa's
    `filters.mel` (slaney scale, slaney area normalization), as in
    openai-whisper's asset; `htk=True, norm_slaney=False` gives kaldi's
    filters for `kaldi_fbank`."""
    fmax = fmax if fmax is not None else sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    if htk:
        def to_mel(f):
            return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

        def to_hz(m):
            return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)
    else:
        to_mel, to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney
    hz_pts = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm_slaney:
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


def _frame_rows(audio: torch.Tensor):
    """audio [B, T] -> the three row views (a, b, c) [B, F, 160] of the
    reflect-padded signal: frame i is a[i] | b[i] | the first half of c[i]."""
    B = audio.shape[0]
    n_frames = audio.shape[-1] // HOP_LENGTH
    pad = N_FFT // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    total_rows = n_frames + 2
    need = total_rows * HOP_LENGTH
    x = F.pad(x, (0, max(0, need - x.shape[-1])))[:, :need]
    rows = x.reshape(B, total_rows, HOP_LENGTH)
    return rows[:, 0:n_frames], rows[:, 1:n_frames + 1], rows[:, 2:n_frames + 2]


def _bases(device, dtype=torch.float32):
    """(c0, c1, c2, s0, s1, s2) of `_split_hann_bases` on `device`."""
    return tuple(torch.from_numpy(m).to(device, dtype) for m in _split_hann_bases())


def _mel_log10(power: torch.Tensor, n_mels: int) -> torch.Tensor:
    """power [B, F, 201] -> log10(max(power @ fb, 1e-10)) [B, F, n_mels]."""
    fb = torch.from_numpy(mel_filterbank(n_mels).T.copy()).to(power.device, power.dtype)
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


def _batched(audio: torch.Tensor):
    audio = audio.float()
    return audio.ndim == 1, audio[None] if audio.ndim == 1 else audio


def log_mel_fused_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, T] f32 -> raw log10 mel energies [B, T // 160, n_mels]:
    the function K7 computes, in f32 matmuls over the split bases (float64
    audio stays float64: the reference K7's f32 bound is measured against)."""
    a, b, c = _frame_rows(audio if audio.dtype == torch.float64 else audio.float())
    c0, c1, c2, s0, s1, s2 = _bases(a.device, a.dtype)
    re = a @ c0 + b @ c1 + c @ c2  # [B, F, 201]
    im = a @ s0 + b @ s1 + c @ s2
    return _mel_log10(re * re + im * im, n_mels)


@functools.lru_cache(maxsize=8)
def _kernel_tables(device: torch.device, n_mels: int):
    """K7's zero-padded f32 tables on `device`: the windowed DFT bases
    [400, 256] (the split bases stacked, their zero rows dropped) and the
    filterbank [256, 128]."""
    bases = _split_hann_bases()
    n_bins = N_FFT // 2 + 1

    def stacked(thirds):
        out = np.zeros((N_FFT, 256), np.float32)
        out[:, :n_bins] = np.concatenate(thirds)[:N_FFT]
        return torch.from_numpy(out).to(device)

    fb = np.zeros((256, 128), np.float32)
    fb[:n_bins, :n_mels] = mel_filterbank(n_mels).T
    return stacked(bases[:3]), stacked(bases[3:]), torch.from_numpy(fb).to(device)


def log_mel_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """K7. Same contract as `log_mel_fused_plain`; audio [B, T] f32."""
    if audio.device.type == "cpu":
        return log_mel_fused_plain(audio, n_mels)
    name = "log_mel_fused"
    _require_cuda(name, audio, dtype=torch.float32)
    if audio.ndim != 2 or not 0 < n_mels <= 128 or audio.shape[1] <= N_FFT // 2:
        raise ValueError(f"{name}: audio {tuple(audio.shape)}, n_mels {n_mels} "
                         "(kernel takes [B, T > 200] and n_mels <= 128)")
    B, T = audio.shape
    n_frames = T // HOP_LENGTH
    pad = N_FFT // 2
    xpad = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0].contiguous()
    cosb, sinb, fb = _kernel_tables(audio.device, n_mels)
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32, device=audio.device)
    lib = kernels.library()
    with torch.cuda.device(audio.device):
        kernels.check(lib.wdt_log_mel(
            xpad.data_ptr(), cosb.data_ptr(), sinb.data_ptr(), fb.data_ptr(),
            out.data_ptr(), B, T + 2 * pad, n_frames, n_mels,
            kernels.stream_ptr(audio.device)), name)
    log_mel_fused.launches += 1
    return out


log_mel_fused.launches = 0


def _normalize(raw: torch.Tensor) -> torch.Tensor:
    """raw log10 mel [B, F, n_mels] -> whisper's scaled log-mel
    [B, n_mels, F]: clamp to the global max - 8 per row, (x + 4) / 4."""
    maxv = raw.amax(dim=(-2, -1), keepdim=True)
    return ((torch.maximum(raw, maxv - 8.0) + 4.0) / 4.0).transpose(-1, -2)


def frontend(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """The fused frontend: audio f32 [T] or [B, T] -> [n_mels, T // 160]
    (or batched), equal to `log_mel_spectrogram`; K7 on a CUDA tensor, its
    plain version on a CPU tensor. It exists to hold the TPU kernel's
    counterpart, not for speed: on the H100 K7 is slower than the plain
    `log_mel_spectrogram` (PERF.md)."""
    squeeze, x = _batched(audio)
    out = _normalize(log_mel_fused(x.contiguous(), n_mels))
    return out[0] if squeeze else out


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio f32 in [-1, 1], [T] or [B, T] -> [n_mels, T // 160] (or batched)."""
    squeeze, x = _batched(audio)
    out = _normalize(log_mel_fused_plain(x, n_mels))
    return out[0] if squeeze else out


KALDI_FRAME_LEN = 400  # 25 ms
KALDI_FRAME_SHIFT = 160  # 10 ms
KALDI_N_FFT = 512
KALDI_PREEMPHASIS = 0.97
KALDI_LOG_FLOOR = 1.1920928955078125e-07  # kaldi's epsilon (f32 machine epsilon)


@functools.lru_cache(maxsize=8)
def _kaldi_tables(device: torch.device, n_mels: int):
    """(bases [400, 2 x 257], filters [257, n_mels]) f32 on `device`: the
    Povey-windowed 512-point DFT's cosine and sine bases side by side, cut to
    the 400 rows a frame fills (its zero padding to 512 adds nothing), and
    kaldi's mel filters (HTK scale, 20 Hz to Nyquist, unnormalized). The
    window is taken over the 512 points, as the JAX package takes it."""
    n_bins = KALDI_N_FFT // 2 + 1
    n = np.arange(KALDI_N_FFT)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * n * k / KALDI_N_FFT
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(KALDI_N_FFT) / (KALDI_N_FFT - 1))
    win = (hann ** 0.85)[:, None]
    cos = (np.cos(ang) * win).astype(np.float32)[:KALDI_FRAME_LEN]
    sin = (np.sin(ang) * win).astype(np.float32)[:KALDI_FRAME_LEN]
    fb = mel_filterbank(n_mels, n_fft=KALDI_N_FFT, fmin=20.0, fmax=SAMPLE_RATE / 2.0,
                        htk=True, norm_slaney=False)
    return (torch.from_numpy(np.concatenate([cos, sin], axis=1)).to(device),
            torch.from_numpy(fb.T.copy()).to(device))


def kaldi_fbank(audio, n_mels: int = 80) -> torch.Tensor:
    """Kaldi-compatible log-mel fbank (snip_edges, no dither) of int16-scale
    samples (raw PCM cast to float: CAM++ is scale-sensitive), a tensor on
    any device or a numpy array (CPU): [..., T] -> [..., 1 + (T - 400) //
    160, n_mels] f32 on the input's device."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    n = audio.shape[-1]
    if n < KALDI_FRAME_LEN:
        raise ValueError(f"audio too short for fbank: {n} < {KALDI_FRAME_LEN}")
    frames = audio.unfold(-1, KALDI_FRAME_LEN, KALDI_FRAME_SHIFT)  # [..., F, 400]
    frames = frames - frames.mean(dim=-1, keepdim=True)  # DC offset per frame
    # pre-emphasis; kaldi's first sample subtracts itself
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - KALDI_PREEMPHASIS * prev
    bases, fb = _kaldi_tables(audio.device, n_mels)
    n_bins = KALDI_N_FFT // 2 + 1
    with exact_f32():
        spec = frames @ bases  # [..., F, 2 x 257]: re | im
        re, im = spec[..., :n_bins], spec[..., n_bins:]
        mel_energy = (re * re + im * im) @ fb
    return torch.log(torch.clamp(mel_energy, min=KALDI_LOG_FLOOR))
