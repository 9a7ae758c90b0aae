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
TPU kernel writes: on a CUDA tensor K7 (`csrc/mel.cu`: one launch, a real
FFT a frame in float64 on the CUDA cores, never TF32; its tables
`fft_tables`, its stages walked in plain PyTorch by `log_mel_fft_walk`), on
a CPU tensor its plain version `log_mel_fused_plain`
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
from ..utils import exact_f32, ieee_f32_products
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


@ieee_f32_products
def log_mel_fused_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, T] f32 -> raw log10 mel energies [B, T // 160, n_mels]:
    the function K7 computes, in f32 matmuls over the split bases (float64
    audio stays float64: the reference K7's f32 bound is measured against)."""
    a, b, c = _frame_rows(audio if audio.dtype == torch.float64 else audio.float())
    c0, c1, c2, s0, s1, s2 = _bases(a.device, a.dtype)
    re = a @ c0 + b @ c1 + c @ c2  # [B, F, 201]
    im = a @ s0 + b @ s1 + c @ s2
    return _mel_log10(re * re + im * im, n_mels)


# K7's tables (`csrc/mel.cu`): every twiddle and the window computed in
# float64 and rounded once to f32, in one f32 vector at these offsets (in
# floats; complex values as (re, im) pairs), and the sparse filterbank.
FFT_N = N_FFT // 2  # the 200-point complex FFT of a frame's packed samples
T_WIN = 0  # [400] periodic Hann window
T_W5 = 400  # cos(2pi/5), sin(2pi/5), cos(4pi/5), sin(4pi/5): the 5-point DFTs
T_R8 = 404  # sqrt(1/2): the 8-point DFTs
T_W25 = 408  # [25] W25^m (W_N = e^(-2 pi i / N)): the 25-point DFT's inner twiddles
T_W200 = 458  # [8][25] W200^(j k2): the four-step twiddles
T_W400 = 858  # [201] W400^k: the real split
T_MELW = 1260  # the filterbank's nonzero weights, mel by mel


def _unit_roots(n: int, count: int) -> np.ndarray:
    """(re, im) of W_n^m = exp(-2 pi i m / n), m = 0 .. count - 1, float64."""
    ang = -2.0 * np.pi * np.arange(count) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).reshape(-1)


@functools.lru_cache(maxsize=8)
def fft_tables(n_mels: int):
    """K7's tables for `n_mels` filters, as numpy arrays: the f32 vector
    laid out at the `T_*` offsets (the filterbank's nonzero weights from
    `T_MELW` on, each mel's run of bins in order) and int32 [3, n_mels]:
    each mel's first bin, its bin count and the offset of its weights after
    `T_MELW`. A filter's nonzero weights are one run of bins (a triangle),
    at most 2 filters share a bin."""
    fb = mel_filterbank(n_mels)
    first, count, off, weights = [], [], [], []
    for row in fb:
        nz = np.nonzero(row)[0]
        lo = int(nz[0]) if nz.size else 0
        n = int(nz[-1]) - lo + 1 if nz.size else 0
        first.append(lo)
        count.append(n)
        off.append(len(weights))
        weights.extend(row[lo:lo + n])
    c5, s5 = np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5)
    c25, s25 = np.cos(4 * np.pi / 5), np.sin(4 * np.pi / 5)
    head = np.concatenate([
        0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)),  # periodic
        [c5, s5, c25, s25, np.sqrt(0.5), 0.0, 0.0, 0.0],
        _unit_roots(25, 25),
        _unit_roots(FFT_N, FFT_N).reshape(FFT_N, 2)[np.outer(np.arange(8), np.arange(25))]
        .reshape(-1),
        _unit_roots(N_FFT, FFT_N + 1)])
    assert head.size == T_MELW
    tab = np.concatenate([head.astype(np.float32), np.asarray(weights, np.float32)])
    return tab, np.asarray([first, count, off], np.int32)


@functools.lru_cache(maxsize=8)
def _kernel_tables(device: torch.device, n_mels: int):
    """`fft_tables` on `device`."""
    tab, itab = fft_tables(n_mels)
    return torch.from_numpy(tab).to(device), torch.from_numpy(itab).to(device)


def _dft5(x, c1, s1, c2, s2):
    """5-point DFTs along dim -2 of complex pairs x [..., 5, 2] as K7
    computes them (the symmetric form, constants from the table)."""
    x0, x1, x2, x3, x4 = x.unbind(-2)
    t1, t2, d1, d2 = x1 + x4, x2 + x3, x1 - x4, x2 - x3
    a1, a2 = x0 + c1 * t1 + c2 * t2, x0 + c2 * t1 + c1 * t2
    b1, b2 = s1 * d1 + s2 * d2, s2 * d1 - s1 * d2  # X1 = a1 - i b1, X2 = a2 - i b2

    def mi(a, b, sign):  # a + sign * (-i) b
        return torch.stack([a[..., 0] + sign * b[..., 1], a[..., 1] - sign * b[..., 0]], -1)

    return torch.stack([x0 + t1 + t2, mi(a1, b1, 1), mi(a2, b2, 1), mi(a2, b2, -1),
                        mi(a1, b1, -1)], -2)


def _cmul(x, w):
    """Complex pairs x [..., 2] times w [..., 2]."""
    return torch.stack([x[..., 0] * w[..., 0] - x[..., 1] * w[..., 1],
                        x[..., 0] * w[..., 1] + x[..., 1] * w[..., 0]], -1)


def _dft8(y, r):
    """8-point DFTs along dim -2 of complex pairs y [..., 8, 2] as K7
    computes them: two 4-point DFTs (even, odd inputs) joined by W8^k,
    with r = sqrt(1/2) from the table."""
    def dft4(a0, a1, a2, a3):
        t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
        mi_t3 = torch.stack([t3[..., 1], -t3[..., 0]], -1)  # -i t3
        return t0 + t2, t1 + mi_t3, t0 - t2, t1 - mi_t3

    e = dft4(*y[..., 0::2, :].unbind(-2))
    o = list(dft4(*y[..., 1::2, :].unbind(-2)))
    x, z = o[1][..., 0], o[1][..., 1]
    o[1] = torch.stack([r * (x + z), r * (z - x)], -1)  # W8^1 o1
    o[2] = torch.stack([o[2][..., 1], -o[2][..., 0]], -1)  # W8^2 o2 = -i o2
    x, z = o[3][..., 0], o[3][..., 1]
    o[3] = torch.stack([r * (z - x), -r * (x + z)], -1)  # W8^3 o3
    return torch.stack([e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)], -2)


def reflect_index(T: int, n_frames: int, device=None) -> torch.Tensor:
    """[n_frames, 400] source sample of each frame's samples in audio of
    length T: frame f reads j = 160 f - 200 + t, j < 0 reflected to -j and
    j >= T to 2 (T - 1) - j (the center reflect padding, as K7 indexes)."""
    j = (torch.arange(n_frames, device=device)[:, None] * HOP_LENGTH - N_FFT // 2
         + torch.arange(N_FFT, device=device))
    j = torch.where(j < 0, -j, j)
    return torch.where(j >= T, 2 * (T - 1) - j, j)


def log_mel_fft_walk(audio: torch.Tensor, n_mels: int, tab=None, itab=None) -> torch.Tensor:
    """K7's stages in plain PyTorch on the tables the wrapper hands it
    (`fft_tables`, or `tab` / `itab` given): audio [B, T] -> raw log10 mel
    [B, T // 160, n_mels] in audio's float dtype. Reflect-indexed frames,
    the window, 200 packed complex samples z[n] = x[2n] + i x[2n+1]; the
    200-point FFT as 8 x 25 (n = j + 8 n2, k = k2 + 25 k1): a 25-point DFT
    over n2 (5 x 5, the inner twiddles W25^(p s)) for each j, times
    W200^(j k2), then an 8-point DFT over j; the real split X[k] = (Z[k] +
    Z*[200-k]) / 2 - i W400^k (Z[k] - Z*[200-k]) / 2; the power; each mel
    the sum of its run of bins in order; log10 of its max with 1e-10. The
    kernel computes through the power in float64 and the rest in f32. Only
    the tests and `agreement.k7_faults` call it: it shows the kernel's
    stage order and tables, not its rounding."""
    if tab is None:
        tab, itab = (torch.from_numpy(t) for t in fft_tables(n_mels))
    dt, dev = audio.dtype, audio.device
    tab = tab.to(dev, dt)
    B, T = audio.shape
    n_frames = T // HOP_LENGTH
    x = audio[:, reflect_index(T, n_frames, dev)] * tab[T_WIN:T_WIN + N_FFT]
    z = x.reshape(B, n_frames, FFT_N, 2)  # packed: (x[2n], x[2n+1])
    c1, s1, c2, s2 = tab[T_W5:T_W5 + 4]
    # n = j + 8 (p + 5 q) -> [B, F, j, p, q, 2]
    a = z.reshape(B, n_frames, 5, 5, 8, 2).permute(0, 1, 4, 3, 2, 5)
    w25 = tab[T_W25:T_W25 + 50].reshape(25, 2)
    ps = torch.arange(5, device=dev)[:, None] * torch.arange(5, device=dev)[None, :]
    b = _cmul(_dft5(a, c1, s1, c2, s2), w25[ps])  # [B, F, j, p, s, 2]: W25^(p s)
    a = _dft5(b.transpose(-3, -2), c1, s1, c2, s2)  # [B, F, j, s, r, 2]
    a = a.transpose(-3, -2).reshape(B, n_frames, 8, 25, 2)  # k2 = s + 5 r
    y = _cmul(a, tab[T_W200:T_W200 + 2 * FFT_N].reshape(8, 25, 2))  # W200^(j k2)
    zf = _dft8(y.transpose(-3, -2), tab[T_R8])  # [B, F, k2, k1, 2]
    zf = zf.transpose(-3, -2).reshape(B, n_frames, FFT_N, 2)  # k = k2 + 25 k1
    k = torch.arange(FFT_N + 1, device=dev)
    zk, zr = zf[..., k % FFT_N, :], zf[..., (FFT_N - k) % FFT_N, :]
    w400 = tab[T_W400:T_W400 + 2 * (FFT_N + 1)].reshape(FFT_N + 1, 2)
    sr, si = zk[..., 0] + zr[..., 0], zk[..., 1] - zr[..., 1]  # Z[k] + Z*[200-k]
    d = torch.stack([zk[..., 0] - zr[..., 0], zk[..., 1] + zr[..., 1]], -1)
    wd = _cmul(d, w400)
    xr, xi = 0.5 * sr + 0.5 * wd[..., 1], 0.5 * si - 0.5 * wd[..., 0]
    power = xr * xr + xi * xi  # [B, F, 201]
    first, count, off = (torch.as_tensor(t, dtype=torch.long, device=dev) for t in itab)
    weights = tab[T_MELW:]
    acc = torch.zeros(B, n_frames, n_mels, dtype=dt, device=dev)
    for c in range(int(count.max())):
        live = c < count
        bins = torch.where(live, first + c, 0)
        w = torch.where(live, weights[torch.where(live, off + c, 0)], 0.0)
        acc = acc + w * power[..., bins]
    return torch.log10(torch.clamp(acc, min=1e-10))


def log_mel_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """K7. Same contract as `log_mel_fused_plain`; audio [B, T] f32, read
    unpadded (the kernel reflects at both edges itself): one launch."""
    if audio.device.type == "cpu":
        return log_mel_fused_plain(audio, n_mels)
    name = "log_mel_fused"
    _require_cuda(name, audio, dtype=torch.float32)
    if audio.ndim != 2 or not 0 < n_mels <= 128 or audio.shape[1] <= N_FFT // 2:
        raise ValueError(f"{name}: audio {tuple(audio.shape)}, n_mels {n_mels} "
                         "(kernel takes [B, T > 200] and n_mels <= 128)")
    audio = audio.contiguous()
    B, T = audio.shape
    n_frames = T // HOP_LENGTH
    tab, itab = _kernel_tables(audio.device, n_mels)
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32, device=audio.device)
    lib = kernels.library()
    with torch.cuda.device(audio.device):
        kernels.check(lib.wdt_log_mel(
            audio.data_ptr(), tab.data_ptr(), itab.data_ptr(), out.data_ptr(), B, T,
            n_frames, n_mels, tab.numel(), kernels.stream_ptr(audio.device)), name)
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
    plain version on a CPU tensor. On the H100 ("NVIDIA H100 80GB HBM3,
    700.00 W"), B 8 x 30 s at 128 mels, K7 takes 0.043 ms of device time,
    openai-whisper's cuFFT route 0.22 ms (`tools/bench_f32_attn.py --only
    K7`) and the plain version 0.55 ms (`chip_smoke.py`; PERF.md)."""
    squeeze, x = _batched(audio)
    out = _normalize(log_mel_fused(x, n_mels))
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
