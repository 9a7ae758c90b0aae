"""Speaker segmentation network (pyannote segmentation-3.0, PyanNet) in
PyTorch (counterpart of `whisper_diarize_tpu/models/segmentation.py`).

  InstanceNorm1d(affine) on the raw waveform
  -> SincNet: band-pass sinc filters (80, kernel 251, stride 10) -> abs ->
     maxpool 3 -> InstanceNorm1d -> leaky-relu; then two blocks of
     Conv1d(k5, valid) -> maxpool 3 -> InstanceNorm1d -> leaky-relu
  -> 4-layer bidirectional LSTM (hidden 128)
  -> 2 linear layers (128, leaky-relu) -> classifier -> log-softmax over the
     7 powerset classes of <= 3 speakers {0, s1, s2, s3, s1s2, s1s3, s2s3}.

10 s windows (160 000 samples) give 589 frames of 16.875 ms (270 samples).
No TPU kernel lies here: the net is plain PyTorch on either device, its
convolutions and products held in f32 on the card (`utils.exact_f32`).

Layout: channels first (`[B, C, T]`) through SincNet, the convs as torch
`[out, in, k]`. The BiLSTM runs one loop over time that serves both
directions: step t feeds the forward cell frame t and the backward cell
frame T - 1 - t, with every frame's input projection (both directions in
one product) hoisted out of the loop and one batched product a step for the
two directions' recurrent weights. Gates i, f, g, o, one bias
(`params_from_jax` splits the JAX package's fused `[in + H, 4H]` weight).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import exact_f32

SAMPLE_RATE = 16_000
WINDOW_SECONDS = 10.0
WINDOW_SAMPLES = int(WINDOW_SECONDS * SAMPLE_RATE)

SINC_FILTERS = 80
SINC_KERNEL = 251
SINC_STRIDE = 10
CONV_FILTERS = 60
CONV_KERNEL = 5
POOL = 3
LSTM_HIDDEN = 128
LSTM_LAYERS = 4
LINEAR_DIM = 128
N_CLASSES = 7  # powerset of up to 3 simultaneous speakers
MAX_SPEAKERS_LOCAL = 3

# class index -> active local speakers
POWERSET: List[Tuple[int, ...]] = [(), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2)]

FRAME_STEP_SAMPLES = SINC_STRIDE * POOL ** 3  # 270 -> 16.875 ms

MIN_LOW_HZ = 50.0
MIN_BAND_HZ = 50.0


def n_out_frames(n_samples: int) -> int:
    t = (n_samples - SINC_KERNEL) // SINC_STRIDE + 1
    t //= POOL
    t = (t - CONV_KERNEL + 1) // POOL
    t = (t - CONV_KERNEL + 1) // POOL
    return t


def _mel_init_bands(n_filters: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mel-spaced initial (low, band) Hz params like SincNet."""
    low_hz, high_hz = 30.0, SAMPLE_RATE / 2 - 100.0
    mel = np.linspace(2595.0 * np.log10(1 + low_hz / 700.0),
                      2595.0 * np.log10(1 + high_hz / 700.0), n_filters + 1)
    hz = 700.0 * (10 ** (mel / 2595.0) - 1)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


def init_params_np(seed: int = 0) -> Dict[str, Any]:
    """Random weights in the JAX package's layout, from the same numpy draws
    as `whisper_diarize_tpu.models.segmentation.init_params`."""
    rng = np.random.default_rng(seed)
    low, band = _mel_init_bands(SINC_FILTERS)

    def lin(n_in, n_out):
        return {"w": (rng.standard_normal((n_in, n_out)) * n_in ** -0.5).astype(np.float32),
                "b": np.zeros((n_out,), np.float32)}

    def conv(cin, cout, k):
        return {"w": (rng.standard_normal((k, cin, cout)) * (k * cin) ** -0.5).astype(np.float32),
                "b": np.zeros((cout,), np.float32)}

    def lstm_dir(n_in):
        return {"w": (rng.standard_normal((n_in + LSTM_HIDDEN, 4 * LSTM_HIDDEN))
                      * n_in ** -0.5).astype(np.float32),
                "b": np.zeros((4 * LSTM_HIDDEN,), np.float32)}

    def norm(c):
        return {"s": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}

    return {
        "wav_norm": norm(1),
        "sinc": {"low_hz": low, "band_hz": band},
        "ln0": norm(SINC_FILTERS),
        "conv1": conv(SINC_FILTERS, CONV_FILTERS, CONV_KERNEL),
        "ln1": norm(CONV_FILTERS),
        "conv2": conv(CONV_FILTERS, CONV_FILTERS, CONV_KERNEL),
        "ln2": norm(CONV_FILTERS),
        "lstm": [{"fwd": lstm_dir(CONV_FILTERS if i == 0 else 2 * LSTM_HIDDEN),
                  "bwd": lstm_dir(CONV_FILTERS if i == 0 else 2 * LSTM_HIDDEN)}
                 for i in range(LSTM_LAYERS)],
        "fc1": lin(2 * LSTM_HIDDEN, LINEAR_DIM),
        "fc2": lin(LINEAR_DIM, LINEAR_DIM),
        "cls": lin(LINEAR_DIM, N_CLASSES),
    }


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX-layout segmentation weights (numpy or JAX arrays) -> port tensors
    (f32): convs and a converted filterbank `[k, in, out]` -> `[out, in, k]`;
    each LSTM layer's two fused `[in + H, 4H]` weights -> `w_ih [in, 8H]`
    (forward | backward), `w_hh [2, H, 4H]`, `b [8H]`."""
    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def conv_w(a):
        return t(np.asarray(a, np.float32).transpose(2, 1, 0).copy())

    out: Dict[str, Any] = {}
    for name in ("wav_norm", "ln0", "ln1", "ln2", "fc1", "fc2", "cls"):
        if name in tree:
            out[name] = {k: t(v) for k, v in tree[name].items()}
    sinc = tree["sinc"]
    out["sinc"] = ({"kernel": conv_w(sinc["kernel"])} if "kernel" in sinc
                   else {"low_hz": t(sinc["low_hz"]), "band_hz": t(sinc["band_hz"])})
    for name in ("conv1", "conv2"):
        out[name] = {"w": conv_w(tree[name]["w"]), "b": t(tree[name]["b"])}
    layers = []
    for layer in tree["lstm"]:
        ws = [np.asarray(layer[d]["w"], np.float32) for d in ("fwd", "bwd")]
        n_in = ws[0].shape[0] - LSTM_HIDDEN
        layers.append({
            "w_ih": t(np.concatenate([w[:n_in] for w in ws], axis=1)),
            "w_hh": t(np.stack([w[n_in:] for w in ws])),
            "b": t(np.concatenate([np.asarray(layer[d]["b"], np.float32)
                                   for d in ("fwd", "bwd")])),
        })
    out["lstm"] = layers
    return out


def init_params(seed: int = 0, device="cpu") -> Dict[str, Any]:
    return params_from_jax(init_params_np(seed), device)


def load_params_np(path: str) -> Dict[str, Any]:
    """Converted pyannote weights (.npz with dotted keys like
    "lstm.0.fwd.w", written by `models/convert.py`) in the JAX layout."""
    z = np.load(path)
    out: Dict[str, Any] = {}
    for k in z.files:
        cur = out
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = z[k]
    if "lstm" in out:
        out["lstm"] = [out["lstm"][str(i)] for i in range(LSTM_LAYERS)]
    return out


def load_params(path: str, device="cpu") -> Dict[str, Any]:
    return params_from_jax(load_params_np(path), device)


def _sinc_kernel(low_hz: torch.Tensor, band_hz: torch.Tensor,
                 window_mode: str = "sincnet") -> torch.Tensor:
    """Band-pass sinc filters as a conv weight [SINC_FILTERS, 1, SINC_KERNEL]
    (SincNet / asteroid ParamSincFB): low = min_low + |low|, high =
    clip(low + min_band + |band|, min_low, Nyquist); the left half is
    (sin(2 pi f_hi t) - sin(2 pi f_lo t)) / (pi t) times a half window, the
    centre tap the unwindowed 2 band, the right half the left mirrored, all
    over 2 band. `window_mode`: "sincnet" (the original ramp
    0.54 - 0.46 cos(2 pi linspace(0, K/2 - 1, half) / K)), "torch" (the
    left half of torch.hamming_window(K, periodic=False)) or "hann"."""
    low = MIN_LOW_HZ + low_hz.abs()
    high = torch.clamp(low + MIN_BAND_HZ + band_hz.abs(), MIN_LOW_HZ, SAMPLE_RATE / 2)
    band = high - low
    half = (SINC_KERNEL - 1) // 2
    dev = low_hz.device
    n_ = 2.0 * math.pi * torch.arange(-half, 0, device=dev, dtype=torch.float32) / SAMPLE_RATE
    if window_mode == "sincnet":
        n_lin = torch.linspace(0.0, SINC_KERNEL / 2 - 1, half, device=dev)
        window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n_lin / SINC_KERNEL)
    elif window_mode == "torch":
        n_lin = torch.arange(half, device=dev, dtype=torch.float32)
        window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n_lin / (SINC_KERNEL - 1))
    elif window_mode == "hann":
        n_lin = torch.linspace(0.0, SINC_KERNEL / 2 - 1, half, device=dev)
        window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n_lin / SINC_KERNEL)
    else:
        raise ValueError(f"unknown sinc window_mode: {window_mode!r}")
    f_lo = low[:, None] * n_[None, :]
    f_hi = high[:, None] * n_[None, :]
    left = ((torch.sin(f_hi) - torch.sin(f_lo)) / (n_[None, :] / 2.0)) * window
    filt = torch.cat([left, 2.0 * band[:, None], left.flip(1)], dim=1)  # [F, K]
    return (filt / (2.0 * band[:, None]))[:, None, :]


def _instance_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """InstanceNorm1d(affine): each channel of x [B, C, T] over time."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["s"][:, None] + p["b"][:, None]


def _time_reversed(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The backward direction's view of time."""
    return x.flip(dim)


def _bilstm(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """One bidirectional layer: x [B, T, C] -> [B, T, 2H] (forward | backward)."""
    B, T, _ = x.shape
    H = LSTM_HIDDEN
    xi = (x @ p["w_ih"] + p["b"]).view(B, T, 2, 4 * H)
    xs = torch.stack([xi[:, :, 0], _time_reversed(xi[:, :, 1], 1)])  # [2, B, T, 4H]
    xs = xs.permute(2, 0, 1, 3).contiguous()  # [T, 2, B, 4H]
    h = x.new_zeros(2, B, H)
    c = x.new_zeros(2, B, H)
    hs = x.new_empty(T, 2, B, H)
    for t in range(T):
        z = torch.baddbmm(xs[t], h, p["w_hh"])  # [2, B, 4H]
        s = torch.sigmoid(z)
        c = torch.addcmul(s[..., H:2 * H] * c, s[..., :H], torch.tanh(z[..., 2 * H:3 * H]))
        h = s[..., 3 * H:] * torch.tanh(c)
        hs[t] = h
    fwd = hs[:, 0].transpose(0, 1)
    bwd = _time_reversed(hs[:, 1], 0).transpose(0, 1)
    return torch.cat([fwd, bwd], dim=-1)


def forward(params: Dict[str, Any], audio, sinc_window: str | None = None) -> torch.Tensor:
    """audio [B, T] (or [T]) f32 in [-1, 1], a tensor or numpy array, on the
    params' device -> log-probs [B, frames, 7]. `sinc_window` selects the
    SincNet window (`_sinc_kernel`); None reads WDT_SINC_WINDOW (default
    "sincnet"). A converted filterbank (`params["sinc"]["kernel"]`) is used
    as it is."""
    if sinc_window is None:
        sinc_window = os.environ.get("WDT_SINC_WINDOW", "sincnet")
    audio = torch.as_tensor(audio, dtype=torch.float32, device=params["cls"]["w"].device)
    if audio.ndim == 1:
        audio = audio[None]
    with exact_f32():
        x = audio[:, None, :]  # [B, 1, T]
        if "wav_norm" in params:
            x = _instance_norm(x, params["wav_norm"])
        sinc = params["sinc"]
        k = (sinc["kernel"] if "kernel" in sinc
             else _sinc_kernel(sinc["low_hz"], sinc["band_hz"], sinc_window))
        x = F.max_pool1d(F.conv1d(x, k, stride=SINC_STRIDE).abs(), POOL)
        x = F.leaky_relu(_instance_norm(x, params["ln0"]), 0.01)
        for conv_name, ln_name in (("conv1", "ln1"), ("conv2", "ln2")):
            x = F.conv1d(x, params[conv_name]["w"], params[conv_name]["b"])
            x = F.leaky_relu(_instance_norm(F.max_pool1d(x, POOL), params[ln_name]), 0.01)
        x = x.transpose(1, 2)  # [B, frames, C]
        for layer in params["lstm"]:
            x = _bilstm(layer, x)
        x = F.leaky_relu(x @ params["fc1"]["w"] + params["fc1"]["b"], 0.01)
        x = F.leaky_relu(x @ params["fc2"]["w"] + params["fc2"]["b"], 0.01)
        return F.log_softmax(x @ params["cls"]["w"] + params["cls"]["b"], dim=-1)


def powerset_to_activity(log_probs) -> np.ndarray:
    """[.., frames, 7] log-probs (numpy or a tensor) -> [.., frames, 3]
    binary speaker activity by the per-frame argmax over the powerset."""
    if isinstance(log_probs, torch.Tensor):
        log_probs = log_probs.detach().cpu().numpy()
    cls = np.argmax(log_probs, axis=-1)
    act = np.zeros(cls.shape + (MAX_SPEAKERS_LOCAL,), np.bool_)
    for ci, members in enumerate(POWERSET):
        sel = cls == ci
        for m in members:
            act[sel, m] = True
    return act
