"""CAM++ (wespeaker voxceleb) and its kaldi fbank in plain PyTorch, f32:
the benchmark's reference.

A frozen copy of the port's plain net (`models/campplus.py`,
`ops/mel.py::kaldi_fbank`, themselves plain PyTorch with no kernel): the
program's net is held to this copy, so that a later change to it shows.
The random weights are the copied numpy draws (`init_params_np(seed=0)`,
the program's "__random__" weights). The precision is the caller's
(`precision.f32_products`): IEEE f32, or TF32 for the control.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F


def _caller_precision():
    return contextlib.nullcontext()


SAMPLE_RATE = 16_000


def htk_filterbank(n_mels: int, n_fft: int, fmin: float, fmax: float) -> np.ndarray:
    """Kaldi's triangular mel filters [n_mels, n_fft // 2 + 1] (HTK scale,
    unnormalized)."""
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, n_fft // 2 + 1)

    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    hz_pts = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)


N_MELS = 80
EMB_DIM = 192  # wespeaker voxceleb CAM++ embedding size
M_CHANNELS = 32  # FCM channel width
INIT_CHANNELS = 128  # TDNN stem output channels
GROWTH = 32  # dense-layer growth rate
BN_CHANNELS = 128  # bottleneck width (bn_size 4 * growth 32)
BLOCK_LAYERS = (12, 24, 16)  # layers per CAM-Dense-TDNN block
DILATIONS = (1, 2, 2)
SEG_POOL = 100  # frames per CAM segment pooling window
BN_EPS = 1e-5
MAX_EMBED_FRAMES = 1998  # ~20 s of fbank context per embedding



def init_params_np(seed: int = 0, embed_dim: int = EMB_DIM) -> Dict[str, Any]:
    """Random weights in the JAX package's layout (convs `[k(, k), in, out]`),
    from the same numpy draws as `whisper_diarize_tpu.models.campplus.init_params`."""
    rng = np.random.default_rng(seed)

    def bn(c):
        return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32),
                "m": np.zeros((c,), np.float32), "v": np.ones((c,), np.float32)}

    def conv2d_w(cin, cout, k):
        return (rng.standard_normal((k, k, cin, cout)) * (k * k * cin) ** -0.5).astype(np.float32)

    def conv1d_w(cin, cout, k):
        return (rng.standard_normal((k, cin, cout)) * (k * cin) ** -0.5).astype(np.float32)

    def res_block(cin, cout, stride):
        blk = {"conv1_w": conv2d_w(cin, cout, 3), "bn1": bn(cout),
               "conv2_w": conv2d_w(cout, cout, 3), "bn2": bn(cout)}
        if stride != 1 or cin != cout:
            blk["sc_w"] = (rng.standard_normal((1, 1, cin, cout)) * cin ** -0.5).astype(np.float32)
            blk["sc_bn"] = bn(cout)
        return blk

    fcm = {"conv1_w": conv2d_w(1, M_CHANNELS, 3), "bn1": bn(M_CHANNELS)}
    for name in ("layer1", "layer2"):
        fcm[name] = [res_block(M_CHANNELS, M_CHANNELS, 2), res_block(M_CHANNELS, M_CHANNELS, 1)]
    fcm["conv2_w"] = conv2d_w(M_CHANNELS, M_CHANNELS, 3)
    fcm["bn2"] = bn(M_CHANNELS)
    params: Dict[str, Any] = {
        "fcm": fcm,
        "tdnn": {"w": conv1d_w(M_CHANNELS * (N_MELS // 8), INIT_CHANNELS, 5),
                 "bn": bn(INIT_CHANNELS)},
    }
    ch = INIT_CHANNELS
    blocks = []
    for n_layers in BLOCK_LAYERS:
        layers = []
        for _ in range(n_layers):
            layers.append({
                "bn1": bn(ch),
                "lin1_w": conv1d_w(ch, BN_CHANNELS, 1),
                "bn2": bn(BN_CHANNELS),
                "local_w": conv1d_w(BN_CHANNELS, GROWTH, 3),
                "cam1_w": conv1d_w(BN_CHANNELS, BN_CHANNELS // 2, 1),
                "cam1_b": np.zeros((BN_CHANNELS // 2,), np.float32),
                "cam2_w": conv1d_w(BN_CHANNELS // 2, GROWTH, 1),
                "cam2_b": np.zeros((GROWTH,), np.float32),
            })
            ch += GROWTH
        transit = {"bn": bn(ch), "w": conv1d_w(ch, ch // 2, 1)}
        ch //= 2
        blocks.append({"layers": layers, "transit": transit})
    params["blocks"] = blocks
    params["out_bn"] = bn(ch)
    params["dense"] = {"w": conv1d_w(ch * 2, embed_dim, 1),
                       "bn_m": np.zeros((embed_dim,), np.float32),
                       "bn_v": np.ones((embed_dim,), np.float32)}
    return params


def params_from_jax(tree: Any, device="cpu") -> Any:
    """JAX-layout CAM++ weights (numpy or JAX arrays) -> port tensors (f32),
    the same tree with conv weights in torch's layout: `[k, in, out]` ->
    `[out, in, k]`, `[kh, kw, in, out]` -> `[out, in, kh, kw]`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    a = np.array(tree, np.float32)
    if a.ndim == 3:
        a = a.transpose(2, 1, 0)
    elif a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _apply_bn(bn: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm over the channel axis (1) of x [B, C, ...]."""
    shape = (-1,) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(bn["v"] + BN_EPS)
    return (x - bn["m"].view(shape)) * inv.view(shape) * bn["g"].view(shape) + bn["b"].view(shape)


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """x [B, C, F, T], padding 1; `stride` applies to (F, T)."""
    return F.conv2d(x, w, stride=stride, padding=1)


def _conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """x [B, C, T]; same padding for odd kernels."""
    pad = (w.shape[-1] - 1) * dilation // 2
    return F.conv1d(x, w, stride=stride, padding=pad, dilation=dilation)


def _res_block_apply(blk, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(_apply_bn(blk["bn1"], _conv2d(x, blk["conv1_w"], (stride, 1))))
    out = _apply_bn(blk["bn2"], _conv2d(out, blk["conv2_w"], (1, 1)))
    sc = (_apply_bn(blk["sc_bn"], F.conv2d(x, blk["sc_w"], stride=(stride, 1)))
          if "sc_w" in blk else x)
    return F.relu(out + sc)


def _fcm(params, feats: torch.Tensor) -> torch.Tensor:
    """feats [B, T, 80] -> [B, 320, T] (frequency 80 -> 10, 32 channels,
    channel-major as torch reshapes (B, C, F', T))."""
    x = feats.transpose(1, 2)[:, None]  # [B, 1, F, T]
    x = F.relu(_apply_bn(params["bn1"], _conv2d(x, params["conv1_w"], (1, 1))))
    for stage in ("layer1", "layer2"):
        for i, blk in enumerate(params[stage]):
            x = _res_block_apply(blk, x, 2 if i == 0 else 1)
    x = F.relu(_apply_bn(params["bn2"], _conv2d(x, params["conv2_w"], (2, 1))))
    B, C, Fq, T = x.shape
    return x.reshape(B, C * Fq, T)


def _seg_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked segment average pooling (torch avg_pool1d k = s = 100, ceil),
    broadcast back over time. x [B, C, T]; mask [B, 1, T]."""
    B, C, T = x.shape
    n_seg = -(-T // SEG_POOL)
    pad = n_seg * SEG_POOL - T
    xs = F.pad(x * mask, (0, pad)).view(B, C, n_seg, SEG_POOL).sum(-1)
    ms = F.pad(mask, (0, pad)).view(B, 1, n_seg, SEG_POOL).sum(-1)
    return (xs / ms.clamp_min(1.0)).repeat_interleave(SEG_POOL, dim=-1)[..., :T]


def _cam_layer(layer, x: torch.Tensor, mask: torch.Tensor, dilation: int) -> torch.Tensor:
    """CAM: the local conv gated by sigmoid(MLP(global + segment context)).
    x [B, 128, T] (bottleneck features), mask [B, 1, T]."""
    local = _conv1d(x, layer["local_w"], dilation=dilation)  # [B, 32, T]
    g = (x * mask).sum(-1, keepdim=True) / mask.sum(-1, keepdim=True).clamp_min(1.0)
    context = g + _seg_pool(x, mask)
    h = F.relu(F.conv1d(context, layer["cam1_w"], layer["cam1_b"]))
    return local * torch.sigmoid(F.conv1d(h, layer["cam2_w"], layer["cam2_b"]))


def embed_from_fbank(params: Dict[str, Any], feats: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """feats [B, T, 80] mean-normalized fbank, mask [B, T] (1 = valid
    frame), on the params' device -> embeddings [B, EMB_DIM]."""
    with _caller_precision():
        x = _fcm(params["fcm"], feats)  # [B, 320, T]
        tdnn = params["tdnn"]
        x = F.relu(_apply_bn(tdnn["bn"], _conv1d(x, tdnn["w"], stride=2)))
        m = mask[:, ::2][:, None, :x.shape[-1]].to(x.dtype)  # [B, 1, T']
        for block, dil in zip(params["blocks"], DILATIONS):
            for layer in block["layers"]:
                h = _conv1d(F.relu(_apply_bn(layer["bn1"], x)), layer["lin1_w"])
                h = F.relu(_apply_bn(layer["bn2"], h))
                x = torch.cat([x, _cam_layer(layer, h, m, dil)], dim=1)  # dense
            t = block["transit"]
            x = _conv1d(F.relu(_apply_bn(t["bn"], x)), t["w"])
        x = F.relu(_apply_bn(params["out_bn"], x))
        # masked statistics pooling (mean | std), the std unbiased (n - 1)
        # like the upstream StatsPool
        denom = m.sum(-1).clamp_min(1.0)  # [B, 1]
        mean = (x * m).sum(-1) / denom
        var = ((x - mean[..., None]) * m).square().sum(-1) / (denom - 1.0).clamp_min(1.0)
        stats = torch.cat([mean, var.clamp_min(1e-10).sqrt()], dim=-1)  # [B, 1024]
        d = params["dense"]
        emb = F.linear(stats, d["w"][..., 0])
        return (emb - d["bn_m"]) * torch.rsqrt(d["bn_v"] + BN_EPS)


def embed_from_audio(params: Dict[str, Any], audio: torch.Tensor, n_valid) -> torch.Tensor:
    """Embeddings of a decode batch on the device that holds it: audio
    [B, T] f32 in [-1, 1] (T >= 400) and n_valid [B] real sample counts ->
    [B, EMB_DIM]. The kaldi fbank of the int16-scale samples, the first
    MAX_EMBED_FRAMES frames, each row mean-normalized over its valid frames
    (a frame is valid when its 400 samples are; frame 0 always is)."""
    n_keep = (MAX_EMBED_FRAMES - 1) * KALDI_FRAME_SHIFT + KALDI_FRAME_LEN
    feats = kaldi_fbank(audio[:, :n_keep] * 32768.0)  # frames past the cap are not needed
    Tf = feats.shape[1]
    n_valid = torch.as_tensor(n_valid, device=audio.device)
    frames = torch.arange(Tf, device=audio.device)
    frame_ok = frames[None, :] * KALDI_FRAME_SHIFT + KALDI_FRAME_LEN <= n_valid[:, None]
    frame_ok[:, 0] = True  # rows without a full frame fall back to frame 0
    m = frame_ok[:, :, None].to(feats.dtype)
    mean = (feats * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp_min(1.0)
    return embed_from_fbank(params, (feats - mean) * m, frame_ok.to(feats.dtype))


KALDI_FRAME_LEN = 400  # 25 ms
KALDI_FRAME_SHIFT = 160  # 10 ms
KALDI_N_FFT = 512
KALDI_PREEMPHASIS = 0.97
KALDI_LOG_FLOOR = 1.1920928955078125e-07  # kaldi's epsilon (f32 machine epsilon)

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
    fb = htk_filterbank(n_mels, KALDI_N_FFT, 20.0, SAMPLE_RATE / 2.0)
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
    with _caller_precision():
        spec = frames @ bases  # [..., F, 2 x 257]: re | im
        re, im = spec[..., :n_bins], spec[..., n_bins:]
        mel_energy = (re * re + im * im) @ fb
    return torch.log(torch.clamp(mel_energy, min=KALDI_LOG_FLOOR))
