"""CAM++ speaker-embedding network in PyTorch (counterpart of
`whisper_diarize_tpu/models/campplus.py`, the wespeaker voxceleb topology):

  80-dim kaldi fbank, mean-normalized per utterance (`ops/mel.py::kaldi_fbank`)
  -> FCM head: Conv2d(1->32, 3x3) + BN + ReLU, two stages of two residual
     blocks (stride 2 on the frequency axis), Conv2d stride (2, 1) + BN +
     ReLU; frequency 80 -> 10, reshaped channel-major to 320 channels
  -> TDNN stem: Conv1d(320->128, k5, stride 2) + BN + ReLU
  -> 3 CAM-Dense-TDNN blocks of (12, 24, 16) layers, kernel 3, dilations
     (1, 2, 2), growth 32, bottleneck 128; a layer is BN+ReLU -> 1x1 conv ->
     BN+ReLU -> CAM (a dilated local conv gated by
     sigmoid(W2 relu(W1 (mean_t + 100-frame segment mean)))); a transit
     layer halves the channels after each block
  -> BN+ReLU -> statistics pooling (mean | unbiased std) -> 1024
  -> 1x1 conv + BatchNorm(affine=False) -> 192-dim embedding.

BatchNorms run in eval mode (eps 1e-5) with explicit g / b / m / v. A batch
of segments of different lengths runs padded with a frame mask, which gates
the CAM context, the segment pooling and the statistics pool; convolutions
see zeros past a segment's end, as in the JAX package. No TPU kernel lies
here: plain PyTorch on either device, channels first, its convolutions and
products held in f32 on the card (`utils.exact_f32`).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..ops.mel import KALDI_FRAME_LEN, KALDI_FRAME_SHIFT, kaldi_fbank
from ..utils import default_device, exact_f32

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


def init_params(seed: int = 0, device="cpu", embed_dim: int = EMB_DIM) -> Dict[str, Any]:
    return params_from_jax(init_params_np(seed, embed_dim), device)


def load_params_np(path: str) -> Dict[str, Any]:
    """Converted wespeaker CAM++ weights (flat .npz with dotted keys, written
    by `models/convert.py`) in the JAX layout."""
    z = np.load(path)
    out: Dict[str, Any] = {}
    for k in z.files:
        cur = out
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = z[k]

    def listify(d):
        if isinstance(d, dict) and d and all(s.isdigit() for s in d):
            return [listify(d[str(i)]) for i in range(len(d))]
        if isinstance(d, dict):
            return {k: listify(v) for k, v in d.items()}
        return d

    return listify(out)


def load_params(path: str, device=None) -> Dict[str, Any]:
    """`load_params_np` onto `device`: CUDA device 0 unless given one
    (raises without a card)."""
    device = default_device(device, "campplus.load_params")
    return params_from_jax(load_params_np(path), device)


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
    with exact_f32():
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


def _segment_fbank(samples, device) -> torch.Tensor:
    """One segment's int16 samples -> its mean-normalized fbank [T, 80]
    (zero-padded to one frame when shorter)."""
    x = torch.as_tensor(np.asarray(samples, np.float32), device=device)
    if x.shape[0] < KALDI_FRAME_LEN:
        x = F.pad(x, (0, KALDI_FRAME_LEN - x.shape[0]))
    f = kaldi_fbank(x)
    return f - f.mean(0, keepdim=True)


def compute_embedding(params: Dict[str, Any], int_samples: np.ndarray,
                      device=None) -> np.ndarray:
    """i16 samples of one segment -> its [EMB_DIM] embedding (host array),
    computed on `device` (CUDA device 0 unless given one; raises without a
    card)."""
    device = default_device(device, "campplus.compute_embedding")
    f = _segment_fbank(int_samples, device)[None]
    mask = torch.ones(f.shape[:2], device=device)
    return embed_from_fbank(params, f, mask)[0].cpu().numpy()


def compute_embeddings_batch(params: Dict[str, Any], segments: List[np.ndarray],
                             max_frames: int = MAX_EMBED_FRAMES, device=None) -> np.ndarray:
    """Embeddings of variable-length i16 segments in one padded, masked batch
    on `device` (CUDA device 0 unless given one; raises without a card):
    each segment's fbank is mean-normalized over all its frames, then cut to
    `max_frames`. Returns a host array [len(segments), EMB_DIM]."""
    device = default_device(device, "campplus.compute_embeddings_batch")
    feats = [_segment_fbank(seg, device)[:max_frames] for seg in segments]
    T = max(f.shape[0] for f in feats)
    batch = torch.zeros((len(feats), T, N_MELS), device=device)
    mask = torch.zeros((len(feats), T), device=device)
    for i, f in enumerate(feats):
        batch[i, :f.shape[0]] = f
        mask[i, :f.shape[0]] = 1.0
    return tracing.to_host(embed_from_fbank(params, batch, mask), "embed")
