"""Whisper encoder-decoder in PyTorch (counterpart of
`whisper_diarize_tpu/models/whisper.py`).

Parameters are the JAX package's tree as torch tensors on one device:
every transformer layer stacked on a leading `[L, ...]` axis, linear
weights `[in, out]` (x @ w), the conv stem in torch's `[out, in, k]`
(`models/weights.py::params_from_jax` converts). Functions take and return
tensors; the caller picks the device and dtype (bf16 on CUDA, f32 on CPU).

Numerics follow the JAX package path by path: layer norms in f32, the
encoder's bf16 "compact" softmax buffers when compute is low precision,
f32 decode logits, tanh GELU. The encoder and decoder self-attention are
plain matmul + softmax (they were plain XLA in JAX), except the beam step's
self-attention over the split cache, which runs on K4 (`ops/attn.py`); the
decoder's cross attention runs on the hand-written kernels of `ops/attn.py`
(K1 at prefill, K2 for the cross K/V) and `ops/tail.py` (K3, the whole
layer tail of every single-token step).

The int8 decode path: a cross cache {"k8", "ks", "v8", "vs"}
(`cross_kv(..., quantize=True)`) runs the prompt pass on K5 and the
single-token tails on K6; int8 tail weights (`tail_q8` of `decode_step`,
from `ops/tail.py::quantize_tail_weights`, held by `TranscribeStep`) run the
single-token tails on K6 as well. Either is independent of the other.
Language detection always reads the bf16 cache and the bf16 weights.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attn import (cross_attn_layer, cross_attn_layer_q8, cross_kv_build,
                        quantize_cross_kv, split_self_attn_layer)
from ..ops.tail import fused_tail_layer

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    multilingual: bool = True
    num_languages: int = 99

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


def _cfg(state, head, enc_layers, dec_layers, mels=80, vocab=51865,
         multilingual=True, num_languages=99) -> WhisperConfig:
    return WhisperConfig(
        n_mels=mels, n_vocab=vocab,
        n_audio_ctx=1500, n_audio_state=state, n_audio_head=head,
        n_audio_layer=enc_layers,
        n_text_ctx=448, n_text_state=state, n_text_head=head,
        n_text_layer=dec_layers,
        multilingual=multilingual, num_languages=num_languages,
    )


PRESETS: Dict[str, WhisperConfig] = {
    "tiny": _cfg(384, 6, 4, 4),
    "tiny.en": _cfg(384, 6, 4, 4, vocab=51864, multilingual=False),
    "base": _cfg(512, 8, 6, 6),
    "base.en": _cfg(512, 8, 6, 6, vocab=51864, multilingual=False),
    "small": _cfg(768, 12, 12, 12),
    "small.en": _cfg(768, 12, 12, 12, vocab=51864, multilingual=False),
    "medium": _cfg(1024, 16, 24, 24),
    "medium.en": _cfg(1024, 16, 24, 24, vocab=51864, multilingual=False),
    "large-v1": _cfg(1280, 20, 32, 32),
    "large-v2": _cfg(1280, 20, 32, 32),
    "large-v3": _cfg(1280, 20, 32, 32, mels=128, vocab=51866, num_languages=100),
    "large-v3-turbo": _cfg(1280, 20, 32, 4, mels=128, vocab=51866, num_languages=100),
}

# DTW alignment heads (layer, head) per checkpoint (openai-whisper / whisper.cpp)
ALIGNMENT_HEADS: Dict[str, List[Tuple[int, int]]] = {
    "tiny.en": [(1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)],
    "tiny": [(2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)],
    "base.en": [(3, 3), (4, 7), (5, 1), (5, 5), (6, 1), (6, 6), (7, 0), (7, 1)],
    "base": [(3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)],
    "small.en": [(6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7), (9, 0),
                 (9, 4), (9, 8), (9, 10), (10, 0), (10, 1), (10, 2), (10, 3),
                 (10, 6), (10, 11), (11, 2), (11, 4)],
    "small": [(5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
              (9, 9), (10, 5)],
    "medium.en": [(11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0),
                  (16, 4), (16, 9), (17, 12), (17, 14), (18, 7), (18, 10),
                  (18, 15), (20, 0), (20, 3), (20, 9), (20, 14), (21, 12)],
    "medium": [(13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)],
    "large-v1": [(9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11),
                 (22, 17), (23, 2), (23, 15)],
    "large-v2": [(10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15),
                 (17, 16), (18, 4), (18, 11), (18, 19), (19, 11), (21, 2),
                 (21, 3), (22, 3), (22, 9), (22, 12), (23, 5), (23, 7),
                 (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)],
    "large-v3": [(7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14),
                 (19, 11), (21, 4), (24, 1), (25, 6)],
    "large-v3-turbo": [(2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)],
}


def alignment_heads_for(model_name: str, cfg: WhisperConfig) -> List[Tuple[int, int]]:
    """Alignment-head preset (unknown names fall back to the Small preset, a
    quantization suffix is stripped), clamped to the model's layers/heads."""
    base = re.sub(r"-q\d+_(?:\d+|k(?:_[sml])?)$", "", model_name)
    heads = ALIGNMENT_HEADS.get(model_name, ALIGNMENT_HEADS.get(
        base, ALIGNMENT_HEADS["small"]))
    return [
        (l, h) for (l, h) in heads
        if l < cfg.n_text_layer and h < cfg.n_text_head
    ] or [(cfg.n_text_layer - 1, 0)]


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Encoder positional sinusoids (computed, not learned)."""
    assert channels % 2 == 0
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# --------------------------------------------------------------------------
# Initialization (the JAX package's numpy draws, in its layout)
# --------------------------------------------------------------------------

def init_params_np(cfg: WhisperConfig, seed: int = 0) -> Dict[str, object]:
    """Random parameters as a numpy tree in the JAX package's layout, from
    the same `np.random.default_rng(seed)` draws in the same order as
    `whisper_diarize_tpu.models.whisper.init_params`."""
    rng = np.random.default_rng(seed)
    d = cfg.n_audio_state
    dt = cfg.n_text_state

    def lin(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) * n_in ** -0.5).astype(np.float32)

    def stack(L, n_in, n_out):
        return np.stack([lin(n_in, n_out) for _ in range(L)])

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def enc_blocks(L):
        return {
            "ln1_s": ones(L, d), "ln1_b": zeros(L, d),
            "q_w": stack(L, d, d), "q_b": zeros(L, d),
            "k_w": stack(L, d, d),
            "v_w": stack(L, d, d), "v_b": zeros(L, d),
            "o_w": stack(L, d, d), "o_b": zeros(L, d),
            "ln2_s": ones(L, d), "ln2_b": zeros(L, d),
            "fc1_w": stack(L, d, 4 * d), "fc1_b": zeros(L, 4 * d),
            "fc2_w": stack(L, 4 * d, d), "fc2_b": zeros(L, d),
        }

    def dec_blocks(L):
        return {
            "ln1_s": ones(L, dt), "ln1_b": zeros(L, dt),
            "q_w": stack(L, dt, dt), "q_b": zeros(L, dt),
            "k_w": stack(L, dt, dt),
            "v_w": stack(L, dt, dt), "v_b": zeros(L, dt),
            "o_w": stack(L, dt, dt), "o_b": zeros(L, dt),
            "ln2_s": ones(L, dt), "ln2_b": zeros(L, dt),
            "cq_w": stack(L, dt, dt), "cq_b": zeros(L, dt),
            "ck_w": stack(L, dt, dt),
            "cv_w": stack(L, dt, dt), "cv_b": zeros(L, dt),
            "co_w": stack(L, dt, dt), "co_b": zeros(L, dt),
            "ln3_s": ones(L, dt), "ln3_b": zeros(L, dt),
            "fc1_w": stack(L, dt, 4 * dt), "fc1_b": zeros(L, 4 * dt),
            "fc2_w": stack(L, 4 * dt, dt), "fc2_b": zeros(L, dt),
        }

    return {
        "encoder": {
            "conv1_w": (rng.standard_normal((3, cfg.n_mels, d)) * (3 * cfg.n_mels) ** -0.5).astype(np.float32),
            "conv1_b": zeros(d),
            "conv2_w": (rng.standard_normal((3, d, d)) * (3 * d) ** -0.5).astype(np.float32),
            "conv2_b": zeros(d),
            "pos": sinusoids(cfg.n_audio_ctx, d),
            "blocks": enc_blocks(cfg.n_audio_layer),
            "ln_post_s": ones(d),
            "ln_post_b": zeros(d),
        },
        "decoder": {
            "tok_emb": (rng.standard_normal((cfg.n_vocab, dt)) * dt ** -0.5).astype(np.float32),
            "pos_emb": (rng.standard_normal((cfg.n_text_ctx, dt)) * 0.01).astype(np.float32),
            "blocks": dec_blocks(cfg.n_text_layer),
            "ln_s": ones(dt),
            "ln_b": zeros(dt),
        },
    }


def param_shapes(cfg: WhisperConfig) -> Dict[str, object]:
    """Leaf shapes of `init_params_np` (JAX layout) without drawing."""
    d, dt = cfg.n_audio_state, cfg.n_text_state
    Le, Ld = cfg.n_audio_layer, cfg.n_text_layer
    enc = {k: (Le, d) for k in ("ln1_s", "ln1_b", "q_b", "v_b", "o_b",
                                "ln2_s", "ln2_b", "fc2_b")}
    enc.update({k: (Le, d, d) for k in ("q_w", "k_w", "v_w", "o_w")})
    enc.update(fc1_w=(Le, d, 4 * d), fc1_b=(Le, 4 * d), fc2_w=(Le, 4 * d, d))
    dec = {k: (Ld, dt) for k in ("ln1_s", "ln1_b", "q_b", "v_b", "o_b", "ln2_s",
                                 "ln2_b", "cq_b", "cv_b", "co_b", "ln3_s",
                                 "ln3_b", "fc2_b")}
    dec.update({k: (Ld, dt, dt) for k in ("q_w", "k_w", "v_w", "o_w", "cq_w",
                                          "ck_w", "cv_w", "co_w")})
    dec.update(fc1_w=(Ld, dt, 4 * dt), fc1_b=(Ld, 4 * dt), fc2_w=(Ld, 4 * dt, dt))
    return {
        "encoder": {
            "conv1_w": (3, cfg.n_mels, d), "conv1_b": (d,),
            "conv2_w": (3, d, d), "conv2_b": (d,),
            "pos": (cfg.n_audio_ctx, d), "blocks": enc,
            "ln_post_s": (d,), "ln_post_b": (d,),
        },
        "decoder": {
            "tok_emb": (cfg.n_vocab, dt), "pos_emb": (cfg.n_text_ctx, dt),
            "blocks": dec, "ln_s": (dt,), "ln_b": (dt,),
        },
    }


def init_params(cfg: WhisperConfig, seed: int = 0, device="cpu",
                dtype=torch.float32) -> Params:
    """`init_params_np` converted to the port's tensors (same values)."""
    from .weights import params_from_jax

    return params_from_jax(init_params_np(cfg, seed), device, dtype)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------

def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 layernorm (biased variance), result in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), s.float(), b.float(), eps).to(x.dtype)


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, Dh]"""
    B, T, D = x.shape
    return x.view(B, T, n_head, D // n_head).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _attn(q, k, v, mask=None, compact_probs=False):
    """q, k, v [B, H, T, Dh] -> [B, H, Tq, Dh]; q and k each scaled by
    Dh^-0.25. Default: f32 logits and softmax. compact_probs keeps the
    [Tq, Tk] logits / probabilities in the value dtype with an f32
    normalizer (the encoder's low-precision path)."""
    scale = q.shape[-1] ** -0.25
    if not compact_probs:
        logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(v.dtype)
    else:
        logits = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
        if mask is not None:
            logits = logits + mask.to(v.dtype)
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        s = e.float().sum(dim=-1, keepdim=True)
        w = (e / s.to(v.dtype)).to(v.dtype)
    return torch.matmul(w, v)


def _layer(blocks: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    """Layer l of the stacked weights (views, no copies)."""
    return {k: t[l] for k, t in blocks.items()}


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> audio states [B, 1500, d]."""
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = _gelu(F.conv1d(x, enc["conv1_w"], padding=1) + enc["conv1_b"][:, None])
    x = _gelu(F.conv1d(x, enc["conv2_w"], stride=2, padding=1) + enc["conv2_b"][:, None])
    x = x.transpose(1, 2) + enc["pos"].to(dtype)
    H = cfg.n_audio_head
    compact = dtype != torch.float32
    blocks = enc["blocks"]
    for l in range(blocks["q_w"].shape[0]):
        blk = _layer(blocks, l)
        h = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q = _heads(h @ blk["q_w"] + blk["q_b"], H)
        k = _heads(h @ blk["k_w"], H)
        v = _heads(h @ blk["v_w"] + blk["v_b"], H)
        x = x + _unheads(_attn(q, k, v, compact_probs=compact)) @ blk["o_w"] + blk["o_b"]
        h = _ln(x, blk["ln2_s"], blk["ln2_b"])
        h = _gelu(h @ blk["fc1_w"] + blk["fc1_b"])
        x = x + h @ blk["fc2_w"] + blk["fc2_b"]
    return _ln(x, enc["ln_post_s"], enc["ln_post_b"])


# --------------------------------------------------------------------------
# Decoder with KV cache
# --------------------------------------------------------------------------

def init_self_cache(cfg: WhisperConfig, batch: int, dtype, device,
                    max_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Fixed-size self-attention KV cache [L, B, H, T, Dh]; `decode_step`
    writes into it in place."""
    L, H, Dh = cfg.n_text_layer, cfg.n_text_head, cfg.head_dim
    T = cfg.n_text_ctx if max_len is None else min(cfg.n_text_ctx, max_len)
    return {"k": torch.zeros((L, batch, H, T, Dh), dtype=dtype, device=device),
            "v": torch.zeros((L, batch, H, T, Dh), dtype=dtype, device=device)}


def cross_kv(params: Params, xa: torch.Tensor, cfg: WhisperConfig,
             quantize: bool = False) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V of every decoder layer, {"k", "v"}
    [L, B, H, Ta, Dh] (K2); with `quantize`, the int8 cache of
    `quantize_cross_cache`."""
    blk = params["decoder"]["blocks"]
    k, v = cross_kv_build(xa, blk["ck_w"], blk["cv_w"], blk["cv_b"], cfg.n_text_head)
    cc = {"k": k, "v": v}
    return quantize_cross_cache(cc) if quantize else cc


def quantize_cross_cache(cc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{"k", "v"} -> the int8 cache {"k8", "ks", "v8", "vs"}: payloads
    [L, B, H, Ta, Dh] int8, per-position f32 scales [L, B, H, Ta]
    (`ops/attn.py::quantize_cross_kv`)."""
    k8, ks, v8, vs = quantize_cross_kv(cc["k"], cc["v"])
    return {"k8": k8, "ks": ks, "v8": v8, "vs": vs}


def _cross_attn(layer: int, q: torch.Tensor, cross: Dict[str, torch.Tensor],
                ta_total: int) -> torch.Tensor:
    """Cross attention of one layer over either cache: K5 over int8, K1
    over bf16."""
    if "k8" in cross:
        return cross_attn_layer_q8(layer, q, cross["k8"], cross["ks"],
                                   cross["v8"], cross["vs"], ta_total)
    return cross_attn_layer(layer, q, cross["k"], cross["v"], ta_total)


def _tail_step(layer: int, x: torch.Tensor, self_out: torch.Tensor,
               blocks: Dict[str, torch.Tensor], cross: Dict[str, torch.Tensor],
               beams: int, cfg: WhisperConfig) -> torch.Tensor:
    """One single-token layer tail: K3 over bf16 weights and cache, K6 when
    the weights (`blocks` from `quantize_tail_weights`) or the cache are
    int8."""
    if "k8" in cross:
        return fused_tail_layer(layer, x, self_out, blocks, cross["k8"], cross["v8"],
                                beams, cfg.n_audio_ctx, cross["ks"], cross["vs"])
    return fused_tail_layer(layer, x, self_out, blocks, cross["k"], cross["v"],
                            beams, cfg.n_audio_ctx)


def _decoder_qkv(x, blk, H):
    h = _ln(x, blk["ln1_s"], blk["ln1_b"])
    q = _heads(h @ blk["q_w"] + blk["q_b"], H)
    k_new = _heads(h @ blk["k_w"], H)
    v_new = _heads(h @ blk["v_w"] + blk["v_b"], H)
    return q, k_new, v_new


def _decoder_layer_tail(x, blk, self_out, cross_cache, layer, beams, cfg):
    """Prompt-pass tail (S > 1): projections in torch on the bf16 weights,
    the cross attention on K1 (K5 over the int8 cache) with beams x
    positions folded into its query axis."""
    H = cfg.n_text_head
    x = x + _unheads(self_out) @ blk["o_w"] + blk["o_b"]
    h = _ln(x, blk["ln2_s"], blk["ln2_b"])
    cq = h @ blk["cq_w"] + blk["cq_b"]  # [N, S, D]
    N, S, D = cq.shape
    q = cq.reshape(N // beams, beams * S, H, D // H)
    a = _cross_attn(layer, q.contiguous(), cross_cache, cfg.n_audio_ctx)
    x = x + a.reshape(N, S, D) @ blk["co_w"] + blk["co_b"]
    h = _ln(x, blk["ln3_s"], blk["ln3_b"])
    h = _gelu(h @ blk["fc1_w"] + blk["fc1_b"])
    return x + h @ blk["fc2_w"] + blk["fc2_b"]


def _vocab_logits(x: torch.Tensor, tok_emb: torch.Tensor) -> torch.Tensor:
    """[N, S, D] -> f32 logits [N, S, V] (f32 accumulation, as in JAX)."""
    return torch.matmul(x.float(), tok_emb.float().t())


def decode_step(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # [N, S] int64
    pos_offset: int,  # buffer slot of tokens[:, 0]
    self_cache: Dict[str, torch.Tensor],
    cross_cache: Dict[str, torch.Tensor],
    beams: int = 1,
    row_pad: Optional[torch.Tensor] = None,  # [N] left pad per row
    logits_at: Optional[Tuple[int, ...]] = None,
    tail_q8: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Run S tokens through the decoder against the fixed-size KV cache,
    which is UPDATED IN PLACE (slots pos_offset .. pos_offset + S - 1 of
    every layer). Returns f32 logits [N, S, V] ([N, len(logits_at), V]).

    `beams > 1`: rows are beam-folded [B * beams] and share their stream's
    cross K/V (`cross_cache` has B rows). `row_pad`: per-row left-padded
    prompts; padded slots are masked and positions shift down by the pad
    (a pad-filler query attends its own slot so its softmax stays finite).
    S == 1 runs each layer tail on K3, or on K6 over the int8 cache or the
    int8 tail weights `tail_q8` (`ops/tail.py::quantize_tail_weights`); the
    prompt pass (S > 1) runs the cross attention on K1 (K5 over the int8
    cache) and its projections on the bf16 weights."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    device = tokens.device
    N, S = tokens.shape
    H = cfg.n_text_head
    Tc = self_cache["k"].shape[-2]

    buf_pos = pos_offset + torch.arange(S, device=device)
    kpos = torch.arange(Tc, device=device)
    neg_inf = torch.tensor(float("-inf"), device=device)
    zero = torch.tensor(0.0, device=device)
    if row_pad is None:
        x = dec["tok_emb"][tokens] + dec["pos_emb"][buf_pos][None].to(dtype)
        mask = torch.where(kpos[None, :] <= buf_pos[:, None], zero, neg_inf)[None, None]
    else:
        pos = torch.clamp(buf_pos[None, :] - row_pad[:, None], min=0)  # [N, S]
        x = dec["tok_emb"][tokens] + dec["pos_emb"][pos].to(dtype)
        qpos = buf_pos[None, :, None]
        kp = kpos[None, None, :]
        valid = (kp <= qpos) & ((kp >= row_pad[:, None, None]) | (kp == qpos))
        mask = torch.where(valid, zero, neg_inf)[:, None]  # [N, 1, S, Tc]

    kc, vc = self_cache["k"], self_cache["v"]
    blocks = dec["blocks"]
    tail_blocks = blocks if tail_q8 is None else tail_q8
    for l in range(cfg.n_text_layer):
        blk = _layer(blocks, l)
        q, k_new, v_new = _decoder_qkv(x, blk, H)
        # in-place K/V cache update (JAX: dynamic_update_slice on a copy)
        kc[l, :, :, pos_offset:pos_offset + S] = k_new
        vc[l, :, :, pos_offset:pos_offset + S] = v_new
        self_out = _attn(q, kc[l], vc[l], mask)
        if S == 1:
            x = _tail_step(l, x, self_out.contiguous(), tail_blocks, cross_cache,
                           beams, cfg)
        else:
            x = _decoder_layer_tail(x, blk, self_out, cross_cache, l, beams, cfg)
    if logits_at is not None:
        x = torch.cat([x[:, p:p + 1] for p in logits_at], dim=1)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _vocab_logits(x, dec["tok_emb"])


def decode_step_split(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # [N, 1] int64, N = B * beams
    step: int,  # decode slot being written (0-based)
    prompt_cache: Dict[str, torch.Tensor],  # {"k","v": [L, B, H, Tp, Dh]}
    decode_cache: Dict[str, torch.Tensor],  # {"k","v": [L, N, H, Td, Dh]}
    cross_cache: Dict[str, torch.Tensor],  # {"k","v": [L, B, H, Ta, Dh]}
    prompt_len: int,  # prompt buffer slots (= the prompt's length P)
    beams: int,
    row_pad: Optional[torch.Tensor],  # [N] left pad per row (constant per stream)
    anc: torch.Tensor,  # [N, Td] ancestry: row holding beam n's slot-t K/V
) -> torch.Tensor:
    """One beam step against the SPLIT self-cache -> f32 logits [N, 1, V].

    The prompt half was prefilled once per stream and is shared by its
    beams; the decode half is never permuted: `anc[n, t]` names the row that
    holds beam n's slot t (callers keep `anc = anc[new_src]; anc[:, step] =
    arange(N)`). Each layer writes this step's K/V into slot `step` of the
    decode cache IN PLACE, attends both halves on K4 and runs its tail on K3
    (K6 over an int8 cache) with the beams folded against the B-row cross
    K/V."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    N = tokens.shape[0]
    B = N // beams
    H, Dh = cfg.n_text_head, cfg.head_dim
    Td = decode_cache["k"].shape[-2]
    if row_pad is None:
        row_pad = torch.zeros((N,), dtype=torch.long, device=tokens.device)
    emb_pos = torch.clamp(prompt_len + step - row_pad, min=0)  # [N]
    x = dec["tok_emb"][tokens] + dec["pos_emb"][emb_pos][:, None, :].to(dtype)
    row_pad_b = row_pad.view(B, beams)[:, 0].to(torch.int32)
    anc_j = (anc % beams).view(B, beams, Td).to(torch.int32)

    pk, pv = prompt_cache["k"], prompt_cache["v"]
    dk, dv = decode_cache["k"], decode_cache["v"]
    blocks = dec["blocks"]
    for l in range(cfg.n_text_layer):
        q, k_new, v_new = _decoder_qkv(x, _layer(blocks, l), H)  # [N, H, 1, Dh]
        # in-place decode-cache update (JAX: dynamic_update_slice on a copy)
        dk[l, :, :, step] = k_new[:, :, 0]
        dv[l, :, :, step] = v_new[:, :, 0]
        self_out = split_self_attn_layer(
            l, q.reshape(B, beams, H, Dh).contiguous(), pk, pv, dk, dv, anc_j,
            step, row_pad_b, prompt_len)
        x = _tail_step(l, x, self_out.reshape(N, H, 1, Dh), blocks, cross_cache,
                       beams, cfg)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _vocab_logits(x, dec["tok_emb"])


def alignment_cross_attn(
    params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
    xa: torch.Tensor, heads: List[Tuple[int, int]],
) -> torch.Tensor:
    """Teacher-forced pass capturing the scaled QK logits (pre-softmax) of
    the DTW alignment heads only -> [B, K, S, Ta] f32."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    B, S = tokens.shape
    H, Dh = cfg.n_text_head, cfg.head_dim
    device = tokens.device
    by_layer: Dict[int, List[int]] = {}
    for (l, h) in heads:
        by_layer.setdefault(l, []).append(h)

    x = dec["tok_emb"][tokens] + dec["pos_emb"][:S][None].to(dtype)
    ar = torch.arange(S, device=device)
    causal = torch.where(ar[None, :] <= ar[:, None], torch.tensor(0.0, device=device),
                         torch.tensor(float("-inf"), device=device))
    captured: Dict[Tuple[int, int], torch.Tensor] = {}
    blocks = dec["blocks"]
    for l in range(cfg.n_text_layer):
        blk = _layer(blocks, l)
        h_ = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q = _heads(h_ @ blk["q_w"] + blk["q_b"], H)
        k = _heads(h_ @ blk["k_w"], H)
        v = _heads(h_ @ blk["v_w"] + blk["v_b"], H)
        x = x + _unheads(_attn(q, k, v, causal[None, None])) @ blk["o_w"] + blk["o_b"]
        h_ = _ln(x, blk["ln2_s"], blk["ln2_b"])
        cq = _heads(h_ @ blk["cq_w"] + blk["cq_b"], H)
        ck = _heads(xa @ blk["ck_w"], H)
        cv = _heads(xa @ blk["cv_w"] + blk["cv_b"], H)
        if l in by_layer:
            scale = Dh ** -0.25
            logits = torch.matmul((cq * scale).float(), (ck * scale).float().transpose(-1, -2))
            for hd in by_layer[l]:
                captured[(l, hd)] = logits[:, hd]
        x = x + _unheads(_attn(cq, ck, cv)) @ blk["co_w"] + blk["co_b"]
        h_ = _ln(x, blk["ln3_s"], blk["ln3_b"])
        h_ = _gelu(h_ @ blk["fc1_w"] + blk["fc1_b"])
        x = x + h_ @ blk["fc2_w"] + blk["fc2_b"]
        if l >= max(by_layer):
            break  # nothing after the last captured layer is read
    return torch.stack([captured[lh] for lh in heads], dim=1)


def detect_language_logits(params: Params, cfg: WhisperConfig,
                           xa: torch.Tensor, sot_id: int,
                           cross: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One decoder step from <|startoftranscript|> -> [B, V] f32 logits;
    `cross` is the bf16 cross K/V of `xa` when the caller already built it.
    Always on the exact (bf16) cache and weights, as the JAX package
    detects language: int8 could flip a near-tie language."""
    if cross is not None and "k8" in cross:
        raise ValueError("detect_language_logits reads the bf16 cross cache, "
                         "not the int8 one")
    B = xa.shape[0]
    tokens = torch.full((B, 1), sot_id, dtype=torch.long, device=xa.device)
    cache = init_self_cache(cfg, B, xa.dtype, xa.device, max_len=16)
    if cross is None:
        cross = cross_kv(params, xa, cfg)
    logits = decode_step(params, cfg, tokens, 0, cache, cross)
    return logits[:, 0]
