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

Meshes (`parallel/mesh.py`): every forward takes the rank's `mesh` (None:
one device) and reads its head count from its weights, so a rank holding a
head slice runs the same code on its local heads; the row-parallel products
(o, co, fc2) are all-reduced over the model group before their replicated
bias, the embedding is looked up vocab-parallel and the logits all-gathered.
Under a head split (n_model > 1) the single-token step runs the un-fused
tail (K1 / K5 at Q = beams, its products in torch), not K3 / K6 / K8, whose
GEMMs contract the whole feature axis; a rank with whole layers keeps them.
`decoder_forward_nocache` is the teacher-forced pass of training (plain
`_attn`, no kernel), differentiable through the mesh's collectives.

Speculative decoding: `decode_step_pos` is `decode_step` with a base
position per row (a scatter into the cache, per-row position embeddings
and causal mask); S == 1 runs its tails on K3 / K6, S > 1 (the verify pass)
on K1 / K5 at Q = S.

The all-fused greedy path: `encode(..., flash=True)` runs the encoder's
self-attention on K10 (`ops/encoder_attn.py::encoder_self_attention`, single
pass, as the JAX `make_encode(cfg, "flash-custom")` does), and a "front"
pack on the decoder params (`ops/front.py::pack_front_weights`) runs every
single-token step of `decode_step` through K8 (ln1, q/k/v, self-attention
and the cache write); beam steps (`decode_step_split`) never take it. On
f32 params both run the kernels' f32 forms.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import encoder_attn
from ..ops.attn import (as_device_int, cross_attn_layer, cross_attn_layer_q8, cross_kv_build,
                        quantize_cross_kv, split_self_attn_layer)
from ..ops.front import fused_front_layer
from ..ops.tail import fused_tail_layer
from ..parallel.mesh import (copy_to_model, gather_from_model, model_parallel,
                             reduce_from_model, vocab_embed)

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


def _n_heads(w: torch.Tensor, cfg: WhisperConfig) -> int:
    """Heads of a q / k / v weight [..., in, H * Dh]: this rank's under a
    head split."""
    return w.shape[-1] // cfg.head_dim


def local_heads(params: Params, cfg: WhisperConfig) -> int:
    """The decoder heads `params` hold (all of them on one device)."""
    return _n_heads(params["decoder"]["blocks"]["q_w"], cfg)


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
           flash: bool = False, attn: Optional[Callable] = None,
           mesh=None) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> audio states [B, 1500, d]. Every layer's
    self-attention is the plain `_attn` (compact probabilities in low
    precision), or with `flash` K10 in its single-pass form, or `attn(q, k,
    v)` where given (the encoder attention tool's modes); over the rank's
    heads under a mesh."""
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = _gelu(F.conv1d(x, enc["conv1_w"], padding=1) + enc["conv1_b"][:, None])
    x = _gelu(F.conv1d(x, enc["conv2_w"], stride=2, padding=1) + enc["conv2_b"][:, None])
    x = x.transpose(1, 2) + enc["pos"].to(dtype)
    compact = dtype != torch.float32
    blocks = enc["blocks"]
    H = _n_heads(blocks["q_w"], cfg)
    for l in range(blocks["q_w"].shape[0]):
        blk = _layer(blocks, l)
        h = copy_to_model(_ln(x, blk["ln1_s"], blk["ln1_b"]), mesh)
        q = _heads(h @ blk["q_w"] + blk["q_b"], H)
        k = _heads(h @ blk["k_w"], H)
        v = _heads(h @ blk["v_w"] + blk["v_b"], H)
        if attn is not None:
            a = attn(q, k, v)
        elif flash:
            a = encoder_attn.encoder_self_attention(q, k, v)
        else:
            a = _attn(q, k, v, compact_probs=compact)
        x = x + reduce_from_model(_unheads(a) @ blk["o_w"], mesh) + blk["o_b"]
        x = _mlp(x, blk, mesh)
    return _ln(x, enc["ln_post_s"], enc["ln_post_b"])


def _mlp(x: torch.Tensor, blk: Dict[str, torch.Tensor], mesh,
         ln: str = "ln2") -> torch.Tensor:
    """x + fc2(gelu(fc1(ln(x)))): fc1 column-parallel, fc2 row-parallel."""
    h = copy_to_model(_ln(x, blk[f"{ln}_s"], blk[f"{ln}_b"]), mesh)
    h = _gelu(h @ blk["fc1_w"] + blk["fc1_b"])
    return x + reduce_from_model(h @ blk["fc2_w"], mesh) + blk["fc2_b"]


# --------------------------------------------------------------------------
# Decoder with KV cache
# --------------------------------------------------------------------------

def init_self_cache(cfg: WhisperConfig, batch: int, dtype, device,
                    max_len: Optional[int] = None,
                    n_head: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Fixed-size self-attention KV cache [L, B, H, T, Dh] (H: `n_head`, the
    rank's heads, else all); `decode_step` writes into it in place."""
    L, Dh = cfg.n_text_layer, cfg.head_dim
    H = cfg.n_text_head if n_head is None else n_head
    T = cfg.n_text_ctx if max_len is None else min(cfg.n_text_ctx, max_len)
    return {"k": torch.zeros((L, batch, H, T, Dh), dtype=dtype, device=device),
            "v": torch.zeros((L, batch, H, T, Dh), dtype=dtype, device=device)}


def cross_kv(params: Params, xa: torch.Tensor, cfg: WhisperConfig,
             quantize: bool = False,
             out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V of every decoder layer, {"k", "v"}
    [L, B, H, Ta, Dh] (K2, over the heads `params` hold); with `quantize`,
    the int8 cache of `quantize_cross_cache`. `out`: the cache's tensors to
    write (bf16 {"k", "v"}, or int8 {"k8", "ks", "v8", "vs"} with
    `quantize`), returned."""
    blk = params["decoder"]["blocks"]
    bf16_out = None if quantize or out is None else (out["k"], out["v"])
    k, v = cross_kv_build(xa, blk["ck_w"], blk["cv_w"], blk["cv_b"],
                          _n_heads(blk["ck_w"], cfg), out=bf16_out)
    cc = {"k": k, "v": v}
    return quantize_cross_cache(cc, out=out) if quantize else cc


def quantize_cross_cache(cc: Dict[str, torch.Tensor],
                         out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """{"k", "v"} -> the int8 cache {"k8", "ks", "v8", "vs"}: payloads
    [L, B, H, Ta, Dh] int8, per-position f32 scales [L, B, H, Ta]
    (`ops/attn.py::quantize_cross_kv`), written into `out`'s tensors where
    given."""
    names = ("k8", "ks", "v8", "vs")
    k8, ks, v8, vs = quantize_cross_kv(
        cc["k"], cc["v"], out=None if out is None else tuple(out[n] for n in names))
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


def _decoder_qkv(x, blk, H, mesh=None):
    h = copy_to_model(_ln(x, blk["ln1_s"], blk["ln1_b"]), mesh)
    q = _heads(h @ blk["q_w"] + blk["q_b"], H)
    k_new = _heads(h @ blk["k_w"], H)
    v_new = _heads(h @ blk["v_w"] + blk["v_b"], H)
    return q, k_new, v_new


def _decoder_layer_tail(x, blk, self_out, cross_cache, layer, beams, cfg, mesh=None):
    """Un-fused layer tail: the prompt pass (S > 1), and every step under a
    head split. Projections in torch, the cross attention on K1 (K5 over
    the int8 cache) with beams x positions folded into its query axis, over
    the heads of `self_out` [N, H, S, Dh]."""
    H = self_out.shape[1]
    x = x + reduce_from_model(_unheads(self_out) @ blk["o_w"], mesh) + blk["o_b"]
    h = copy_to_model(_ln(x, blk["ln2_s"], blk["ln2_b"]), mesh)
    cq = h @ blk["cq_w"] + blk["cq_b"]  # [N, S, H Dh]
    N, S, D = cq.shape
    q = cq.reshape(N // beams, beams * S, H, D // H)
    a = _cross_attn(layer, q.contiguous(), cross_cache, cfg.n_audio_ctx)
    x = x + reduce_from_model(a.reshape(N, S, D) @ blk["co_w"], mesh) + blk["co_b"]
    return _mlp(x, blk, mesh, "ln3")


def _vocab_logits(x: torch.Tensor, tok_emb: torch.Tensor, mesh=None) -> torch.Tensor:
    """[N, S, D] -> f32 logits [N, S, V] (f32 accumulation, as in JAX);
    over vocab-sharded rows, each rank's columns all-gathered."""
    return gather_from_model(
        torch.matmul(copy_to_model(x.float(), mesh), tok_emb.float().t()), mesh)


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
    mesh=None,
) -> torch.Tensor:
    """Run S tokens through the decoder against the fixed-size KV cache,
    which is UPDATED IN PLACE (slots pos_offset .. pos_offset + S - 1 of
    every layer). Returns f32 logits [N, S, V] ([N, len(logits_at), V]).

    `beams > 1`: rows are beam-folded [B * beams] and share their stream's
    cross K/V (`cross_cache` has B rows). `row_pad`: per-row left-padded
    prompts; padded slots are masked and positions shift down by the pad
    (a pad-filler query attends its own slot so its softmax stays finite).
    S == 1 runs each layer tail on K3, or on K6 over the int8 cache or the
    int8 tail weights `tail_q8` (`ops/tail.py::quantize_tail_weights`), and,
    when `params["decoder"]` carries a "front" pack, each layer's front on
    K8 (whatever `beams`: the rows' self caches are their own); the prompt
    pass (S > 1) runs the cross attention on K1 (K5 over the int8 cache) and
    its projections on the bf16 weights. Under a head split (`mesh` with
    n_model > 1) every step runs the prompt pass's un-fused tail and no
    front; `tail_q8` is refused there."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    device = tokens.device
    N, S = tokens.shape
    H = local_heads(params, cfg)
    Tc = self_cache["k"].shape[-2]
    split = model_parallel(mesh)
    if split and tail_q8 is not None:
        raise ValueError("int8 tail weights run on K6, which takes whole layers: "
                         "not under a head split")
    emb = vocab_embed(dec["tok_emb"], tokens, mesh)

    buf_pos = pos_offset + torch.arange(S, device=device)
    kpos = torch.arange(Tc, device=device)
    neg_inf = torch.tensor(float("-inf"), device=device)
    zero = torch.tensor(0.0, device=device)
    if row_pad is None:
        x = emb + dec["pos_emb"][buf_pos][None].to(dtype)
        mask = torch.where(kpos[None, :] <= buf_pos[:, None], zero, neg_inf)[None, None]
    else:
        pos = torch.clamp(buf_pos[None, :] - row_pad[:, None], min=0)  # [N, S]
        x = emb + dec["pos_emb"][pos].to(dtype)
        qpos = buf_pos[None, :, None]
        kp = kpos[None, None, :]
        valid = (kp <= qpos) & ((kp >= row_pad[:, None, None]) | (kp == qpos))
        mask = torch.where(valid, zero, neg_inf)[:, None]  # [N, 1, S, Tc]

    kc, vc = self_cache["k"], self_cache["v"]
    blocks = dec["blocks"]
    tail_blocks = blocks if tail_q8 is None else tail_q8
    front = dec.get("front") if S == 1 and not split else None
    if front is not None:  # K8's row pads, converted once for every layer
        front_rp = (torch.zeros((N,), dtype=torch.int32, device=device) if row_pad is None
                    else row_pad.to(torch.int32))
    for l in range(cfg.n_text_layer):
        blk = _layer(blocks, l)
        if front is not None:  # K8 writes the cache slot itself
            self_out = fused_front_layer(l, pos_offset, front_rp, x, front, kc, vc)[0]
        else:
            q, k_new, v_new = _decoder_qkv(x, blk, H, mesh)
            # in-place K/V cache update (JAX: dynamic_update_slice on a copy)
            kc[l, :, :, pos_offset:pos_offset + S] = k_new
            vc[l, :, :, pos_offset:pos_offset + S] = v_new
            self_out = _attn(q, kc[l], vc[l], mask)
        if S == 1 and not split:
            x = _tail_step(l, x, self_out.contiguous(), tail_blocks, cross_cache,
                           beams, cfg)
        else:
            x = _decoder_layer_tail(x, blk, self_out, cross_cache, l, beams, cfg, mesh)
    if logits_at is not None:
        x = torch.cat([x[:, p:p + 1] for p in logits_at], dim=1)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _vocab_logits(x, dec["tok_emb"], mesh)


def decode_step_pos(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # [B, S] int64
    pos0: torch.Tensor,  # [B] buffer slot of tokens[:, 0], PER ROW
    self_cache: Dict[str, torch.Tensor],
    cross_cache: Dict[str, torch.Tensor],
    mesh=None,
) -> torch.Tensor:
    """`decode_step` with per-row base positions (speculative decoding):
    row b's S tokens take slots pos0[b] .. pos0[b] + S - 1 of the cache,
    which is UPDATED IN PLACE by a scatter; position embeddings and the
    causal mask (kpos <= qpos) are per row. Slots are clamped to Tc - 1:
    finished rows keep being fed in lockstep and their writes land in the
    last slot, which no live row reads. Stale K/V of rejected proposals
    past a row's position is hidden by the mask and overwritten later.

    S == 1 runs each layer tail on K3 (K6 over the int8 cache), S > 1 on
    `_decoder_layer_tail`, whose cross attention is K1 (K5 over
    int8) at Q = S (every S under a head split). With a constant pos0 this
    equals `decode_step`. Returns f32 logits [B, S, V]."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    device = tokens.device
    B, S = tokens.shape
    H = local_heads(params, cfg)
    Tc = self_cache["k"].shape[-2]
    split = model_parallel(mesh)

    qpos = torch.clamp(pos0[:, None] + torch.arange(S, device=device)[None, :], max=Tc - 1)
    x = vocab_embed(dec["tok_emb"], tokens, mesh) + dec["pos_emb"][
        torch.clamp(qpos, max=cfg.n_text_ctx - 1)].to(dtype)
    kpos = torch.arange(Tc, device=device)
    mask = torch.where(kpos[None, None, :] <= qpos[:, :, None],
                       torch.tensor(0.0, device=device),
                       torch.tensor(float("-inf"), device=device))[:, None]  # [B, 1, S, Tc]
    b_idx = torch.arange(B, device=device)[:, None]  # [B, 1] against qpos [B, S]

    kc, vc = self_cache["k"], self_cache["v"]
    blocks = dec["blocks"]
    for l in range(cfg.n_text_layer):
        blk = _layer(blocks, l)
        q, k_new, v_new = _decoder_qkv(x, blk, H, mesh)  # [B, H, S, Dh]
        # numpy's mixed-index rule: the advanced (b, t) pairs come first, so
        # the slots take [B, S, H, Dh]; a plain put (repeated clamped slots
        # are never read)
        kc[l][b_idx, :, qpos] = k_new.transpose(1, 2)
        vc[l][b_idx, :, qpos] = v_new.transpose(1, 2)
        self_out = _attn(q, kc[l], vc[l], mask)
        if S == 1 and not split:
            x = _tail_step(l, x, self_out.contiguous(), blocks, cross_cache, 1, cfg)
        else:
            x = _decoder_layer_tail(x, blk, self_out, cross_cache, l, 1, cfg, mesh)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _vocab_logits(x, dec["tok_emb"], mesh)


def decode_step_split(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # [N, 1] int64, N = B * beams
    step: Union[int, torch.Tensor],  # decode slot being written (0-based)
    prompt_cache: Dict[str, torch.Tensor],  # {"k","v": [L, B, H, Tp, Dh]}
    decode_cache: Dict[str, torch.Tensor],  # {"k","v": [L, N, H, Td, Dh]}
    cross_cache: Dict[str, torch.Tensor],  # {"k","v": [L, B, H, Ta, Dh]}
    prompt_len: Union[int, torch.Tensor],  # the prompt's length P (<= Tp)
    beams: int,
    row_pad: Optional[torch.Tensor],  # [N] left pad per row (constant per stream)
    anc: torch.Tensor,  # [N, Td] ancestry: row holding beam n's slot-t K/V
    mesh=None,
) -> torch.Tensor:
    """One beam step against the SPLIT self-cache -> f32 logits [N, 1, V].

    The prompt half was prefilled once per stream and is shared by its
    beams; the decode half is never permuted: `anc[n, t]` names the row that
    holds beam n's slot t (callers keep `anc = anc[new_src]; anc[:, step] =
    arange(N)`). Each layer writes this step's K/V into slot `step` of the
    decode cache IN PLACE, attends both halves on K4 and runs its tail on K3
    (K6 over an int8 cache) with the beams folded against the B-row cross
    K/V; under a head split K4 over the rank's heads and the un-fused tail
    (K1 / K5 at Q = beams).

    `step` and `prompt_len` are ints or one-element integer tensors on the
    device, where the position, the slot writes and K4 read them: no launch
    depends on their values, so one captured CUDA graph of this call serves
    every step and prompt length (`ops/beam_graph.py`). The loops pass
    tensors; an int costs a fill a call."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    N = tokens.shape[0]
    B = N // beams
    H, Dh = local_heads(params, cfg), cfg.head_dim
    Td = decode_cache["k"].shape[-2]
    split = model_parallel(mesh)
    if row_pad is None:
        row_pad = torch.zeros((N,), dtype=torch.long, device=tokens.device)
    step = as_device_int("decode_step_split", tokens.device, step)
    prompt_len = as_device_int("decode_step_split", tokens.device, prompt_len)
    slot = step.long()  # the slot the writes take
    emb_pos = torch.clamp(prompt_len + slot - row_pad, min=0)  # [N]
    x = vocab_embed(dec["tok_emb"], tokens, mesh) + dec["pos_emb"][emb_pos][:, None, :].to(dtype)
    row_pad_b = row_pad.view(B, beams)[:, 0].to(torch.int32)
    anc_j = (anc % beams).view(B, beams, Td).to(torch.int32)

    pk, pv = prompt_cache["k"], prompt_cache["v"]
    dk, dv = decode_cache["k"], decode_cache["v"]
    blocks = dec["blocks"]
    for l in range(cfg.n_text_layer):
        blk = _layer(blocks, l)
        q, k_new, v_new = _decoder_qkv(x, blk, H, mesh)  # [N, H, 1, Dh]
        # in-place decode-cache update (JAX: dynamic_update_slice on a copy)
        dk[l].index_copy_(2, slot, k_new)
        dv[l].index_copy_(2, slot, v_new)
        self_out = split_self_attn_layer(
            l, q.reshape(B, beams, H, Dh).contiguous(), pk, pv, dk, dv, anc_j,
            step, row_pad_b, prompt_len)
        self_out = self_out.reshape(N, H, 1, Dh)
        if split:
            x = _decoder_layer_tail(x, blk, self_out, cross_cache, l, beams, cfg, mesh)
        else:
            x = _tail_step(l, x, self_out, blocks, cross_cache, beams, cfg)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _vocab_logits(x, dec["tok_emb"], mesh)


def alignment_cross_attn(
    params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
    xa: torch.Tensor, heads: List[Tuple[int, int]], mesh=None,
) -> torch.Tensor:
    """Teacher-forced pass capturing the scaled QK logits (pre-softmax) of
    the DTW alignment heads only -> [B, K, S, Ta] f32. Under a head split
    each head's logits come from the rank that holds it: a layer's selected
    heads, zero on the other ranks, are summed over the model group."""
    H, Dh = local_heads(params, cfg), cfg.head_dim
    h0 = mesh.model_rank * H if model_parallel(mesh) else 0
    by_layer: Dict[int, List[int]] = {}
    for (l, h) in heads:
        by_layer.setdefault(l, []).append(h)

    captured: Dict[Tuple[int, int], torch.Tensor] = {}

    def capture(l, cq, ck):
        if l not in by_layer:
            return
        scale = Dh ** -0.25
        logits = torch.matmul((cq * scale).float(), (ck * scale).float().transpose(-1, -2))
        sel = torch.stack([logits[:, hd - h0] if h0 <= hd < h0 + H
                           else torch.zeros_like(logits[:, 0]) for hd in by_layer[l]], 1)
        sel = reduce_from_model(sel, mesh)
        for i, hd in enumerate(by_layer[l]):
            captured[(l, hd)] = sel[:, i]

    _teacher_forced(params, cfg, tokens, xa, mesh, capture, max(by_layer))
    return torch.stack([captured[lh] for lh in heads], dim=1)


def _teacher_forced(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                    xa: torch.Tensor, mesh, on_cross=None,
                    last_layer: Optional[int] = None) -> torch.Tensor:
    """The decoder without a cache over [B, S] tokens and the audio states
    xa (plain `_attn`, causal self-attention) -> the final layer's states
    [B, S, D] before the last layer norm. `on_cross(l, cq, ck)` is called
    with each layer's cross-attention queries and keys; the pass stops
    after layer `last_layer` where given."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    S = tokens.shape[1]
    H = local_heads(params, cfg)
    device = tokens.device
    x = vocab_embed(dec["tok_emb"], tokens, mesh) + dec["pos_emb"][:S][None].to(dtype)
    ar = torch.arange(S, device=device)
    causal = torch.where(ar[None, :] <= ar[:, None], torch.tensor(0.0, device=device),
                         torch.tensor(float("-inf"), device=device))
    xa = copy_to_model(xa, mesh)
    blocks = dec["blocks"]
    for l in range(cfg.n_text_layer):
        blk = _layer(blocks, l)
        q, k, v = _decoder_qkv(x, blk, H, mesh)
        x = x + reduce_from_model(_unheads(_attn(q, k, v, causal[None, None])) @ blk["o_w"],
                                  mesh) + blk["o_b"]
        h_ = copy_to_model(_ln(x, blk["ln2_s"], blk["ln2_b"]), mesh)
        cq = _heads(h_ @ blk["cq_w"] + blk["cq_b"], H)
        ck = _heads(xa @ blk["ck_w"], H)
        cv = _heads(xa @ blk["cv_w"] + blk["cv_b"], H)
        if on_cross is not None:
            on_cross(l, cq, ck)
        x = x + reduce_from_model(_unheads(_attn(cq, ck, cv)) @ blk["co_w"], mesh) + blk["co_b"]
        x = _mlp(x, blk, mesh, "ln3")
        if last_layer is not None and l >= last_layer:
            break  # nothing after the last captured layer is read
    return x


def decoder_forward_nocache(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                            xa: torch.Tensor, mesh=None) -> torch.Tensor:
    """Teacher-forced decoder pass without a cache (training / scoring):
    tokens [B, S], audio states xa [B, Ta, D] -> f32 logits [B, S, V]."""
    dec = params["decoder"]
    x = _teacher_forced(params, cfg, tokens, xa, mesh)
    return _vocab_logits(_ln(x, dec["ln_s"], dec["ln_b"]), dec["tok_emb"], mesh)


def detect_language_logits(params: Params, cfg: WhisperConfig,
                           xa: torch.Tensor, sot_id: int,
                           cross: Optional[Dict[str, torch.Tensor]] = None,
                           mesh=None) -> torch.Tensor:
    """One decoder step from <|startoftranscript|> -> [B, V] f32 logits;
    `cross` is the bf16 cross K/V of `xa` when the caller already built it.
    Always on the exact (bf16) cache and weights, as the JAX package
    detects language: int8 could flip a near-tie language."""
    if cross is not None and "k8" in cross:
        raise ValueError("detect_language_logits reads the bf16 cross cache, "
                         "not the int8 one")
    B = xa.shape[0]
    tokens = torch.full((B, 1), sot_id, dtype=torch.long, device=xa.device)
    cache = init_self_cache(cfg, B, xa.dtype, xa.device, max_len=16,
                            n_head=local_heads(params, cfg))
    if cross is None:
        cross = cross_kv(params, xa, cfg)
    logits = decode_step(params, cfg, tokens, 0, cache, cross, mesh=mesh)
    return logits[:, 0]
