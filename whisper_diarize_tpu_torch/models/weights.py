"""Checkpoint I/O for the port (counterpart of
`whisper_diarize_tpu/models/weights.py`).

* `params_from_jax` — the weight bridge: the JAX package's parameter tree
  (numpy arrays, or tensors in that layout) -> the port's tensors on one
  device. The stacked `[L, ...]` axis and the `[in, out]` linear layout
  stay; the conv stem's `WIO` kernels become torch's `[out, in, k]`.
* `load_model` — a snapshot directory (`config.json` + `model.safetensors`),
  in the native layout (`_flatten` keys, as `save_params` writes) or the HF
  transformers layout, onto CUDA device 0 unless given a device.
* `init_params_fast` — the deterministic `arange % 1009` pattern of the JAX
  package's `init_params_fast`, filled on the device.
* `tail_q8_from_jax` — the JAX package's int8 tail pack
  (`pack_tail_weights(quantize=True)`) -> the port's int8 tail weights
  (`ops/tail.py::quantize_tail_weights` layout), so both sides hold the
  same bytes.
* `front_from_jax` — the JAX package's greedy front pack
  (`tools/pallas_front.py::pack_front_weights`) -> the port's front
  (`ops/front.py::pack_front_weights` layout), payloads unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..utils import default_device
from . import whisper as wm

# conv stem leaves stored "WIO" [k, in, out] in JAX, [out, in, k] in torch
_CONV_LEAVES = ("conv1_w", "conv2_w")


def params_from_jax(tree: Dict[str, Any], device, dtype) -> Dict[str, Any]:
    """JAX-layout parameter tree -> port tensors (every leaf cast to dtype)."""

    def conv(name: str, leaf) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(leaf)) if not isinstance(leaf, torch.Tensor) else leaf
        if name in _CONV_LEAVES:
            t = t.permute(2, 1, 0)
        return t.to(device=device, dtype=dtype).contiguous()

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else conv(k, v)
                for k, v in node.items()}

    return walk(tree)


def hf_config_to_whisper_config(cfg: Dict[str, Any]) -> wm.WhisperConfig:
    """Map an HF WhisperConfig dict to WhisperConfig."""
    vocab = int(cfg.get("vocab_size", 51865))
    return wm.WhisperConfig(
        n_mels=int(cfg.get("num_mel_bins", 80)),
        n_vocab=vocab,
        n_audio_ctx=int(cfg.get("max_source_positions", 1500)),
        n_audio_state=int(cfg.get("d_model", 512)),
        n_audio_head=int(cfg.get("encoder_attention_heads", 8)),
        n_audio_layer=int(cfg.get("encoder_layers", 6)),
        n_text_ctx=int(cfg.get("max_target_positions", 448)),
        n_text_state=int(cfg.get("d_model", 512)),
        n_text_head=int(cfg.get("decoder_attention_heads", 8)),
        n_text_layer=int(cfg.get("decoder_layers", 6)),
        multilingual=vocab != 51864,
        num_languages=100 if vocab == 51866 else 99,
    )


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        cur = out
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def convert_hf_params(flat: Dict[str, np.ndarray], cfg: wm.WhisperConfig) -> Dict[str, Any]:
    """HF transformers whisper tensors -> the JAX-layout numpy tree
    (linears [out, in] -> [in, out], layers stacked, conv -> WIO)."""

    def g(name):
        return np.asarray(flat[name])

    def lin_w(name):
        return g(name).T

    def stack(fmt, L, f):
        return np.stack([f(fmt.format(i=i)) for i in range(L)])

    Le, Ld = cfg.n_audio_layer, cfg.n_text_layer
    e, d = "model.encoder.layers.{i}.", "model.decoder.layers.{i}."
    attn = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}

    def blocks(pre, L, lns, attns):
        out = {}
        for ours, theirs in lns.items():
            out[ours + "_s"] = stack(pre + theirs + ".weight", L, g)
            out[ours + "_b"] = stack(pre + theirs + ".bias", L, g)
        for prefix, (module, keys) in attns.items():
            for key in keys:
                out[f"{prefix}{key}_w"] = stack(
                    f"{pre}{module}.{attn[key]}.weight", L, lin_w)
                if key != "k":
                    out[f"{prefix}{key}_b"] = stack(
                        f"{pre}{module}.{attn[key]}.bias", L, g)
        for fc in ("fc1", "fc2"):
            out[fc + "_w"] = stack(pre + fc + ".weight", L, lin_w)
            out[fc + "_b"] = stack(pre + fc + ".bias", L, g)
        return out

    qkvo = ("q", "k", "v", "o")
    enc_blocks = blocks(e, Le, {"ln1": "self_attn_layer_norm", "ln2": "final_layer_norm"},
                        {"": ("self_attn", qkvo)})
    dec_blocks = blocks(d, Ld, {"ln1": "self_attn_layer_norm",
                                "ln2": "encoder_attn_layer_norm",
                                "ln3": "final_layer_norm"},
                        {"": ("self_attn", qkvo), "c": ("encoder_attn", qkvo)})
    return {
        "encoder": {
            "conv1_w": g("model.encoder.conv1.weight").transpose(2, 1, 0),
            "conv1_b": g("model.encoder.conv1.bias"),
            "conv2_w": g("model.encoder.conv2.weight").transpose(2, 1, 0),
            "conv2_b": g("model.encoder.conv2.bias"),
            "pos": g("model.encoder.embed_positions.weight"),
            "blocks": enc_blocks,
            "ln_post_s": g("model.encoder.layer_norm.weight"),
            "ln_post_b": g("model.encoder.layer_norm.bias"),
        },
        "decoder": {
            "tok_emb": g("model.decoder.embed_tokens.weight"),
            "pos_emb": g("model.decoder.embed_positions.weight"),
            "blocks": dec_blocks,
            "ln_s": g("model.decoder.layer_norm.weight"),
            "ln_b": g("model.decoder.layer_norm.bias"),
        },
    }


def load_model(model_dir, device=None, dtype=torch.float32
               ) -> Tuple[Dict[str, Any], wm.WhisperConfig]:
    """(params, config) from a snapshot directory (native or HF layout), on
    `device`: CUDA device 0 unless given one (raises without a card)."""
    from safetensors.numpy import load_file

    device = default_device(device, "load_model")
    d = Path(model_dir)
    cfg_dict = json.loads((d / "config.json").read_text())
    cfg = hf_config_to_whisper_config(cfg_dict)
    flat = load_file(str(d / "model.safetensors"))
    if cfg_dict.get("wdt_native") or any(k.startswith("encoder.") for k in flat):
        tree = _unflatten(dict(flat))
    else:
        tree = convert_hf_params(flat, cfg)
    return params_from_jax(tree, device, dtype), cfg


def init_params_fast(cfg: wm.WhisperConfig, device, dtype, scale: float = 0.02
                     ) -> Dict[str, Any]:
    """Benchmark-grade weights, equal to the JAX package's
    `init_params_fast`: layernorm scales 1, every other leaf the pattern
    ((arange(n) % 1009 - 504) / 504 * scale) in f32, reshaped to the JAX
    layout and cast; filled on the device (no host RNG)."""

    def fill(name: str, shape) -> torch.Tensor:
        if name.endswith("_s"):
            return torch.ones(shape, dtype=dtype, device=device)
        n = int(np.prod(shape))
        base = (torch.arange(n, dtype=torch.float32, device=device) % 1009 - 504.0) / 504.0
        return (base.reshape(shape) * scale).to(dtype)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v)
                for k, v in node.items()}

    return params_from_jax(walk(wm.param_shapes(cfg)), device, dtype)


# rows of the pack's "b" bundle (`pack_tail_weights`): eight D-rows, then
# fc1_b as four more
_PACK_SMALL_ROWS = ("ln2_s", "ln2_b", "ln3_s", "ln3_b", "o_b", "cq_b", "co_b", "fc2_b")


def tail_q8_from_jax(pack: Dict[str, Any], device="cpu", dtype=torch.float32
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 tail pack {"w8" [L, NTOT, D, TW] int8, "ws"
    [L, NTOT, TW] f32, "b" [L, 12, D]} (numpy arrays) -> the port's int8
    tail weights: o_w, cq_w, co_w, fc1_w int8 [L, Din, Dout] with scales
    "<name>s" [L, Dout]; fc2_w int8 [L, 4D, D] with "fc2_ws" [L, 4D] (the
    pack's fc2 tiles are transposed contraction slices, so their column
    scales are fc2's row scales); biases and layer norms from "b" in
    `dtype`. Payloads and scales are carried over unchanged."""
    w8, ws, b = (np.asarray(pack[key]) for key in ("w8", "ws", "b"))
    L, _, D, TW = w8.shape
    n_d, n4 = D // TW, 4 * D // TW

    def cols(i0: int, n: int):  # n column tiles -> [L, D, n * TW], [L, n * TW]
        w = w8[:, i0:i0 + n].transpose(0, 2, 1, 3).reshape(L, D, n * TW)
        return w, ws[:, i0:i0 + n].reshape(L, n * TW)

    out: Dict[str, Any] = {}
    for i, name in enumerate(("o_w", "cq_w", "co_w")):
        out[name], out[f"{name}s"] = cols(i * n_d, n_d)
    out["fc1_w"], out["fc1_ws"] = cols(3 * n_d, n4)
    f2 = w8[:, 3 * n_d + n4:]  # [L, n4, D, TW] -> [L, 4D, D]
    out["fc2_w"] = f2.transpose(0, 1, 3, 2).reshape(L, 4 * D, D)
    out["fc2_ws"] = ws[:, 3 * n_d + n4:].reshape(L, 4 * D)
    tensors = {key: torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for key, a in out.items()}
    small = {name: b[:, i] for i, name in enumerate(_PACK_SMALL_ROWS)}
    small["fc1_b"] = b[:, len(_PACK_SMALL_ROWS):].reshape(L, 4 * D)
    for key, a in small.items():
        tensors[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
    return tensors


def front_from_jax(pack: Dict[str, Any], device="cpu", dtype=torch.float32
                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's greedy front pack {"w" [L, 3D/TW, D, TW] column
    tiles of [q_w | k_w | v_w], "b" [L, 4, D] rows ln1_s, ln1_b, q_b, v_b}
    (numpy arrays) -> the port's front: "w" [L, D, 3D], "b" [L, 3D] =
    [q_b | 0 | v_b], "ln1_s", "ln1_b" [L, D], in `dtype` on `device`. The
    tiles are the concatenated matrix's columns in order, so the payloads
    are carried over unchanged."""
    w, b = np.asarray(pack["w"]), np.asarray(pack["b"])
    L, _, D, TW = w.shape
    out = {"w": w.transpose(0, 2, 1, 3).reshape(L, D, w.shape[1] * TW),
           "b": np.concatenate([b[:, 2], np.zeros_like(b[:, 2]), b[:, 3]], axis=1),
           "ln1_s": b[:, 0], "ln1_b": b[:, 1]}
    return {key: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
            for key, a in out.items()}
