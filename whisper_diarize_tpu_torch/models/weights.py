"""Checkpoint I/O for the port (counterpart of
`whisper_diarize_tpu/models/weights.py`).

* `params_from_jax` — the weight bridge: the JAX package's parameter tree
  (numpy arrays, or tensors in that layout) -> the port's tensors on one
  device. The stacked `[L, ...]` axis and the `[in, out]` linear layout
  stay; the conv stem's `WIO` kernels become torch's `[out, in, k]`.
* `load_model` — a snapshot directory (`config.json` + `model.safetensors`),
  in the native layout (`_flatten` keys, as `save_params` writes) or the HF
  transformers layout, onto CUDA device 0 unless given a device;
  `save_params` writes the native layout.
* `load_openai_pt` — an original OpenAI checkpoint file (`.pt`: {"dims",
  "model_state_dict"}), through `convert_openai_params`, which GGML files
  (`models/ggml.py`) share: their tensors carry the OpenAI names;
  `openai_state_dict` is its inverse (files for tests and re-export).
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


def whisper_config_to_dict(cfg: wm.WhisperConfig) -> Dict[str, Any]:
    return {
        "num_mel_bins": cfg.n_mels,
        "vocab_size": cfg.n_vocab,
        "max_source_positions": cfg.n_audio_ctx,
        "d_model": cfg.n_audio_state,
        "encoder_attention_heads": cfg.n_audio_head,
        "encoder_layers": cfg.n_audio_layer,
        "max_target_positions": cfg.n_text_ctx,
        "decoder_attention_heads": cfg.n_text_head,
        "decoder_layers": cfg.n_text_layer,
    }


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def save_params(params: Dict[str, Any], cfg: wm.WhisperConfig, dir_path) -> None:
    """Write the port's params as a native-layout snapshot directory
    (config.json + model.safetensors, the JAX package's layout: the conv
    stem back in "WIO"), in f32 (bf16 values are exact in f32)."""
    from safetensors.numpy import save_file

    d = Path(dir_path)
    d.mkdir(parents=True, exist_ok=True)
    flat = {}
    for key, t in _flatten(params).items():
        if key.rsplit(".", 1)[-1] in _CONV_LEAVES:
            t = t.permute(2, 1, 0)
        flat[key] = np.ascontiguousarray(t.detach().float().cpu().numpy())
    save_file(flat, str(d / "model.safetensors"), metadata={"format": "wdt-native"})
    (d / "config.json").write_text(json.dumps({**whisper_config_to_dict(cfg),
                                               "wdt_native": True}))


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        cur = out
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _stack_blocks(sd: Dict[str, np.ndarray], pre: str, L: int, lns: Dict[str, str],
                  attns: Dict[str, str], attn: Dict[str, str], fcs: Dict[str, str]
                  ) -> Dict[str, np.ndarray]:
    """One stack's per-layer tensors (names `pre` formatted with i) ->
    the JAX layout's stacked blocks: layer norms `lns` (ours: theirs),
    attention modules `attns` (our prefix: their module) with projections
    named by `attn` (no key bias), the MLP's linears `fcs`; linears
    [out, in] -> [in, out]."""

    def stack(name, lin=False):
        return np.stack([np.asarray(sd[name.format(i=i)]).T if lin
                         else np.asarray(sd[name.format(i=i)]) for i in range(L)])

    out = {}
    for ours, theirs in lns.items():
        out[ours + "_s"] = stack(pre + theirs + ".weight")
        out[ours + "_b"] = stack(pre + theirs + ".bias")
    for prefix, module in attns.items():
        for key in ("q", "k", "v", "o"):
            out[f"{prefix}{key}_w"] = stack(f"{pre}{module}.{attn[key]}.weight", lin=True)
            if key != "k":
                out[f"{prefix}{key}_b"] = stack(f"{pre}{module}.{attn[key]}.bias")
    for ours, theirs in fcs.items():
        out[ours + "_w"] = stack(pre + theirs + ".weight", lin=True)
        out[ours + "_b"] = stack(pre + theirs + ".bias")
    return out


def convert_hf_params(flat: Dict[str, np.ndarray], cfg: wm.WhisperConfig) -> Dict[str, Any]:
    """HF transformers whisper tensors -> the JAX-layout numpy tree
    (linears [out, in] -> [in, out], layers stacked, conv -> WIO)."""

    def g(name):
        return np.asarray(flat[name])

    Le, Ld = cfg.n_audio_layer, cfg.n_text_layer
    e, d = "model.encoder.layers.{i}.", "model.decoder.layers.{i}."
    attn = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}
    fcs = {"fc1": "fc1", "fc2": "fc2"}
    enc_blocks = _stack_blocks(flat, e, Le, {"ln1": "self_attn_layer_norm",
                                             "ln2": "final_layer_norm"},
                               {"": "self_attn"}, attn, fcs)
    dec_blocks = _stack_blocks(flat, d, Ld, {"ln1": "self_attn_layer_norm",
                                             "ln2": "encoder_attn_layer_norm",
                                             "ln3": "final_layer_norm"},
                               {"": "self_attn", "c": "encoder_attn"}, attn, fcs)
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


def _dims_to_config(dims: Dict[str, Any]) -> wm.WhisperConfig:
    """An OpenAI `dims` (or GGML hparams) dict -> WhisperConfig."""
    vocab = int(dims["n_vocab"])
    return wm.WhisperConfig(
        n_mels=int(dims["n_mels"]), n_vocab=vocab,
        n_audio_ctx=int(dims["n_audio_ctx"]), n_audio_state=int(dims["n_audio_state"]),
        n_audio_head=int(dims["n_audio_head"]), n_audio_layer=int(dims["n_audio_layer"]),
        n_text_ctx=int(dims["n_text_ctx"]), n_text_state=int(dims["n_text_state"]),
        n_text_head=int(dims["n_text_head"]), n_text_layer=int(dims["n_text_layer"]),
        multilingual=vocab != 51864, num_languages=100 if vocab == 51866 else 99,
    )


def load_openai_pt(path, device=None, dtype=torch.float32
                   ) -> Tuple[Dict[str, Any], wm.WhisperConfig]:
    """(params, config) from an original OpenAI whisper checkpoint (.pt:
    {"dims", "model_state_dict"}), on `device`: CUDA device 0 unless given
    one (raises without a card). The file is a pickle (`weights_only=False`:
    OpenAI's `dims` may be an object): load only files you trust."""
    device = default_device(device, "load_openai_pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    dims = ckpt["dims"]
    if not isinstance(dims, dict):
        dims = dims.__dict__
    sd = {k: v.float().numpy() for k, v in ckpt["model_state_dict"].items()}
    cfg = _dims_to_config(dims)
    return params_from_jax(convert_openai_params(sd, cfg), device, dtype), cfg


def convert_openai_params(sd: Dict[str, np.ndarray], cfg: wm.WhisperConfig
                          ) -> Dict[str, Any]:
    """OpenAI-named tensors (as in `.pt` and GGML files) -> the JAX-layout
    numpy tree. The encoder's sinusoids are recomputed when the state dict
    lacks them."""

    def g(name):
        return np.asarray(sd[name])

    Le, Ld = cfg.n_audio_layer, cfg.n_text_layer
    attn = {"q": "query", "k": "key", "v": "value", "o": "out"}
    fcs = {"fc1": "mlp.0", "fc2": "mlp.2"}
    enc_blocks = _stack_blocks(sd, "encoder.blocks.{i}.", Le,
                               {"ln1": "attn_ln", "ln2": "mlp_ln"}, {"": "attn"}, attn, fcs)
    dec_blocks = _stack_blocks(sd, "decoder.blocks.{i}.", Ld,
                               {"ln1": "attn_ln", "ln2": "cross_attn_ln", "ln3": "mlp_ln"},
                               {"": "attn", "c": "cross_attn"}, attn, fcs)
    enc_pos = (g("encoder.positional_embedding") if "encoder.positional_embedding" in sd
               else wm.sinusoids(cfg.n_audio_ctx, cfg.n_audio_state))
    return {
        "encoder": {
            "conv1_w": g("encoder.conv1.weight").transpose(2, 1, 0),
            "conv1_b": g("encoder.conv1.bias").reshape(-1),
            "conv2_w": g("encoder.conv2.weight").transpose(2, 1, 0),
            "conv2_b": g("encoder.conv2.bias").reshape(-1),
            "pos": enc_pos,
            "blocks": enc_blocks,
            "ln_post_s": g("encoder.ln_post.weight"),
            "ln_post_b": g("encoder.ln_post.bias"),
        },
        "decoder": {
            "tok_emb": g("decoder.token_embedding.weight"),
            "pos_emb": g("decoder.positional_embedding"),
            "blocks": dec_blocks,
            "ln_s": g("decoder.ln.weight"),
            "ln_b": g("decoder.ln.bias"),
        },
    }


def openai_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's params under the OpenAI names, f32 numpy ([out, in]
    linears, torch conv kernels, conv biases flat): what `.pt` files and
    `ggml.write_ggml` take. `convert_openai_params` inverts it."""
    attn = {"q": "query", "k": "key", "v": "value", "o": "out"}
    enc, dec = params["encoder"], params["decoder"]

    def a(t):
        return t.detach().float().cpu().numpy()

    sd = {"encoder.conv1.weight": a(enc["conv1_w"]), "encoder.conv1.bias": a(enc["conv1_b"]),
          "encoder.conv2.weight": a(enc["conv2_w"]), "encoder.conv2.bias": a(enc["conv2_b"]),
          "encoder.positional_embedding": a(enc["pos"]),
          "encoder.ln_post.weight": a(enc["ln_post_s"]),
          "encoder.ln_post.bias": a(enc["ln_post_b"]),
          "decoder.token_embedding.weight": a(dec["tok_emb"]),
          "decoder.positional_embedding": a(dec["pos_emb"]),
          "decoder.ln.weight": a(dec["ln_s"]), "decoder.ln.bias": a(dec["ln_b"])}
    for pre, blocks, lns, mods in (
            ("encoder", enc["blocks"], {"ln1": "attn_ln", "ln2": "mlp_ln"}, {"": "attn"}),
            ("decoder", dec["blocks"], {"ln1": "attn_ln", "ln2": "cross_attn_ln", "ln3": "mlp_ln"},
             {"": "attn", "c": "cross_attn"})):
        for i in range(blocks["q_w"].shape[0]):
            p = f"{pre}.blocks.{i}."
            for ours, theirs in lns.items():
                sd[p + theirs + ".weight"] = a(blocks[ours + "_s"][i])
                sd[p + theirs + ".bias"] = a(blocks[ours + "_b"][i])
            for prefix, mod in mods.items():
                for key, name in attn.items():
                    sd[f"{p}{mod}.{name}.weight"] = a(blocks[f"{prefix}{key}_w"][i].t())
                    if key != "k":
                        sd[f"{p}{mod}.{name}.bias"] = a(blocks[f"{prefix}{key}_b"][i])
            for fc, name in (("fc1", "mlp.0"), ("fc2", "mlp.2")):
                sd[f"{p}{name}.weight"] = a(blocks[fc + "_w"][i].t())
                sd[f"{p}{name}.bias"] = a(blocks[fc + "_b"][i])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


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


def init_params_normal(cfg: wm.WhisperConfig, device, dtype, seed: int = 0) -> Dict[str, Any]:
    """Weights of the JAX package's `init_params` distribution (layer norms
    1, biases 0, a weight [.., n_in, n_out] N(0, 1 / n_in), the conv stem
    N(0, 1 / (3 n_in)), tok_emb N(0, 1 / d), pos_emb N(0, 0.01^2), the
    encoder's sinusoids), drawn on the device from a torch generator (not
    the JAX package's numpy draws): a full-size model in a second, whose
    logits do not tie as the pattern of `init_params_fast` makes them tie."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(name: str, shape) -> torch.Tensor:
        if name.endswith("_s"):
            return torch.ones(shape, device=device)
        if name.endswith("_b"):
            return torch.zeros(shape, device=device)
        if name == "pos":
            return torch.from_numpy(wm.sinusoids(*shape)).to(device)
        std = {"tok_emb": shape[-1] ** -0.5, "pos_emb": 0.01}.get(name)
        if std is None:
            std = (shape[-2] * (3 if name.startswith("conv") else 1)) ** -0.5
        return torch.randn(shape, generator=gen, device=device) * std

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v) for k, v in node.items()}

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
