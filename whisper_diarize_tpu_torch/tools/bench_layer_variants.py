"""The greedy decode step's layer rebuilt in variants, large-v3 at batch 16
(counterpart of `tools/bench_layer_variants.py`).

Each variant is a step built from `models/whisper.py`'s own pieces
(`_ln`, `_heads`, `_decoder_qkv`, `_attn`, `_tail_step`,
`_decoder_layer_tail`), on a fixed token over a 128-slot self cache and the
cross cache of random audio states (`standard_normal * 0.05`, seed 0), the
prompt length 5 as in the JAX tool:

  v0 baseline        the port's step: `_decoder_qkv`, `_attn`, K3 a layer
  v1 no-cross        the un-fused torch tail with the cross output set to
                     zero (no K1, no K3)
  v1b unfused        that same torch tail with K1 (`_decoder_layer_tail`):
                     with v0 and v1, whether K3 beats cuBLAS plus K1 in
                     the step
  v2 fused-qkv       one [D, 3D] product for q / k / v (the front pack's
                     `w` / `b`, `ops/front.py::pack_front_weights`), then K3
  v3 fused+nocross   v2's product and v1's tail

The JAX tool's v4 / v5 (a Python-unrolled layer loop against `lax.scan`)
have no counterpart: the port's layer loop is always a Python loop over
static layer slices. Each variant's row: wall and profiled device ms a step
(the slope between 32- and 64-step budgets, `timing.phase_row`), ms a
layer, the busy share and the device operations a step. Weights
`init_params_fast`, bf16 on the card. `--smoke`: budgets 4 and 8.
`WDT_VARIANTS=v0,v2` picks variants by their first word, as in the JAX
tool.

    python -m whisper_diarize_tpu_torch.tools.bench_layer_variants [model] [batch]
        [--device cpu] [--repeat N] [--smoke]

Runs on CUDA device 0 and raises without a card (`--device cpu` for the
CPU). The first line names the card and its power limit.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch

from ..models import whisper as wm
from ..ops.front import pack_front_weights
from ..utils import default_device
from . import timing
from .bench_decode_breakdown import (B, FIXED_TOKEN, random_xa, setup, smoke_budgets,
                                     tool_args)

P = 5
CACHE_LEN = 128
# name -> (fused q / k / v product, tail: "k3" | "unfused" | "nocross")
VARIANTS = {
    "v0 baseline": (False, "k3"),
    "v1 no-cross": (False, "nocross"),
    "v1b unfused": (False, "unfused"),
    "v2 fused-qkv": (True, "k3"),
    "v3 fused+nocross": (True, "nocross"),
}
NO_COUNTERPART = {
    "v4 unrolled": "the port's layer loop is a Python loop over static layer slices (v0)",
    "v5 unrolled-nocross": "as v4, and v1 is its no-cross form",
}


def _tail_nocross(x: torch.Tensor, blk: Dict[str, torch.Tensor],
                  self_out: torch.Tensor) -> torch.Tensor:
    """The un-fused layer tail with the cross attention's output set to
    zero: o, ln2 and cq as in `_decoder_layer_tail`, then co of zeros, ln3
    and the MLP."""
    x = x + wm._unheads(self_out) @ blk["o_w"] + blk["o_b"]
    cq = wm._ln(x, blk["ln2_s"], blk["ln2_b"]) @ blk["cq_w"] + blk["cq_b"]
    x = x + (cq * 0.0) @ blk["co_w"] + blk["co_b"]
    return wm._mlp(x, blk, None, "ln3")


def variant_loop(b: SimpleNamespace, name: str, cache: Dict[str, torch.Tensor],
                 cross: Dict[str, torch.Tensor], budget: int, params=None,
                 fused: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`budget` steps of variant `name` on the fixed token (slots P .. P +
    budget - 1 of `cache`, written in place); `fused` is the front pack
    (the [D, 3D] q / k / v weights) for v2 / v3. Returns (the accumulated
    logit of vocabulary entry 0 [B], the last step's logits [B, V])."""
    fused_qkv, tail = VARIANTS[name]
    params = b.params if params is None else params
    cfg = b.cfg
    dec = params["decoder"]
    blocks = dec["blocks"]
    dtype = dec["tok_emb"].dtype
    H, D = cfg.n_text_head, cfg.n_text_state
    kc, vc = cache["k"], cache["v"]
    kpos = torch.arange(kc.shape[-2], device=b.dev)
    zero = torch.tensor(0.0, device=b.dev)
    neg_inf = torch.tensor(float("-inf"), device=b.dev)
    tok = torch.full((b.B, 1), FIXED_TOKEN, dtype=torch.long, device=b.dev)
    acc = torch.zeros((b.B,), dtype=torch.float32, device=b.dev)
    for step in range(budget):
        pos = P + step
        x = dec["tok_emb"][tok] + dec["pos_emb"][pos:pos + 1][None].to(dtype)
        mask = torch.where(kpos <= pos, zero, neg_inf)[None, None, None]
        for l in range(cfg.n_text_layer):
            blk = wm._layer(blocks, l)
            if fused_qkv:
                qkv = wm._ln(x, blk["ln1_s"], blk["ln1_b"]) @ fused["w"][l] + fused["b"][l]
                q, k_new, v_new = (wm._heads(t, H) for t in qkv.split(D, dim=-1))
            else:
                q, k_new, v_new = wm._decoder_qkv(x, blk, H)
            kc[l, :, :, pos:pos + 1] = k_new
            vc[l, :, :, pos:pos + 1] = v_new
            self_out = wm._attn(q, kc[l], vc[l], mask)
            if tail == "k3":
                x = wm._tail_step(l, x, self_out.contiguous(), blocks, cross, 1, cfg)
            elif tail == "unfused":
                x = wm._decoder_layer_tail(x, blk, self_out, cross, l, 1, cfg)
            else:
                x = _tail_nocross(x, blk, self_out)
        logits = wm._vocab_logits(wm._ln(x, dec["ln_s"], dec["ln_b"]), dec["tok_emb"])
        acc = acc + logits[:, 0, 0]
    return acc, logits[:, 0]


def layer_setup(model, batch: int, dev: torch.device, params=None) -> SimpleNamespace:
    """`setup`, the cross cache of random audio states (K2) and the front
    pack."""
    b = setup(wm.PRESETS[model] if isinstance(model, str) else model, batch, dev, 64, params)
    b.P = P
    b.cross = wm.cross_kv(b.params, random_xa(b), b.cfg)
    b.fused = pack_front_weights(b.params, b.cfg)
    return b


def main(model: str = "large-v3", batch: int = B, device: Optional[str] = None,
         smoke: Optional[bool] = None, repeat: Optional[int] = None) -> SimpleNamespace:
    """Each variant's row, printed (then the two without a counterpart);
    returns the rows and each variant's `variant_loop` result of its
    longer call."""
    dev = default_device(device, "bench_layer_variants")
    print(timing.card_line(dev), flush=True)
    smoke, budgets, reps = smoke_budgets(smoke)
    reps = reps if repeat is None else repeat
    names = list(VARIANTS) + list(NO_COUNTERPART)
    sel = os.environ.get("WDT_VARIANTS")
    if sel:
        names = [n for n in names if n.split()[0] in set(sel.split(","))]
    rows: List[dict] = []
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    with torch.inference_mode():
        b = layer_setup(model, batch, dev)
        L = b.cfg.n_text_layer
        for name in names:
            if name in NO_COUNTERPART:
                print(f"{name:22s} no counterpart: {NO_COUNTERPART[name]}", flush=True)
                continue
            cache = wm.init_self_cache(b.cfg, b.B, b.dtype, dev, CACHE_LEN)

            def run(n, name=name, cache=cache):
                return variant_loop(b, name, cache, b.cross, n, fused=b.fused)

            outs = []
            row = timing.phase_row(name, run, dev, budgets, reps, outputs=outs)
            row["wall_ms_per_layer"] = row["wall_ms"] / L
            rows.append(row)
            out[name] = outs[0]
            print(f"{timing.format_row(row)}  {row['wall_ms_per_layer']:7.4f} ms/layer",
                  flush=True)
            del cache
    return SimpleNamespace(rows=rows, out=out)


if __name__ == "__main__":
    main(**tool_args(__doc__.split("\n\n")[0]))
