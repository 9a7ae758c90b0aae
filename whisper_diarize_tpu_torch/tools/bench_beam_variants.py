"""The beam-5 decode step rebuilt one component at a time, large-v3 at
batch 16 (N = 80 beam rows) (counterpart of `tools/bench_beam_variants.py`).

Variants, cumulative as in the JAX tool unless noted:

  embed   token embedding, final layer norm and the logits (no layers)
  qkv     + every layer's ln1 / q / k / v and the decode cache's slot write
  self    + the split-cache self-attention in plain torch
          (`ops/attn.py::split_self_attn_layer_plain`, K4's plain version:
          the JAX tool's XLA arm)
  selfk   qkv + K4 (`split_self_attn_layer`; not cumulative with `self`)
  tail    qkv + K3 (`_tail_step`), no self-attention (q stands in)
  xtail   qkv + the un-fused torch tail with K1 (`_decoder_layer_tail`), no
          self-attention
  full    qkv + K4 + K3: `decode_step_split`'s structure

Each variant's row: wall and profiled device ms a step over the 32- and
64-step budgets, a fresh zeroed decode cache each call (`timing.phase_row`),
the busy share and the device operations a step. The prompt half of the
split cache and the cross cache come from one `beam_init` over random audio
states (`standard_normal * 0.05`, seed 0), the ancestry map is each beam's
own rows. Each variant runs in its own subprocess (`WDT_PART`), or all in
this process with `inline` (`chip_smoke.py`). Weights `init_params_fast`,
bf16 on the card. `--smoke`: budgets 4 and 8.

    python -m whisper_diarize_tpu_torch.tools.bench_beam_variants [model] [batch]
        [--device cpu] [--repeat N] [--smoke]

Runs on CUDA device 0 and raises without a card (`--device cpu` for the
CPU). The first line names the card and its power limit.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import whisper as wm
from ..ops import attn
from ..ops import decode as dec
from . import timing
from .bench_beam_breakdown import K, beam_setup
from .bench_decode_breakdown import B, FIXED_TOKEN, run_parts, tool_args

PARTS = ("embed", "qkv", "self", "selfk", "tail", "xtail", "full")
# part -> (layers, self-attention: None | "plain" | "kernel", tail: None | "k3" | "unfused")
SPEC = {
    "embed": (False, None, None),
    "qkv": (True, None, None),
    "self": (True, "plain", None),
    "selfk": (True, "kernel", None),
    "tail": (True, None, "k3"),
    "xtail": (True, None, "unfused"),
    "full": (True, "kernel", "k3"),
}
NOTES = {"self": "K4's plain version (the JAX tool's XLA arm)", "selfk": "K4",
         "tail": "K3", "xtail": "torch tail + K1", "full": "K4 + K3"}


def variant_loop(b: SimpleNamespace, part: str, dk: torch.Tensor, dv: torch.Tensor,
                 budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`budget` steps of variant `part` at N rows on the fixed token, the
    decode cache dk / dv [L, N, H, Td, Dh] written in place (slots 0 ..
    budget - 1). Returns (the accumulated logit of vocabulary entry 0 [N],
    the last step's logits [N, V])."""
    layers, self_attn, tail = SPEC[part]
    cfg, params, P = b.cfg, b.params, b.P
    dec_p = params["decoder"]
    blocks = dec_p["blocks"]
    dtype = dec_p["tok_emb"].dtype
    H, Dh = cfg.n_text_head, cfg.head_dim
    N = b.B * K
    tok = torch.full((N, 1), FIXED_TOKEN, dtype=torch.long, device=b.dev)
    acc = torch.zeros((N,), dtype=torch.float32, device=b.dev)
    for step in range(budget):
        x = dec_p["tok_emb"][tok] + dec_p["pos_emb"][P + step][None, None].to(dtype)
        for l in range(cfg.n_text_layer if layers else 0):
            blk = wm._layer(blocks, l)
            q, k_new, v_new = wm._decoder_qkv(x, blk, H)
            dk[l, :, :, step] = k_new[:, :, 0]
            dv[l, :, :, step] = v_new[:, :, 0]
            if self_attn is None:
                self_out = q  # a stand-in of the right shape
            else:
                fn = (attn.split_self_attn_layer if self_attn == "kernel"
                      else attn.split_self_attn_layer_plain)
                self_out = fn(l, q.reshape(b.B, K, H, Dh).contiguous(), b.pk, b.pv, dk, dv,
                              b.anc_j, step, b.row_pad, P).reshape(N, H, 1, Dh)
            if tail == "k3":
                x = wm._tail_step(l, x, self_out.contiguous(), blocks, b.cross, K, cfg)
            elif tail == "unfused":
                x = wm._decoder_layer_tail(x, blk, self_out, b.cross, l, K, cfg)
            else:  # a data dependency through x without the tail's arithmetic
                x = x + wm._unheads(self_out).to(dtype) * 1e-12
        logits = wm._vocab_logits(wm._ln(x, dec_p["ln_s"], dec_p["ln_b"]), dec_p["tok_emb"])
        acc = acc + logits[:, 0, 0]
    return acc, logits[:, 0]


def variant_setup(model, batch: int, dev: torch.device, steps: int,
                  params: Optional[Dict[str, Any]] = None) -> SimpleNamespace:
    """`beam_setup`, then one `beam_init`'s prompt cache and cross cache, the
    shape of its decode cache, each beam's own ancestry and zero row pads."""
    b = beam_setup(model, batch, dev, steps, params)
    state = dec.beam_init(b.params, b.cfg, b.dc, b.sp, b.xa, b.prompt, b.P)
    b.pk, b.pv, b.cross = state["cache"]["pk"], state["cache"]["pv"], state["cross"]
    b.decode_shape = tuple(state["cache"]["dk"].shape)
    Td = b.decode_shape[3]
    N = b.B * K
    b.anc_j = (torch.arange(N, device=dev) % K).to(torch.int32)[:, None].expand(
        N, Td).reshape(b.B, K, Td).contiguous()
    b.row_pad = torch.zeros((b.B,), dtype=torch.int32, device=dev)
    return b


def part_row(b: SimpleNamespace, part: str, budgets: Tuple[int, int], repeat: int) -> dict:
    """One variant's row on `b`."""
    def run(n):
        dk = torch.zeros(b.decode_shape, dtype=b.dtype, device=b.dev)
        return variant_loop(b, part, dk, torch.zeros_like(dk), n)

    return timing.phase_row(part, run, b.dev, budgets, repeat, note=NOTES.get(part))


def main(model: str = "large-v3", batch: int = B, device: Optional[str] = None,
         smoke: Optional[bool] = None, repeat: Optional[int] = None, inline: bool = False,
         parts=PARTS) -> List[dict]:
    """Each of `parts` (a subprocess each unless `inline`, `run_parts`),
    printed; returns the rows."""
    return run_parts(__spec__.name, parts, PARTS, model, batch, device, smoke, repeat, inline,
                     variant_setup, part_row)


if __name__ == "__main__":
    main(**tool_args(__doc__.split("\n\n")[0]))
