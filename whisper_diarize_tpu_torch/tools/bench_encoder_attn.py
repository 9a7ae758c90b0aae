"""The encoder, timed whole with each form of its self-attention
(counterpart of `tools/bench_encoder_attn.py`).

Modes (`make_encode(cfg, mode)`: `models/whisper.py::encode` with every
layer's self-attention replaced):

  full          `_attn` with compact probabilities (the JAX tool's plain path)
  no-attn       v + q * 1e-9: the attention skipped, the floor of the encoder
  flash-custom  K10 in its single-pass form (`ops/encoder_attn.py`)
  flash         `F.scaled_dot_product_attention`, the library's kernel (the
                JAX tool's mode of this name calls the library's TPU flash
                kernel); in `make_encode` only, as in the JAX tool

Each mode encodes B 16 windows (`init_params_fast` weights, mel
`standard_normal * 0.3` from seed 0), best of `repeat` calls after one
warm-up, the host clock around `torch.cuda.synchronize()`; bf16 on the
card, f32 on the CPU. It prints one line a mode and "flash-custom vs full:
max rel diff", the largest difference of their outputs over the largest
|output|. A mode that fails makes the tool fail.

    python -m whisper_diarize_tpu_torch.tools.bench_encoder_attn [model]
        [--device cpu] [--batch N] [--repeat N]

Runs on CUDA device 0 and raises without a card; `--device cpu` runs it on
the CPU (the tests). The first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import weights
from ..models import whisper as wm
from ..ops import encoder_attn
from ..utils import default_device
from . import timing

B = 16
MODES = ("full", "no-attn", "flash-custom")  # the JAX tool's run
ATTN = {
    "full": lambda q, k, v: wm._attn(q, k, v, compact_probs=True),
    "no-attn": lambda q, k, v: v + q * 1e-9,
    "flash-custom": encoder_attn.encoder_self_attention,
    "flash": F.scaled_dot_product_attention,
}


def make_encode(cfg: wm.WhisperConfig, mode: str) -> Callable:
    """encode(params, mel) -> audio states, with `mode`'s attention in
    every layer."""
    attn = ATTN[mode]

    def encode(params, mel):
        return wm.encode(params, mel, cfg, attn=attn)

    return encode


def main(model: str = "large-v3", device: Optional[str] = None, batch: int = B,
         repeat: int = 5) -> List[dict]:
    """Print a line a mode of MODES (the first line names the card) and
    return the rows: {"mode", "ms"}, and on the flash-custom row
    "max_rel_diff_vs_full"."""
    dev = default_device(device, "bench_encoder_attn")
    print(timing.card_line(dev), flush=True)
    cfg = wm.PRESETS[model]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = weights.init_params_fast(cfg, dev, dtype)
    mel = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (batch, cfg.n_mels, 3000)) * 0.3).astype(np.float32)).to(dev)
    rows, outs = [], {}
    with torch.inference_mode():
        for mode in MODES:
            enc = make_encode(cfg, mode)
            ms, outs[mode] = timing.best_ms(lambda: enc(params, mel), dev, repeat)
            rows.append({"mode": mode, "ms": ms})
            print(f"{mode:8s} {ms:8.1f} ms", flush=True)
    a, b = outs["full"].float(), outs["flash-custom"].float()
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    rows[MODES.index("flash-custom")]["max_rel_diff_vs_full"] = rel
    print(f"flash-custom vs full: max rel diff {rel:.2e}", flush=True)
    return rows


def _args(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", nargs="?", default="large-v3", choices=sorted(wm.PRESETS))
    p.add_argument("--device", default=None, help="cpu for the CPU (tests)")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--repeat", type=int, default=5)
    return vars(p.parse_args(argv))


if __name__ == "__main__":
    main(**_args())
