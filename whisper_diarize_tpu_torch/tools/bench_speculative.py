"""Speculative greedy decoding, measured at controlled acceptance
(counterpart of `tools/bench_speculative.py`).

Random weights cannot show a speculative gain: a real draft never agrees
with a random target. So the rows measure what random weights can:

  greedy         plain `greedy_decode`, the baseline;
  self-g4        the target drafts for itself, gamma 4: acceptance is ~1 by
                 construction, so rounds ~ steps / gamma; the mechanism's
                 cost a round at the highest agreement;
  turbo-aX-gG    a large-v3-turbo draft whose agreement with the target is
                 REPLACED by a Bernoulli(X) draw (`sim_accept`: a timing
                 instrument that breaks exactness); turbo shares large-v3's
                 frozen encoder, so the draft reads the target's audio
                 states (xa_d = xa_t), as the real pairing does.

Each row: large-v3 target, batch 16, 64 tokens with eot suppressed (every
row decodes the whole budget), weights from `weights.init_params_fast`,
audio `standard_normal * 0.1`; the mel + encoder frontend timed once. Times
are the host clock around `torch.cuda.synchronize()`, best of `--repeat`
calls after one warm-up.

    python -m whisper_diarize_tpu_torch.tools.bench_speculative [--row NAME ...]

Runs on CUDA device 0 and raises without a card; `--device cpu` with a
small `--preset` runs it on the CPU (the tests). The first line names the
card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import weights
from ..models import whisper as wm
from ..ops import decode as dec
from ..ops import speculative as spec
from ..ops.mel import N_SAMPLES, log_mel_spectrogram
from ..tokenizer import DebugTokenizer
from ..utils import default_device
from . import timing

B = 16
STEPS = 64
ROWS = {
    "greedy": None,
    "self-g4": dict(draft=None, gamma=4, sim=None),
    "turbo-a1.0-g4": dict(draft="large-v3-turbo", gamma=4, sim=1.0),
    "turbo-a0.8-g4": dict(draft="large-v3-turbo", gamma=4, sim=0.8),
    "turbo-a0.5-g4": dict(draft="large-v3-turbo", gamma=4, sim=0.5),
    "turbo-a0.8-g8": dict(draft="large-v3-turbo", gamma=8, sim=0.8),
}


@dataclasses.dataclass
class Bench:
    """The rows' shared inputs, and what `main` measured."""

    params: Dict[str, Any]
    cfg: wm.WhisperConfig
    dc: dec.DecodeConfig
    sp: Any
    suppress: torch.Tensor
    prompt: torch.Tensor
    xa: torch.Tensor
    frontend_ms: float
    drafts: Dict[str, Tuple[Dict[str, Any], wm.WhisperConfig]]
    rows: List[dict] = dataclasses.field(default_factory=list)
    results: Dict[str, dec.DecodeResult] = dataclasses.field(default_factory=dict)


def setup(dev: torch.device, preset: str, batch: int, steps: int, repeat: int) -> Bench:
    cfg = wm.PRESETS[preset]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = weights.init_params_fast(cfg, dev, dtype)
    tk = DebugTokenizer(num_languages=cfg.num_languages)
    sp = tk.specials
    suppress = torch.from_numpy(dec.build_suppress_mask(
        sp, cfg.n_vocab, extra_suppress=[sp.eot])).to(dev)
    audio = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (batch, N_SAMPLES)) * 0.1).astype(np.float32)).to(dev)
    prompt = torch.tensor([tk.sot_sequence(language="en")] * batch, device=dev)
    with torch.inference_mode():
        front_ms, xa = timing.best_ms(lambda: wm.encode(
            params, log_mel_spectrogram(audio, n_mels=cfg.n_mels), cfg), dev, repeat)
    return Bench(params, cfg, dec.DecodeConfig(max_tokens=steps, with_timestamps=True), sp,
                 suppress, prompt, xa, front_ms, drafts={})


def run_row(b: Bench, name: str, repeat: int) -> Tuple[dict, dec.DecodeResult]:
    """One row: its times (and rounds), and the last call's result."""
    row_cfg = ROWS[name]
    dev, batch, P = b.xa.device, b.xa.shape[0], b.prompt.shape[1]
    steps = b.dc.max_tokens
    rounds = None
    with torch.inference_mode():
        if row_cfg is None:
            ms, res = timing.best_ms(lambda: dec.greedy_decode(
                b.params, b.cfg, b.dc, b.sp, b.xa, b.prompt, P, suppress_mask=b.suppress),
                dev, repeat)
        else:
            key = row_cfg["draft"]
            if key is None:
                params_d, cfg_d = b.params, b.cfg
            else:
                if key not in b.drafts:
                    cfg_k = wm.PRESETS[key]
                    b.drafts[key] = (weights.init_params_fast(cfg_k, dev, b.xa.dtype), cfg_k)
                params_d, cfg_d = b.drafts[key]
            ms, (res, r) = timing.best_ms(lambda: spec.speculative_greedy_run(
                b.params, b.cfg, params_d, cfg_d, b.dc, b.sp, b.xa, b.xa, b.prompt, P,
                b.suppress, gamma=row_cfg["gamma"], sim_accept=row_cfg["sim"]), dev, repeat)
            rounds = int(r)
    audio_s = batch * N_SAMPLES / 16000.0
    row = dict(row=name, decode_ms=ms, frontend_ms=b.frontend_ms,
               xrt=audio_s / ((b.frontend_ms + ms) / 1e3), tok_s=batch * steps / (ms / 1e3))
    if rounds is not None:
        row.update(rounds=rounds, tok_per_round=steps / max(rounds, 1))
    return row, res


def main(device: Optional[str] = None, preset: str = "large-v3", batch: int = B,
         steps: int = STEPS, rows: Optional[Sequence[str]] = None, repeat: int = 3) -> Bench:
    """Print one JSON line a row (the first line names the card) and return
    the rows, with each row's result, in a `Bench`."""
    dev = default_device(device, "bench_speculative")
    print(timing.card_line(dev), flush=True)
    b = setup(dev, preset, batch, steps, repeat)
    for name in rows or ROWS:
        row, res = run_row(b, name, repeat)
        b.rows.append(row)
        b.results[name] = res
        print(json.dumps(row), flush=True)
    return b


def _args(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cpu for the CPU (tests)")
    p.add_argument("--preset", default="large-v3", choices=sorted(wm.PRESETS))
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--row", dest="rows", action="append", choices=list(ROWS))
    p.add_argument("--repeat", type=int, default=3)
    return vars(p.parse_args(argv))


if __name__ == "__main__":
    main(**_args())
