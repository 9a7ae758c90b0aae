"""Greedy and beam-5 decode steps over the bf16 and the int8 cross K/V
cache, large-v3 at batch 16 (counterpart of `tools/bench_quant_kv.py`).

Variants, the JAX tool's names:

  greedy tail         the port's greedy step: K3 every layer (K1 at the
                      prompt pass)
  greedy q8kv+tail    `DecodeConfig(quantize_cross_kv=True)`: K5 at the prompt
                      pass, K6 (`kvq`) every step
  greedy q8all+tail   the int8 cache and int8 tail weights
                      (`ops/tail.py::quantize_tail_weights`, as
                      `TranscribeStep` attaches them): K6 `wq` + `kvq`
  beam   fp           beam 5: K4 + K3
  beam   q8kv         beam 5 over the int8 cache: K4 + K6

The JAX tool's greedy `fp` and `q8kv` (its step without the fused tail) have
no single-token counterpart in the port: they are named and not timed.

Each variant runs in its own subprocess (`--worker`, the JAX tool's rule),
or all in this process with `inline` (`chip_smoke.py`): the init
(`greedy_init` / `beam_init`, best of `repeat - 2`) and the step slope
between the 32- and 64-step budgets on fresh copies of one state
(`timing.phase_row`: wall and profiled device ms, the busy share and the
device operations a step), then the verdict against each mode's baseline
(greedy: `tail`, as the JAX tool's `fp` is not timed; beam: `fp`) on the
device ms a step, the wall's ratio beside it (the host moves a step's wall
between runs far more than its device time). Weights
`init_params_fast`, audio `standard_normal * 0.1` (seed 0) through the plain
mel and encoder, eot suppressed, bf16 on the card. `--smoke` (or, as for
the JAX tool, `WDT_QUANT_SMOKE=1`): budgets 4 and 8, one timed call (a
plumbing check).

    python -m whisper_diarize_tpu_torch.tools.bench_quant_kv [model] [batch]
        [--device cpu] [--repeat N] [--smoke]

Runs on CUDA device 0 and raises without a card (`--device cpu` for the
CPU). The first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import whisper as wm
from ..ops import decode as dec
from ..ops.mel import log_mel_spectrogram
from ..ops.tail import quantize_tail_weights
from ..utils import default_device
from . import timing
from .bench_decode_breakdown import B, fresh, setup, smoke_budgets, spawn_row, tool_args

VARIANTS = {"greedy": ("fp", "tail", "q8kv", "q8kv+tail", "q8all+tail"), "beam": ("fp", "q8kv")}
OFF = ("no single-token counterpart in the port: every greedy step runs the fused "
       "tail (DecodeConfig refuses pallas_tail=False)")
UNTIMED = {("greedy", "fp"), ("greedy", "q8kv")}
BASELINE = {"greedy": "tail", "beam": "fp"}


def variant_setup(model, batch: int, variant: str, mode: str, dev: torch.device, steps: int,
                  params: Optional[Dict[str, Any]] = None) -> SimpleNamespace:
    """`setup` for one variant: the int8 cache (`q8*`), the int8 tail
    weights (`q8all`), beam 5 (`beam`), and the encoded audio `xa`."""
    if (mode, variant) in UNTIMED:
        raise ValueError(f"bench_quant_kv: {mode} {variant!r} has {OFF}")
    if variant not in VARIANTS.get(mode, ()):
        raise ValueError(f"bench_quant_kv: no variant {variant!r} in mode {mode!r} "
                         f"(variants {VARIANTS})")
    kvq, wq = variant.startswith("q8"), variant.startswith("q8all")
    cfg = wm.PRESETS[model] if isinstance(model, str) else model
    b = setup(cfg, batch, dev, steps, params, quantize_cross_kv=kvq, quantize_tail_weights=wq)
    b.mode, b.variant = mode, variant
    b.xa = wm.encode(b.params, log_mel_spectrogram(b.audio, n_mels=cfg.n_mels), cfg)
    b.tail_q8 = quantize_tail_weights(b.params["decoder"]["blocks"]) if wq else None
    return b


def init(b: SimpleNamespace) -> Dict[str, Any]:
    """The variant's loop state: `greedy_init` or `beam_init`."""
    if b.mode == "greedy":
        return dec.greedy_init(b.params, b.cfg, b.dc, b.sp, b.xa, b.prompt, b.P,
                               suppress_mask=b.suppress, tail_q8=b.tail_q8)
    return dec.beam_init(b.params, b.cfg, b.dc, b.sp, b.xa, b.prompt, b.P)


def run(b: SimpleNamespace, state: Dict[str, Any], budget: int) -> Dict[str, Any]:
    """`budget` steps of the variant's loop on a fresh copy of `state`."""
    loop = dec.greedy_run if b.mode == "greedy" else dec.beam_run
    return loop(b.params, b.cfg, b.dc, b.sp, fresh(state), b.suppress, b.P, budget)


def measure(model: str, batch: int, variant: str, mode: str, device: Optional[str] = None,
            smoke: Optional[bool] = None, repeat: Optional[int] = None
            ) -> Tuple[dict, torch.Tensor]:
    """One variant's row (the JAX tool's keys: variant, mode, ms_per_step,
    t64_ms (the longer budget's call), init_ms; and `timing.phase_row`'s
    device fields: device_ms_per_step, busy, launches_per_step, host_bound,
    t64_device_ms, init_device_ms) and the tokens of its longer run."""
    dev = default_device(device, "bench_quant_kv")
    smoke, budgets, reps = smoke_budgets(smoke, "WDT_QUANT_SMOKE")
    reps = reps if repeat is None else repeat
    with torch.inference_mode():
        b = variant_setup(model, batch, variant, mode, dev, budgets[1])
        first = timing.phase_row("init", lambda n: init(b), dev, None, max(1, reps - 2))
        state = init(b)
        outs = []
        step = timing.phase_row(f"{mode} {variant}", lambda n: run(b, state, n)["tokens"],
                                dev, budgets, reps, outputs=outs)
        tokens = outs[0]
    return {"variant": variant, "mode": mode, "ms_per_step": step["wall_ms"],
            "t64_ms": step["wall_long_ms"], "init_ms": first["wall_ms"],
            "device_ms_per_step": step["device_ms"], "busy": step["busy"],
            "launches_per_step": step["launches"], "host_bound": step["host_bound"],
            "t64_device_ms": step["device_long_ms"],
            "init_device_ms": first["device_ms"]}, tokens


def worker(model: str, batch: int, variant: str, mode: str, device: Optional[str] = None,
           smoke: Optional[bool] = None, repeat: Optional[int] = None) -> dict:
    """`measure`, its row printed as one JSON line."""
    row = measure(model, batch, variant, mode, device, smoke, repeat)[0]
    print(json.dumps(row), flush=True)
    return row


def main(model: str = "large-v3", batch: int = B, device: Optional[str] = None,
         smoke: Optional[bool] = None, repeat: Optional[int] = None,
         inline: bool = False) -> List[dict]:
    """Each variant (a subprocess each unless `inline`), the untimed ones
    named, then the verdict. Returns the rows."""
    dev = default_device(device, "bench_quant_kv")
    print(timing.card_line(dev), flush=True)
    smoke = smoke_budgets(smoke, "WDT_QUANT_SMOKE")[0]
    rows, by = [], {}
    for mode, variants in VARIANTS.items():
        for variant in variants:
            if (mode, variant) in UNTIMED:
                print(f"{mode:6s} {variant:10s} not timed: {OFF}", flush=True)
                continue
            if inline:
                row = worker(model, batch, variant, mode, device, smoke, repeat)
            else:
                args = ["--worker", model, str(batch), variant, mode]
                args += ["--device", device] if device is not None else []
                args += ["--repeat", str(repeat)] if repeat is not None else []
                args += ["--smoke"] if smoke else []
                row = spawn_row(__spec__.name, args)
            rows.append(row)
            by[mode, variant] = row
            dev_txt = ("device not measured (cpu)" if row["device_ms_per_step"] is None else
                       f"device {row['device_ms_per_step']:.3f} ms/step, busy "
                       f"{timing.busy_text(row['busy'])}, {row['launches_per_step']:.0f} "
                       "launches/step")
            print(f"{mode:6s} {variant:10s} {row['ms_per_step']:7.3f} ms/step, {dev_txt} "
                  f"(longer call {row['t64_ms']:.1f} ms, init {row['init_ms']:.1f} ms)",
                  flush=True)
    print("\nverdict on device ms a step (vs each mode's baseline: greedy tail, the JAX "
          "tool's fp not timed; beam fp), the wall beside it moves with the host:")
    for (mode, variant), row in by.items():
        base = by[mode, BASELINE[mode]]
        if variant == BASELINE[mode]:
            continue
        d0, d1 = base["device_ms_per_step"], row["device_ms_per_step"]
        w0, w1 = base["ms_per_step"], row["ms_per_step"]
        dev_txt = ("device not measured (cpu)" if d1 is None else
                   f"device {d0:.3f} -> {d1:.3f} ms/step ({d0 / d1:.3f}x)")
        print(f"  {mode} {variant}: {dev_txt}; wall, host-dependent, {w0:.3f} -> {w1:.3f} "
              f"ms/step ({w0 / w1:.2f}x)")
    return rows


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        w = argparse.ArgumentParser()
        w.add_argument("--worker", nargs=4, metavar=("MODEL", "BATCH", "VARIANT", "MODE"))
        w.add_argument("--device", default=None)
        w.add_argument("--repeat", type=int, default=None)
        w.add_argument("--smoke", action="store_true")
        a = w.parse_args()
        worker(a.worker[0], int(a.worker[1]), a.worker[2], a.worker[3], a.device,
               a.smoke, a.repeat)
    else:
        main(**tool_args(__doc__.split("\n\n")[0]))
