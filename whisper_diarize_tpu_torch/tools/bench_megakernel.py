"""Decoder step time with and without the fused front, greedy and beam-5
(counterpart of `tools/bench_megakernel.py`).

The JAX tool decides whether the fused tail (K3) and the fused greedy front
(K8) pay for themselves: each variant's decode-step slope against the
un-fused step. The port's variants:

  tail        the port's step: K3 runs every single-token layer tail
  tail+front  K3 and K8 (`ops/front.py::pack_front_weights` attached to the
              decoder params): greedy only, as in JAX (beam steps read the
              split cache through K4)
  off         no counterpart: the port has no un-fused single-token step
              (`DecodeConfig` refuses `pallas_tail=False`); named in the
              summary, not timed

Each variant runs in its own subprocess (the JAX tool's rule: a process
keeps what its earlier configurations allocated), on `greedy_init` /
`greedy_run` or `beam_init` / `beam_run` (`ops/decode.py`), with
`init_params_fast` weights, audio `standard_normal * 0.1` (seed 0), the
plain mel and encoder, eot suppressed; each run re-initialises the loop
state, as production does. It times the slope between the 32- and 64-step
budgets (best of 5 each, host clock around `torch.cuda.synchronize()`),
bf16 on the card and f32 on the CPU, and prints one JSON line a variant,
then the summary and the verdict. `WDT_MEGAKERNEL_SMOKE=1` takes budgets 4
and 8, one call each (a plumbing check: the slope of so few steps is
noise). A worker that fails makes the tool fail.

    python -m whisper_diarize_tpu_torch.tools.bench_megakernel [model] [batch]
    python -m whisper_diarize_tpu_torch.tools.bench_megakernel --worker MODEL BATCH VARIANT MODE

Runs on CUDA device 0 and raises without a card (`--device cpu` for the
CPU, the tests). The first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import weights
from ..models import whisper as wm
from ..ops import decode as dec
from ..ops.front import pack_front_weights
from ..ops.mel import N_SAMPLES, log_mel_spectrogram
from ..tokenizer import DebugTokenizer
from ..utils import default_device
from . import timing

VARIANTS = {"greedy": ("off", "tail", "tail+front"), "beam": ("off", "tail")}
BUDGETS = {False: (32, 64, 5), True: (4, 8, 1)}  # smoke -> (short, long budget, calls)
OFF = ("no counterpart in the port: every single-token step runs K3 "
       "(DecodeConfig refuses pallas_tail=False)")
ROOT = Path(__file__).resolve().parents[2]


def _smoke(smoke: Optional[bool]) -> bool:
    return os.environ.get("WDT_MEGAKERNEL_SMOKE") == "1" if smoke is None else smoke


def measure(model: str, batch: int, variant: str, mode: str, device: Optional[str] = None,
            smoke: Optional[bool] = None) -> Tuple[dict, torch.Tensor]:
    """One variant's row (the JAX tool's keys: variant, mode, ms_per_step,
    t64_ms, the time of the longer budget's run) and the tokens [N, steps]
    of its last run."""
    if variant == "off":
        raise ValueError(f"bench_megakernel: variant 'off' has {OFF}")
    if variant not in VARIANTS.get(mode, ()):
        raise ValueError(f"bench_megakernel: no variant {variant!r} in mode {mode!r} "
                         f"(variants {VARIANTS})")
    smoke = _smoke(smoke)
    dev = default_device(device, "bench_megakernel")
    cfg = wm.PRESETS[model]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = weights.init_params_fast(cfg, dev, dtype)
    if variant == "tail+front":
        params = {**params, "decoder": {**params["decoder"],
                                        "front": pack_front_weights(params, cfg)}}
    tk = DebugTokenizer(num_languages=cfg.num_languages)
    sp = tk.specials
    b_lo, b_hi, reps = BUDGETS[smoke]
    dc = dec.DecodeConfig(max_tokens=b_hi, with_timestamps=True)
    audio = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (batch, N_SAMPLES)) * 0.1).astype(np.float32)).to(dev)
    prompt = torch.tensor([tk.sot_sequence(language="en")] * batch, device=dev)
    P = prompt.shape[1]
    suppress = torch.from_numpy(dec.build_suppress_mask(
        sp, cfg.n_vocab, extra_suppress=[sp.eot])).to(dev)

    with torch.inference_mode():
        xa = wm.encode(params, log_mel_spectrogram(audio, n_mels=cfg.n_mels), cfg)

        def run(budget):
            if mode == "greedy":
                st = dec.greedy_init(params, cfg, dc, sp, xa, prompt, P, suppress_mask=suppress)
                return dec.greedy_run(params, cfg, dc, sp, st, suppress, P, budget)["tokens"]
            st = dec.beam_init(params, cfg, dc, sp, xa, prompt, P)
            return dec.beam_run(params, cfg, dc, sp, st, suppress, P, budget)["tokens"]

        t_lo, _ = timing.best_ms(lambda: run(b_lo), dev, reps)
        t_hi, tokens = timing.best_ms(lambda: run(b_hi), dev, reps)
    return {"variant": variant, "mode": mode, "ms_per_step": (t_hi - t_lo) / (b_hi - b_lo),
            "t64_ms": t_hi}, tokens


def worker(model: str, batch: int, variant: str, mode: str, device: Optional[str] = None,
           smoke: Optional[bool] = None) -> Tuple[dict, torch.Tensor]:
    """`measure`, its row printed as one JSON line."""
    row, tokens = measure(model, batch, variant, mode, device, smoke)
    print(json.dumps(row), flush=True)
    return row, tokens


def _spawn(model: str, batch: int, variant: str, mode: str, device: Optional[str],
           smoke: bool) -> dict:
    """One worker in a subprocess; its last output line is its row."""
    cmd = [sys.executable, "-m", __spec__.name, "--worker", model, str(batch), variant, mode]
    if device is not None:
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    env["WDT_MEGAKERNEL_SMOKE"] = "1" if smoke else "0"
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=1800)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"bench_megakernel: worker {mode} {variant} failed "
                           f"({out.returncode}):\n{out.stdout[-2000:]}{out.stderr[-4000:]}")
    return json.loads(lines[-1])


def main(model: str = "large-v3", batch: int = 16, device: Optional[str] = None,
         smoke: Optional[bool] = None, inline: bool = False) -> List[dict]:
    """Each variant (a subprocess each; `inline`: in this process, as
    `chip_smoke.py` runs it to count the kernels' launches), the summary
    and the verdict. Returns the rows."""
    dev = default_device(device, "bench_megakernel")
    print(timing.card_line(dev), flush=True)
    smoke = _smoke(smoke)
    rows, ms = [], {}
    for mode, variants in VARIANTS.items():
        for variant in variants:
            if variant == "off":
                print(f"{mode:6s} {variant:10s} not timed: {OFF}", flush=True)
                continue
            row = (worker(model, batch, variant, mode, device, smoke)[0] if inline
                   else _spawn(model, batch, variant, mode, device, smoke))
            rows.append(row)
            ms[mode, variant] = row["ms_per_step"]
            print(f"{mode:6s} {variant:10s} {row['ms_per_step']:7.3f} ms/step "
                  f"({BUDGETS[smoke][1]}-step run {row['t64_ms']:.1f} ms)", flush=True)
    g_tail, g_full, b_tail = ms["greedy", "tail"], ms["greedy", "tail+front"], ms["beam", "tail"]
    print("\nverdict:")
    print(f"  greedy tail:       off not timed ({OFF}); tail {g_tail:.3f} ms/step")
    print(f"  greedy +front:     {g_tail:.3f} -> {g_full:.3f} ms/step "
          f"({'KEEP' if g_full < g_tail else 'DROP'})")
    print(f"  beam-5 tail:       off not timed; tail {b_tail:.3f} ms/step", flush=True)
    return rows


def _args(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", nargs="?", default="large-v3", choices=sorted(wm.PRESETS))
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("--device", default=None, help="cpu for the CPU (tests)")
    return vars(p.parse_args(argv))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        w = argparse.ArgumentParser()
        w.add_argument("--worker", nargs=4, metavar=("MODEL", "BATCH", "VARIANT", "MODE"))
        w.add_argument("--device", default=None)
        a = w.parse_args()
        worker(a.worker[0], int(a.worker[1]), a.worker[2], a.worker[3], a.device)
    else:
        main(**_args())
