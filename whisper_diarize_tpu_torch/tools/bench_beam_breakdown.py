"""A beam-5 decode step taken apart, large-v3 at batch 16 (N = 80 beam
rows) (counterpart of `tools/bench_beam_breakdown.py`).

Parts, the JAX tool's names:

  run          `beam_run`: the slope between the 32- and 64-step budgets,
               a fresh `beam_init` each call (its cost cancels); its steps
               replay the beam step's CUDA graph where one engages
               (`ops/beam_graph.py`, held for the part)
  model        bare `decode_step_split` at N = 80 on a fixed token (K4 and
               K3 every layer), the ancestry map fixed
  modelgather  `model` with the ancestry map rotated within each stream
               every step: the port never permutes the decode cache (K4
               reads it through `anc`), where the JAX part permuted dk / dv
  modelmul     `model` with an elementwise pass over dk / dv (the volume of
               the JAX part's gather)
  gather       the per-step reindex the port does: the ancestry map and the
               beam state by `new_src` (a rotation within each stream)
  topk         the exact two-stage top-2K of `ops/decode.py::_top_k` (a
               stable sort of all V columns of each of the N rows, ties to
               the lower index as `jax.lax.top_k` orders them), on random
               logits
  sample       `beam_run`'s step without the model (`ops/decode.py::
               beam_sample`: the timestamp grammar, the two-stage top-2K,
               the EOT retirement, the bookkeeping), the new tokens fed back
               into the logits

Each part's row (`timing.phase_row`): wall and profiled device ms a step,
the busy share and the device operations a step, over the 32- and 64-step
budgets (best of `repeat`). Each part runs in its own subprocess (`WDT_PART`
selects it in the child, as in the JAX tool), or all in this process with
`inline` (`chip_smoke.py`, which counts the kernels' launches). Weights
`init_params_fast`, audio states `standard_normal * 0.05` (seed 0), eot
suppressed, bf16 on the card. `--smoke`: budgets 4 and 8.

    python -m whisper_diarize_tpu_torch.tools.bench_beam_breakdown [model] [batch]
        [--device cpu] [--repeat N] [--smoke]

Runs on CUDA device 0 and raises without a card (`--device cpu` for the
CPU). The first line names the card and its power limit.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import whisper as wm
from ..ops import decode as dec
from . import timing
from .bench_decode_breakdown import (B, FIXED_TOKEN, fresh, random_xa, run_parts, setup,
                                     tool_args)

K = 5
PARTS = ("run", "model", "modelgather", "modelmul", "gather", "topk", "sample")
NOTES = {
    "model": "K4 + K3, ancestry map fixed",
    "modelgather": "anc rotated within each stream every step (the port never permutes "
                   "dk / dv; the JAX part did)",
    "modelmul": "an elementwise pass over dk / dv",
    "gather": "anc and the beam state reindexed by new_src (JAX: the decode cache)",
    "topk": "stable sort of all V columns a row (jax.lax.top_k's tie order)",
    "sample": "beam_sample: beam_run's step without the model",
}
# the beam state `gather` reindexes, as `beam_sample` and `beam_run` do
REINDEXED = ("tokens", "probs", "length", "last_was_ts", "max_ts_tok", "ts_seen", "scores",
             "anc")


def rotation(N: int, step: int, device) -> torch.Tensor:
    """The JAX part's permutation: beam k of each stream takes beam (k +
    step) % K's row."""
    base = torch.arange(N, device=device)
    return (base // K) * K + (base + step) % K


def model_loop(b: SimpleNamespace, state: Dict[str, Any], budget: int, form: str = "model"
               ) -> torch.Tensor:
    """`budget` bare `decode_step_split`s at N rows on the fixed token over
    `state`'s caches (the decode cache written in place, slots 0 .. budget -
    1): `form` "model" keeps the ancestry map, "modelgather" rotates it
    every step, "modelmul" passes over dk / dv. Returns the accumulated
    logit of vocabulary entry 0 [N]."""
    c, N = state["cache"], state["scores"].shape[0]
    tok = torch.full((N, 1), FIXED_TOKEN, dtype=torch.long, device=b.dev)
    acc = torch.zeros((N,), dtype=torch.float32, device=b.dev)
    anc = state["anc"].clone()
    rows = torch.arange(N, device=b.dev)
    for step in range(budget):
        if form == "modelgather":
            anc = anc[rotation(N, step, b.dev)]
            anc[:, step] = rows
        elif form == "modelmul":
            f = 1.0 + step * 1e-12
            c["dk"].mul_(f)
            c["dv"].mul_(f)
        logits = wm.decode_step_split(
            b.params, b.cfg, tok, step, {"k": c["pk"], "v": c["pv"]},
            {"k": c["dk"], "v": c["dv"]}, state["cross"], b.P, K, state["row_pad"], anc)
        acc = acc + logits[:, 0, 0]
    return acc


def gather_loop(b: SimpleNamespace, state: Dict[str, Any], budget: int) -> torch.Tensor:
    """`budget` steps of the beam state's reindex by a rotation within each
    stream, and the ancestry map's new slot. Returns the ancestry map."""
    s = {k: state[k].clone() for k in REINDEXED}
    N = s["scores"].shape[0]
    rows = torch.arange(N, device=b.dev)
    for step in range(budget):
        new_src = rotation(N, step, b.dev)
        for k in REINDEXED:
            s[k] = s[k][new_src]
        s["anc"][:, step] = rows
    return s["anc"]


def topk_step(logits: torch.Tensor, B_: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact two-stage top-2K of a beam step on raw logits [B*K, V]: per
    row over V, then pooled over the stream's K * 2K candidates (`_top_k`
    both times) -> (values, flat candidate index beam * V + token) [B, 2K]."""
    N, V = logits.shape
    v1, i1 = dec._top_k(logits, 2 * K)
    v1 = v1.reshape(B_, K * 2 * K)
    i1 = (i1 + (torch.arange(N, device=logits.device) % K)[:, None] * V).reshape(B_, K * 2 * K)
    topv, sel = dec._top_k(v1, 2 * K)
    return topv, torch.gather(i1, 1, sel)


def topk_loop(logits0: torch.Tensor, B_: int, budget: int) -> torch.Tensor:
    """`budget` two-stage top-2Ks, each step's best value fed back into the
    logits; returns the accumulated best values [1]."""
    logits = logits0.clone()
    acc = torch.zeros((1,), dtype=torch.float32, device=logits.device)
    for _ in range(budget):
        topv, _ = topk_step(logits, B_)
        logits[:, 0] += topv[0, 0] * 1e-9
        acc = acc + topv[0, 0]
    return acc


SAMPLE_KEYS = ("step", "logits", "tokens", "probs", "scores", "length", "last_was_ts",
               "penult_was_ts", "max_ts_tok", "ts_seen", "fin_tokens", "fin_probs",
               "fin_scores", "fin_lengths", "fin_count")


def sample_loop(b: SimpleNamespace, state: Dict[str, Any], budget: int) -> torch.Tensor:
    """`budget` steps of `beam_sample` with no model, from a copy of the
    beam state's sampling part: each step's new tokens are fed back into
    the logits (`+ token * 1e-9` on vocabulary entry 0). Returns the active
    beams' tokens [N, steps]."""
    s = fresh({k: state[k] for k in SAMPLE_KEYS})
    rows = torch.arange(s["scores"].shape[0], device=b.dev)
    while s["step"] < budget:
        new_tok, _ = dec.beam_sample(s, b.suppress, b.sp, b.dc, rows)
        s["logits"][:, 0] += new_tok.float() * 1e-9
        s["step"] += 1
    return s["tokens"]


def beam_setup(model: str, batch: int, dev: torch.device, steps: int,
               params: Optional[Dict[str, Any]] = None) -> SimpleNamespace:
    """`setup` for beam 5 over random audio states `xa`."""
    b = setup(wm.PRESETS[model] if isinstance(model, str) else model, batch, dev, steps,
              params, beam_size=K)
    b.xa = random_xa(b)
    return b


def part_row(b: SimpleNamespace, part: str, budgets: Tuple[int, int], repeat: int) -> dict:
    """One part's row on `b`."""
    cfg, dc, sp, P = b.cfg, b.dc, b.sp, b.P
    N = b.B * K

    def init(graph=None):
        return dec.beam_init(b.params, cfg, dc, sp, b.xa, b.prompt, P, graph=graph)

    state = init() if part not in ("run", "topk") else None
    logits0 = (torch.from_numpy(np.random.default_rng(0).standard_normal(
        (N, cfg.n_vocab)).astype(np.float32)).to(b.dev) if part == "topk" else None)
    with (dec.beam_hold(b.params, cfg, dc, b.xa) if part == "run"
          else contextlib.nullcontext()) as graph:
        runs = {
            "run": lambda n: dec.beam_run(b.params, cfg, dc, sp, init(graph), b.suppress, P,
                                          n)["tokens"],
            "gather": lambda n: gather_loop(b, state, n),
            "topk": lambda n: topk_loop(logits0, b.B, n),
            "sample": lambda n: sample_loop(b, state, n),
        }
        run = runs.get(part, lambda n: model_loop(b, state, n, part))
        name = {"run": "beam_run"}.get(part, f"{part}_N{N}" if part.startswith("model") else part)
        return timing.phase_row(name, run, b.dev, budgets, repeat, note=NOTES.get(part))


def main(model: str = "large-v3", batch: int = B, device: Optional[str] = None,
         smoke: Optional[bool] = None, repeat: Optional[int] = None, inline: bool = False,
         parts=PARTS) -> List[dict]:
    """Each of `parts` (a subprocess each unless `inline`, `run_parts`),
    printed; returns the rows."""
    return run_parts(__spec__.name, parts, PARTS, model, batch, device, smoke, repeat, inline,
                     beam_setup, part_row)


if __name__ == "__main__":
    main(**tool_args(__doc__.split("\n\n")[0]))
