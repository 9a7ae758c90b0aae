"""A rehearsal of `run.py` on the CPU at the tiny preset: the same set-up,
window, probes and check through the kernels' plain versions, at a traffic
cut to a few short files (`--files`, `--tokens`, ...). It measures nothing:
every time and device number reads "not measured"; the counters and the
check are real.

    python3 -m benchmark.rehearse --workload large-v3.beam5.b16 --seed 3
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from . import check, spec
from .run import Cell, banned_modules, per_layer, quiet_program_logs

NOT_MEASURED = "not measured"


def rehearsal_cell(workload: str, files: int = 3, tokens: int = 4, batch: int = 2,
                   min_s: float = 30.0, max_s: float = 40.0) -> Dict:
    sp = spec.cell(workload)
    sp["config"] = spec.load_json(os.path.join(spec.HERE, "rehearsal", "tiny.json"))
    sp["traffic"] = dict(sp["traffic"], files_per_call=files, tokens_per_window=tokens,
                         batch_size=batch, length_s_min=min_s, length_s_max=max_s)
    return sp


def rehearse(sp: Dict, seed: int, seconds: float = 0.0, int8_kv: bool = False,
             lowp: bool = False) -> Dict:
    """One rehearsal run; the result line's dict, with the numbers the check
    compared under "checks" (and, with `lowp`, the control's instead)."""
    import torch

    device = torch.device("cpu")
    workdir = tempfile.mkdtemp(prefix="wdt_rehearse_")
    try:
        cell = Cell(sp, seed, device, workdir, int8_kv=int8_kv)
        cell.warm()
        cell.window(seconds, trace=False)
        ctx = cell.context()
        cell.free_program()
        numbers = {} if cell.error else cell.numbers(lowp=lowp)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ok, checks = check.verdict(numbers, sp["limits"])
    metrics = {m["name"]: {"value": NOT_MEASURED, "unit": m["unit"]}
               for m in sp["end_to_end"] + sp["per_layer"]}
    for name, item in per_layer(sp, ctx).items():
        if name == "batch_fill":  # a program counter: the CPU counts it as the card would
            metrics[name] = item
    return {"correct": bool(ok and not cell.error), "attempted": len(cell.calls) * len(cell.paths),
            "failed": cell.failed, "metrics": metrics,
            "device": {"platform": "cpu", "kind": NOT_MEASURED, "count": 0,
                       "memory_peak_bytes": NOT_MEASURED},
            "error": cell.error, "numbers": numbers, "windows": cell.windows,
            "banned": banned_modules(),
            "checks": checks}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--files", type=int, default=3)
    p.add_argument("--tokens", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    quiet_program_logs()
    sp = rehearsal_cell(args.workload, args.files, args.tokens, args.batch)
    out = rehearse(sp, args.seed, args.seconds)
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU", file=sys.stderr)
    print(json.dumps(out, default=str))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
