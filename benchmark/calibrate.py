"""The readings a cell's limits are set from, on the card, in one process:
for each of `--seeds` one call of the cell's traffic through the program,
its numbers (the lower readings) and, for the first `--lowp-seeds`, the
control's (the reference one step of precision lower in the program's
place, `check.compute(lowp=True)`);
then for each of `--control-seeds` one call through the program's own
lower-precision path (`EngineConfig(quantize_kv_cache=True)`: the int8
cross K/V cache) and its numbers. One JSON line a reading.

    python3 -m benchmark.calibrate --workload large-v3.beam5.b16 \\
        --seeds 11 12 ... --control-seeds 91 92 93 [--lowp-seeds 4]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

from . import spec
from .run import Cell, quiet_program_logs, sample_plan, set_cache_dirs


def one(sp, seed: int, device, lowp: bool, int8_kv: bool = False):
    """One seed's readings from one call of the cell's traffic."""
    import torch

    workdir = tempfile.mkdtemp(prefix="wdt_calib_")
    try:
        t0 = time.perf_counter()
        cell = Cell(sp, seed, device, workdir, int8_kv=int8_kv)
        targets, seg_targets, layers = sample_plan(sp["traffic"], seed,
                                                   int(sp["config"]["decoder_layers"]), calls=1)
        cell.plan((targets, seg_targets, layers))
        cell.window(0.0, trace=False)
        wall = cell.wall_s
        cell.free_program()
        out = {"seed": seed, "int8_kv": int8_kv, "call_s": wall, "error": cell.error,
               "numbers": cell.numbers()}
        if lowp:
            out["control"] = cell.numbers(lowp=True)
        out["seconds"] = time.perf_counter() - t0
        del cell
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--lowp-seeds", type=int, default=4,
                   help="the first this many seeds also read the reference's control")
    args = p.parse_args(argv)
    set_cache_dirs(spec.ROOT)
    quiet_program_logs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    sp = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for k, seed in enumerate(args.seeds):
        print(json.dumps(one(sp, seed, device, lowp=k < args.lowp_seeds)), flush=True)
    for seed in args.control_seeds:
        print(json.dumps(one(sp, seed, device, lowp=False, int8_kv=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
