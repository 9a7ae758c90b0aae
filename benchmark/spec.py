"""A cell of `BENCHMARK.json` and the files it names, found by name:
`configs/<config>.json`, `traffic/<traffic>.json`, `limits/<cell>.json`
and `metrics/<metric>.py` (each a `read(ctx)` returning a number, or None
where the stretch it reads holds nothing to read). A traffic file with a key
the harness does not read is refused (`traffic.check_keys`)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, Optional

from .traffic import check_keys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def metric_reader(name: str, here: str = HERE) -> Callable[[Dict], Optional[float]]:
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Dict:
    """The cell `name` with its configuration, traffic, limits and the
    metrics it reports."""
    bench = benchmark(root)
    here = os.path.join(root, "benchmark")
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    traffic = load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    check_keys(traffic)
    return {
        "name": name,
        "chips": int(w["chips"]),
        "run_seconds": int(bench["run_seconds"]),
        "config_name": conf["name"],
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic_name": w["traffic"],
        "traffic": traffic,
        "limits": load_json(os.path.join(here, "limits", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m, name)],
        "per_layer": [m for m in bench["per_layer"] if reports(m, name)],
        "here": here,
    }

