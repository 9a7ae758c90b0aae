"""The command on and off the card: without a card it prints no result and
exits with another code than 0; in a directory that holds only
`BENCHMARK.json` and the benchmark's files it does the same; on a card a
short run of a cell prints a correct result line (marked `cuda`)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

CELL = "large-v3.beam5.b16.sparse"


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELL,
                           "--seed", str(2**31 + 3), "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=1200)


def _no_result(out):
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    return out.returncode != 0 and not any(l.lstrip().startswith("{") for l in lines)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_no_card_no_result(no_card):
    assert _no_result(_run(spec.ROOT, "--trace", "0"))


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    assert _no_result(_run(tmp_path, "--trace", "0"))


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_runs_on_the_card(card, trace):
    out = _run(spec.ROOT, "--trace", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in spec.cell(CELL)["end_to_end" if trace == "0" else "per_layer"]}
    assert set(res["metrics"]) == names
