"""BENCHMARK.json and the files it names: the contract's shapes, names and
units, each file found by name, and a cell added as new files and entries
only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import check, run, spec, traffic

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_entries(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and w["config"] in names
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in bench["workloads"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(cells) == len(bench["workloads"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics", "limits"])
def test_every_file_is_found_by_name(bench, kind):
    for w in bench["workloads"]:
        sp = spec.cell(w["name"])
        assert sp["config"]["source"] and sp["traffic"]["why"] and sp["limits"]
        handling = sp["traffic"]["handling"]
        assert handling["suppress"] and "fallback_ladder" in handling
        assert sp["traffic"]["config_source"].startswith("https://")
        for m in sp["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))


def test_metric_files_name_source_and_layer(bench):
    for m in bench["per_layer"]:
        with open(os.path.join(spec.HERE, "metrics", f"{m['name']}.py")) as f:
            doc = f.read()
        doc = " ".join(doc.split())
        assert "Layer:" in doc and "Source:" in doc and "Moves xrt" in doc


def test_a_cell_is_added_by_new_files_and_entries(tmp_path, bench):
    """A configuration, a traffic mix, a per-layer metric and their cell
    added to a copy: new files and new entries, no file of the copy edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(spec.HERE, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(copy / "benchmark") for p in fs}
    here = copy / "benchmark"
    shutil.copy(here / "configs" / "large-v3.json", here / "configs" / "throwaway.json")
    tr = json.loads((here / "traffic" / "beam5.b16.json").read_text())
    tr["tokens_per_window"] = 8
    (here / "traffic" / "beam8.b16.json").write_text(json.dumps(tr))
    (here / "limits" / "throwaway.beam8.b16.json").write_text(json.dumps({"mel_err": 1.0}))
    (here / "metrics" / "throwaway_share.py").write_text(
        '"""Layer: test. Source: program counter. Moves xrt."""\n\n\n'
        "def read(ctx):\n    return 42.0 if ctx['decodes'] else None\n")
    b = json.loads((copy / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "throwaway", "source": "https://example.org/c",
                         "file": "benchmark/configs/throwaway.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "throwaway.beam8.b16", "config": "throwaway",
                           "traffic": "beam8.b16", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "throwaway_share", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "test", "moves": "xrt",
                           "workloads": ["throwaway.beam8.b16"]})
    # a cell that serves f32 with the int8 cross K/V cache: files and entries only
    conf = json.loads((here / "configs" / "large-v3.json").read_text())
    conf["served_dtype"] = "float32"
    (here / "configs" / "throwaway-f32.json").write_text(json.dumps(conf))
    (here / "traffic" / "beam5.b16.int8kv.json").write_text(
        json.dumps(dict(tr, tokens_per_window=64, engine={"quantize_kv_cache": True})))
    (here / "limits" / "throwaway-f32.beam5.b16.int8kv.json").write_text(
        json.dumps({"mel_err": 1.0}))
    b["configs"].append({"name": "throwaway-f32", "source": "https://example.org/c",
                         "file": "benchmark/configs/throwaway-f32.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "throwaway-f32.beam5.b16.int8kv", "config": "throwaway-f32",
                           "traffic": "beam5.b16.int8kv", "chips": 1, "why": "test"})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    f32 = spec.cell("throwaway-f32.beam5.b16.int8kv", root=str(copy))
    cfg, opts = run.engine_settings(f32, 5, torch.device("cpu"), str(tmp_path))
    assert cfg.dtype == "float32" and cfg.quantize_kv_cache and cfg.max_decode_tokens == 64
    assert check.lower(f32["config"]) is not None and opts.advanced.best_of_or_beam_size == 5
    cfg, _ = run.engine_settings(spec.cell("large-v3.beam5.b16", root=str(copy)), 5,
                                 torch.device("cpu"), str(tmp_path))
    assert cfg.dtype == "bfloat16" and not cfg.quantize_kv_cache
    sp = spec.cell("throwaway.beam8.b16", root=str(copy))
    assert sp["traffic"]["tokens_per_window"] == 8 and sp["limits"] == {"mel_err": 1.0}
    assert [m["name"] for m in sp["per_layer"]][-1] == "throwaway_share"
    read = spec.metric_reader("throwaway_share", str(here))
    assert read({"decodes": [1]}) == 42.0 and read({"decodes": []}) is None
    assert "throwaway_share" not in [m["name"] for m in spec.cell(
        "large-v3.beam5.b16", root=str(copy))["per_layer"]]
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(copy / "benchmark") for p in fs}
    assert all(after[p] == before[p] for p in before)


def test_traffic_and_engine_keys_the_harness_does_not_read_are_refused(tmp_path):
    sp = spec.cell("large-v3.beam5.b16")
    tr = sp["traffic"]
    traffic.check_keys(tr)
    for bad in (dict(tr, burst=3), dict(tr, handling=dict(tr["handling"], vad_turns=True))):
        with pytest.raises(ValueError, match="does not read"):
            traffic.check_keys(bad)
    traffic.check_keys(dict(tr, burst_note="a comment"))
    for engine in ({"quantize_kv_cache": True, "no_such_field": 1}, {"batch_size": 32}):
        with pytest.raises(ValueError, match="not passed to EngineConfig"):
            run.engine_settings(dict(sp, traffic=dict(tr, engine=engine)), 5,
                                torch.device("cpu"), str(tmp_path))
    with pytest.raises(ValueError, match="not passed to AdvancedTranscribe"):
        run.engine_settings(dict(sp, traffic=dict(tr, advanced={"sampling_strategy": "greedy"})),
                            5, torch.device("cpu"), str(tmp_path))
    cfg, opts = run.engine_settings(
        dict(sp, traffic=dict(tr, engine={"draft_model_path": "__random__:tiny:{seed}",
                                          "speculative_gamma": 3},
                              advanced={"temperature": 0.0})),
        2**31 + 9, torch.device("cpu"), str(tmp_path))
    assert cfg.draft_model_path == f"__random__:tiny:{2**31 + 9}" and cfg.speculative_gamma == 3
    assert opts.advanced.temperature == 0.0


METRIC_FILES = ("from benchmark import spec\n"
                "for m in spec.benchmark()['per_layer']:\n"
                "    spec.metric_reader(m['name'])\n")
IMPORTS = {
    "harness": "import benchmark.run, benchmark.calibrate, benchmark.rehearse, benchmark.probes, "
               "benchmark.devtrace, benchmark.check\n" + METRIC_FILES,
    "reference": "import benchmark.reference.whisper_ref, benchmark.reference.segmentation, "
                 "benchmark.reference.campplus, benchmark.reference.precision",
}


@pytest.mark.parametrize("part", sorted(IMPORTS))
def test_fresh_interpreter_loads_no_jax(part):
    code = (IMPORTS[part] + "\nimport sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "whisper_diarize_tpu"}
    if part == "reference":
        assert "whisper_diarize_tpu_torch" not in top
