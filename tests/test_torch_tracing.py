"""The port's tracer (`whisper_diarize_tpu_torch/tracing.py`) on the CPU:
three Engine requests at the tiny preset (random weights), beam 5 with
language detection, greedy with diarization and the fallback ladder, and
greedy behind VAD, each recorded, against counts taken outside the tracer
(the sampling calls, `pack_batch`'s rows and slots, every device-to-host
read a tensor method makes); then recording off, under `torch.profiler`,
and the clock of the recorded spans against the profiler's own events."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from whisper_diarize_tpu_torch import tracing
from whisper_diarize_tpu_torch.audio import write_wav
from whisper_diarize_tpu_torch.engine import Engine, EngineConfig
from whisper_diarize_tpu_torch.ops import decode as dec
from whisper_diarize_tpu_torch.ops import dtw as dtw_ops
from whisper_diarize_tpu_torch.ops import prng
from whisper_diarize_tpu_torch.parallel import batching
from whisper_diarize_tpu_torch.types import AdvancedTranscribe, TranscribeOptions

torch.set_num_threads(2)

# tensor methods that read the device's memory on the host
READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__")
CASES = {
    "beam": dict(options=TranscribeOptions(enable_vad=False), seconds=(35, 20),
                 engine=dict(temperature_fallback=False),
                 sites={"lang", "decode.poll", "align.launch", "align.backtrack",
                        "chunk_results"}),
    "greedy-diarize": dict(
        options=TranscribeOptions(enable_diarize=True, lang="en",
                                  advanced=AdvancedTranscribe(sampling_strategy="greedy")),
        seconds=(12, 7), engine=dict(temperature_fallback=True),
        sites={"segment", "embed", "fallback", "decode.poll", "align.launch",
               "align.backtrack", "chunk_results"}),
    "greedy-vad": dict(
        options=TranscribeOptions(enable_vad=True, lang="en",
                                  advanced=AdvancedTranscribe(sampling_strategy="greedy")),
        seconds=(9, 6), engine=dict(temperature_fallback=False),
        sites={"vad", "decode.poll", "align.launch", "align.backtrack", "chunk_results"}),
}
STAGES = {"mel", "encode", "decode", "embed", "cross_kv", "lang", "align", "chunk_results",
          "segment", "vad", "format"}


@contextlib.contextmanager
def observed():
    """Counts made outside the tracer while the block runs: the calls of
    `beam_sample` / `greedy_sample` and `pack_batch` (its rows and slots),
    and every call of a tensor method in READS but inside the DTW's plain
    version (its loop bounds: a card runs the kernel, which reads nothing)
    and `Threefry.split` (its keys live on the host on every device)."""
    seen = {"steps": 0, "batches": 0, "rows": 0, "slots": 0, "reads": 0}
    lock = threading.Lock()
    plain = threading.local()
    undo = []

    def bump(key, n=1):
        if key == "reads" and getattr(plain, "inside", False):
            return
        with lock:
            seen[key] += n

    def patch(owner, name, new):
        had = name in vars(owner)
        old = vars(owner).get(name)
        setattr(owner, name, new)
        undo.append(lambda: setattr(owner, name, old) if had else delattr(owner, name))

    for name in ("beam_sample", "greedy_sample"):
        def sample(*args, _orig=getattr(dec, name), **kwargs):
            bump("steps")
            return _orig(*args, **kwargs)
        patch(dec, name, sample)
    pack_orig = batching.pack_batch

    def pack_batch(group, batch_size):
        bump("batches")
        bump("rows", len(group))
        bump("slots", batch_size)
        return pack_orig(group, batch_size)

    patch(batching, "pack_batch", pack_batch)
    for owner, name in ((dtw_ops, "dtw_anchor_frames_plain"), (prng.Threefry, "split")):
        def on_host(*args, _orig=getattr(owner, name), **kwargs):
            plain.inside = True
            try:
                return _orig(*args, **kwargs)
            finally:
                plain.inside = False
        patch(owner, name, on_host)
    for name in READS:
        def read(self, *args, _orig=getattr(torch.Tensor, name), **kwargs):
            bump("reads")
            return _orig(self, *args, **kwargs)
        patch(torch.Tensor, name, read)
    try:
        yield seen
    finally:
        while undo:
            undo.pop()()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's request, recorded: (summary, its stretch's events,
    `last_run`, the outside counts)."""
    tmp = tmp_path_factory.mktemp("tracing")
    rng = np.random.default_rng(0)
    out = {}
    for case, c in CASES.items():
        paths = []
        for i, sec in enumerate(c["seconds"]):
            p = str(tmp / f"{case}{i}.wav")
            write_wav(p, (rng.standard_normal(16000 * sec) * 4000).astype(np.int16))
            paths.append(p)
        eng = Engine(EngineConfig(
            use_gpu=False, cache_dir=str(tmp / "cache"), whisper_model_path="__random__:tiny:0",
            vad_model_path="__random__", diarize_segment_model_path="__random__",
            diarize_embedding_model_path="__random__", allow_random_weights=True,
            batch_size=2, max_decode_tokens=4, **c["engine"]))
        tracing.enable()
        try:
            with observed() as seen:
                eng.transcribe_audio_batch(paths, c["options"])
        finally:
            tracing.disable()
        summary = tracing.requests()[-1]
        out[case] = (summary, [e for e in tracing.events(tracing.stretch())
                               if e["request"] == summary["id"]], eng.last_run, seen)
    return out


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_under_one_request(runs, case):
    summary, events, _, _ = runs[case]
    spans = {e["id"]: e for e in events if e["kind"] == "span"}
    roots = [e for e in spans.values() if e["name"] == "request"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    root = roots[0]
    for e in events:
        assert e["request"] == summary["id"]
        hop, seen = e, 0
        while hop["parent"] is not None:
            hop = spans[hop["parent"]]
            seen += 1
            assert seen < 16
        assert hop is root or e is root
        if e["kind"] == "span":
            assert root["start_ns"] <= e["start_ns"] <= e["end_ns"] <= root["end_ns"]
    # the backtrack runs on its own thread, under the launch that started it
    backtracks = [e for e in events if e["name"] == "align.backtrack"]
    assert backtracks
    for e in backtracks:
        assert e["thread"] != root["thread"]
        assert spans[e["parent"]]["name"] == "align.launch"
    counted = {}
    for e in events:
        if e["kind"] == "span":
            counted[e["name"]] = counted.get(e["name"], 0) + 1
    assert counted == {k: v["count"] for k, v in summary["spans"].items()}


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_are_the_sampling_calls(runs, case):
    summary, _, _, seen = runs[case]
    steps = seen["steps"]
    assert steps > 0
    assert summary["counters"]["decode.steps"] == steps
    for name in ("decode.step", "decode.sample", "decode.model"):
        assert summary["spans"][name]["count"] == steps


@pytest.mark.parametrize("case", CASES)
def test_batch_counters_are_pack_batch(runs, case):
    summary, _, last_run, seen = runs[case]
    assert summary["counters"]["batch.rows"] == seen["rows"] == last_run["windows"]
    assert summary["counters"]["batch.slots"] == seen["slots"] == 2 * seen["batches"]
    assert summary["spans"]["batch"]["count"] == seen["batches"]


@pytest.mark.parametrize("case", CASES)
def test_host_syncs_are_every_read(runs, case):
    summary, _, _, seen = runs[case]
    assert summary["counters"]["host_sync"] == seen["reads"]
    assert set(summary["sites"]["host_sync"]) == CASES[case]["sites"]
    assert sum(summary["sites"]["host_sync"].values()) == seen["reads"]


@pytest.mark.parametrize("case", CASES)
def test_last_run_is_a_view_of_the_request(runs, case):
    summary, _, last_run, _ = runs[case]
    assert set(last_run) == {"windows", "stage_s", "counters", "request"}
    assert last_run["request"] == summary["id"]
    assert last_run["counters"] == summary["counters"]
    assert set(last_run["stage_s"]) == STAGES
    spans = summary["spans"]
    assert last_run["stage_s"]["decode"] == spans["decode"]["seconds"]
    assert last_run["stage_s"]["align"] == pytest.approx(
        spans["align.launch"]["seconds"] + spans["align.wait"]["seconds"])
    diarized = case == "greedy-diarize"
    assert (last_run["stage_s"]["embed"] > 0) == diarized
    assert (last_run["stage_s"]["segment"] > 0) == diarized
    assert (last_run["stage_s"]["vad"] > 0) == (case == "greedy-vad")
    assert last_run["stage_s"]["format"] == spans["engine.format"]["seconds"] > 0
    assert spans["decode"]["seconds"] >= spans["decode.step"]["seconds"]
    assert summary["profiled"] is False


def test_off_records_nothing_but_totals():
    before = len(tracing.events())
    with tracing.request(kind="off") as req:
        with tracing.span("outer"):
            with tracing.span("inner"):
                tracing.count("host_sync", 2, site="here")
    assert len(tracing.events()) == before
    summary = tracing.requests()[-1]
    assert summary["id"] == req.id and summary["attrs"] == {"kind": "off"}
    assert summary["spans"]["inner"]["count"] == 1
    assert summary["spans"]["outer"]["seconds"] >= summary["spans"]["inner"]["seconds"]
    assert summary["counters"] == {"host_sync": 2}
    assert summary["sites"] == {"host_sync": {"here": 2}}
    assert summary["profiled"] is False
    with tracing.span("outside"):  # no request: no totals, nothing recorded
        tracing.count("host_sync")
    assert tracing.requests()[-1] == summary and len(tracing.events()) == before


def test_profiler_switches_recording_on_and_off():
    first = tracing.stretch()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.request() as req:
            with tracing.span("inside"):
                pass
            late = tracing.span("late")
            late.__enter__()
    late.__exit__(None, None, None)  # started while recording: kept
    on = tracing.stretch()
    assert on == first + 1
    assert req.summary()["profiled"] is True
    names = [e["name"] for e in tracing.events(on)]
    assert names == ["inside", "request", "late"]  # in the order they ended
    with tracing.request():
        with tracing.span("after"):
            pass
    assert tracing.stretch() == on
    assert all(e["name"] != "after" for e in tracing.events())
    assert tracing.requests()[-1]["profiled"] is False


def test_span_holds_a_profiled_op_and_merges_with_its_trace(tmp_path):
    """The span's interval, on the profiler's clock, contains the CPU op
    launched inside it, as the profiler recorded it; the Chrome trace
    merges into the profiler's export on its time base."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("clock"):
            time.sleep(0.005)
            torch.mm(a, b)
            time.sleep(0.005)
    span = [e for e in tracing.events(tracing.stretch()) if e["name"] == "clock"][-1]
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    # the sleeps leave 5 ms on each side: a clock off by more breaks this
    assert span["start_ns"] <= start <= end <= span["end_ns"]
    exported = str(tmp_path / "profile.json")
    prof.export_chrome_trace(exported)
    merged = str(tmp_path / "merged.json")
    tracing.write_chrome_trace(merged, merge_with=exported, stretch_no=tracing.stretch())
    with open(merged) as f:
        trace = json.load(f)
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "wdt" and e["name"] == "clock"]
    theirs = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert len(ours) == 1 and len(theirs) == 1
    assert ours[0]["ts"] <= theirs[0]["ts"] <= theirs[0]["ts"] + theirs[0]["dur"] \
        <= ours[0]["ts"] + ours[0]["dur"]
