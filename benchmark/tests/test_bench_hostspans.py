"""The readers of the program's own spans and counters
(`benchmark/hostspans.py`, the metrics `step_host_ms`,
`host_syncs_per_batch`, `engine_idle_ms_per_batch`): on a synthetic run
with known request summaries, spans and device idle gaps, without a
tracer, and on the CPU rehearsal at the tiny preset, where the counters
are real and the device trace is missing."""

import shutil
import tempfile

import pytest
import torch

from benchmark import hostspans, rehearse, spec
from benchmark.run import Cell

BASE = 1_790_000_000  # seconds on the profiler's clock (the Unix epoch)


def summary(profiled, steps, step_s, batches, syncs, rid):
    return {"id": rid, "profiled": profiled, "counters": {"host_sync": syncs},
            "spans": {"decode.step": {"count": steps, "seconds": step_s},
                      "batch": {"count": batches, "seconds": 1.0}}}


def host(name, start_ms, end_ms, thread=1, request=7, id=None, parent=None):
    return {"kind": "span", "name": name, "thread": thread, "request": request,
            "id": id, "parent": parent,
            "start_ns": BASE * 10**9 + int(start_ms * 1e6),
            "end_ns": BASE * 10**9 + int(end_ms * 1e6)}


def device(start_ms, end_ms):
    return (BASE + start_ms * 1e-3, BASE + end_ms * 1e-3, "kernel")


@pytest.fixture
def synthetic(monkeypatch):
    """The warm call, then a window of three calls, the first profiled
    (request 7); its traced stretch: the request's first two batches, the
    host's spans and the device's operations in milliseconds."""
    reqs = [summary(False, 64, 9.0, 10, 150, rid=6),  # the warm call
            summary(True, 128, 4.0, 12, 180, rid=7),  # the traced call
            summary(False, 128, 1.28, 12, 180, rid=8),
            summary(False, 64, 0.64, 12, 168, rid=9)]
    events = [
        host("request", -2, 100),
        host("engine.load", 1, 5), host("engine.read_wav", 5, 9),
        host("engine.schedule", 9, 10),
        host("batch", 10, 50), host("mel", 10, 12), host("decode", 12, 40),
        host("decode.prefill", 12, 14),
        host("decode.step", 14, 20, id=1), host("decode.model", 15, 19, parent=1),
        host("decode.step", 20, 26, id=2),
        host("engine.chunk_results", 40, 45), host("engine.finalize", 45, 50),
        host("engine.schedule", 50, 51),
        host("batch", 51, 90), host("decode", 51, 80), host("engine.emit", 90, 95),
        host("align.backtrack", 41, 60, thread=2),  # another thread: not the main one
    ]
    trace_spans = {"mel": [device(10.5, 12.5)],
                   "decode": [device(13, 14), device(14.5, 22), device(23, 40.5)],
                   "glue:decode": [device(47, 48)],
                   "decode2": [device(52, 79)], "glue:x": [device(92, 93)]}
    monkeypatch.setattr(hostspans, "requests", lambda: list(reqs))
    monkeypatch.setattr(hostspans, "stretch_events", lambda: list(events))
    monkeypatch.setattr(hostspans, "recorded_events", lambda: list(events))
    return {"window": {"calls": 3},
            "trace": {"spans": trace_spans, "window_s": 0.1, "busy_s": 0.05},
            "decodes": [{"traced": True}, {"traced": True}, {"traced": False}]}


def test_innermost_flattens_nested_spans():
    spans = [(0, 10, "a"), (2, 4, "b"), (3, 4, "c"), (6, 9, "d"), (11, 12, "e")]
    assert hostspans.innermost(spans) == [
        (0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"), (6, 9, "d"), (9, 10, "a"),
        (11, 12, "e")]


def test_readers_on_a_synthetic_run(synthetic):
    # the last three requests, less the traced call's two recorded 6 ms steps
    assert hostspans.step_host_ms(synthetic) == pytest.approx(
        1e3 * (4.0 - 0.012 + 1.28 + 0.64) / (126 + 192))
    assert hostspans.host_syncs_per_batch(synthetic) == pytest.approx((180 + 180 + 168) / 36)
    assert hostspans.steps_by_index(hostspans.stretch_events()) == {
        "0": {"n": 1, "step_ms": pytest.approx(6.0), "model_ms": pytest.approx(4.0)},
        "1": {"n": 1, "step_ms": pytest.approx(6.0), "model_ms": 0.0}}
    idle = hostspans.idle_by_span(synthetic)
    # the gaps (ms), from the request's start: -2-1 request, 1-5 load, 5-9
    # read_wav, 9-10 schedule, 10-10.5 mel; 12.5-13 prefill; 14-14.5, 22-23
    # decode.step; 40.5-45 chunk results, 45-47 finalize; 48-50 finalize,
    # 50-51 schedule, 51-52 decode; 79-80 decode, 80-90 batch, 90-92 emit
    # (thread 2 not read)
    want = {"request": 3e-3, "engine.load": 4e-3, "engine.read_wav": 4e-3, "mel": 0.5e-3,
            "decode.prefill": 0.5e-3, "decode": 2e-3, "decode.step": 1.5e-3, "engine.chunk_results": 4.5e-3,
            "engine.finalize": 4e-3, "engine.schedule": 2e-3, "batch": 10e-3,
            "engine.emit": 2e-3}
    assert set(idle) == set(want)
    for name, seconds in want.items():
        assert idle[name] == pytest.approx(seconds, abs=2e-6)
    assert hostspans.engine_idle_ms_per_batch(synthetic) == pytest.approx(20.5 / 2, abs=2e-3)


def test_a_window_of_the_profiled_call_alone(synthetic, monkeypatch):
    """A window of the traced call alone: its steps after the profiler
    stopped (its totals less its two recorded 6 ms steps) and its syncs a
    batch (counts, which the profiler does not change)."""
    reqs = hostspans.requests()[:2]  # the warm call, the traced call
    monkeypatch.setattr(hostspans, "requests", lambda: list(reqs))
    synthetic["window"]["calls"] = 1
    assert hostspans.step_host_ms(synthetic) == pytest.approx(1e3 * (4.0 - 0.012) / 126)
    assert hostspans.host_syncs_per_batch(synthetic) == pytest.approx(180 / 12)


def test_outside_any_span_and_without_a_tracer(synthetic, monkeypatch):
    events = hostspans.stretch_events()
    monkeypatch.setattr(hostspans, "stretch_events",
                        lambda: [e for e in events if e["name"] not in ("engine.emit", "request")]
                        + [host("request", 0, 91)])
    idle = hostspans.idle_by_span(synthetic)
    assert idle["request"] == pytest.approx(2e-3, abs=2e-6)  # 0 - 1, 90 - 91 ms
    assert idle[hostspans.OUTSIDE] == pytest.approx(1e-3, abs=2e-6)  # 91 - 92 ms
    monkeypatch.setattr(hostspans, "requests", lambda: [])
    monkeypatch.setattr(hostspans, "stretch_events", lambda: [])
    monkeypatch.setattr(hostspans, "recorded_events", lambda: [])
    assert hostspans.step_host_ms(synthetic) is None
    assert hostspans.host_syncs_per_batch(synthetic) is None
    assert hostspans.engine_idle_ms_per_batch(synthetic) is None


def rehearsal_ctx(workload, seed):
    sp = rehearse.rehearsal_cell(workload)
    workdir = tempfile.mkdtemp(prefix="wdt_hostspans_")
    try:
        cell = Cell(sp, seed, torch.device("cpu"), workdir)
        cell.warm()
        cell.window(0.0, trace=False)
        ctx = cell.context()
        cell.free_program()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return sp, ctx


@pytest.mark.parametrize("workload", ["large-v3.beam5.b16", "large-v3-turbo.diarize.b16"])
def test_rehearsal_counts_syncs_and_steps(workload):
    """A beam batch of 4 tokens reads the device 14 times: one poll, the
    chunk results' ten, the alignment's three; a diarized one adds its
    embedding fetch where the batch holds a chunk's first window, and the
    segmentation forwards' reads. No trace on the CPU: no idle reading."""
    sp, ctx = rehearsal_ctx(workload, 2**31 + 11)
    syncs = hostspans.host_syncs_per_batch(ctx)
    if sp["traffic"]["diarize"]:
        assert 14 < syncs <= 16
    else:
        assert syncs == 14
    assert hostspans.step_host_ms(ctx) > 0
    assert hostspans.engine_idle_ms_per_batch(ctx) is None
    for m in ("step_host_ms", "host_syncs_per_batch", "engine_idle_ms_per_batch"):
        assert spec.metric_reader(m)(ctx) == getattr(hostspans, m)(ctx)
