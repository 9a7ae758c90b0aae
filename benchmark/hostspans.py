"""What the program's own tracer (`whisper_diarize_tpu_torch/tracing.py`)
recorded in a run, read for three per-layer metrics, and the traced
stretch's device idle put down to the span the host was in.

The program keeps a summary of each of its latest requests (one
`Engine.transcribe_audio_batch` call each: span counts and host seconds by
name, counter sums) and, while a profiler records, each span's event on
the profiler's clock. The probes' profiler session over the traced call
(`devtrace.Tracer`) is such a recording, so the traced call's spans come
with no probe of this file's own. A program without that tracer gives
None for every reading here.

- `step_host_ms`: `decode.step` seconds over its count, summed over the
  window's requests less the steps the profiler recorded (their totals
  less their recorded events);
- `host_syncs_per_batch`: the `host_sync` counter over the `batch` spans,
  in the window's requests (the profiler changes no count);
- `engine_idle_ms_per_batch`: the traced stretch's device idle (from the
  traced request's start) while the main thread's innermost open span was
  an Engine span that enqueues no device work (ENGINE_HOST), over the
  traced decode batches.

    python3 -m benchmark.hostspans --workload <cell> --seed <n> [--seconds S]
        [--trace 0|1] [--out FILE]

runs `benchmark.run` once (`--trace 1` by default) and writes the window's
request summaries and, in a traced run, the idle by innermost span and the
traced steps' host ms by their index in the loop (`steps_by_index`) to FILE
(JSON; by default under `build/hostspans/`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Engine spans whose own work is host work: device idle under them is the
# host's (loading, reading audio, scheduling, reading results, emitting)
ENGINE_HOST = ("engine.load", "engine.read_wav", "engine.schedule", "engine.chunk_results",
               "engine.finalize", "engine.emit")
OUTSIDE = "(no span)"  # device idle while the main thread was in no span
NS = 1e-9

Interval = Tuple[float, float]


def _tracing():
    try:
        from whisper_diarize_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def requests() -> List[Dict]:
    """The program's request summaries, oldest first ([] without a tracer)."""
    t = _tracing()
    return t.requests() if t is not None else []


def recorded_events() -> List[Dict]:
    """Every recorded event the program holds ([] without a tracer)."""
    t = _tracing()
    return t.events() if t is not None else []


def stretch_events() -> List[Dict]:
    """The recorded events of the program's latest stretch ([] without)."""
    t = _tracing()
    if t is None or not t.stretch():
        return []
    return t.events(t.stretch())


def window_requests(ctx: Dict) -> List[Dict]:
    """The summaries of the window's calls: the last `ctx["window"]["calls"]`
    requests (the warm call is before them)."""
    n = int(ctx["window"]["calls"])
    return requests()[-n:] if n else []


def _span_total(reqs: Iterable[Dict], name: str) -> Tuple[int, float]:
    count, seconds = 0, 0.0
    for r in reqs:
        s = r["spans"].get(name)
        if s:
            count += s["count"]
            seconds += s["seconds"]
    return count, seconds


def step_host_ms(ctx: Dict) -> Optional[float]:
    reqs = window_requests(ctx)
    count, seconds = _span_total(reqs, "decode.step")
    ids = {r["id"] for r in reqs}
    for e in recorded_events():  # less the steps recorded (under the profiler)
        if e["kind"] == "span" and e["name"] == "decode.step" and e["request"] in ids:
            count -= 1
            seconds -= (e["end_ns"] - e["start_ns"]) * NS
    return 1e3 * seconds / count if count > 0 else None


def host_syncs_per_batch(ctx: Dict) -> Optional[float]:
    reqs = window_requests(ctx)
    batches, _ = _span_total(reqs, "batch")
    if not batches:
        return None
    return sum(r["counters"].get("host_sync", 0) for r in reqs) / batches


def device_idle(spans: Dict[str, List[Tuple[float, float, str]]],
                start_s: Optional[float] = None) -> List[Interval]:
    """The gaps between the union of the trace's device events (seconds
    on the profiler's clock), from `start_s` (else the first event's
    start) to the last event's end."""
    gaps: List[Interval] = []
    end = start_s
    for start, stop in sorted((s, e) for evs in spans.values() for s, e, _ in evs):
        if end is not None and start > end:
            gaps.append((end, start))
        end = stop if end is None else max(end, stop)
    return gaps


def innermost(spans: Iterable[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """One thread's nested spans (start, end, name) flattened into the
    stretches in which each was the innermost open span, in time order."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []  # (end, name), innermost last
    cursor = 0.0
    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= start:
            stop, closed = stack.pop()
            out.append((cursor, stop, closed))
            cursor = stop
        if stack:
            out.append((cursor, start, stack[-1][1]))
        cursor = start
        stack.append((end, name))
    while stack:
        stop, closed = stack.pop()
        out.append((cursor, stop, closed))
        cursor = stop
    return [s for s in out if s[1] > s[0]]


def idle_by_span(ctx: Dict) -> Optional[Dict[str, float]]:
    """The traced stretch's device idle seconds by the main thread's
    innermost open span (OUTSIDE: none open), or None where the trace or
    the program's recorded spans are missing. The main thread is the one
    that ran the `request` span; the idle counts from the request's start
    (the trace's first marker ran just before it) to the last device
    event."""
    tr = ctx.get("trace")
    events = [e for e in stretch_events() if e["kind"] == "span"]
    req = [e for e in events if e["name"] == "request"]
    if not tr or not req:
        return None
    timeline = innermost((e["start_ns"] * NS, e["end_ns"] * NS, e["name"])
                         for e in events if e["thread"] == req[-1]["thread"])
    out: Dict[str, float] = {}
    k = 0
    for g0, g1 in device_idle(tr["spans"], req[-1]["start_ns"] * NS):
        t = g0
        while k < len(timeline) and timeline[k][1] <= g0:
            k += 1
        j = k
        while t < g1:
            if j < len(timeline) and timeline[j][0] <= t < timeline[j][1]:
                stop, name = min(g1, timeline[j][1]), timeline[j][2]
                j += 1
            else:
                stop = min(g1, timeline[j][0]) if j < len(timeline) else g1
                name = OUTSIDE
            out[name] = out.get(name, 0.0) + (stop - t)
            t = stop
    return out


STEP_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)  # a bucket's first step index


def steps_by_index(events: Iterable[Dict]) -> Dict[str, Dict[str, float]]:
    """The recorded `decode.step` spans' host ms, and their `decode.model`
    children's, by the step's index in its loop (counted from the loop's
    `decode.prefill` on the same thread), in the buckets of STEP_BUCKETS:
    {"0": {"n", "step_ms", "model_ms"}, "1": .., "2-3": .., .., "64-": ..}.
    A step that waits for room in the launch queue (behind work enqueued
    before the loop) reads above the steps after it."""
    spans = sorted((e for e in events if e["kind"] == "span"), key=lambda e: e["start_ns"])
    model = {e["parent"]: e for e in spans if e["name"] == "decode.model"}
    index: Dict[int, int] = {}  # thread -> the next step's index
    sums: Dict[int, List[float]] = {}  # bucket -> [n, step ns, model ns]
    for e in spans:
        if e["name"] == "decode.prefill":
            index[e["thread"]] = 0
        elif e["name"] == "decode.step":
            i = index.get(e["thread"], 0)
            index[e["thread"]] = i + 1
            lo = max(b for b in STEP_BUCKETS if b <= i)
            m = model.get(e["id"])
            acc = sums.setdefault(lo, [0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += e["end_ns"] - e["start_ns"]
            acc[2] += (m["end_ns"] - m["start_ns"]) if m else 0
    out = {}
    for k, lo in enumerate(STEP_BUCKETS):
        if lo in sums:
            n, step_ns, model_ns = sums[lo]
            hi = STEP_BUCKETS[k + 1] - 1 if k + 1 < len(STEP_BUCKETS) else None
            label = str(lo) if hi == lo else f"{lo}-{'' if hi is None else hi}"
            out[label] = {"n": n, "step_ms": step_ns * 1e-6 / n, "model_ms": model_ns * 1e-6 / n}
    return out


def engine_idle_ms_per_batch(ctx: Dict) -> Optional[float]:
    idle = idle_by_span(ctx)
    batches = sum(1 for d in ctx["decodes"] if d["traced"])
    if idle is None or not batches:
        return None
    return 1e3 * sum(idle.get(n, 0.0) for n in ENGINE_HOST) / batches


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from . import run, spec

    seconds = args.seconds if args.seconds is not None else spec.benchmark()["run_seconds"]
    got: Dict = {}
    per_layer = run.per_layer

    def reading(sp, ctx):
        got["calls"] = int(ctx["window"]["calls"])
        got["idle_by_span"] = idle_by_span(ctx)
        got["traced_batches"] = sum(1 for d in ctx["decodes"] if d["traced"])
        got["steps_by_index"] = steps_by_index(stretch_events())
        if ctx["trace"]:
            got["trace_idle_s"] = ctx["trace"]["window_s"] - ctx["trace"]["busy_s"]
        return per_layer(sp, ctx)

    run.per_layer = reading
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(seconds), "--trace", str(args.trace)])
    finally:
        run.per_layer = per_layer
    got["requests"] = requests()
    out = args.out or os.path.join(
        "build", "hostspans", f"{args.workload}_{args.seed}_t{args.trace}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(got, f)
    print(f"hostspans: wrote {out}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
