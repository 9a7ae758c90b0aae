"""Spans and counters of the port's request path: one tracer for the
process, always on.

    from whisper_diarize_tpu_torch import tracing
    with tracing.span("decode", rows=16):
        ...
    tracing.count("host_sync", site="decode.poll")
    frames = tracing.to_host(frames_dev, "align.backtrack")

A request is one `Engine.transcribe_audio` / `transcribe_audio_batch`
call (`request()`). Every span and counter opened inside it, on the calling
thread or on a thread it hands work to (`carry`), shares the request's id
and adds to its totals: a count and host seconds a span name, a sum a
counter name (and a site, for counters given one). The tracer keeps the
summaries of the latest `HISTORY` requests (`requests()`); the Engine's
`last_run` is a view of its request's summary. A span opened outside any
request adds to no totals.

Events. Each span's own record (name, start, end, thread, its id and its
parent's, the request's id, attributes) and each counter's are kept only
while recording is on: between `enable()` and `disable()`, and also while a
`torch.profiler` session records in the process (read from the profiler's
own flag at each span's start). Under a profiler each recorded span is also
a `torch.profiler.record_function` range, so a CPU + CUDA profile shows the
spans beside their kernels. A span that started while recording is kept
when it ends, even if recording stopped in between. Each stretch of
recording has a number (`stretch()`, the latest), carried by its events; a
stretch ends at the first span that starts with recording off.
At most `MAX_EVENTS` events are held; the oldest go first.

Clock. Spans are stamped by `time.perf_counter_ns` and mapped onto the
clock of the profiler's events (Unix-epoch nanoseconds, the clock of
`time.time_ns`) by one offset taken as each stretch starts, so a device
event of a profile can be set against the span the host was in.

Cost. Recording off, a span is an object, two clock reads and a dict
update under the request's lock (about a microsecond); recording on, it adds a
record and, under a profiler, a `record_function` range.
`write_chrome_trace` writes the recorded events, merged into a profiler's
exported trace if given one.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

HISTORY = 256  # request summaries kept
MAX_EVENTS = 1 << 18  # recorded events kept (the oldest dropped first)

_now = time.perf_counter_ns
_ids = itertools.count(1)


def _profiler_on() -> bool:
    """Whether a `torch.profiler` / autograd profiler session records in
    this process: the flag the profiler sets as it starts and clears as it
    stops (the C flag where the Python one is missing)."""
    return _autograd_profiler._is_profiler_enabled


if not hasattr(_autograd_profiler, "_is_profiler_enabled"):
    _profiler_on = torch._C._autograd._profiler_enabled  # noqa: F811


def _epoch_offset() -> int:
    """`time.time_ns() - time.perf_counter_ns()`, from the tightest of a
    few bracketed reads."""
    best = None
    for _ in range(5):
        a = _now()
        wall = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _Request:
    """The running totals of one request."""

    __slots__ = ("id", "attrs", "thread", "start_ns", "end_ns", "spans", "counters",
                 "sites", "profiled", "lock")

    def __init__(self, attrs: Dict[str, Any]):
        self.id = next(_ids)
        self.attrs = attrs
        self.thread = threading.get_ident()
        self.start_ns = _now()
        self.end_ns: Optional[int] = None
        self.spans: Dict[str, List[int]] = {}  # name -> [count, ns]
        self.counters: Dict[str, int] = {}
        self.sites: Dict[str, Dict[str, int]] = {}
        self.profiled = False
        self.lock = threading.Lock()

    def add_span(self, name: str, ns: int) -> None:
        with self.lock:
            tot = self.spans.get(name)
            if tot is None:
                self.spans[name] = [1, ns]
            else:
                tot[0] += 1
                tot[1] += ns

    def add_count(self, name: str, n: int, site: Optional[str]) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if site is not None:
                by_site = self.sites.setdefault(name, {})
                by_site[site] = by_site.get(site, 0) + n

    def summary(self) -> Dict[str, Any]:
        """The request's totals: span seconds are host seconds (an open
        span counts from its start to now)."""
        with self.lock:
            end = self.end_ns if self.end_ns is not None else _now()
            return {
                "id": self.id, "attrs": dict(self.attrs), "thread": self.thread,
                "seconds": (end - self.start_ns) * 1e-9,
                "spans": {k: {"count": c, "seconds": ns * 1e-9}
                          for k, (c, ns) in self.spans.items()},
                "counters": dict(self.counters),
                "sites": {k: dict(v) for k, v in self.sites.items()},
                "profiled": self.profiled,
            }


class _Local(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []  # open spans of this thread, innermost last
        self.request: Optional[_Request] = None
        self.base_parent: Optional[int] = None  # a carried thread's parent span


class Tracer:
    """The process's spans, counters, request summaries and recorded
    events (the module's functions act on one instance)."""

    def __init__(self):
        self.local = _Local()
        self.history: "deque[Dict[str, Any]]" = deque(maxlen=HISTORY)
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=MAX_EVENTS)
        self.enabled = False
        self.on = False  # the recording state the last span start saw
        self.stretch = 0
        self.offsets: Dict[int, int] = {}  # stretch -> epoch offset (ns)
        self.lock = threading.Lock()

    def recording(self, req: Optional[_Request]) -> int:
        """The stretch a span starting now records into, 0 when recording
        is off; marks `req` profiled under a profiler."""
        prof = _profiler_on()
        on = self.enabled or prof
        if on != self.on:
            with self.lock:
                if on and not self.on:
                    self.stretch += 1
                    self.offsets[self.stretch] = _epoch_offset()
                self.on = on
        if prof and req is not None:
            req.profiled = True
        return self.stretch if on else 0


_TRACER = Tracer()


class Span:
    """A timed region (`span(name, **attrs)`), used as a context manager."""

    __slots__ = ("name", "attrs", "id", "parent", "req", "stretch", "rf", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def _open(self, req: Optional[_Request]) -> None:
        loc = _TRACER.local
        stack = loc.stack
        self.req = req
        self.parent = stack[-1].id if stack else loc.base_parent
        self.id = next(_ids)
        stack.append(self)
        self.stretch = _TRACER.recording(req)
        self.rf = None
        if self.stretch and _profiler_on():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = _now()

    def __enter__(self) -> "Span":
        self._open(_TRACER.local.request)
        return self

    def _close(self) -> int:
        t1 = _now()
        stack = _TRACER.local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.req is not None:
            self.req.add_span(self.name, t1 - self.t0)
        if self.stretch:
            off = _TRACER.offsets[self.stretch]
            _TRACER.events.append({
                "kind": "span", "name": self.name, "start_ns": self.t0 + off,
                "end_ns": t1 + off, "thread": threading.get_ident(), "id": self.id,
                "parent": self.parent, "request": self.req.id if self.req else None,
                "stretch": self.stretch, "attrs": self.attrs})
        return t1

    def __exit__(self, *exc) -> bool:
        self._close()
        return False


class _RequestSpan(Span):
    """The `request` span: opens a request on this thread, and files its
    summary in the history as it ends."""

    __slots__ = ()

    def __enter__(self) -> _Request:
        loc = _TRACER.local
        loc.request = _Request(self.attrs)
        self._open(loc.request)
        return loc.request

    def __exit__(self, *exc) -> bool:
        t1 = self._close()
        req = self.req
        if _profiler_on():
            req.profiled = True
        req.end_ns = t1
        _TRACER.local.request = None
        _TRACER.history.append(req.summary())
        return False


def span(name: str, **attrs) -> Span:
    """A span of `name` (attributes kept with its recorded event)."""
    return Span(name, attrs)


def request(**attrs) -> _RequestSpan:
    """The span of one request; `with request() as req:` gives its
    running totals (`req.summary()`)."""
    return _RequestSpan("request", attrs)


def count(name: str, n: int = 1, site: Optional[str] = None) -> None:
    """Add `n` to the counter `name` of the current request (and to its
    `site`, where given)."""
    loc = _TRACER.local
    req = loc.request
    if req is not None:
        req.add_count(name, n, site)
    if _TRACER.on:
        stretch = _TRACER.stretch
        attrs = {"n": n} if site is None else {"n": n, "site": site}
        _TRACER.events.append({
            "kind": "count", "name": name, "start_ns": _now() + _TRACER.offsets[stretch],
            "end_ns": None, "thread": threading.get_ident(), "id": None,
            "parent": loc.stack[-1].id if loc.stack else loc.base_parent,
            "request": req.id if req else None, "stretch": stretch, "attrs": attrs})


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """`t` read to the host as an array, counted as one `host_sync` at
    `site`: every device-to-host read of the request path goes through
    here (or `bool` of a flag in `ops/decode.poll`)."""
    count("host_sync", site=site)
    return t.detach().cpu().numpy()


def carry(fn: Callable) -> Callable:
    """`fn` wrapped to run, on whatever thread calls it, inside the current
    request and under the current span: its spans get their own parent
    stack and the request's id."""
    loc = _TRACER.local
    req = loc.request
    parent = loc.stack[-1].id if loc.stack else loc.base_parent

    def carried(*args, **kwargs):
        here = _TRACER.local
        saved = (here.request, here.stack, here.base_parent)
        here.request, here.stack, here.base_parent = req, [], parent
        try:
            return fn(*args, **kwargs)
        finally:
            here.request, here.stack, here.base_parent = saved

    return carried


def profiling() -> bool:
    """Whether a `torch.profiler` session records in this process now."""
    return _profiler_on()


def enable() -> None:
    """Record events from the next span on, until `disable()`."""
    _TRACER.enabled = True


def disable() -> None:
    """Stop recording (events recorded under a running profiler go on
    until it stops)."""
    _TRACER.enabled = False


def stretch() -> int:
    """The number of the latest recorded stretch (0: none yet)."""
    return _TRACER.stretch


def requests() -> List[Dict[str, Any]]:
    """The summaries of the latest `HISTORY` requests, oldest first."""
    return list(_TRACER.history)


def events(stretch_no: Optional[int] = None) -> List[Dict[str, Any]]:
    """The recorded events, of one stretch where given, oldest first."""
    return [e for e in list(_TRACER.events)
            if stretch_no is None or e["stretch"] == stretch_no]


def write_chrome_trace(path: str, merge_with: Optional[str] = None,
                       stretch_no: Optional[int] = None) -> None:
    """Write the recorded events (of one stretch where given) as a Chrome
    trace: spans as complete events, counters as instant events. With
    `merge_with`, the path of a trace that `torch.profiler`'s
    `export_chrome_trace` wrote, the events join its own, on its time base
    (`baseTimeNanoseconds`)."""
    evs = events(stretch_no)
    if merge_with is not None:
        with open(merge_with) as f:
            trace = json.load(f)
    else:
        trace = {"traceEvents": [], "displayTimeUnit": "ms",
                 "baseTimeNanoseconds": min((e["start_ns"] for e in evs), default=0)}
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for e in evs:
        args = dict(e["attrs"], request=e["request"], parent=e["parent"])
        out = {"name": e["name"], "cat": "wdt", "pid": pid, "tid": e["thread"],
               "ts": (e["start_ns"] - base) / 1e3, "args": args}
        if e["kind"] == "span":
            out.update(ph="X", dur=(e["end_ns"] - e["start_ns"]) / 1e3)
            args["id"] = e["id"]
        else:
            out.update(ph="i", s="t")
        trace["traceEvents"].append(out)
    with open(path, "w") as f:
        json.dump(trace, f)
