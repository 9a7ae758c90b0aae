"""The device trace of a traced stretch of the window: `torch.profiler`
records the card's operations (kernels, copies, fills), and marker kernels
(`torch.cuda._sleep`) that the probes launch at each span's start and end
split them by span: the program launches on one stream, so the device runs
them in launch order, and the k-th marker on the device is the k-th label
the host recorded.

A session loses a few of its first device events and up to a few hundred
of its last: small fills before the first marker and after the last take
those losses (the port's `tools/timing.py` found them on the H100). A
session whose markers cannot be placed is dropped, and the probes trace
the next call instead.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from .counts import union_s

LEAD_FILLS, TAIL_FILLS = 64, 2048
SPIN = "spin_kernel"  # the name of `torch.cuda._sleep`'s kernel
BEGIN, END, TAIL = "begin", "end", "tail"

Event = Tuple[float, float, str]  # (start s, end s, name)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list."""
    s = name.replace("(anonymous namespace)::", "").split("(")[0]
    s = s[5:] if s.startswith("void ") else s
    return s.split("<")[0][:96]


class Tracer:
    """One profiler session over a stretch of the window, split by labels."""

    def __init__(self):
        self.labels: List[str] = []
        self.active = False
        self._prof = None
        self._fill = None
        self.window_s = 0.0
        self._t0 = 0.0

    def mark(self, label: str) -> None:
        if self.active:
            torch.cuda._sleep(50)
            self.labels.append(label)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._fill = torch.empty(256, device="cuda")
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(LEAD_FILLS):
            self._fill.fill_(0.0)
        self.labels = []
        self.active = True
        self.mark(BEGIN)
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[Dict]:
        """End the session; the trace's reading, or None where its markers
        cannot be placed."""
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.mark(END)
        for _ in range(TAIL_FILLS):
            self._fill.fill_(0.0)
        self.mark(TAIL)
        self.active = False
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = sorted((e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9, e.name())
                        for e in self._prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA)
        self._prof = None
        return read(events, self.labels, self.window_s)


def read(events: List[Event], labels: List[str], window_s: float) -> Optional[Dict]:
    """The trace's reading: the device events of each span (by the label
    of its start marker; "glue:<label>" after a span's end marker), the
    busy seconds (the union of every event's interval between the begin and
    end markers, markers left out), the device operations that took most
    time and the longest idle gaps by what the host was doing."""
    marks = [i for i, (_, _, name) in enumerate(events) if SPIN in name]
    if len(marks) == len(labels):
        pass
    elif len(marks) == len(labels) - 1 and marks and marks[-1] < len(events) - 1:
        marks.append(len(events))  # the tail's marker alone was lost
    else:
        return None
    if marks[0] > LEAD_FILLS:
        return None
    spans: Dict[str, List[Event]] = defaultdict(list)
    inside: List[Event] = []
    gaps: Dict[str, float] = defaultdict(float)
    for k in range(len(labels) - 2):  # from the begin marker to the end marker
        label = labels[k]
        where = label[:-1] if label.endswith(">") else f"glue:{label.rstrip('<')}"
        chunk = events[marks[k] + 1: marks[k + 1]]
        spans[where].extend(chunk)
        inside.extend(chunk)
        prev_end = events[marks[k]][1]
        for start, end, _ in chunk:
            if start > prev_end:
                gaps[where] += start - prev_end
            prev_end = max(prev_end, end)
        nxt = events[marks[k + 1]][0] if marks[k + 1] < len(events) else prev_end
        if nxt > prev_end:
            gaps[where] += nxt - prev_end
    by_name: Dict[str, float] = defaultdict(float)
    for start, end, name in inside:
        by_name[short_name(name)] += end - start
    return {
        "spans": dict(spans),
        "busy_s": union_s((s, e) for s, e, _ in inside),
        "window_s": window_s,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10],
        "ops": len(inside),
    }
