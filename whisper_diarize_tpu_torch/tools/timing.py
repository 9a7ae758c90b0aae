"""How the port times a kernel on the card, and the least time the card
could take for it: shared by `chip_smoke.py` and the tools of this package.

- `time_ms`: CUDA-event time of back-to-back calls over their count;
- `best_ms`: the best host-clock time of a few calls, each ended by a
  synchronisation: the time of a whole decode or encode (the tools);
- `slope_ms`: the slope of CUDA-event times over two repetition counts
  (best of a few runs each), which cancels a run's fixed cost: the TPU
  tools' method;
- `device_ms`: the profiled device time of one call, without the gaps in
  which the device waits for the host (`device_ms_by_kernel`: split by
  kernel). For a call of a few tens of microseconds the host issues calls
  slower than the card runs them, and the slope times the host
  (`host_bound`): the tools give their rates over the device time;
- `bound`: the larger of a call's bytes over the memory rate and its
  operations over the peak rate for their type (H100 SXM data sheet);
- `phase_row`: one phase of a decode breakdown (the breakdown tools): its
  wall time a step beside its profiled device time a step, the busy share
  and the launches a step.

On the CPU (the tools' `--device cpu`, for the tests) `slope_ms` reads the
host clock and the device time is not measured.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# H100 SXM data sheet: memory rate, dense bf16 tensor rate, f32 rate outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# The least time for an f32 product held to the f32 check: the card has no
# f32 x f32 tensor-core product, and TF32's 10-bit mantissas miss the check
# (`kernels/agreement.py`), but a 3xTF32 split (hi = tf32(x), lo = tf32(x -
# hi); lo hi' + hi lo' + hi hi') passes it at three TF32 products a
# product: the dense TF32 rate (495 TFLOP/s) over three, 2.5x the CUDA
# cores' f32 rate. The f32 forms' bounds by operations use it.
TF32X3_FLOPS = 495e12 / 3


def nvidia_smi_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line(dev: torch.device) -> str:
    """The first line of a tool's output: the card it measures, with its
    power limit, or that nothing is measured on the card."""
    if dev.type != "cuda":
        return "device cpu: plain versions, host clock; no card numbers"
    return f"device {torch.cuda.get_device_name(dev)} | nvidia-smi: {nvidia_smi_line()}"


def time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def best_ms(fn: Callable[[], object], device: torch.device, repeat: int, warm: bool = True):
    """(best host-clock ms of `repeat` calls after one warm-up (none where
    `warm` is False), each ended by a synchronisation on the card, the last
    call's result): the TPU tools' `best_of`."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = None
    if warm:
        out = fn()
        sync()
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def slope_ms(fn: Callable[[], object], device: torch.device,
             reps: Sequence[int] = (8, 40), best_of: int = 3) -> float:
    """Time of one call: (best time of reps[1] calls - best time of reps[0]
    calls) / (reps[1] - reps[0]), each count warmed once and run `best_of`
    times; CUDA events on the card, the host clock on the CPU."""
    cuda = device.type == "cuda"
    best = []
    for n in reps:
        fn()
        t = float("inf")
        for _ in range(best_of):
            if cuda:
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                torch.cuda.synchronize(device)
                t = min(t, start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                t = min(t, (time.perf_counter() - t0) * 1e3)
        best.append(t)
    return (best[1] - best[0]) / (reps[1] - reps[0])


def gb_per_s(nbytes: float, ms: float) -> float:
    """GB/s of `nbytes` a call at `ms` a call (nan where a slope came out
    <= 0: a pass too short for its noise)."""
    return nbytes / ms / 1e6 if ms > 0 else float("nan")


# small fills before and after a profiler session's windows: a session
# loses a few of its first device events and, recording the device alone,
# up to a few hundred of its last (seen on the H100 with torch 2.11)
LEAD_FILLS, TAIL_FILLS = 64, 2048
# profiler sessions tried before a reading gives up: `split_windows` refuses
# a session whose lost marker leaves its windows' places uncertain (seen
# twice in a row on the H100)
PROFILE_ATTEMPTS = 5


def split_windows(kern: Sequence[Tuple[float, str, float]], n: int
                  ) -> Optional[List[List[Tuple[str, float, float]]]]:
    """The `n` windows of a profiler session's device events (start us,
    name, duration us; in order of start) as lists of (name, start us,
    duration us), or None where the session's layout is not certain.

    A whole session reads: lead fills, marker, window 1, marker, ...,
    window n, marker, tail fills, marker (a marker: a `spin_kernel`). Two
    layouts are certain: every marker shown and nothing after the last; or
    n + 1 markers and events after the last, where the tail's marker alone
    was lost (a device-only session loses its last events). n + 1 markers
    with nothing after the last lost the lead's marker or a window's, and
    the windows would shift by one: such a session is profiled again. The
    lead and the tail hold no more events than their fills."""
    wins: List[List[Tuple[str, float, float]]] = []
    cur: List[Tuple[str, float, float]] = []
    for start, name, us in kern:
        if "spin_kernel" in name:
            wins.append(cur)
            cur = []
        else:
            cur.append((name, start, us))
    if len(wins) == n + 2 and not cur:
        tail = wins[n + 1]
    elif len(wins) == n + 1 and cur:
        tail = cur
    else:
        return None
    if len(wins[0]) > LEAD_FILLS or len(tail) > TAIL_FILLS:
        return None
    return wins[1:n + 1]


def _median_windows(fns: Sequence[Callable[[], object]], iters: int, windows: int,
                    warmup: int, host_ops: bool = True
                    ) -> List[List[Tuple[str, float, float]]]:
    """For each of `fns`, the median profiled window of `iters` calls: its
    (kernel name, start us, duration us) device events (see `device_ms`).
    One session profiles `windows` windows of each function, in turns,
    between a lead window of `LEAD_FILLS` small fills and a tail of
    `TAIL_FILLS`, which take the events the session loses at its start and
    its end; a session whose windows `split_windows` cannot place is
    profiled again. `host_ops` False records the device's activity alone,
    a quarter of the events to stop and scan."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        for _ in range(warmup):
            fn()
    lead = torch.empty(256, device="cuda")
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=activities) as prof:
            for _ in range(LEAD_FILLS):
                lead.fill_(0.0)
            torch.cuda._sleep(1000)
            for _ in range(windows):
                for fn in fns:
                    for _ in range(iters):
                        fn()
                    torch.cuda._sleep(1000)
            for _ in range(TAIL_FILLS):
                lead.fill_(0.0)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        # the raw device events: `prof.events()` would build a Python event
        # tree of every host op too, ~35x slower
        kern = sorted((e.start_ns() / 1e3, e.name(), e.duration_ns() / 1e3)
                      for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA)
        del prof
        n = windows * len(fns)
        wins = split_windows(kern, n)
        if wins is None:
            marks = [i for i, (_, name, _) in enumerate(kern) if "spin_kernel" in name]
            print(f"[kernels] device_ms: the profiler lost window markers ({len(marks)} of "
                  f"{n + 2}, {marks[0] if marks else len(kern)} events before the first, "
                  f"{len(kern) - 1 - marks[-1] if marks else 0} after the last); profiling "
                  "again", flush=True)
            continue
        out = []
        for k in range(len(fns)):
            mine = wins[k::len(fns)]
            full = max(len(w) for w in mine)
            kept = sorted((w for w in mine if len(w) == full),
                          key=lambda w: sum(us for _, _, us in w))
            if len(kept) < windows:
                print(f"[kernels] device_ms: dropped {windows - len(kept)} of {windows} "
                      f"profiled windows that lost kernel events", flush=True)
            out.append(kept[len(kept) // 2])
        return out
    raise AssertionError(f"device_ms: the profiler lost window markers in "
                         f"{PROFILE_ATTEMPTS} sessions")


def _median_window(fn: Callable[[], object], iters: int, windows: int,
                   warmup: int) -> List[Tuple[str, float, float]]:
    return _median_windows([fn], iters, windows, warmup)[0]


def _union_us(events: Sequence[Tuple[str, float, float]]) -> float:
    """The length of the union of the events' intervals (us): their summed
    durations, less any overlap."""
    total, end = 0.0, float("-inf")
    for _, start, us in sorted(events, key=lambda e: e[1]):
        stop = start + us
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def device_profiles(fns: Sequence[Callable[[], object]]) -> List[Tuple[float, float]]:
    """For each of `fns`, one call profiled (all in one session of the
    device's activity alone): (the device's busy ms: the union of the
    kernels' intervals; the device operations of the call: kernels, copies
    and fills). A call of a decode loop
    launches ~30,000 - 100,000 kernels: one window each keeps the
    profiler's stop and scan to a few seconds."""
    return [(_union_us(w) / 1e3, float(len(w)))
            for w in _median_windows(fns, 1, 1, 0, host_ops=False)]


def device_ms(fn: Callable[[], object], iters: int = 10, windows: int = 3,
              warmup: int = 3) -> float:
    """Mean device time of one call: the summed durations of the kernels it
    launches (torch.profiler), without the gaps in which the device waits
    for the host. Where the host issues calls slower than the device runs
    them, `time_ms` measures the host and this the kernels.

    The profiler at times loses kernel events (a reading far below the
    CUDA-event time), so one session profiles `windows` windows of `iters`
    calls, each ended by a marker kernel (`torch.cuda._sleep`). Every window
    launches the same kernels: one that holds fewer kernel events than the
    fullest lost some and is dropped, and the reading is the median of the
    rest. A session whose lost markers leave the windows' places uncertain
    (`split_windows`) is profiled again."""
    return sum(us for _, _, us in _median_window(fn, iters, windows, warmup)) / iters / 1e3


def device_ms_by_kernel(fn: Callable[[], object], iters: int = 10, windows: int = 3,
                        warmup: int = 3) -> Dict[str, float]:
    """`device_ms` split by kernel: ms a call of each kernel `fn` launches
    (its name up to the argument list), from the same median window."""
    out: Dict[str, float] = {}
    for name, _, us in _median_window(fn, iters, windows, warmup):
        short = kernel_name(name)
        out[short] = out.get(short, 0.0) + us / iters / 1e3
    return out


def kernel_name(name: str) -> str:
    """A profiler's kernel name without its return type, anonymous
    namespace and argument list."""
    short = name.replace("(anonymous namespace)::", "").split("(")[0]
    return short[5:] if short.startswith("void ") else short


def host_bound(slope: float, dev_ms: float) -> bool:
    """Whether a slope of event times measured the host issuing calls rather
    than the card: it exceeds the device time by more than a fifth."""
    return slope > 1.2 * dev_ms


def phase_row(name: str, run: Callable[[int], object], device: torch.device,
              budgets: Optional[Tuple[int, int]] = None, repeat: int = 5,
              note: Optional[str] = None, outputs: Optional[list] = None) -> dict:
    """One phase of a decode breakdown. `run(n)` runs the phase over n steps
    (a fresh state each call where the phase consumes one); the row is a
    step's: slopes between the step budgets (lo, hi), which cancel what a
    call costs once. Without `budgets` the phase is one call, `run(1)`, and
    the row is that call's.

    - wall_ms: the slope of `best_ms` (host clock around a synchronisation,
      best of `repeat` after a warm-up): what the step costs its caller;
    - device_ms: the slope of `device_profiles` (both budgets' calls in one
      profiler session): the union of the kernels' intervals, without the
      gaps in which the card waits for the host;
    - busy: device_ms / wall_ms, the card's busy share of the step (None
      where the wall slope is not above 0);
    - launches: device operations a step (kernels, copies, fills);
    - host_bound: `host_bound(wall_ms, device_ms)`;
    - wall_long_ms / device_long_ms: the longer budget's whole call, its
      unprofiled wall and its profiled busy time (which the profiler
      lengthens a little).

    Every step of `run` does work and launches the same kernels, so its
    launches a step are whole: a pair of profiled calls that says otherwise
    lost events and is profiled again (up to three times, then it raises).
    A wall slope <= 0 is the host's noise in one call: the pair is timed
    again, up to three times, and then kept as it is. On the CPU the device
    fields are None (the host clock only). The last longer call's result is
    appended to `outputs` where given."""
    lo, hi = budgets if budgets is not None else (0, 1)
    for _ in range(3):
        t_hi, out = best_ms(lambda: run(hi), device, repeat)
        # the longer call just ran the same code: the shorter needs no warm-up
        t_lo = (best_ms(lambda: run(lo), device, repeat, warm=False)[0]
                if budgets is not None else 0.0)
        wall = (t_hi - t_lo) / (hi - lo)
        if wall > 0:
            break
        # a step does work: a slope <= 0 is the host's noise in one call
        print(f"[time] {name}: wall slope {wall:.3f} ms a step ({t_lo:.1f} -> {t_hi:.1f} "
              "ms); timing again", flush=True)
    if outputs is not None:
        outputs.append(out)
    row = dict(phase=name, budgets=list(budgets) if budgets is not None else None,
               wall_ms=wall, device_ms=None, busy=None, launches=None, host_bound=None,
               wall_long_ms=t_hi, device_long_ms=None,
               note=note)
    if device.type == "cuda":
        fns = [lambda: run(hi)] + ([lambda: run(lo)] if budgets is not None else [])
        for _ in range(3):
            (d_hi, n_hi), (d_lo, n_lo) = (device_profiles(fns) + [(0.0, 0.0)])[:2]
            # every step of a loop launches the same kernels: a profiled
            # call that lost events leaves a fraction of a launch a step
            if (n_hi - n_lo) % (hi - lo) == 0:
                break
            print(f"[kernels] {name}: the profiler lost events ({n_hi:.0f} - {n_lo:.0f} "
                  f"device operations over {hi - lo} steps); profiling again", flush=True)
        else:
            raise AssertionError(f"{name}: the profiler lost events in three sessions")
        dev = (d_hi - d_lo) / (hi - lo)
        row.update(device_ms=dev, busy=dev / wall if wall > 0 else None,
                   launches=(n_hi - n_lo) / (hi - lo), host_bound=host_bound(wall, dev),
                   device_long_ms=d_hi)
    return row


def busy_text(busy: Optional[float]) -> str:
    """A busy share as a percentage ("-" where the wall slope was not above
    0)."""
    return "-" if busy is None else f"{busy:.1%}"


def format_row(row: dict) -> str:
    """A phase row as one line (the device fields "not measured" off the
    card)."""
    unit = "ms/step" if row["budgets"] else "ms/call"
    line = f"{row['phase']:22s} wall {row['wall_ms']:9.3f} {unit}"
    if row["device_ms"] is None:
        line += "  device not measured (cpu)"
    else:
        line += (f"  device {row['device_ms']:9.3f}  busy {busy_text(row['busy']):>6s}  "
                 f"launches {row['launches']:8.1f}{'  host-bound' if row['host_bound'] else ''}")
    if row["budgets"]:
        line += f"  ({row['budgets'][1]}-step call {row['wall_long_ms']:.1f} ms)"
    return line + (f"  [{row['note']}]" if row.get("note") else "")


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS) -> dict:
    """The least time the card could take for a call: the larger of the
    bytes it must move (each input read once, each output written once)
    over the memory rate and its operations over the rate for their type
    (the bf16 tensor rate unless given another)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def attn_bound(B: int, Q: int, H: int, Ta: int, kv_row_bytes: int) -> dict:
    """K1 / K5 / K9's attention forms: q in and out [B, Q, H, 64] bf16, one
    layer's Ta unmasked K and V rows (`kv_row_bytes` a row: 128 bf16, 64 + 4
    int8 with its scale)."""
    return bound(2 * B * Q * H * 64 * 2 + 2 * B * H * Ta * kv_row_bytes,
                 4 * B * H * Q * Ta * 64)


def sum_bound(nbytes: int) -> dict:
    """K9b / K11: a bf16 array of `nbytes` read once, an f32 scalar written;
    a max and an add per element at the f32 rate."""
    return bound(nbytes + 4, nbytes, F32_FLOPS)

