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
  operations over the peak rate for their type (H100 SXM data sheet).

On the CPU (the tools' `--device cpu`, for the tests) `slope_ms` reads the
host clock and the device time is not measured.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, List, Sequence, Tuple

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


def best_ms(fn: Callable[[], object], device: torch.device, repeat: int):
    """(best host-clock ms of `repeat` calls after one warm-up, each ended
    by a synchronisation on the card, the last call's result): the TPU
    tools' `best_of`."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

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


def _median_window(fn: Callable[[], object], iters: int, windows: int,
                   warmup: int) -> List[Tuple[str, float]]:
    """The (kernel name, us) events of the median profiled window of
    `iters` calls (see `device_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(windows):
                for _ in range(iters):
                    fn()
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        wins, cur = [], []
        for e in kern:
            if "spin_kernel" in e.name:
                wins.append(cur)
                cur = []
            else:
                cur.append((e.name, e.time_range.elapsed_us()))
        if len(wins) != windows or cur:
            continue
        full = max(len(w) for w in wins)
        kept = sorted((w for w in wins if len(w) == full),
                      key=lambda w: sum(us for _, us in w))
        if len(kept) < windows:
            print(f"[kernels] device_ms: dropped {windows - len(kept)} of {windows} "
                  f"profiled windows that lost kernel events", flush=True)
        return kept[len(kept) // 2]
    raise AssertionError("device_ms: the profiler lost window markers in three sessions")


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
    rest. A session whose markers do not all show is profiled again."""
    return sum(us for _, us in _median_window(fn, iters, windows, warmup)) / iters / 1e3


def device_ms_by_kernel(fn: Callable[[], object], iters: int = 10, windows: int = 3,
                        warmup: int = 3) -> Dict[str, float]:
    """`device_ms` split by kernel: ms a call of each kernel `fn` launches
    (its name up to the argument list), from the same median window."""
    out: Dict[str, float] = {}
    for name, us in _median_window(fn, iters, windows, warmup):
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

