"""Run one cell of the benchmark once and print one JSON line last.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as `setup_s`): import the program, check the card, make the
weights on the card from the seed ("__random__:<preset>:<seed>"), build or
load the kernels (the checkout's `build/` cache, keyed by the sources'
digest), write the run's audio files, and make one warm call of the cell's
own shapes. The window: a closed loop of `Engine.transcribe_audio_batch`
calls, each with the traffic's files in the traffic's one order; it holds
every call that starts within `--seconds`. Then,
with the program's state freed, the plain reference judges the sampled
batches (`check.py`) and the result line is printed.

`--trace 1` runs the same window with the probes' spans on, traces the
first decode batches of a call with `torch.profiler` and reports the
cell's per-layer metrics (`metrics/<name>.py`) instead of its end-to-end
ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the OpenMP and BLAS pools at one thread
# each (set before numpy and torch load), torch's intra-op pool at the
# traffic's `intra_op_threads`: a deployment setting the traffic states
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional, Sequence  # noqa: E402

import numpy as np  # noqa: E402

from . import check, spec  # noqa: E402
from . import traffic as traffic_mod  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "whisper_diarize_tpu")
TRACE_BATCHES = 4  # decode batches a traced call records (every file's first window in them)
SAMPLED_BATCHES = 2  # decode batches the check compares


def parse(argv: Optional[Sequence[str]]):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def sample_plan(tr: Dict, seed: int, layers: int, calls: int = 2):
    """What the check compares, drawn from the seed: the decode batch that
    holds a drawn window of a drawn file in the first call (in a diarized
    cell the file's first window, which its embedding is taken from) and
    the one holding a drawn window of a drawn file in one of the first
    `calls` calls; the segmentation forward that holds a drawn 10 s window
    of the first call; the decoder layers whose cross K/V is compared (the
    first, a drawn one, the last). -> ({call: {(stream, window)}}, {call:
    global 10 s window}, layers)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 7])
    lengths = traffic_mod.lengths(tr)
    n = len(lengths)

    def drawn(first: bool):
        stream = int(rng.integers(n))
        file_len = lengths[traffic_mod.call_order(tr)[stream]]
        windows = -(-file_len // traffic_mod.WINDOW)
        return stream, 0 if first else int(rng.integers(windows))

    targets: Dict[int, set] = {0: {drawn(bool(tr["diarize"]))}}
    later = int(rng.integers(calls))
    targets.setdefault(later, set()).add(drawn(False))
    order = traffic_mod.call_order(tr)
    seg_windows = [-(-lengths[i] // traffic_mod.SEG_WINDOW) for i in order]
    stream = int(rng.integers(n))
    seg_target = {0: sum(seg_windows[:stream]) + int(rng.integers(seg_windows[stream]))}
    mid = int(rng.integers(1, layers - 1)) if layers > 2 else 0
    return targets, seg_target, sorted({0, mid, layers - 1})


# EngineConfig fields the harness sets from the configuration's and the
# traffic's own keys; a traffic's `engine` may set any other field
ENGINE_SET = {"use_gpu", "gpu_device", "cache_dir", "whisper_model_path", "vad_model_path",
              "diarize_segment_model_path", "diarize_embedding_model_path",
              "allow_random_weights", "enable_dtw", "batch_size", "max_decode_tokens",
              "temperature_fallback", "long_form_seek", "dtype"}
# AdvancedTranscribe fields set from the traffic's `strategy` and `beam_size`
ADVANCED_SET = {"sampling_strategy", "best_of_or_beam_size"}


def passed_through(extra: Dict, cls, taken, seed: int, where: str) -> Dict:
    """The traffic's `engine` or `advanced` entries as fields of `cls`:
    a string's "{seed}" becomes the run's seed, a list a tuple. A name
    that is no field of `cls`, or one the harness sets itself, is
    refused."""
    fields = {f.name for f in dataclasses.fields(cls)}
    bad = sorted(k for k in extra if k not in fields or k in taken)
    if bad:
        raise ValueError(f"traffic {where} keys not passed to {cls.__name__}: {bad} "
                         f"(not a field, or set from the traffic's own keys)")
    return {k: v.format(seed=int(seed)) if isinstance(v, str)
            else tuple(v) if isinstance(v, list) else v for k, v in extra.items()}


def engine_settings(sp: Dict, seed: int, device, workdir: str, int8_kv: bool = False):
    """(EngineConfig, TranscribeOptions) of a cell, from its files alone: the
    configuration's preset and `served_dtype`, the traffic's keys, and its
    `engine` and `advanced` entries passed through; `int8_kv` (the
    control) turns the int8 cross K/V cache on over them."""
    from whisper_diarize_tpu_torch.engine import EngineConfig
    from whisper_diarize_tpu_torch.types import AdvancedTranscribe, TranscribeOptions

    c, tr = sp["config"], sp["traffic"]
    on_card = device.type == "cuda"
    fields = dict(
        use_gpu=on_card, gpu_device=0 if on_card else None,
        cache_dir=os.path.join(workdir, "cache"),
        whisper_model_path=f"__random__:{c['preset']}:{int(seed)}",
        vad_model_path="__random__",
        diarize_segment_model_path="__random__",
        diarize_embedding_model_path="__random__",
        allow_random_weights=True,
        enable_dtw=bool(tr["dtw"]),
        batch_size=int(tr["batch_size"]),
        max_decode_tokens=int(tr["tokens_per_window"]),
        temperature_fallback=bool(tr["handling"]["fallback_ladder"]),
        long_form_seek=bool(tr["long_form_seek"]),
        dtype=str(c["served_dtype"]),
    )
    fields.update(passed_through(tr.get("engine", {}), EngineConfig, ENGINE_SET, seed, "engine"))
    if int8_kv:
        fields["quantize_kv_cache"] = True
    advanced = dict(sampling_strategy="greedy" if tr["strategy"] == "greedy" else None,
                    best_of_or_beam_size=int(tr["beam_size"]))
    advanced.update(passed_through(tr.get("advanced", {}), AdvancedTranscribe, ADVANCED_SET,
                                   seed, "advanced"))
    opts = TranscribeOptions(
        model=c["preset"], lang=tr["lang"], enable_vad=bool(tr["vad"]),
        enable_diarize=bool(tr["diarize"]), advanced=AdvancedTranscribe(**advanced))
    return EngineConfig(**fields), opts


class Cell:
    """One run of a cell: set-up, the window, the check."""

    def __init__(self, sp: Dict, seed: int, device, workdir: str, int8_kv: bool = False):
        import torch

        from .probes import Probes

        self.sp, self.seed, self.device = sp, int(seed), device
        self.tr, self.c = sp["traffic"], sp["config"]
        self.audio = traffic_mod.make_audio(self.tr, seed)
        self.paths = traffic_mod.write_pool(self.audio, workdir)
        from whisper_diarize_tpu_torch.engine import Engine

        config, self.opts = engine_settings(sp, seed, device, workdir, int8_kv)
        self.eng = Engine(config)
        self.probes = Probes(self.tr, device, TRACE_BATCHES)
        self.probes.install()
        self.torch = torch
        self.calls: List[Dict] = []
        self.latencies: List[float] = []
        self.windows = 0
        self.failed = 0
        self.error: Optional[str] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """One call of the cell's own shapes (its strategy, batch size,
        tokens a window, diarization, full and partial windows): the
        `batch_size` shortest files."""
        P = self.probes
        P.begin_call(-1, trace=False)
        self.eng.transcribe_audio_batch(self.paths[:int(self.tr["batch_size"])], self.opts)
        self.sync()
        P.decodes.clear()
        self.plan(sample_plan(self.tr, self.seed, int(self.c["decoder_layers"])))

    def plan(self, plan) -> None:
        self.probes.targets, self.probes.seg_targets, self.probes.kv_layers = plan

    def call(self, index: int, trace: bool) -> Dict:
        from whisper_diarize_tpu_torch.types import Callbacks

        P = self.probes
        order = traffic_mod.call_order(self.tr)
        seen: Dict[int, float] = {}
        cb = Callbacks(new_segment_callback=lambda s: seen.__setitem__(id(s), time.perf_counter()))
        P.begin_call(index, trace)
        start = time.perf_counter()
        self.eng.transcribe_audio_batch([self.paths[i] for i in order], self.opts, callbacks=cb)
        self.sync()
        end = time.perf_counter()
        P.end_call()
        for segs in P.seg_lists:
            last = max((seen[id(s)] for s in segs), default=end)
            self.latencies.append(last - start)
        self.windows += int(self.eng.last_run["windows"])
        rec = {"start": start, "end": end, "files": len(order)}
        self.calls.append(rec)
        return rec

    def window(self, seconds: float, trace: bool) -> None:
        t0 = time.perf_counter()
        index = 0
        while index == 0 or time.perf_counter() - t0 < seconds:
            want_trace = trace and self.probes.trace is None
            try:
                self.call(index, want_trace)
            except Exception:  # the program failed a call: its files failed
                self.error = traceback.format_exc()
                self.failed += len(self.paths)
                self.probes.end_call()
                break
            index += 1
        self.t0 = t0

    @property
    def wall_s(self) -> float:
        return (self.calls[-1]["end"] - self.t0) if self.calls else float("nan")

    def context(self) -> Dict:
        """What the per-layer readers read."""
        P = self.probes
        return {
            "cell": self.sp["name"], "config": self.c, "traffic": self.tr,
            "device": self.device.type,
            "window": {"calls": len(self.calls), "wall_s": self.wall_s,
                       "audio_s": len(self.calls) * traffic_mod.audio_seconds(self.tr),
                       "windows": self.windows},
            "decodes": list(P.decodes),
            "trace": P.trace,
            "span_walls": dict(P.span_walls),
            "traced_windows": P.traced_windows,
            "traced_audio_s": P.traced_audio_s,
        }

    def free_program(self) -> None:
        self.probes.uninstall()
        self.eng = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def numbers(self, lowp: bool = False) -> Dict[str, float]:
        P = self.probes
        return check.compute(self.sp, self.seed, P.captures, P.seg_captures, self.audio,
                             self.device, lowp=lowp)


def end_to_end(cell: Cell, setup_s: float) -> Dict[str, Dict]:
    """The end-to-end metrics that the cell reports (`BENCHMARK.json`)."""
    lat = cell.latencies
    audio_s = len(cell.calls) * traffic_mod.audio_seconds(cell.tr)
    every = {
        "xrt": {"value": audio_s / cell.wall_s, "unit": "x"},
        "file_p95_s": {"value": float(np.percentile(lat, 95)) if lat else float("nan"),
                       "unit": "s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    return {m["name"]: every[m["name"]] for m in cell.sp["end_to_end"]}


def per_layer(sp: Dict, ctx: Dict) -> Dict[str, Dict]:
    out = {}
    for m in sp["per_layer"]:
        value = spec.metric_reader(m["name"], sp["here"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def quiet_program_logs() -> None:
    """Random weights decode every window to unprintable text, and the
    program warns of each empty segment: its warnings are silenced, its
    errors kept."""
    logging.getLogger("whisper_diarize_tpu_torch").setLevel(logging.ERROR)


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernels and native library build under `build/` there)."""
    base = os.path.join(root, "build", "benchmark")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ["USE_FLAX"] = "0"


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse(argv)
    sp = spec.cell(args.workload)
    set_cache_dirs(spec.ROOT)
    quiet_program_logs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < sp["chips"]:
        print(f"benchmark: the cell needs {sp['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(int(sp["traffic"]["intra_op_threads"]))
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="wdt_bench_")
    try:
        cell = Cell(sp, args.seed, device, workdir)
        cell.warm()
        torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - T_START
        cell.window(args.seconds, bool(args.trace))
        peak = max(torch.cuda.max_memory_allocated(device), 0)
        ctx = cell.context()
        cell.free_program()
        numbers = {} if cell.error else cell.numbers()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if cell.error:
        print(cell.error, file=sys.stderr)
    ok, checks = check.verdict(numbers, sp["limits"])
    ok = ok and not cell.error
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": sp["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": len(cell.calls) * len(cell.paths) + cell.failed,
              "failed": cell.failed}
    if args.trace:
        result["metrics"] = per_layer(sp, ctx)
        tr = ctx["trace"] or {}
        device_info["busy_s"] = tr.get("busy_s", 0.0)
        device_info["window_s"] = tr.get("window_s", 0.0)
        if tr:
            result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    else:
        result["metrics"] = end_to_end(cell, setup_s)
    result["device"] = device_info
    result["checks"] = checks
    print(f"benchmark: {args.workload} seed {args.seed} | {card_line()} | calls "
          f"{len(cell.calls)} | windows {cell.windows} | wall {cell.wall_s:.4f} s | call walls "
          f"{[round(c['end'] - c['start'], 4) for c in cell.calls]} s", file=sys.stderr)
    for name, item in checks.items():
        print(f"check {name} {item['value']} limit {item['limit']}", file=sys.stderr)
    # after the window, the check and every metric reader: what this
    # process loaded by the time the result would be printed
    banned = banned_modules()
    if banned:
        print(f"benchmark: modules of JAX or the JAX package loaded: {banned}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
