"""The DTW kernel (`csrc/dtw.cu`, `ops/dtw.py::dtw_anchor_frames_batch`) and
the alignment stage's cost reduction (`ops/dtw.py::alignment_cost_batch`)
timed on the card at the Engine's shapes: B 8 rows of Ta 1500 frames at N
32, 64, 224 and 440 text rows (32 and 64 sampled tokens, the largest window
of 224 and the kernel's largest N), on the costs `alignment_cost_batch`
makes of random alignment logits of K 10 heads (large-v3's alignment
heads) after a 3-token sot sequence, every row and frame valid.

    python -m whisper_diarize_tpu_torch.tools.bench_dtw [--rows 32 64 224 440] [--no-plain]

Each row: the kernel's CUDA-event ms of back-to-back calls and its profiled
device ms (`timing.time_ms`, `timing.device_ms`), ns an anti-diagonal
(device ms / (N + Ta - 1), the DP's dependent chain), the bound (each
valid cost cell read once and the anchors written once over the memory
rate; 4 f32 operations a cell), the plain version's CUDA-event ms, the
host native DP's ms on the fetched costs (`anchor_times_from_cost` a row,
best of 3; with the cost's fetch beside it), and the device memory
`alignment_cost_batch` allocates above its inputs at that shape (peak).
The kernel's anchors are held equal to the plain version's.

The tool imports only entry points every version of the port since the
on-device DTW has (`ops/dtw.py`'s `alignment_cost_batch`,
`dtw_anchor_frames_batch`, `dtw_anchor_frames_plain`,
`anchor_times_from_cost`; `tools/timing.py`), so the same file times an
older checkout's kernel beside this one's in one run on one card:

    PYTHONPATH=<older checkout> python whisper_diarize_tpu_torch/tools/bench_dtw.py

`--probe` instead builds instrumented copies of `csrc/dtw.cu` (nvcc, into
the gitignored build directory) and times them at B 8, Ta 1500, N 32 and
224 on random costs: "probe" is the kernel with `clock64` read around the
walk (block 0's walk in cycles; the DP is the rest of the kernel's time),
and each ablation drops a part of a DP step (the handoff ring's reads and
writes, the code-word stores, the cost copies, the shuffles, or the first
three) to show what a step's time goes to. The ablations' anchors are
wrong: they are timed, never used.

It prints the card's name and power limit first and one JSON object last.
Raises without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

import whisper_diarize_tpu_torch
from whisper_diarize_tpu_torch import kernels
from whisper_diarize_tpu_torch.ops import dtw
from whisper_diarize_tpu_torch.tools import timing

B, K, TA, SOT = 8, 10, 1500, 3

# --probe: text edits of csrc/dtw.cu (each must match exactly once)
_PROBE = [
    ("namespace {\n", "__device__ long long g_probe[2];\nnamespace {\n"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n  const long long clk0 = clock64();\n"),
    ("    int r = nt - 1, c = nf - 1", "    const long long clk = clock64();\n    int r = nt - 1, c = nf - 1"),
    ("    out[0] = 0;\n", "    out[0] = 0;\n    if (b == 0) {\n      g_probe[0] = clock64() - clk;\n"
     "      g_probe[1] = clock64() - clk0;\n    }\n"),
]
_ABLATIONS = {
    "no-ring": [("lane == 0 ? e.x : s0, u1 = lane == 0 ? e.y : s1",
                 "lane == 0 ? inf : s0, u1 = lane == 0 ? inf : s1"),
                ("lane == 0 ? e.z : s2, u3 = lane == 0 ? e.w : s3",
                 "lane == 0 ? inf : s2, u3 = lane == 0 ? inf : s3"),
                ("st_shared_if(hands_on && t < n_steps,", "st_shared_if(false,")],
    "no-code-stores": [("st_shared_if(code_rows && wi >= 0 && wi < words,", "st_shared_if(false,")],
    "no-copies": [("        fetch(t + AHEAD - 1,", "        if (false) fetch(t + AHEAD - 1,"),
                  ("        cp_async_wait<AHEAD - 2>();", "")],
    "no-shuffles": [(f"__shfl_up_sync(0xffffffffu, c{k}, 1)", f"c{k}") for k in range(4)],
}
_ABLATIONS["no-ring-code-stores-copies"] = (
    _ABLATIONS["no-ring"] + _ABLATIONS["no-code-stores"] + _ABLATIONS["no-copies"])


def host_dp_ms(cost: torch.Tensor, n_tok: Sequence[int], n_frames: Sequence[int],
               sot_len: int) -> tuple:
    """The host path on the same costs: (fetch + DP ms, DP ms), the native
    DP of `anchor_times_from_cost` a row, best of three."""
    fetch, dp = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = cost.cpu().numpy()
        t1 = time.perf_counter()
        for b in range(host.shape[0]):
            dtw.anchor_times_from_cost(np.ascontiguousarray(
                host[b, sot_len: sot_len + n_tok[b], : n_frames[b]]), n_tok[b])
        t2 = time.perf_counter()
        fetch.append((t2 - t0) * 1e3)
        dp.append((t2 - t1) * 1e3)
    return min(fetch), min(dp)


def row(qk: torch.Tensor, N: int, plain: bool) -> dict:
    """One shape: the cost of the first SOT + N rows of `qk`, then the
    kernel, the plain version and the host DP on it."""
    dev = qk.device
    q = qk[:, :, : SOT + N].contiguous()
    nf = torch.full((B,), TA, device=dev)
    nr = torch.full((B,), SOT + N, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cost = dtw.alignment_cost_batch(q, nf, nr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del q
    cost = cost.contiguous()
    n_tok = torch.full((B,), N, device=dev)

    def call():
        return dtw.dtw_anchor_frames_batch(cost, n_tok, nf, SOT)

    got = call()
    want = dtw.dtw_anchor_frames_plain(cost, n_tok, nf, SOT)
    if not torch.equal(got.long(), want.long()):
        raise AssertionError(f"bench_dtw N {N}: the kernel's anchors differ from the plain version")
    out = dict(ms=timing.time_ms(call), device_ms=timing.device_ms(call),
               plain_ms=(timing.time_ms(lambda: dtw.dtw_anchor_frames_plain(
                   cost, n_tok, nf, SOT), iters=2, warmup=1) if plain else None),
               alignment_peak_mib=peak / 2 ** 20)
    out["ns_per_diagonal"] = out["device_ms"] * 1e6 / (N + TA - 1)
    cells = float(B * N * TA)
    out.update(timing.bound(4 * cells + 4 * B * N + 8 * B, 4 * cells, timing.F32_FLOPS))
    out["host_fetch_dp_ms"], out["host_dp_ms"] = host_dp_ms(cost, [N] * B, [TA] * B, SOT)
    return out


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"bench_dtw --probe: {old!r} is not in csrc/dtw.cu once")
        text = text.replace(old, new)
    return text


def probe(dev: torch.device, rows: Sequence[int] = (32, 224), seed: int = 0) -> dict:
    """The instrumented and ablated copies of the kernel, built in parallel
    and timed (device ms) at B 8, Ta 1500 on random costs: for each N the
    kernel's ms, block 0's walk in cycles and its DP's cycles a step (its
    thread 0's cycles from start to the walk, over the steps of the warps'
    pipeline, nblk + 31 + 40 (warps - 1))."""
    src = (kernels.CSRC / "dtw.cu").read_text()
    out_dir = kernels.BUILD_DIR / "dtw_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = {"probe": []} | _ABLATIONS
    procs = {}
    for name, edits in variants.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(_edit(src, _PROBE + edits) + "\nWDT_EXPORT int wdt_dtw_probe(long long* out) "
                      "{ return (int)cudaMemcpyFromSymbol(out, g_probe, 2 * sizeof(long long)); }\n")
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", f"-I{kernels.CSRC}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"bench_dtw --probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.wdt_dtw_anchors.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.wdt_dtw_probe.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    g = torch.Generator(device=dev).manual_seed(seed)
    res = {}
    for N in rows:
        cost = torch.randn((B, SOT + N, TA), generator=g, device=dev)
        nt = torch.full((B,), N, dtype=torch.int32, device=dev)
        nf = torch.full((B,), TA, dtype=torch.int32, device=dev)
        out = torch.empty((B, N), dtype=torch.int32, device=dev)
        steps = (TA + 3) // 4 + 31 + 40 * (-(-N // 32) - 1)
        for name, lib in libs.items():
            def call(lib=lib):
                kernels.check(lib.wdt_dtw_anchors(
                    cost.data_ptr(), nt.data_ptr(), nf.data_ptr(), B, SOT + N, TA, SOT,
                    out.data_ptr(), kernels.stream_ptr(dev)), name)
            ms = timing.device_ms(call)
            cyc = (ctypes.c_longlong * 2)()
            torch.cuda.synchronize()
            kernels.check(lib.wdt_dtw_probe(ctypes.addressof(cyc)), name)
            walk, total = cyc[0], cyc[1]
            r = res[f"N={N} {name}"] = dict(device_ms=ms, walk_cycles=walk, kernel_cycles=total,
                                            walk_cycles_a_row=walk / N,
                                            dp_cycles_a_step=(total - walk) / steps,
                                            clock_ghz=total / (ms * 1e6))
            print(f"probe N={N} {name}: device {ms:.4f} ms; block 0: {total} cycles "
                  f"({r['clock_ghz']:.2f} GHz over the device time), walk {walk} "
                  f"({r['walk_cycles_a_row']:.0f} a row), DP {r['dp_cycles_a_step']:.0f} a step "
                  f"({steps} steps)", flush=True)
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[32, 64, 224, 440])
    ap.add_argument("--no-plain", action="store_true", help="skip the plain version's time")
    ap.add_argument("--probe", action="store_true",
                    help="time instrumented and ablated copies of the kernel instead")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_dtw: no CUDA device")
    dev = torch.device("cuda", 0)
    print(timing.card_line(dev), flush=True)
    if args.probe:
        res = dict(package=whisper_diarize_tpu_torch.__file__, probe=probe(dev, seed=args.seed))
        print(json.dumps(res), flush=True)
        return res
    g = torch.Generator(device=dev).manual_seed(args.seed)
    qk = torch.randn((B, K, SOT + max(args.rows), TA), generator=g, device=dev) * 3.0
    rows = {}
    for N in args.rows:
        r = rows[f"N={N}"] = row(qk, N, not args.no_plain)
        plain = "not timed" if r["plain_ms"] is None else f"{r['plain_ms']:.4f} ms"
        print(f"DTW B={B} N={N} Ta={TA}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
              f"{r['ns_per_diagonal']:.1f} ns an anti-diagonal), bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), plain {plain}, host native DP {r['host_dp_ms']:.4f} ms "
              f"({r['host_fetch_dp_ms']:.4f} with the fetch); alignment_cost_batch peak "
              f"{r['alignment_peak_mib']:.1f} MiB above its inputs", flush=True)
    res = dict(package=whisper_diarize_tpu_torch.__file__, rows=rows)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
