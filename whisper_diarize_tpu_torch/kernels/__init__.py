"""Build and load the hand-written Hopper kernels (`../csrc/*.cu`).

The CUDA sources are compiled with `nvcc` for `sm_90a`, one `nvcc` process
per source, all started together, and linked into one shared library with
a plain C interface, loaded with `ctypes`. The build happens on first use,
never at import: the library lands in
`<checkout>/build/whisper_diarize_tpu_torch/`, named by a hash of the
sources so an edited source never loads a stale binary. A failed build
raises with `nvcc`'s output; nothing runs without the kernels.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "whisper_diarize_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: name -> argtypes (every entry returns int = cudaError_t)
_SIGNATURES = {
    "wdt_cross_attn": [_P] * 4 + [_I] * 8 + [_P],
    "wdt_cross_attn_const_layer": [_P] * 4 + [_I] * 7 + [_P],
    "wdt_cross_attn_q8": [_P] * 6 + [_I] * 8 + [_P],
    "wdt_cross_kv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wdt_encoder_attn": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_I, _P],
    "wdt_fused_front": [_P] * 10 + [_I] * 10 + [_P],
    "wdt_fused_tail": [_P] * 31 + [_I] * 30 + [_P],
    "wdt_kv_stream_sum": [_P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P],
    "wdt_log_mel": [_P] * 5 + [_I] * 4 + [_P],
    "wdt_split_self_attn": [_P] * 8 + [_I] * 8 + [_P],
    "wdt_stream_sum": [_P, _L, _F, _P, _I, _P, _P],
    "wdt_stream_sum_pipelined": [_P, _L, _F, _I, _I, _P, _I, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log: str = ""  # nvcc's output (-Xptxas -v: registers, spills, smem)


class KernelCompileError(RuntimeError):
    pass


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelCompileError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first call."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha1()
        for p in _sources():
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        digest.update(" ".join(ARCH_FLAGS).encode())
        so = BUILD_DIR / f"libwdt_kernels-{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{so.stem}.{os.getpid()}"
            nvcc = _nvcc()
            t0, build_log = time.perf_counter(), ""
            objs, cmds = [], []
            for src in sorted(CSRC.glob("*.cu")):
                objs.append(BUILD_DIR / f"{tag}.{src.stem}.o")
                cmds.append([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
                             "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
                             "-o", str(objs[-1]), str(src)])
            tmp = so.with_name(f"{tag}.tmp")
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            try:
                _run_all(cmds)
                _run_all([link])
            finally:
                build_seconds = time.perf_counter() - t0
                for o in objs:
                    o.unlink(missing_ok=True)
            os.replace(tmp, so)
            (BUILD_DIR / "build.log").write_text(build_log)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _run_all(cmds) -> None:
    """Run the commands in parallel; their output goes to `build_log`; the
    first failure raises with its command and output."""
    global build_log
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    build_log += "".join(outs)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelCompileError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
