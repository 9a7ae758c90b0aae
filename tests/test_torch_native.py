"""The port's native library (`whisper_diarize_tpu_torch/native.py`): built
from `native/wdt_native.cpp` into its own build directory under a lock, so
processes that load at once never load a half-written file, and never
written over the JAX package's `native/libwdt_native.so`."""

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# one process: load the library from the build directory the environment
# names, and hold its DTW to the numpy DP on a small cost
_LOAD = """
import sys
import numpy as np
from whisper_diarize_tpu_torch import native
from whisper_diarize_tpu_torch.ops import dtw
cost = np.random.default_rng(int(sys.argv[1])).random((9, 23)).astype(np.float32)
got = native.dtw_path(cost)
want = dtw.dtw_backtrack(dtw.dtw_cost_matrix(cost))
assert got is not None, "native library did not load"
assert all(np.array_equal(a, b) for a, b in zip(got, want)), (got, want)
print("ok", native.build())
"""


def _needs_compiler():
    from shutil import which

    if which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("needs g++")


def test_concurrent_loads_share_one_build(tmp_path):
    """Two processes load from an empty build directory at the same moment:
    both get a working library, and the directory ends with one library and
    no temporary file."""
    _needs_compiler()
    env = dict(os.environ, WDT_TORCH_NATIVE_DIR=str(tmp_path / "native"))
    env.pop("WDT_NATIVE_PATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(seed)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for seed in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert out.strip().splitlines()[-1].startswith("ok "), out
    libs = sorted((tmp_path / "native").glob("*.so"))
    assert len(libs) == 1
    assert not list((tmp_path / "native").glob(".*.tmp"))


def test_port_never_writes_the_jax_build(tmp_path, monkeypatch):
    """The port builds into its own directory, named by a hash of the
    source, and leaves `native/libwdt_native.so` as it found it."""
    _needs_compiler()
    from whisper_diarize_tpu_torch import native

    jax_lib = ROOT / "native" / "libwdt_native.so"
    before = (jax_lib.stat().st_mtime_ns, jax_lib.read_bytes()) if jax_lib.exists() else None
    monkeypatch.setenv("WDT_TORCH_NATIVE_DIR", str(tmp_path / "own"))
    so = native.build()
    assert so is not None and so.parent == tmp_path / "own"
    digest = hashlib.sha1((ROOT / "native" / "wdt_native.cpp").read_bytes()).hexdigest()[:16]
    assert so.name == f"libwdt_native-{digest}.so"
    after = (jax_lib.stat().st_mtime_ns, jax_lib.read_bytes()) if jax_lib.exists() else None
    assert after == before
    assert native.build() == so  # a second call reuses the build
    assert ctypes.CDLL(str(so)).dtw_band_for_frames(1500) > 0
