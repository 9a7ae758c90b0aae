"""The port imports no JAX: a fresh interpreter imports the package and
`chip_smoke`, runs a tiny CPU `Engine.transcribe_audio`, and finds no `jax`
module loaded. A subprocess, because the test process imports JAX
(tests/conftest.py)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import whisper_diarize_tpu_torch as wdt
    import chip_smoke  # noqa: F401 (imports only, runs nothing)
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

    tmp = sys.argv[1]
    rng = np.random.default_rng(0)
    wdt.write_wav(tmp + "/in.wav", (rng.standard_normal(32000) * 3000).astype(np.int16))
    eng = Engine(EngineConfig(
        cache_dir=tmp + "/cache", use_gpu=False,
        whisper_model_path="__random__:tiny", vad_model_path="__random__",
        batch_size=1, max_decode_tokens=4, temperature_fallback=False))
    cues = eng.transcribe_audio(tmp + "/in.wav", wdt.TranscribeOptions(
        enable_vad=False, lang="en",
        advanced=wdt.AdvancedTranscribe(sampling_strategy="greedy")))
    assert eng.last_run["windows"] == 1, eng.last_run
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert not leaked, leaked
    print("NO_JAX_OK", len(cues))
""")


def test_port_imports_no_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
