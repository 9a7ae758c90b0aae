"""The port imports no JAX and nothing of the JAX package: a fresh
interpreter imports the package and `chip_smoke`, runs a tiny CPU
`Engine.transcribe_audio` that decodes one window (whole file), then a VAD
request (the port's own Silero reader and audio code), and finds no `jax`
and no `whisper_diarize_tpu`
module loaded (a subprocess, because the test process imports JAX, see
tests/conftest.py); and a static scan of every module of the port and of
`chip_smoke.py` finds no import of either. Also: the port's VAD entry
point and its loaders (`load_model`, `load_vad_params`) ask for the card
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "whisper_diarize_tpu")

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
    greedy = wdt.AdvancedTranscribe(sampling_strategy="greedy")
    cues = eng.transcribe_audio(tmp + "/in.wav", wdt.TranscribeOptions(
        enable_vad=False, lang="en", advanced=greedy))
    assert eng.last_run["windows"] == 1, eng.last_run
    eng.transcribe_audio(tmp + "/in.wav", wdt.TranscribeOptions(
        enable_vad=True, lang="en", advanced=greedy))
    for name in ("ModelManager", "to_srt", "wer", "translate_text", "get_segments"):
        getattr(wdt, name)
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert not leaked, leaked
    jax_pkg = sorted(m for m in sys.modules
                     if m == "whisper_diarize_tpu" or m.startswith("whisper_diarize_tpu."))
    assert not jax_pkg, jax_pkg
    print("NO_JAX_OK", len(cues))
""")


def test_port_imports_no_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def _imported(path: Path):
    """Every module name an import statement of `path` names (absolute),
    with the lines, including imports inside functions and strings handed
    to `importlib` in a `_LAZY` table of (module, attribute) pairs."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno
        elif isinstance(node, ast.Tuple) and len(node.elts) == 2 and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str) for e in node.elts):
            yield node.elts[0].value, node.lineno


def test_static_scan_finds_no_jax_package_import():
    files = sorted((ROOT / "whisper_diarize_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"whisper_diarize_tpu_torch/ops/{m}.py" for m in (
        "front", "encoder_attn", "mel", "attn", "tail")} <= scanned
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}" for f in files
           for mod, line in _imported(f) if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_get_segments_defaults_to_the_card():
    """Without `device` the VAD asks for CUDA device 0: here, with no card,
    it raises; `device="cpu"` runs."""
    from whisper_diarize_tpu_torch import vad

    x = (np.random.default_rng(0).standard_normal(16000) * 3000).astype(np.int16)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: vad.get_segments("__random__", x),
                 lambda: vad.get_segments_batch("__random__", [x])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    mask, segs = vad.get_segments("__random__", x, device="cpu")
    assert isinstance(mask, list) and isinstance(segs, list)


def test_loaders_default_to_the_card(tmp_path):
    """`load_model` and `load_vad_params` load onto CUDA device 0 unless
    given a device: here, with no card, they raise before reading anything;
    `device="cpu"` loads."""
    from whisper_diarize_tpu_torch import vad
    from whisper_diarize_tpu_torch.models import weights

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.load_model(tmp_path)
    for model in ("__random__", None):
        with pytest.raises(RuntimeError, match="CUDA"):
            vad.load_vad_params(model)
        params = vad.load_vad_params(model, device="cpu")
        assert all(t.device.type == "cpu" for t in params.values()
                   if isinstance(t, torch.Tensor))
