"""The port imports no JAX and nothing of the JAX package: a fresh
interpreter imports the package and `chip_smoke`, runs a tiny CPU
`Engine.transcribe_audio` that decodes one window (whole file), then a VAD
request (the port's own Silero reader and audio code), then a diarized
request (the port's segmentation net, CAM++ and kaldi fbank), then a
greedy request with a draft model the port wrote (`save_params`:
speculative decoding), a GGML file written and read back, the CLI's
`models list`, then the diagnostic tools' `main` on the CPU at tiny shapes
(and the encoder attention tool's `main`, a megakernel worker, the decode
breakdown tools' `main`, the converter CLI and the long-form tool's `main`), one
alignment through the on-device DTW's function (its plain version), the
eval harness (`tools/run_config.py`) and two examples with `--cpu`, and
finds no `jax` and no `whisper_diarize_tpu`
module loaded (a subprocess, because the test process imports JAX, see
tests/conftest.py); and a static scan of every module of the port and of
`chip_smoke.py` finds no import of either, nor of the repo's top-level
`evals/`. Also: the port's VAD and diarization entry points, its loaders
(`load_model`, `load_vad_params`, `load_segmentation_params`,
`load_campplus_params`, `load_ggml`, `load_openai_pt`, the nets'
`load_params`), its tools (the breakdown tools too), its eval harness, its examples and its CLI ask
for the card unless the caller asks for the CPU."""

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
    eng.cfg.diarize_segment_model_path = eng.cfg.diarize_embedding_model_path = "__random__"
    diarized = eng.transcribe_audio(tmp + "/in.wav", wdt.TranscribeOptions(
        enable_diarize=True, lang="en", advanced=greedy))
    assert eng.last_run["windows"] >= 1 and "segment" in eng.last_run["stage_s"], eng.last_run
    assert all(isinstance(c.speaker_id, str) for c in diarized), diarized
    for name in ("ModelManager", "to_srt", "wer", "translate_text", "get_segments"):
        getattr(wdt, name)
    from whisper_diarize_tpu_torch.models import ggml, weights, whisper
    from whisper_diarize_tpu_torch.__main__ import main as cli
    cfg = whisper.PRESETS["tiny"]
    params = whisper.init_params(cfg, seed=1)
    weights.save_params(params, cfg, tmp + "/draft")
    eng.cfg.draft_model_path = tmp + "/draft"
    eng.transcribe_audio(tmp + "/in.wav", wdt.TranscribeOptions(
        enable_vad=False, lang="en", advanced=greedy))
    assert any(s.draft is not None for s in eng._step_cache.values()), eng._step_cache
    hp = {k: getattr(cfg, k) for k in (
        "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
        "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer", "n_mels")}
    ggml.write_ggml(tmp + "/g.bin", {"decoder.ln.weight": params["decoder"]["ln_s"].numpy()},
                    hp, np.zeros((80, 201), np.float32), [b"a"], quantize="q8_0")
    assert ggml.read_ggml(tmp + "/g.bin")[1]["n_text_state"] == cfg.n_text_state
    assert cli(["models", "list", "--cache-dir", tmp + "/cache"]) == 0
    from whisper_diarize_tpu_torch.tools import bench_attn_kernel, bench_dma, bench_speculative
    assert len(bench_dma.main(device="cpu", tiles=(1,))) == 12
    assert len(bench_attn_kernel.main(device="cpu", layers=2, batch=1)) == 8
    b = bench_speculative.main(device="cpu", preset="tiny", batch=1, steps=4,
                               rows=["greedy", "self-g4"], repeat=1)
    assert [r["row"] for r in b.rows] == ["greedy", "self-g4"] and b.rows[1]["rounds"] == 1
    from whisper_diarize_tpu_torch.tools import bench_encoder_attn, bench_megakernel
    assert len(bench_encoder_attn.main("tiny", device="cpu", batch=1, repeat=1)) == 3
    row, _ = bench_megakernel.worker("tiny", 1, "tail+front", "greedy", device="cpu", smoke=True)
    assert row["variant"] == "tail+front", row
    from whisper_diarize_tpu_torch.tools import (
        bench_beam_breakdown, bench_beam_variants, bench_decode_breakdown, bench_layer_variants,
        bench_quant_kv, convert_models)
    cpu = dict(device="cpu", smoke=True)
    assert bench_decode_breakdown.main("tiny", 1, **cpu).rows[0]["phase"] == "mel"
    rows = bench_beam_breakdown.main("tiny", 1, inline=True, parts=("gather", "sample"), **cpu)
    assert [r["phase"] for r in rows] == ["gather", "sample"], rows
    assert len(bench_layer_variants.main("tiny", 1, **cpu).rows) == 5
    rows = bench_beam_variants.main("tiny", 1, inline=True, parts=("embed", "full"), **cpu)
    assert [r["phase"] for r in rows] == ["embed", "full"], rows
    assert len(bench_quant_kv.main("tiny", 1, inline=True, **cpu)) == 5
    torch.save({"_model.decoder.decoder.2.bias": torch.zeros(1)}, tmp + "/silero.pt")
    assert convert_models.main(["silero", tmp + "/silero.pt", tmp + "/silero.npz"]) == 0
    from whisper_diarize_tpu_torch.ops import dtw
    frames = dtw.dtw_anchor_frames_batch(torch.randn(2, 7, 30), torch.tensor([4, 1]),
                                         torch.tensor([30, 12]), 2)
    assert frames.shape == (2, 5) and frames.dtype == torch.int32 and frames[0, 0] == 0
    from whisper_diarize_tpu_torch.tools import bench_longform
    assert bench_longform.main(["--device", "cpu", "--minutes", "1", "--model", "tiny",
                                "--max-tokens", "2", "--beam", "1",
                                "--warmup-minutes", "0"]) == 0
    from whisper_diarize_tpu_torch.tools import run_config
    import os
    os.environ["WDT_VAD_MODEL"] = "__random__"  # no download
    assert run_config.main(["1", tmp + "/in.wav", "--model-dir", "__random__:tiny",
                            "--cache-dir", tmp + "/cache", "--max-tokens", "2", "--cpu"]) == 0
    from whisper_diarize_tpu_torch.examples import _common, delete_nonexistent, transcribe
    _common.main(["make-fixture", tmp + "/fx"])
    os.chdir(tmp)
    transcribe.main([tmp + "/fx/example.wav", "--model-dir", tmp + "/fx/snap", "--cpu",
                     "--greedy", "--max-tokens", "2", "--no-vad"])
    delete_nonexistent.main([tmp + "/cache"])
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
        "front", "encoder_attn", "mel", "attn", "tail", "stream", "attn_probe")} <= scanned
    assert {f"whisper_diarize_tpu_torch/tools/{m}.py" for m in (
        "bench_dma", "bench_attn_kernel", "bench_speculative", "timing", "bench_encoder_attn",
        "bench_megakernel")} <= scanned
    assert {f"whisper_diarize_tpu_torch/tools/{m}.py" for m in (
        "run_config", "quality_golden", "bench_decode_breakdown", "bench_beam_breakdown",
        "bench_layer_variants", "bench_beam_variants", "bench_quant_kv",
        "convert_models", "bench_longform")} <= scanned
    assert {f"whisper_diarize_tpu_torch/examples/{m}.py" for m in (
        "_common", "transcribe", "transcribe_translate", "translate_progress", "translate_text",
        "progress_simple", "progress_types", "speculative_decode", "list_cached_models",
        "delete_cached_model", "delete_nonexistent")} <= scanned
    assert {f"whisper_diarize_tpu_torch/{m}.py" for m in (
        "diarize", "models/segmentation", "models/campplus", "models/onnx_io",
        "models/convert", "models/net_check", "models/ggml", "ops/speculative",
        "__main__")} <= scanned
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}" for f in files
           for mod, line in _imported(f)
           if mod.split(".")[0] in FORBIDDEN + ("evals", "torch_refs", "tools", "examples",
                                                "make_quality_golden", "run_config", "_common")]
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


def test_diarize_entry_points_default_to_the_card():
    """Without `device` the segmentation windows, the CAM++ host path and
    the diarization loaders ask for CUDA device 0: here, with no card, they
    raise before computing anything; `device="cpu"` runs."""
    from whisper_diarize_tpu_torch import diarize
    from whisper_diarize_tpu_torch.models import campplus, convert

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = (np.random.default_rng(0).standard_normal(16000) * 3000).astype(np.int16)
    for call in (lambda: diarize.get_segments(x), lambda: diarize.get_segments_batch([x]),
                 lambda: campplus.compute_embeddings_batch({}, [x]),
                 lambda: campplus.compute_embedding({}, x),
                 lambda: convert.load_segmentation_params("__random__"),
                 lambda: convert.load_campplus_params("__random__")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert isinstance(diarize.get_segments(x, device="cpu"), list)
    params = convert.load_campplus_params("__random__", device="cpu")
    assert campplus.compute_embeddings_batch(params, [x], device="cpu").shape == (1, 192)


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


@pytest.mark.parametrize("net", ["silero_vad", "segmentation", "campplus"])
def test_net_load_params_default_to_the_card(tmp_path, net):
    """Each net's `load_params` loads onto CUDA device 0 unless given a
    device: here, with no card, it raises before reading anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"whisper_diarize_tpu_torch.models.{net}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.load_params(str(tmp_path / "missing.npz"))


def test_checkpoint_file_loaders_default_to_the_card(tmp_path):
    """`load_ggml` and `load_openai_pt` load onto CUDA device 0 unless given
    a device: here, with no card, they raise before reading anything."""
    from whisper_diarize_tpu_torch.models import ggml, weights

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for load in (ggml.load_ggml, weights.load_openai_pt):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(tmp_path / "missing.bin")


def test_tools_default_to_the_card():
    """The diagnostic and breakdown tools run on CUDA device 0 unless given
    a device: here, with no card, `main()` (and the quantized-cache tool's
    worker, and each part-per-process tool's child) raises before it
    allocates anything."""
    from whisper_diarize_tpu_torch.tools import (
        bench_attn_kernel, bench_beam_breakdown, bench_beam_variants, bench_cross_kv,
        bench_decode_breakdown, bench_dma, bench_layer_variants, bench_longform, bench_quant_kv,
        bench_speculative)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (bench_dma.main, bench_attn_kernel.main, bench_speculative.main,
                 lambda: bench_longform.main([]), lambda: bench_cross_kv.main([]),
                 bench_decode_breakdown.main, bench_beam_breakdown.main,
                 bench_layer_variants.main, bench_beam_variants.main, bench_quant_kv.main,
                 lambda: bench_quant_kv.worker("tiny", 1, "tail", "greedy"),
                 lambda: bench_beam_breakdown.main(inline=True),
                 lambda: bench_beam_variants.main(inline=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()


def test_harness_and_examples_default_to_the_card(tmp_path, monkeypatch):
    """`tools/run_config.py` and every example that builds an Engine ask for
    CUDA device 0 unless given `--cpu`: here, with no card, they raise
    before any work."""
    from whisper_diarize_tpu_torch.examples import (
        progress_simple, progress_types, speculative_decode, transcribe, transcribe_translate)
    from whisper_diarize_tpu_torch.tools import run_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    wav, model = str(tmp_path / "missing.wav"), ["--model-dir", "__random__:tiny"]
    calls = [lambda: run_config.main(["2", wav, *model]),
             lambda: speculative_decode.main([wav, *model, "--draft-model-dir", "d"])]
    calls += [lambda m=m: m.main([wav, *model])
              for m in (transcribe, transcribe_translate, progress_simple, progress_types)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
