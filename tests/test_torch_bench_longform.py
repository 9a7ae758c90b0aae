"""The port's long-form tool (`whisper_diarize_tpu_torch/tools/
bench_longform.py`) against the JAX package's (`tools/bench_longform.py`,
imported by its path, unchanged) on the CPU: both tools' `main` in this
process, on one seeded snapshot (each package's `EngineConfig` patched, in
the test only, to load it in place of the tools' "__random__:<model>"
weights, whose pattern makes logits tie), `--model tiny`, 2 minutes of
audio, 4 tokens a window, no warm-up, beam 1 and beam 2. Both exit 0 with
the same windows and the same cues (text equal, times within 1e-3 s; the
cues are read from the tools' `transcribe_audio` calls), and the port's
report carries the JAX report's keys but `vs_baseline` (a TPU target), plus
`stage_s`, `peak_device_mib` and `device`. A second run of the port's tool
on the same working directory replays the resume journal (no decode) to
the same cues; a planted growth (each segment's callback held back longer
than the one before) trips the 3x guard: exit 1. Outside the test, the
Engine gets seeded weights of the JAX init's distribution from `--seed`."""

import importlib.util
import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import whisper_diarize_tpu.engine as jengine
from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu_torch import engine as tengine
from whisper_diarize_tpu_torch.tools import bench_longform
from whisper_diarize_tpu_torch.transcribe import TranscribeStep

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ARGS = ["--minutes", "2", "--model", "tiny", "--max-tokens", "4", "--warmup-minutes", "0"]
CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
JAX_ONLY = {"vs_baseline"}
PORT_ONLY = {"stage_s", "peak_device_mib", "device"}


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The JAX random init with printable bytes favoured, so the cues carry
    text."""
    d = tmp_path_factory.mktemp("snap")
    p = jax.tree.map(np.asarray, jwm.init_params(CFG, seed=0))
    emb = p["decoder"]["tok_emb"].copy()
    emb[33:127] *= np.random.default_rng(0).uniform(2.0, 4.0, (94, 1)).astype(np.float32)
    emb[256:DebugTokenizer().specials.eot] = 0.0
    p["decoder"]["tok_emb"] = emb
    jweights.save_params(p, CFG, d)
    return str(d)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_bench_longform",
                                                  ROOT / "tools" / "bench_longform.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _on_snapshot(monkeypatch, module, snapshot: str, record: list) -> None:
    """`module.EngineConfig` loads `snapshot`, and its Engine's
    `transcribe_audio` results are appended to `record`."""
    real_cfg, real_engine = module.EngineConfig, module.Engine

    def config(**kw):
        return real_cfg(**{**kw, "whisper_model_path": snapshot})

    def transcribe(self, *a, **k):
        cues = real_transcribe(self, *a, **k)
        record.append(cues)
        return cues

    real_transcribe = real_engine.transcribe_audio
    monkeypatch.setattr(module, "EngineConfig", config)
    monkeypatch.setattr(real_engine, "transcribe_audio", transcribe)


def _cues(cues):
    return [(c.text, round(c.start, 3), round(c.end, 3)) for c in cues]


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("beam", [1, 2])
def test_port_tool_matches_jax_tool(snapshot, jax_tool, capsys, monkeypatch, tmp_path, beam):
    jcues, tcues = [], []
    _on_snapshot(monkeypatch, jengine, snapshot, jcues)
    _on_snapshot(monkeypatch, tengine, snapshot, tcues)
    monkeypatch.setattr(bench_longform, "EngineConfig", tengine.EngineConfig)
    argv = ARGS + ["--beam", str(beam)]

    def jax_workdir(prefix=""):  # the JAX tool keeps its directory: keep it here
        (tmp_path / "jax").mkdir()
        return str(tmp_path / "jax")

    monkeypatch.setattr(jax_tool.tempfile, "mkdtemp", jax_workdir)
    assert jax_tool.main(argv) == 0
    ref = _report(capsys)
    assert bench_longform.main(argv + ["--device", "cpu"], workdir=str(tmp_path / "port")) == 0
    got = _report(capsys)
    assert set(got) == set(ref) - JAX_ONLY | PORT_ONLY
    assert got["windows"] == ref["windows"] >= 4  # 2 minutes of 30 s windows
    assert got["cues"] == ref["cues"] > 0
    (jc,), (tc,) = jcues, tcues
    assert _cues(tc) == _cues(jc) and any(text.strip() for text, _, _ in _cues(tc))
    assert got["device"] == "cpu" and got["peak_device_mib"] is None
    assert set(got["stage_s"]) >= {"mel", "encode", "decode", "embed"}
    assert got["value"] > 0 and got["first_decile_s_per_window"] is not None

    # the same working directory again: the resume journal replays every
    # window, with no decode, to the same cues
    def no_decode(*a, **k):
        raise AssertionError("a journalled window was decoded again")

    monkeypatch.setattr(TranscribeStep, "decode", no_decode)
    tcues.clear()
    assert bench_longform.main(argv + ["--device", "cpu"], workdir=str(tmp_path / "port")) == 0
    assert _report(capsys)["windows"] == got["windows"]
    (again,) = tcues
    assert _cues(again) == _cues(tc)


def test_growth_guard_exits_1(snapshot, capsys, monkeypatch, tmp_path):
    """Each segment's callback from the third on is held back until 4 (k -
    1) first gaps have passed since the previous one: the last decile's
    seconds a window exceed 3x the first's, and the tool exits 1."""
    _on_snapshot(monkeypatch, tengine, snapshot, [])
    monkeypatch.setattr(bench_longform, "EngineConfig", tengine.EngineConfig)
    real = bench_longform.Callbacks

    def planted(new_segment_callback=None, **kw):
        walls = []

        def held_back(segment):
            k = len(walls)
            if k >= 2:
                gap = max(walls[1] - walls[0], 0.05)
                time.sleep(max(0.0, walls[-1] + 4 * (k - 1) * gap - time.perf_counter()))
            walls.append(time.perf_counter())
            new_segment_callback(segment)

        return real(new_segment_callback=held_back, **kw)

    monkeypatch.setattr(bench_longform, "Callbacks", planted)
    rc = bench_longform.main(ARGS + ["--beam", "1", "--device", "cpu", "--max-tokens", "2"],
                             workdir=str(tmp_path))
    out = capsys.readouterr()
    report = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 1 and "grew superlinearly" in out.err
    assert report["last_decile_s_per_window"] > 3 * report["first_decile_s_per_window"]


@pytest.mark.parametrize("extra,path", [([], "__random__:tiny:0"),
                                        (["--seed", "3"], "__random__:tiny:3")])
def test_weights_follow_the_seed(monkeypatch, tmp_path, extra, path):
    """The Engine loads random weights of the JAX init's distribution from
    `--seed` ("__random__:<model>:<seed>"); the suppression patch is undone
    when the run stops."""
    seen = []

    class Stop(Exception):
        pass

    def config(**kw):
        seen.append(kw)
        raise Stop

    orig = bench_longform.dec.build_suppress_mask
    monkeypatch.setattr(bench_longform, "EngineConfig", config)
    with pytest.raises(Stop):
        bench_longform.main(ARGS + ["--device", "cpu"] + extra, workdir=str(tmp_path))
    (kw,) = seen
    assert kw["whisper_model_path"] == path and kw["sequential_prompt"] and kw["enable_dtw"]
    assert kw["resume_dir"].startswith(str(tmp_path)) and not kw["temperature_fallback"]
    assert bench_longform.dec.build_suppress_mask is orig
