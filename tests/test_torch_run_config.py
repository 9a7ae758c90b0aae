"""The port's eval harness (`whisper_diarize_tpu_torch/tools/run_config.py`)
end to end on the CPU (counterpart of `tests/test_run_config.py`): config 3
(diarization on, DTW on) over synthetic labelled audio (two alternating
tone "speakers" with silences), a reference transcript and an RTTM file;
the report carries xRT, WER and DER with every key the JAX harness prints,
and the RTTM parser round-trips."""

import json

import numpy as np
import pytest
import torch

from whisper_diarize_tpu_torch.audio import write_wav
from whisper_diarize_tpu_torch.tools import run_config
from whisper_diarize_tpu_torch.tools.quality_golden import write_snapshot

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("evalfx")
    write_snapshot(str(d / "snap"))
    sr = 16000
    rng = np.random.default_rng(0)
    pieces, rttm_lines, t = [], [], 0.0
    for freq, dur in [(440, 1.0), (0, 0.4), (880, 1.2), (0, 0.4), (440, 0.8)]:
        n = int(dur * sr)
        tt = np.arange(n) / sr
        if freq:
            x = 0.4 * np.sin(2 * np.pi * freq * tt) + rng.standard_normal(n) * 0.01
            rttm_lines.append(f"SPEAKER synth 1 {t:.2f} {dur:.2f} <NA> <NA> "
                              f"spk{1 if freq == 440 else 2} <NA> <NA>")
        else:
            x = np.zeros(n)
        pieces.append((x * 32767).astype(np.int16))
        t += dur
    write_wav(str(d / "synth.wav"), np.concatenate(pieces))
    (d / "ref.txt").write_text("hello world this is a test")
    (d / "ref.rttm").write_text("\n".join(rttm_lines) + "\n")
    return d


def test_rttm_parser(fixture_dir):
    turns = run_config.read_rttm(str(fixture_dir / "ref.rttm"))
    assert [t.speaker for t in turns] == ["spk1", "spk2", "spk1"]
    assert turns[1].start == pytest.approx(1.4)
    assert turns[1].end == pytest.approx(2.6)


def test_config3_machinery_end_to_end(fixture_dir, capsys, monkeypatch):
    monkeypatch.setenv("WDT_SEG_MODEL", "__random__")
    monkeypatch.setenv("WDT_EMB_MODEL", "__random__")
    rc = run_config.main([
        "3", str(fixture_dir / "synth.wav"),
        "--model-dir", str(fixture_dir / "snap"),
        "--cache-dir", str(fixture_dir / "cache"),
        "--ref-text", str(fixture_dir / "ref.txt"),
        "--ref-rttm", str(fixture_dir / "ref.rttm"),
        "--max-tokens", "8", "--cpu",
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"config", "model", "files", "audio_seconds", "wall_seconds", "xRT",
                           "wer", "der", "speakers_found"}
    assert report["config"] == 3 and report["model"] == "medium" and report["files"] == 1
    assert report["xRT"] > 0 and report["audio_seconds"] == pytest.approx(3.8)
    assert 0.0 <= report["wer"]  # random weights: any finite WER
    assert set(report["der"]) >= {"der", "confusion", "total_speech", "missed", "false_alarm"}
    for v in report["der"].values():
        assert np.isfinite(v)


def test_model_dir_takes_random_weights(tmp_path, capsys, monkeypatch):
    """"__random__:<preset>[:seed]" loads random weights at a preset's
    geometry (config 1: greedy, VAD)."""
    wav = tmp_path / "in.wav"
    write_wav(str(wav), (np.random.default_rng(1).standard_normal(16000) * 3000).astype(np.int16))
    monkeypatch.setenv("WDT_VAD_MODEL", "__random__")
    assert run_config.main(["1", str(wav), "--model-dir", "__random__:tiny:1",
                            "--cache-dir", str(tmp_path / "cache"), "--max-tokens", "4",
                            "--cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["config"] == 1 and report["model"] == "base.en" and report["xRT"] > 0
