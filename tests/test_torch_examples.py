"""The port's ten examples (`whisper_diarize_tpu_torch/examples/`), each
`main(argv)` on the CPU (`--cpu`) in a temporary working directory, on the
tiny fixture that `_common make-fixture` writes, with no network: the
translator's HTTP getter answers from canned responses, and the cache
examples work on a temporary cache. The examples that need no model print
what the JAX package's `examples/*.py` print on the same inputs, line for
line; the others print lines of the JAX scripts' form."""

import json
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

import whisper_diarize_tpu.translate as jtranslate
import whisper_diarize_tpu_torch.translate as ttranslate
from whisper_diarize_tpu_torch.examples import (
    _common, delete_cached_model, delete_nonexistent, list_cached_models, progress_simple,
    progress_types, speculative_decode, transcribe, transcribe_translate, translate_progress,
    translate_text)
from whisper_diarize_tpu_torch.tools.quality_golden import apply_printable_suppression

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("fx")
    _common.main(["make-fixture", str(d)])
    return d


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """A fresh working directory, and canned translations: "<text> (de)"."""
    monkeypatch.chdir(tmp_path)

    def fake_get(url, params):
        return 200, json.dumps([[[f"{params['q']} ({params['tl']})", params["q"]]]])

    for mod in (ttranslate, jtranslate):
        monkeypatch.setattr(mod, "_default_http_get", fake_get)
    return tmp_path


def _args(fixture, *extra):
    return [str(fixture / "example.wav"), "--model-dir", str(fixture / "snap"), "--cpu",
            "--greedy", "--max-tokens", "4", *extra]


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def _jax_example(name, argv, capsys, monkeypatch):
    """stdout of the JAX package's `examples/<name>.py` run as a script."""
    monkeypatch.setattr(sys, "argv", [name + ".py", *argv])
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    return _lines(capsys)


def test_make_fixture_writes_a_snapshot_and_a_wav(fixture):
    from whisper_diarize_tpu_torch.models import weights

    assert (fixture / "example.wav").exists()
    params, cfg = weights.load_model(fixture / "snap", device="cpu")
    assert cfg.n_text_state == 64 and params["decoder"]["tok_emb"].shape == (51865, 64)


def test_transcribe(fixture, offline, capsys):
    transcribe.main(_args(fixture))
    out = _lines(capsys)
    assert re.fullmatch(r"\[Transcribe\] \d+% .+", out[-2]), out
    n = int(re.fullmatch(r"(\d+) cues written to segments.json", out[-1]).group(1))
    assert len(json.loads((offline / "segments.json").read_text())) == n


def test_transcribe_translate(fixture, offline, capsys):
    undo = apply_printable_suppression()  # random weights decode to visible text
    try:
        transcribe_translate.main(_args(fixture, "--to", "de"))
    finally:
        undo()
    cues = json.loads(capsys.readouterr().out)
    # the formatter lays each translated segment out anew, maybe over cues
    assert cues and " ".join(c["text"] for c in cues).endswith("(de)"), cues


def test_translate_progress(offline, capsys, monkeypatch):
    translate_progress.main(["fr"])
    out = _lines(capsys)
    assert out[-1] == "first/last: 0 100"
    assert out[0] == "[Translate]   0% Translating from en to fr"
    ref = _jax_example("translate_progress", ["fr"], capsys, monkeypatch)
    assert sorted(out) == sorted(ref)  # the workers' completion order varies


def test_translate_text(offline, capsys, monkeypatch):
    translate_text.main(["Good morning", "en", "es"])
    out = _lines(capsys)
    assert out == ["Good morning (es)"]
    assert out == _jax_example("translate_text", ["Good morning", "en", "es"], capsys,
                               monkeypatch)


def test_progress_simple(fixture, offline, capsys):
    progress_simple.main(_args(fixture))
    out = capsys.readouterr().out
    assert "\rTranscribing audio: 100%" in out
    assert re.search(r"\ndone: \d+ cues\n$", out), out


def test_progress_types(fixture, offline, capsys):
    progress_types.main(_args(fixture))
    out = _lines(capsys)
    assert out and all(re.fullmatch(r"\w+: \d+ progress events", line) for line in out), out
    assert any(line.startswith("Transcribe: ") for line in out)


def test_speculative_decode(fixture, offline, capsys):
    """The fixture's snapshot drafts for itself (the same vocabulary)."""
    speculative_decode.main(_args(fixture, "--draft-model-dir", str(fixture / "snap")))
    for line in _lines(capsys):
        assert re.fullmatch(r"\[ *\d+\.\d\d - *\d+\.\d\d\] .*", line), line


def _cache_with(cache: Path, name: str) -> None:
    snap = cache / f"models--openai--whisper-{name}" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")


def test_list_cached_models(offline, capsys, monkeypatch):
    cache = offline / "cache"
    list_cached_models.main([str(cache)])
    assert _lines(capsys) == ["no cached models"]
    _cache_with(cache, "tiny")
    _cache_with(cache, "base.en")
    list_cached_models.main([str(cache)])
    out = _lines(capsys)
    assert out == ["base.en", "tiny"]
    assert out == _jax_example("list_cached_models", [str(cache)], capsys, monkeypatch)


def test_delete_cached_model(offline, capsys, monkeypatch):
    cache = offline / "cache"
    delete_cached_model.main([])
    assert _lines(capsys) == ["usage: delete_cached_model.py <model> [cache_dir]"]
    _cache_with(cache, "tiny")
    _cache_with(cache, "small")
    delete_cached_model.main(["tiny", str(cache)])
    assert _lines(capsys) == ["deleted 'tiny': True"]
    delete_cached_model.main(["tiny", str(cache)])
    out = _lines(capsys)
    assert out == ["deleted 'tiny': False"]
    assert out == _jax_example("delete_cached_model", ["tiny", str(cache)], capsys, monkeypatch)
    ref = _jax_example("delete_cached_model", ["small", str(cache)], capsys, monkeypatch)
    assert ref == ["deleted 'small': True"]


def test_delete_nonexistent(offline, capsys, monkeypatch):
    delete_nonexistent.main([])
    out = _lines(capsys)
    assert out == ["delete of nonexistent model correctly returned False"]
    assert out == _jax_example("delete_nonexistent", [], capsys, monkeypatch)
