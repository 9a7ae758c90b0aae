"""The port's command line (`python -m whisper_diarize_tpu_torch`) against
the JAX package's on the CPU: `transcribe --cpu` prints the JAX CLI's cue
JSON on the same snapshot, with and without `--draft-model-dir` (word
times without DTW: interpolated on the host from the same tokens, so equal;
word probabilities within 1e-4); `models list`; SRT output; `--mesh`
reaches the Engine's refusal; there is no `bench` command (the JAX one runs
the JAX package's benchmark).
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax

from whisper_diarize_tpu.__main__ import main as jmain
from whisper_diarize_tpu.audio import write_wav
from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.tokenizer import DebugTokenizer

from whisper_diarize_tpu_torch.__main__ import _format_srt, main
from whisper_diarize_tpu_torch.types import Segment

torch.set_num_threads(2)

CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
DRAFT_CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
    n_text_ctx=448, n_text_state=32, n_text_head=2, n_text_layer=1,
)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """The target (the JAX package's random init with the token embedding
    biased towards printable bytes, so the byte-level tokenizer decodes
    visible text), a smaller draft sharing its vocabulary, and 8 s of
    audio."""
    d = tmp_path_factory.mktemp("snaps")
    p = jax.tree.map(np.asarray, jwm.init_params(CFG, seed=0))
    emb = p["decoder"]["tok_emb"].copy()
    emb[33:127] *= np.random.default_rng(0).uniform(2.0, 4.0, (94, 1)).astype(np.float32)
    emb[256:DebugTokenizer().specials.eot] = 0.0
    p["decoder"]["tok_emb"] = emb
    jweights.save_params(p, CFG, d / "target")
    jweights.init_random_snapshot(d / "draft", cfg=DRAFT_CFG, seed=7)
    x = (np.random.default_rng(1).standard_normal(16000 * 8) * 4000).astype(np.int16)
    write_wav(str(d / "in.wav"), x)
    return str(d / "target"), str(d / "draft"), str(d / "in.wav")


def _args(snaps, tmp_path, *extra):
    target, _, wav = snaps
    return ["transcribe", wav, "--model-dir", target, "--cache-dir", str(tmp_path / "cache"),
            "--greedy", "--max-tokens", "12", "--no-dtw", "--no-vad", "--quiet",
            "--vad-model", "__random__", *extra]


def _words(cues):
    return [(c["text"], c["start"], c["end"],
             [(w["text"], w["start"], w["end"]) for w in c.get("words") or []]) for c in cues]


def _probs(cues):
    return [w.get("probability") for c in cues for w in c.get("words") or []]


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
def test_transcribe_json_matches_jax_cli(snaps, tmp_path, capsys, monkeypatch, draft):
    """Both CLIs' Engines without the temperature-fallback ladder, whose
    sampling cannot match JAX's random bits (the CLI has no flag for it)."""
    import whisper_diarize_tpu.engine as jengine
    import whisper_diarize_tpu_torch.engine as pengine

    for mod in (jengine, pengine):
        monkeypatch.setattr(mod, "EngineConfig", functools.partial(
            mod.EngineConfig, temperature_fallback=False))
    extra = ("--draft-model-dir", snaps[1], "--spec-gamma", "3") if draft else ()
    assert jmain(_args(snaps, tmp_path / "j", *extra)) == 0
    ref = json.loads(capsys.readouterr().out)
    assert main(_args(snaps, tmp_path / "p", "--cpu", *extra)) == 0
    got = json.loads(capsys.readouterr().out)
    assert got and _words(got) == _words(ref)
    np.testing.assert_allclose(_probs(got), _probs(ref), rtol=0, atol=1e-4)


def test_transcribe_srt_to_file(snaps, tmp_path):
    out = tmp_path / "cues.srt"
    assert main(_args(snaps, tmp_path, "--cpu", "--srt", "-o", str(out))) == 0
    blocks = out.read_text().strip().split("\n\n")
    assert blocks and blocks[0].startswith("1\n00:00:")


def test_transcribe_without_cpu_asks_for_the_card(snaps, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(_args(snaps, tmp_path))


def test_mesh_reaches_the_engine_refusal(snaps, tmp_path):
    """`--mesh 1x2` in one process (no torchrun): the Engine refuses a mesh
    that is not the world."""
    with pytest.raises(ValueError, match="initialized process group of 2 ranks"):
        main(_args(snaps, tmp_path, "--cpu", "--mesh", "1x2"))


def test_mesh_1x1_writes_what_no_mesh_writes(snaps, tmp_path):
    """`--mesh 1x1` on the CPU (a one-rank gloo group the Engine makes):
    the same cues as without a mesh."""
    import torch.distributed as dist

    outs = []
    try:
        for i, extra in enumerate(((), ("--mesh", "1x1"))):
            out = tmp_path / f"out{i}.json"
            assert main(_args(snaps, tmp_path, "--cpu", "-o", str(out), *extra)) == 0
            outs.append(json.loads(out.read_text()))
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert outs[0] and outs[0] == outs[1]


def test_format_srt():
    cues = [Segment(0.0, 1.5, "Hello\nworld"), Segment(2.25, 3.0, "Bye", speaker_id="2")]
    blocks = _format_srt(cues).strip().split("\n\n")
    assert blocks[0] == "1\n00:00:00,000 --> 00:00:01,500\nHello\nworld"
    assert blocks[1] == "2\n00:00:02,250 --> 00:00:03,000\n[2] Bye"


def test_models_list_and_delete(tmp_path, capsys):
    assert main(["models", "list", "--cache-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out == ""
    assert main(["models", "delete", "nope", "--cache-dir", str(tmp_path)]) == 1


def test_no_bench_command(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["bench"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
