"""The port's slice end to end: `Engine.transcribe_audio(use_gpu=False)` with
greedy decoding and DTW word timestamps against the JAX Engine on the same
snapshot, for the whole-file and the VAD branch, plus the Engine surface
the slice keeps (callbacks, resume journal, multi-stream batches, caches)
and the options it refuses.

The snapshot is the JAX package's random init with the token embedding
biased towards printable bytes (rows 33..126 scaled, unused ids zeroed), so
the byte-level DebugTokenizer decodes visible text and DTW has words to
place. Both engines use the host DTW DP (`WDT_HOST_DTW=1` on the JAX side)
and run without the temperature-fallback ladder, whose sampling cannot
match JAX's random bits; the ladder runs in `test_fallback_ladder_*`.
Tolerances: cue and word texts equal; cue and word times within one DTW
frame (0.02 s) plus the formatter's 3-decimal rounding.
"""

import numpy as np
import pytest
import torch

import jax

from whisper_diarize_tpu.audio import write_wav
from whisper_diarize_tpu.engine import Engine as JEngine
from whisper_diarize_tpu.engine import EngineConfig as JEngineConfig
from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu_torch.engine import Engine, EngineConfig
from whisper_diarize_tpu_torch.types import (
    AdvancedTranscribe, Callbacks, ProgressType, TranscribeOptions)

torch.set_num_threads(2)

CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
GREEDY = AdvancedTranscribe(sampling_strategy="greedy")
TOL = 0.02 + 1e-3


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("snap")
    p = jax.tree.map(np.asarray, jwm.init_params(CFG, seed=0))
    emb = p["decoder"]["tok_emb"].copy()
    emb[33:127] *= np.random.default_rng(0).uniform(2.0, 4.0, (94, 1)).astype(np.float32)
    emb[256:DebugTokenizer().specials.eot] = 0.0
    p["decoder"]["tok_emb"] = emb
    jweights.save_params(p, CFG, d)
    return str(d)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """40 s of noise with a 3 s gap: two seek-advanced 30 s windows."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(16000 * 40) * 4000).astype(np.int16)
    x[16000 * 12:16000 * 15] = 0
    p = tmp_path_factory.mktemp("audio") / "in.wav"
    write_wav(str(p), x)
    return str(p)


def _kw(snapshot, tmp_path, **over):
    kw = dict(cache_dir=str(tmp_path / "cache"), whisper_model_path=snapshot,
              enable_dtw=True, batch_size=2, max_decode_tokens=32,
              vad_model_path="__random__", temperature_fallback=False)
    kw.update(over)
    return kw


def _engine(snapshot, tmp_path, **over):
    return Engine(EngineConfig(use_gpu=False, **_kw(snapshot, tmp_path, **over)))


@pytest.fixture(scope="module")
def jax_engines(snapshot, tmp_path_factory):
    """One JAX Engine per config (each compiles once), built on demand."""
    cache = {}

    def get(**over):
        key = tuple(sorted(over.items()))
        if key not in cache:
            cache[key] = JEngine(JEngineConfig(
                **_kw(snapshot, tmp_path_factory.mktemp("jax"), **over)))
        return cache[key]

    return get


def _assert_cues_match(ref, got):
    assert [c.text for c in got] == [c.text for c in ref]
    assert got, "the slice produced no cues"
    for a, b in zip(ref, got):
        assert abs(a.start - b.start) <= TOL and abs(a.end - b.end) <= TOL
        aw, bw = a.words or [], b.words or []
        assert [w.text for w in aw] == [w.text for w in bw]
        for wa, wb in zip(aw, bw):
            assert abs(wa.start - wb.start) <= TOL and abs(wa.end - wb.end) <= TOL


@pytest.mark.parametrize("enable_vad,sequential", [(False, False), (True, False), (False, True)],
                         ids=["whole-file", "vad", "rolling-prompt"])
def test_slice_matches_jax_engine(snapshot, wav, jax_engines, tmp_path, monkeypatch,
                                  enable_vad, sequential):
    """`sequential_prompt` carries each window's text into the next window's
    prompt: per-row left-padded prompts (row_pad) through the whole path."""
    monkeypatch.setenv("WDT_HOST_DTW", "1")
    opts = TranscribeOptions(enable_vad=enable_vad, lang="en", advanced=GREEDY)
    ref = jax_engines(sequential_prompt=sequential).transcribe_audio(wav, opts)
    eng = _engine(snapshot, tmp_path, sequential_prompt=sequential)
    got = eng.transcribe_audio(wav, opts)
    _assert_cues_match(ref, got)
    assert eng.last_run["windows"] >= 2
    assert any(c.words for c in got)


def test_fallback_ladder_is_deterministic(snapshot, wav, tmp_path):
    """The full slice (fallback ladder on: random weights fail the logprob
    threshold, so every window climbs it with best_of = 5 candidates)
    gives the same cues twice and well-formed times."""
    opts = TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY)
    runs = [_engine(snapshot, tmp_path / str(i), temperature_fallback=True,
                    max_decode_tokens=12).transcribe_audio(wav, opts)
            for i in range(2)]
    assert [c.to_dict() for c in runs[0]] == [c.to_dict() for c in runs[1]]
    for c in runs[0]:
        assert 0.0 <= c.start and np.isfinite(c.end)


def test_callbacks_resume_and_caches(snapshot, wav, tmp_path):
    eng = _engine(snapshot, tmp_path, resume_dir=str(tmp_path / "resume"))
    events, segs = [], []
    cb = Callbacks(progress=lambda pct, kind, label: events.append((pct, kind)),
                   new_segment_callback=segs.append)
    opts = TranscribeOptions(enable_vad=False, lang="auto", advanced=GREEDY)
    first = eng.transcribe_audio(wav, opts, callbacks=cb)
    pcts = [p for p, k in events if k == ProgressType.TRANSCRIBE]
    assert pcts[-1] == 100 and pcts == sorted(pcts) and len(segs) == len(pcts)
    step = list(eng._step_cache.values())[0]
    # the second call replays every window from the journal: nothing decoded,
    # same cues, and the loaded model and step are reused
    again = eng.transcribe_audio(wav, opts)
    assert eng.last_run["windows"] == 0
    assert [c.to_dict() for c in again] == [c.to_dict() for c in first]
    assert list(eng._step_cache.values())[0] is step
    assert len(eng._whisper_cache) == 1
    assert eng.transcribe_audio(wav, opts, callbacks=Callbacks(is_cancelled=lambda: True)) == []


def test_batch_of_streams_matches_single(snapshot, wav, tmp_path):
    rng = np.random.default_rng(7)
    wav2 = str(tmp_path / "second.wav")
    write_wav(wav2, (rng.standard_normal(16000 * 5) * 5000).astype(np.int16))
    eng = _engine(snapshot, tmp_path)
    opts = TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY)
    both = eng.transcribe_audio_batch([wav, wav2], opts)
    assert [c.text for c in both[0]] == [c.text for c in eng.transcribe_audio(wav, opts)]
    assert [c.text for c in both[1]] == [c.text for c in eng.transcribe_audio(wav2, opts)]
    with pytest.raises(FileNotFoundError):
        eng.transcribe_audio("/nope/missing.wav", opts)


@pytest.mark.parametrize("case", ["diarize", "mesh", "draft", "spec_gamma", "ggml_file"])
def test_unported_options_raise(snapshot, wav, tmp_path, case):
    opts = TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY)
    if case in ("mesh", "draft", "spec_gamma"):
        over = {"mesh": dict(mesh_shape=(1, 1)), "draft": dict(draft_model_path=snapshot),
                "spec_gamma": dict(speculative_gamma=2)}[case]
        with pytest.raises(NotImplementedError):
            _engine(snapshot, tmp_path, **over)
        return
    eng = _engine(snapshot, tmp_path)
    if case == "diarize":
        opts = TranscribeOptions(enable_diarize=True, lang="en", advanced=GREEDY)
    else:
        ggml = tmp_path / "ggml-tiny.bin"
        ggml.write_bytes(b"lmgg" + b"\0" * 64)
        eng = _engine(str(ggml), tmp_path)
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.transcribe_audio(wav, opts)


@pytest.mark.parametrize("quantize", [False, True])
def test_quantize_kv_cache_is_accepted(snapshot, wav, tmp_path, quantize):
    """`quantize_kv_cache` selects the int8 decode path on the CPU as on the
    card; the int8 knobs of DecodeConfig are accepted."""
    from whisper_diarize_tpu_torch.ops.decode import DecodeConfig

    eng = _engine(snapshot, tmp_path, quantize_kv_cache=quantize, max_decode_tokens=4)
    eng.transcribe_audio(wav, TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY))
    (step,) = eng._step_cache.values()
    assert step.dc.quantize_cross_kv is quantize and not step.dc.quantize_tail_weights
    DecodeConfig(quantize_cross_kv=quantize, quantize_tail_weights=not quantize)


@pytest.mark.parametrize("knob", ["pallas_cross", "pallas_split", "pallas_tail",
                                  "unroll_layers", "enable_flash_attn"])
@pytest.mark.parametrize("value", [True, False])
def test_knobs_without_a_counterpart_are_refused(snapshot, tmp_path, knob, value):
    """The JAX package's kernel-selection knobs select nothing in the port:
    any value but the default raises instead of being ignored."""
    from whisper_diarize_tpu_torch.ops.decode import DecodeConfig

    if knob == "enable_flash_attn":
        if value:
            with pytest.raises(ValueError, match="enable_flash_attn"):
                _engine(snapshot, tmp_path, enable_flash_attn=True)
        else:
            _engine(snapshot, tmp_path, enable_flash_attn=False)
        return
    if value == DecodeConfig.__dataclass_fields__[knob].default:
        DecodeConfig(**{knob: value})
    else:
        with pytest.raises(ValueError, match=knob):
            DecodeConfig(**{knob: value})


def test_use_gpu_requires_cuda(snapshot, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(EngineConfig(**_kw(snapshot, tmp_path)))


def test_float32_is_refused_on_the_card(snapshot, wav, tmp_path):
    """The kernels take bf16 only: `dtype="float32"` with the card requested
    (use_gpu left at its default) is refused before any model loads, and
    before the CUDA check, so the CPU reaches it; on the CPU f32 runs."""
    with pytest.raises(NotImplementedError, match="f32 forms of the kernels"):
        Engine(EngineConfig(dtype="float32", **_kw(snapshot, tmp_path)))
    eng = _engine(snapshot, tmp_path, dtype="float32", max_decode_tokens=4)
    eng.transcribe_audio(wav, TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY))
    (params, _, _), = eng._whisper_cache.values()
    assert params["decoder"]["tok_emb"].dtype == torch.float32
    assert eng.last_run["windows"] >= 1


def test_refusals_name_roadmap_headings():
    """Every NotImplementedError of the Engine and of DecodeConfig names the
    ROADMAP item it waits for by a heading that exists ("ROADMAP Queue 1:
    <title>"), not by a number a re-anchor can make stale."""
    import ast
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    headings = set(re.findall(r"^\d+\. \*\*(.+?)\.?\*\*", (root / "ROADMAP.md").read_text(),
                              re.M))
    named = []
    for rel in ("whisper_diarize_tpu_torch/engine.py", "whisper_diarize_tpu_torch/ops/decode.py"):
        tree = ast.parse((root / rel).read_text())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", None) == "NotImplementedError"):
                continue
            text = "".join(c.value for c in ast.walk(node.exc)
                           if isinstance(c, ast.Constant) and isinstance(c.value, str))
            m = re.search(r"ROADMAP Queue 1: ([^)]+)\)", text)
            assert m, f"{rel}:{node.lineno}: names no ROADMAP item: {text!r}"
            assert m.group(1) in headings, f"{rel}:{node.lineno}: no heading {m.group(1)!r}"
            named.append(m.group(1))
    assert len(named) == 7 and "f32 forms of the kernels" in named
