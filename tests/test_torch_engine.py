"""The port's slice end to end: `Engine.transcribe_audio(use_gpu=False)` with
greedy decoding and DTW word timestamps against the JAX Engine on the same
snapshot, for the whole-file, the VAD and the diarization branch, plus the
Engine surface
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

import dataclasses

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


def _recording_manager(base, sims_log):
    """`base` (an EmbeddingManager class) logging, at every decision, the
    similarities of the embedding to each speaker, best first."""
    from whisper_diarize_tpu.diarize import cosine_similarity

    class Recording(base):
        def _best(self, embedding):
            sims_log.append(sorted((cosine_similarity(embedding, sp.centroid)
                                    for sp in self.speakers.values()), reverse=True))
            return super()._best(embedding)

    return Recording


THRESHOLD = 0.97


def test_diarized_slice_matches_jax_engine(snapshot, jax_engines, tmp_path, monkeypatch):
    """`enable_diarize=True` (greedy, lang "en", max_speakers 2, threshold
    THRESHOLD, the "__random__" segmentation and CAM++ weights of seed 0 in
    both packages) on 10 s of noise and 10 s of a tone (two full
    segmentation windows): the same cues (start, end, text) and the same
    speaker ids as the JAX Engine, both speakers among them. Preconditions on
    the JAX side, from the same run: every frame's top-2 log-prob gap
    exceeds twice the largest log-prob difference between the packages (at
    random weights many frames nearly tie, so no fixed gap holds,
    `tests/test_torch_diarize.py`), and every speaker decision clears the
    threshold and the runner-up by more than 1e-3."""
    from whisper_diarize_tpu import diarize as jdz
    from whisper_diarize_tpu.models import segmentation as jseg
    from whisper_diarize_tpu_torch import diarize as tdz
    from whisper_diarize_tpu_torch.models import segmentation as tseg

    monkeypatch.setenv("WDT_HOST_DTW", "1")
    rng = np.random.default_rng(3)
    t = np.arange(16000 * 10) / 16000.0
    wav20 = str(tmp_path / "twenty.wav")
    write_wav(wav20, np.concatenate([  # two "speakers": noise, then a tone
        rng.standard_normal(t.size) * 4000,
        np.sin(2 * np.pi * 1000.0 * t) * 9000 + rng.standard_normal(t.size) * 300,
    ]).astype(np.int16))
    lps, sims = {"jax": [], "port": []}, []
    for key, mod in (("jax", jseg), ("port", tseg)):
        def forward(params, audio, *a, _inner=mod.forward, _sink=lps[key], **kw):
            out = _inner(params, audio, *a, **kw)
            _sink.append(np.asarray(out))
            return out

        monkeypatch.setattr(mod, "forward", forward)
    monkeypatch.setattr(jdz, "EmbeddingManager", _recording_manager(jdz.EmbeddingManager, sims))
    over = dict(diarize_segment_model_path="__random__",
                diarize_embedding_model_path="__random__")
    # random CAM++ weights put noise much nearer noise than a tone in cosine;
    # THRESHOLD lies between the two
    opts = TranscribeOptions(enable_diarize=True, lang="en", max_speakers=2,
                             advanced=AdvancedTranscribe(sampling_strategy="greedy",
                                                         diarize_threshold=THRESHOLD))
    ref = jax_engines(**over).transcribe_audio(wav20, opts)
    eng = _engine(snapshot, tmp_path, **over)
    got = eng.transcribe_audio(wav20, opts)

    (jlp,), (tlp,) = lps["jax"], lps["port"]
    err = float(np.abs(jlp - tlp).max())
    top2 = np.sort(jlp, axis=-1)[..., -2:]
    assert err < 1e-4 and (top2[..., 1] - top2[..., 0]).min() > 2 * err, \
        "precondition: a segmentation near-tie could flip the powerset argmax"
    assert sims, "no speaker decision was made"
    for s in sims:
        assert not s or abs(s[0] - THRESHOLD) > 1e-3, f"precondition: similarity {s[0]} at the threshold"
        assert len(s) < 2 or s[0] - s[1] > 1e-3, f"precondition: speakers tie at {s[:2]}"
    _assert_cues_match(ref, got)
    assert [c.speaker_id for c in got] == [c.speaker_id for c in ref]
    assert all(isinstance(c.speaker_id, str) for c in got)
    assert {c.speaker_id for c in got} == {"1", "2"}
    assert eng.last_run["windows"] >= 2 and eng.last_run["stage_s"]["segment"] > 0
    assert tdz.EmbeddingManager is not jdz.EmbeddingManager


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


@pytest.mark.parametrize("case", ["mesh"])
def test_unported_options_raise(snapshot, wav, tmp_path, case):
    """A mesh of two ranks in a process with no process group (the world
    is one process) is refused at construction, before any work."""
    over = {"mesh": dict(mesh_shape=(1, 2))}[case]
    with pytest.raises(ValueError, match="initialized process group of 2 ranks"):
        _engine(snapshot, tmp_path, **over)


DRAFT_CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
    n_text_ctx=448, n_text_state=32, n_text_head=2, n_text_layer=1,
)


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    """A smaller random snapshot sharing the target's vocabulary."""
    d = tmp_path_factory.mktemp("draft")
    jweights.init_random_snapshot(d, cfg=DRAFT_CFG, seed=7)
    return str(d)


def test_draft_matches_jax_engine_and_plain(snapshot, draft, wav, jax_engines, tmp_path,
                                            monkeypatch):
    """`draft_model_path` runs every greedy window through speculative
    decoding and changes no cue: the port's cues equal the JAX Engine's with
    the same draft and the port's own without it."""
    from whisper_diarize_tpu_torch.ops import speculative

    monkeypatch.setenv("WDT_HOST_DTW", "1")
    opts = TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY)
    ref = jax_engines(draft_model_path=draft).transcribe_audio(wav, opts)
    calls = []
    real = speculative.speculative_greedy_run
    monkeypatch.setattr(speculative, "speculative_greedy_run",
                        lambda *a, **k: calls.append(k["gamma"]) or real(*a, **k))
    eng = _engine(snapshot, tmp_path, draft_model_path=draft)
    got = eng.transcribe_audio(wav, opts)
    assert len(calls) == eng.last_run["windows"] >= 2 and set(calls) == {4}
    _assert_cues_match(ref, got)
    # the same tokens: the same texts and times; word probabilities come
    # from the verify pass, whose sums run in another order (1e-4)
    plain = _engine(snapshot, tmp_path).transcribe_audio(wav, opts)
    assert [(c.text, c.start, c.end) for c in got] == [(c.text, c.start, c.end) for c in plain]
    for a, b in zip(got, plain):
        assert [(w.text, w.start, w.end) for w in a.words] == [
            (w.text, w.start, w.end) for w in b.words]
        np.testing.assert_allclose([w.probability for w in a.words],
                                   [w.probability for w in b.words], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", ["beam", "temperature"])
def test_draft_ignored_with_a_warning(snapshot, draft, wav, tmp_path, caplog, case):
    """Beam search or a sampling temperature ignore the draft, with a
    warning, as the JAX Engine does."""
    adv = (None if case == "beam" else
           AdvancedTranscribe(sampling_strategy="greedy", temperature=0.4))
    eng = _engine(snapshot, tmp_path, draft_model_path=draft, max_decode_tokens=4)
    with caplog.at_level("WARNING", logger="whisper_diarize_tpu_torch.engine"):
        eng.transcribe_audio(wav, TranscribeOptions(enable_vad=False, lang="en", advanced=adv))
    assert "ignoring" in caplog.text
    (step,) = eng._step_cache.values()
    assert step.draft is None


def test_draft_vocab_mismatch_disables_speculation(snapshot, wav, tmp_path, caplog):
    d = tmp_path / "draft_en"
    jweights.init_random_snapshot(d, cfg=dataclasses.replace(
        DRAFT_CFG, n_vocab=51864, multilingual=False), seed=8)
    eng = _engine(snapshot, tmp_path, draft_model_path=str(d), max_decode_tokens=4)
    with caplog.at_level("WARNING", logger="whisper_diarize_tpu_torch.engine"):
        eng.transcribe_audio(wav, TranscribeOptions(enable_vad=False, lang="en",
                                                    advanced=GREEDY))
    assert "speculative decoding disabled" in caplog.text
    (step,) = eng._step_cache.values()
    assert step.draft is None and eng.last_run["windows"] >= 1


def test_speculative_gamma_is_accepted(snapshot, draft, wav, tmp_path):
    """`speculative_gamma` reaches the step (and its cache key), the draft
    is loaded once per path."""
    eng = _engine(snapshot, tmp_path, draft_model_path=draft, speculative_gamma=2,
                  max_decode_tokens=6)
    opts = TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY)
    eng.transcribe_audio(wav, opts)
    (step,) = eng._step_cache.values()
    assert step.spec_gamma == 2 and step.draft is not None
    loaded = eng._draft_cache
    eng.cfg.speculative_gamma = 3
    eng.transcribe_audio(wav, opts)
    assert sorted(s.spec_gamma for s in eng._step_cache.values()) == [2, 3]
    assert eng._draft_cache is loaded


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
def test_knobs_without_a_counterpart_are_refused(snapshot, wav, tmp_path, knob, value,
                                                caplog):
    """The JAX package's kernel-selection knobs select nothing in the port:
    any value but the default raises instead of being ignored. The
    exception is the Engine's `enable_flash_attn`, which the JAX Engine
    accepts with a warning and ignores: so does the port, with the same
    result as without it."""
    from whisper_diarize_tpu_torch.ops.decode import DecodeConfig

    if knob == "enable_flash_attn":
        opts = TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY)
        with caplog.at_level("WARNING", logger="whisper_diarize_tpu_torch.engine"):
            eng = _engine(snapshot, tmp_path, enable_flash_attn=value, max_decode_tokens=4)
        warned = [r for r in caplog.records if "enable_flash_attn" in r.getMessage()]
        assert len(warned) == int(value)
        if value:
            plain = _engine(snapshot, tmp_path, max_decode_tokens=4)
            assert ([c.text for c in eng.transcribe_audio(wav, opts)]
                    == [c.text for c in plain.transcribe_audio(wav, opts)])
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


def test_float32_is_accepted_for_the_card(snapshot, wav, tmp_path):
    """The kernels have f32 forms: `dtype="float32"` with the card requested
    (use_gpu left at its default) is no longer refused, so without a card it
    reaches the CUDA check; on the CPU f32 runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(EngineConfig(dtype="float32", **_kw(snapshot, tmp_path)))
    eng = _engine(snapshot, tmp_path, dtype="float32", max_decode_tokens=4)
    eng.transcribe_audio(wav, TranscribeOptions(enable_vad=False, lang="en", advanced=GREEDY))
    (params, _, _), = eng._whisper_cache.values()
    assert params["decoder"]["tok_emb"].dtype == torch.float32
    assert eng.last_run["windows"] >= 1


@pytest.mark.parametrize("path,seed", [("__random__:tiny", None), ("__random__:tiny:3", 3)])
def test_random_weights_path(tmp_path, path, seed):
    """"__random__:<preset>" loads the benchmark's pattern weights and
    "__random__:<preset>:<seed>" draws of the JAX init's distribution from
    that seed, both at the preset's geometry."""
    from whisper_diarize_tpu_torch.models import weights
    from whisper_diarize_tpu_torch.models import whisper as wm

    eng = Engine(EngineConfig(use_gpu=False, cache_dir=str(tmp_path), whisper_model_path=path))
    params, cfg, _ = eng._load_whisper(TranscribeOptions(), None, None)
    assert cfg == wm.PRESETS["tiny"]
    want = (weights.init_params_fast(cfg, torch.device("cpu"), torch.float32) if seed is None
            else weights.init_params_normal(cfg, torch.device("cpu"), torch.float32, seed))
    for name in ("tok_emb", "pos_emb"):
        torch.testing.assert_close(params["decoder"][name], want["decoder"][name],
                                   rtol=0, atol=0)


def test_refusals_name_roadmap_headings(tmp_path):
    """The Engine and DecodeConfig construct with a mesh (a 1 x 1 mesh makes
    its own one-rank gloo group on the CPU), and any NotImplementedError
    left in either names the ROADMAP item it waits for by a heading that
    exists ("ROADMAP Queue 1: <title>"), not by a number a re-anchor can make
    stale."""
    import ast
    import re
    from pathlib import Path

    import torch.distributed as dist

    from whisper_diarize_tpu_torch.ops.decode import DecodeConfig
    from whisper_diarize_tpu_torch.parallel.mesh import Mesh

    assert DecodeConfig(mesh=Mesh(2, 2, 1, 0)).mesh.shape == {"data": 2, "model": 2}
    assert not dist.is_initialized()
    try:
        eng = Engine(EngineConfig(use_gpu=False, cache_dir=str(tmp_path), mesh_shape=(1, 1)))
        assert eng.mesh.shape == {"data": 1, "model": 1} and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

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
    # the mesh refusals are gone: nothing of either waits on a ROADMAP item
    assert named == []
