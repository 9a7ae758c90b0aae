"""The port's checkpoint files against the JAX package on the CPU: GGML
files (`models/ggml.py`, f32, f16 and the five quantized block formats) and
OpenAI `.pt` files (`models/weights.py::load_openai_pt`).

- Files written by the JAX `write_ggml` load through the port into the
  params the JAX `load_ggml` gives, exactly in f32 (`params_from_jax` of
  the JAX tree); files the port writes load in JAX to the same tensors.
- A `.pt` file from `torch.save({"dims", "model_state_dict"})` gives the
  JAX `load_openai_pt`'s params exactly.
- An Engine pointed at a GGML file or a `.pt` file gives the JAX Engine's
  cues (texts equal, times within one DTW frame plus rounding, as in
  `tests/test_torch_engine.py`).
"""

import struct

import numpy as np
import pytest
import torch

import jax

from whisper_diarize_tpu.audio import write_wav
from whisper_diarize_tpu.engine import Engine as JEngine
from whisper_diarize_tpu.engine import EngineConfig as JEngineConfig
from whisper_diarize_tpu.models import ggml as jggml
from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.tokenizer import DebugTokenizer

from whisper_diarize_tpu_torch.engine import Engine, EngineConfig
from whisper_diarize_tpu_torch.models import ggml as pggml
from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.types import AdvancedTranscribe, TranscribeOptions

torch.set_num_threads(2)

CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
FORMATS = ["f32", "f16", "q4_0", "q4_1", "q5_0", "q5_1", "q8_0"]
VOCAB = [bytes([i]) for i in range(256)]  # byte-level, as DebugTokenizer
TOL = 0.02 + 1e-3

def _openai_sd(tree):
    """A JAX-layout tree under the OpenAI names (`weights.openai_state_dict`
    of the port's params), what `.pt` and GGML files hold."""
    return pweights.openai_state_dict(
        pweights.params_from_jax(jax.tree.map(np.asarray, tree), "cpu", torch.float32))


def _hparams(cfg):
    return {k: getattr(cfg, k) for k in (
        "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
        "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer", "n_mels")}


@pytest.fixture(scope="module")
def tree():
    """The JAX package's random init, the token embedding biased towards
    printable bytes (as `tests/test_torch_engine.py`), so the byte-level
    vocabulary decodes visible text."""
    p = jax.tree.map(np.asarray, jwm.init_params(CFG, seed=0))
    emb = p["decoder"]["tok_emb"].copy()
    emb[33:127] *= np.random.default_rng(0).uniform(2.0, 4.0, (94, 1)).astype(np.float32)
    emb[256:DebugTokenizer().specials.eot] = 0.0
    p["decoder"]["tok_emb"] = emb
    return p


@pytest.fixture(scope="module")
def files(tree, tmp_path_factory):
    """A GGML file in every format (the JAX `write_ggml`) and a `.pt` file."""
    d = tmp_path_factory.mktemp("ckpt")
    sd = _openai_sd(tree)
    out = {}
    for fmt in FORMATS:
        out[fmt] = str(d / f"ggml-{fmt}.bin")
        jggml.write_ggml(out[fmt], sd, _hparams(CFG), np.zeros((80, 201), np.float32), VOCAB,
                         use_f16=fmt == "f16", quantize=None if fmt in ("f32", "f16") else fmt)
    out["pt"] = str(d / "tiny.pt")
    torch.save({"dims": _hparams(CFG),
                "model_state_dict": {k: torch.tensor(v) for k, v in sd.items()}}, out["pt"])
    return out


def _assert_params_equal(got, want_tree):
    want = pweights.params_from_jax(jax.tree.map(np.asarray, want_tree), "cpu", torch.float32)
    flat_g, flat_w = pweights._flatten(got), pweights._flatten(want)
    assert sorted(flat_g) == sorted(flat_w)
    for key in flat_w:
        assert flat_g[key].dtype == torch.float32, key
        np.testing.assert_array_equal(flat_g[key].numpy(), flat_w[key].numpy(), err_msg=key)


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_written_ggml_loads_like_jax(files, fmt):
    params, cfg, vocab = pggml.load_ggml(files[fmt], device="cpu")
    jparams, jcfg, jvocab = jggml.load_ggml(files[fmt])
    assert vars(cfg) == vars(jcfg)
    assert vocab == jvocab == VOCAB
    _assert_params_equal(params, jparams)


@pytest.mark.parametrize("fmt", ["f32", "f16", "q5_0", "q8_0"])
def test_port_written_ggml_loads_in_jax(tree, tmp_path, fmt):
    sd = _openai_sd(tree)
    path = tmp_path / "ggml-port.bin"
    pggml.write_ggml(path, sd, _hparams(CFG), np.zeros((80, 201), np.float32), VOCAB,
                     use_f16=fmt == "f16", quantize=None if fmt in ("f32", "f16") else fmt)
    jt, jhp, _, jvocab = jggml.read_ggml(path)
    pt, php, _, pvocab = pggml.read_ggml(path)
    assert jhp == php and jvocab == pvocab == VOCAB and sorted(jt) == sorted(pt)
    for name in jt:
        np.testing.assert_array_equal(pt[name], jt[name], err_msg=name)
    _assert_params_equal(pggml.load_ggml(path, device="cpu")[0], jggml.load_ggml(path)[0])


def test_unsupported_tensor_type(tmp_path):
    """A K-quant (or any unknown) tensor type fails loudly, naming it."""
    name = b"decoder.ln.weight"
    path = tmp_path / "bad.bin"
    pggml.write_ggml(path, {name.decode(): np.ones(64, np.float32)}, _hparams(CFG),
                     np.zeros((80, 201), np.float32), [b"a"], use_f16=False)
    blob = bytearray(path.read_bytes())
    off = len(blob) - (12 + 4 + len(name) + 64 * 4)
    assert struct.unpack_from("<3i", blob, off) == (1, len(name), 0)
    struct.pack_into("<i", blob, off + 8, 12)  # GGML_TYPE_Q4_K
    path.write_bytes(bytes(blob))
    with pytest.raises(pggml.GGMLFormatError, match="type 12"):
        pggml.read_ggml(path)
    with pytest.raises(ValueError, match="unknown quantize type"):
        pggml.write_ggml(tmp_path / "x.bin", {}, _hparams(CFG), np.zeros((80, 201)), [],
                         quantize="q3_k")


def test_openai_state_dict_round_trips(tree):
    """`convert_openai_params` inverts `openai_state_dict`, and the names
    are the JAX package's (`convert_openai_params` of the JAX package reads
    them back to the same tree)."""
    sd = _openai_sd(tree)
    back = pweights.convert_openai_params(sd, CFG)
    _assert_params_equal(pweights.params_from_jax(back, "cpu", torch.float32), tree)
    _assert_params_equal(pweights.params_from_jax(
        jax.tree.map(np.asarray, jweights.convert_openai_params(sd, CFG)), "cpu",
        torch.float32), tree)


def test_openai_pt_loads_like_jax(files):
    params, cfg = pweights.load_openai_pt(files["pt"], device="cpu")
    jparams, jcfg = jweights.load_openai_pt(files["pt"])
    assert vars(cfg) == vars(jcfg)
    _assert_params_equal(params, jparams)
    half = pweights.load_openai_pt(files["pt"], device="cpu", dtype=torch.bfloat16)[0]
    assert half["decoder"]["tok_emb"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    x = (np.random.default_rng(1).standard_normal(16000 * 12) * 4000).astype(np.int16)
    p = tmp_path_factory.mktemp("audio") / "in.wav"
    write_wav(str(p), x)
    return str(p)


@pytest.mark.parametrize("kind", ["q5_0", "pt"])
def test_engine_on_a_checkpoint_file_matches_jax(files, wav, tmp_path, monkeypatch, kind):
    """The Engine's file branch: a GGML file (its embedded vocabulary builds
    a VocabTokenizer) or a `.pt` file (the byte-level tokenizer), greedy
    with DTW word timestamps, against the JAX Engine on the same file."""
    monkeypatch.setenv("WDT_HOST_DTW", "1")
    kw = dict(whisper_model_path=files[kind], enable_dtw=True, batch_size=1,
              max_decode_tokens=24, vad_model_path="__random__", temperature_fallback=False)
    opts = TranscribeOptions(enable_vad=False, lang="en",
                             advanced=AdvancedTranscribe(sampling_strategy="greedy"))
    ref = JEngine(JEngineConfig(cache_dir=str(tmp_path / "j"), **kw)).transcribe_audio(wav, opts)
    eng = Engine(EngineConfig(use_gpu=False, cache_dir=str(tmp_path / "p"), **kw))
    got = eng.transcribe_audio(wav, opts)
    (_, _, tk), = eng._whisper_cache.values()
    assert type(tk).__name__ == ("VocabTokenizer" if kind != "pt" else "DebugTokenizer")
    assert got and [c.text for c in got] == [c.text for c in ref]
    for a, b in zip(ref, got):
        assert abs(a.start - b.start) <= TOL and abs(a.end - b.end) <= TOL
        assert [w.text for w in a.words or []] == [w.text for w in b.words or []]
