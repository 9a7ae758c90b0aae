"""The port's JAX-compatible random bits (`ops/prng.py::Threefry`) against
`jax.random`, and the port's sampled decoding (the temperature-fallback
ladder's `sample_best_of`) against the JAX package's on the same keys.

Tolerances: key words, split keys, random bits and uniforms equal exactly;
the Gumbel noise within 2e-6 relative (two f32 logarithms, whose last bit
may round otherwise in XLA and in PyTorch); sampled tokens equal, their
log-probabilities within 1e-4 (the logits agree to ~1e-6, far below the
gaps between Gumbel-perturbed maxima).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu.transcribe import TranscribeStep as JStep
from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.ops.prng import Threefry
from whisper_diarize_tpu_torch.transcribe import TranscribeStep as PStep

torch.set_num_threads(2)
TINY = np.finfo(np.float32).tiny


@pytest.mark.parametrize("seed", [0, 1, 5, 123456789])
@pytest.mark.parametrize("shape", [(7, 1001), (3,), (2, 5, 9)])
def test_bits_split_uniform_match_jax(seed, shape):
    key, port = jax.random.PRNGKey(seed), Threefry(seed)
    assert tuple(np.asarray(key).tolist()) == port.key
    for k, p in zip(jax.random.split(key), port.split()):
        assert tuple(np.asarray(k).tolist()) == p.key
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(port.bits(shape, "cpu").numpy().view(np.uint32), bits)
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32, minval=TINY, maxval=1.0))
    np.testing.assert_array_equal(port.uniform_tiny(shape, "cpu").numpy(), u)


@pytest.mark.parametrize("seed", [0, 3])
def test_gumbel_stream_matches_jax_steps(seed):
    """Three decode steps' noise: `key, sub = split(key)`, `gumbel(sub)`."""
    key, port = jax.random.PRNGKey(seed), Threefry(seed)
    for _ in range(3):
        key, sub = jax.random.split(key)
        ref = np.asarray(jax.random.gumbel(sub, (6, 513), jnp.float32))
        np.testing.assert_allclose(port.gumbel((6, 513), "cpu").numpy(), ref, rtol=2e-6, atol=2e-6)
        assert tuple(np.asarray(key).tolist()) == port.key


CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
TK = DebugTokenizer()
SP = TK.specials


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("snap")
    jweights.init_random_snapshot(d, cfg=CFG, seed=0)
    jp, jcfg = jweights.load_model(d)
    pp, pcfg = pweights.load_model(d, device="cpu")
    kw = dict(max_tokens=12, blank_id=32)
    js = JStep(jp, jcfg, TK, decode_config=jdec.DecodeConfig(**kw), strategy="greedy")
    ps = PStep(pp, pcfg, TK, decode_config=pdec.DecodeConfig(**kw), strategy="greedy")
    rng = np.random.default_rng(0)
    audio = np.zeros((2, 480000), np.float32)
    audio[:, :48000] = rng.standard_normal((2, 48000)).astype(np.float32) * 0.1
    return js, ps, js.encode(js.mel(audio)), ps.encode(ps.mel(audio))


@pytest.mark.parametrize("rung,temperature", [(1, 0.2), (3, 0.6), (5, 1.0)])
def test_sample_best_of_matches_jax(steps, rung, temperature):
    """A ladder rung: best_of 5 candidates a stream from the rung's key."""
    js, ps, jxa, pxa = steps
    jp, jlen, jsot, _ = js._build_prompt(2, "en", "transcribe")
    pp_, plen, psot, _ = ps._build_prompt(2, "en", "transcribe")
    ref = jdec.sample_best_of(
        js.params, js.cfg, jdec.DecodeConfig(max_tokens=12, blank_id=32,
                                             temperature=temperature),
        SP, jxa, jp, jlen, best_of=5, rng=jax.random.PRNGKey(rung),
        suppress_mask=js._suppress, sot_pos=jsot)
    got = pdec.sample_best_of(
        ps.params, ps.cfg, pdec.DecodeConfig(max_tokens=12, blank_id=32,
                                             temperature=temperature),
        SP, pxa, pp_, plen, best_of=5, generator=ps._generator(rung),
        suppress_mask=ps._suppress, sot_pos=psot)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.avg_logprob.numpy(), np.asarray(ref.avg_logprob), atol=1e-4)


def test_fallback_ladder_matches_jax(steps):
    """The whole ladder (t = 0, then rungs on `PRNGKey(rung)`) from both
    TranscribeSteps: the same tokens and final temperatures."""
    js, ps, jxa, pxa = steps
    ref, jtemps = js.decode_with_fallback(jxa, "en", "transcribe")
    got, ptemps = ps.decode_with_fallback(pxa, "en", "transcribe")
    np.testing.assert_array_equal(ptemps, jtemps)
    assert (ptemps > 0).any()  # random weights: the ladder climbed
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
