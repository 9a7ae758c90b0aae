"""The PyTorch port's model functions against the JAX package, on the CPU.

Same weights on both sides (the weight bridge, or one snapshot directory
loaded by both packages) and the same numpy inputs. Tolerances (f32):
weights exact; log-mel atol 1e-4 (matmul DFT summed in another order, then
log10); encode / decode_step logits / detect_language_logits /
alignment_cross_attn atol 1e-4; Silero probabilities atol 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu.models import silero_vad as jsilero
from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import mel as jmel

from whisper_diarize_tpu_torch.models import silero_vad as psilero
from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import mel as pmel

torch.set_num_threads(2)

CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
ATOL = 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _assert_same_weights(jax_tree, port_tree):
    """Port tensors equal the JAX leaves up to the conv layout change."""
    a, b = _flat(jax_tree), _flat(port_tree)
    assert a.keys() == b.keys()
    for key in a:
        ref = a[key].transpose(2, 1, 0) if key.endswith(("conv1_w", "conv2_w")) else a[key]
        np.testing.assert_array_equal(b[key], ref, err_msg=key)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("snap")
    jweights.init_random_snapshot(d, cfg=CFG, seed=0)
    jp, jcfg = jweights.load_model(d)
    pp, pcfg = pweights.load_model(d)
    return jp, jcfg, pp, pcfg


def test_weight_bridge_init_params():
    """init_params draws the JAX package's numpy values; the bridge only
    moves the conv stem to torch's [out, in, k]."""
    _assert_same_weights(jwm.init_params(CFG, seed=3), pwm.init_params(CFG, seed=3))
    assert pwm.param_shapes(CFG)["decoder"]["blocks"]["fc1_w"] == (2, 64, 256)
    shapes = {k: a.shape for k, a in _flat(jwm.init_params(CFG, seed=0)).items()}
    assert shapes == {k: tuple(s) for k, s in _flat(pwm.param_shapes(CFG)).items()}


def test_snapshot_loads_identically(snapshot):
    jp, jcfg, pp, pcfg = snapshot
    assert pcfg.__dict__ == jcfg.__dict__
    _assert_same_weights(jp, pp)


def test_init_params_fast_matches_jax():
    ref = jwm.init_params_fast(CFG, dtype=jnp.float32)
    got = pweights.init_params_fast(CFG, "cpu", torch.float32)
    _assert_same_weights(ref, got)


def test_hf_layout_conversion(tmp_path):
    """An HF-layout snapshot converts to the same tree in both packages."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    d, L, V = 64, 2, 51865
    ref_tree = jax.tree.map(np.asarray, jwm.init_params(CFG, seed=4))
    flat = {}
    for part, layers, pre in (("encoder", CFG.n_audio_layer, "model.encoder.layers.{i}."),
                              ("decoder", CFG.n_text_layer, "model.decoder.layers.{i}.")):
        for i in range(layers):
            p = pre.format(i=i)
            attns = [("self_attn", "")] + ([("encoder_attn", "c")] if part == "decoder" else [])
            lns = ["self_attn_layer_norm", "final_layer_norm"] + (
                ["encoder_attn_layer_norm"] if part == "decoder" else [])
            for mod, _ in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    flat[f"{p}{mod}.{proj}.weight"] = rng.standard_normal((d, d)).astype(np.float32)
                    if proj != "k_proj":
                        flat[f"{p}{mod}.{proj}.bias"] = rng.standard_normal(d).astype(np.float32)
            for ln in lns:
                flat[f"{p}{ln}.weight"] = rng.standard_normal(d).astype(np.float32)
                flat[f"{p}{ln}.bias"] = rng.standard_normal(d).astype(np.float32)
            flat[p + "fc1.weight"] = rng.standard_normal((4 * d, d)).astype(np.float32)
            flat[p + "fc1.bias"] = rng.standard_normal(4 * d).astype(np.float32)
            flat[p + "fc2.weight"] = rng.standard_normal((d, 4 * d)).astype(np.float32)
            flat[p + "fc2.bias"] = rng.standard_normal(d).astype(np.float32)
    for name, shape in (("model.encoder.conv1.weight", (d, 80, 3)),
                        ("model.encoder.conv2.weight", (d, d, 3)),
                        ("model.encoder.conv1.bias", (d,)), ("model.encoder.conv2.bias", (d,)),
                        ("model.encoder.embed_positions.weight", (1500, d)),
                        ("model.encoder.layer_norm.weight", (d,)),
                        ("model.encoder.layer_norm.bias", (d,)),
                        ("model.decoder.embed_tokens.weight", (V, d)),
                        ("model.decoder.embed_positions.weight", (448, d)),
                        ("model.decoder.layer_norm.weight", (d,)),
                        ("model.decoder.layer_norm.bias", (d,))):
        flat[name] = rng.standard_normal(shape).astype(np.float32)
    save_file(flat, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(dict(
        vocab_size=V, num_mel_bins=80, d_model=d, encoder_layers=L,
        decoder_layers=L, encoder_attention_heads=2, decoder_attention_heads=2,
        max_source_positions=1500, max_target_positions=448)))
    jp, _ = jweights.load_model(tmp_path)
    pp, _ = pweights.load_model(tmp_path)
    _assert_same_weights(jp, pp)
    assert _flat(pp).keys() == _flat(ref_tree).keys()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    rng = np.random.default_rng(n_mels)
    audio = np.zeros((2, 480000), np.float32)
    audio[:, :96000] = rng.standard_normal((2, 96000)).astype(np.float32) * 0.1
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels))
    got = pmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert got.shape == ref.shape == (2, n_mels, 3000)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.fixture(scope="module")
def encoded(snapshot):
    jp, jcfg, pp, pcfg = snapshot
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 80, 3000)).astype(np.float32)
    jxa = jwm.encode(jp, jnp.asarray(mel), jcfg)
    pxa = pwm.encode(pp, torch.from_numpy(mel), pcfg)
    return jxa, pxa


def test_encode_matches_jax(encoded):
    jxa, pxa = encoded
    assert pxa.shape == (2, 1500, 64)
    np.testing.assert_allclose(pxa.numpy(), np.asarray(jxa), atol=ATOL)


@pytest.mark.parametrize("row_pad", [None, (2, 0)])
def test_decode_step_matches_jax(snapshot, encoded, row_pad):
    """Prompt pass (S > 1: K1 plain) then two single-token steps (S = 1: K3
    plain), cache carried, against JAX's lax.scan path with the plain cross
    cache."""
    jp, jcfg, pp, pcfg = snapshot
    jxa, pxa = encoded
    sot = 50258
    prompt = np.array([[sot, sot, 50363, 50359, 50364],
                       [sot, 50361, 50363, 50359, 50364]], np.int64)
    rp_j = None if row_pad is None else jnp.asarray(row_pad, jnp.int32)
    rp_p = None if row_pad is None else torch.tensor(row_pad)
    jcache = jwm.init_self_cache(jcfg, 2, jnp.float32, 32)
    jcc = jwm.cross_kv(jp, jxa, jcfg)
    pcache = pwm.init_self_cache(pcfg, 2, torch.float32, "cpu", 32)
    pcc = pwm.cross_kv(pp, pxa, pcfg)
    jl, jcache = jwm.decode_step(jp, jcfg, jnp.asarray(prompt, jnp.int32), jnp.int32(0),
                                 jcache, jcc, row_pad=rp_j)
    pl = pwm.decode_step(pp, pcfg, torch.from_numpy(prompt), 0, pcache, pcc, row_pad=rp_p)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL)
    for pos, tok in ((5, 300), (6, 50370)):
        t = np.full((2, 1), tok, np.int64)
        jl, jcache = jwm.decode_step(jp, jcfg, jnp.asarray(t, jnp.int32), jnp.int32(pos),
                                     jcache, jcc, row_pad=rp_j)
        pl = pwm.decode_step(pp, pcfg, torch.from_numpy(t), pos, pcache, pcc, row_pad=rp_p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)


def test_detect_language_logits_matches_jax(snapshot, encoded):
    jp, jcfg, pp, pcfg = snapshot
    jxa, pxa = encoded
    ref = jwm.detect_language_logits(jp, jcfg, jxa, 50258)
    got = pwm.detect_language_logits(pp, pcfg, pxa, 50258)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_alignment_cross_attn_matches_jax(snapshot, encoded):
    jp, jcfg, pp, pcfg = snapshot
    jxa, pxa = encoded
    heads = jwm.alignment_heads_for("tiny", jcfg)
    assert heads == pwm.alignment_heads_for("tiny", pcfg)
    toks = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(np.int64)
    ref = jwm.alignment_cross_attn(jp, jcfg, jnp.asarray(toks, jnp.int32), jxa, heads)
    got = pwm.alignment_cross_attn(pp, pcfg, torch.from_numpy(toks), pxa, heads)
    assert got.shape == (2, len(heads), 12, 1500)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_silero_speech_probs_matches_jax():
    """Same numpy draws and the conv / LSTM bridge: equal probabilities."""
    jp = jsilero.init_params(seed=0)
    pp = psilero.init_params(seed=0)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 16000)) * 0.3).astype(np.float32)
    audio[1, 9000:] = 0.0
    ref = np.asarray(jsilero.speech_probs(jp, jnp.asarray(audio)))
    got = psilero.speech_probs(pp, torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (2, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5)
