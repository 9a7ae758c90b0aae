"""The port's int8 decode path against the JAX package on the CPU (f32, same
numpy inputs and weights on both sides): the int8 cross cache and K5
(`ops/attn.py::quantize_cross_kv`, `cross_attn_layer_q8`), the int8 tail
weights and K6 (`ops/tail.py::quantize_tail_weights`, `fused_tail_layer`),
the decode loops and the Engine over them. The JAX side runs its Pallas
kernels in interpret mode, as the JAX package's own tests do; its
lane-tiled cache is un-tiled to the port's [L, B, H, Ta, Dh].

Tolerances:
- quantizers: exact (payloads and scales);
- K5 against the Pallas kernel, and K6 with int8 weights over the f32
  cache: atol 1e-5, rtol 1e-4 (K1's and K3's; sums in another order);
- K6 over the int8 cache against JAX's K5 path (its XLA tail with the
  cross attention on `cross_attn_layer_q8`, what the JAX package runs under
  `quantize_cross_kv` alone): atol 1e-5, rtol 1e-4;
- K6 over the int8 cache against JAX's fused tail (`kvq`): atol 2e-3 on a
  hidden state of magnitude ~2. The fused tail rounds q * Dh^-0.5 and
  p * vs to the activation dtype, f32 here, where `_flash_kernel_q8` and
  the port round them to bf16 whatever the dtype (2^-9 relative);
- the slice: greedy tokens equal up to the first step whose top-2 margin
  (of the port's logits, teacher-forced on the JAX tokens) is under 1e-3;
  token probabilities there within 2e-3 against the fused JAX tail, 1e-4
  where both sides run K5's numerics (beam search).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.ops import pallas_tail
from whisper_diarize_tpu.ops.pallas_attn import (
    cross_attn_layer_q8 as jax_cross_attn_q8, tile_cross_kv, tile_quantize_cross_kv)
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu.transcribe import TranscribeStep as JStep

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import attn, tail
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.transcribe import TranscribeStep as PStep
from whisper_diarize_tpu_torch.types import AdvancedTranscribe, TranscribeOptions

from tests.test_torch_engine import _engine, snapshot, wav  # noqa: F401  (fixtures)
from tests.test_torch_kernels import GEOMETRIES, TA, _cfg, _t, _untile
from tests.test_whisper_model import TINY_TEST_CFG

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
KVQ_FUSED_ATOL = 2e-3
TK = DebugTokenizer()
SP = TK.specials


def _untile_scales(s, ta):
    """JAX [L, B, NT, H, TT] -> [L, B, H, Ta]."""
    s = np.asarray(s)
    L, B, NT, H, TT = s.shape
    return s.transpose(0, 1, 3, 2, 4).reshape(L, B, H, NT * TT)[:, :, :, :ta]


def _kv(rng, L, B, H, Dh):
    return [rng.standard_normal((L, B, H, TA, Dh)).astype(np.float32) for _ in range(2)]


# --------------------------------------------------------------------------
# quantizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_cross_kv_matches_jax_exactly(dtype):
    rng = np.random.default_rng(0)
    k, v = _kv(rng, 2, 2, 3, 32)
    jt = getattr(jnp, dtype)
    k8, ks, v8, vs = tile_quantize_cross_kv(jnp.asarray(k, jt), jnp.asarray(v, jt))
    got = attn.quantize_cross_kv(_t(k).to(getattr(torch, dtype)),
                                 _t(v).to(getattr(torch, dtype)))
    for g, r in zip(got, (_untile(k8, TA), _untile_scales(ks, TA),
                          _untile(v8, TA), _untile_scales(vs, TA))):
        np.testing.assert_array_equal(g.numpy(), r)
    # the JAX package's plain (untiled) quantizer gives the same bytes
    plain = jwm.quantize_cross_kv({"k": jnp.asarray(k, jt), "v": jnp.asarray(v, jt)})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(plain["k_q"]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(plain["v_s"])[..., 0])


@pytest.mark.parametrize("D,H", GEOMETRIES)
def test_quantize_tail_weights_matches_jax_pack_exactly(D, H):
    cfg = _cfg(D, H)
    qpack = pallas_tail.pack_tail_weights(jwm.init_params(cfg, seed=2), cfg, quantize=True)
    blocks = pwm.init_params(cfg, seed=2)["decoder"]["blocks"]
    got = tail.quantize_tail_weights(blocks)
    carried = pweights.tail_q8_from_jax({key: np.asarray(a) for key, a in qpack.items()})
    assert set(got) == set(carried)
    for key in got:
        assert got[key].dtype == carried[key].dtype, key
        torch.testing.assert_close(got[key], carried[key], rtol=0, atol=0, msg=key)
    assert got["fc2_w"].dtype == torch.int8 and tuple(got["fc2_ws"].shape) == (2, 4 * D)
    assert tuple(got["fc1_ws"].shape) == (2, 4 * D) and tuple(got["o_ws"].shape) == (2, D)


# --------------------------------------------------------------------------
# K5
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D,H", GEOMETRIES)
@pytest.mark.parametrize("Q,ta_total", [(1, TA), (7, TA), (3, 1100)])
def test_k5_cross_attn_q8_matches_pallas(D, H, Q, ta_total):
    Dh, L, B = D // H, 2, 2
    rng = np.random.default_rng(Q)
    k, v = _kv(rng, L, B, H, Dh)
    q = rng.standard_normal((B, Q, H, Dh)).astype(np.float32)
    k8, ks, v8, vs = tile_quantize_cross_kv(jnp.asarray(k), jnp.asarray(v))
    pq = attn.quantize_cross_kv(_t(k), _t(v))
    for layer in range(L):
        ref = jax_cross_attn_q8(layer, jnp.asarray(q), k8, ks, v8, vs,
                                ta_total=ta_total, interpret=True)
        got = attn.cross_attn_layer_q8(layer, _t(q), *pq, ta_total)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------------
# K6
# --------------------------------------------------------------------------

def _tail_inputs(D, H, beams):
    cfg = _cfg(D, H)
    params = jwm.init_params(cfg, seed=2)
    Dh, L, B = D // H, cfg.n_text_layer, 2
    N = B * beams
    rng = np.random.default_rng(beams)
    x = rng.standard_normal((N, 1, D)).astype(np.float32)
    so = (rng.standard_normal((N, H, 1, Dh)) * 0.3).astype(np.float32)
    k, v = _kv(rng, L, B, H, Dh)
    return cfg, params, x, so, k, v


@pytest.mark.parametrize("D,H", GEOMETRIES)
@pytest.mark.parametrize("beams", [1, 3])
@pytest.mark.parametrize("form", ["wq", "kvq", "wq+kvq"])
def test_k6_fused_tail_int8_matches_pallas(D, H, beams, form):
    cfg, params, x, so, k, v = _tail_inputs(D, H, beams)
    wq, kvq = "wq" in form, "kvq" in form
    fpack = pallas_tail.pack_tail_weights(params, cfg)
    qpack = pallas_tail.pack_tail_weights(params, cfg, quantize=True)
    if kvq:
        jk, jks, jv, jvs = tile_quantize_cross_kv(jnp.asarray(k), jnp.asarray(v))
        pk, pks, pv, pvs = attn.quantize_cross_kv(_t(k), _t(v))
    else:
        (jk, jv), jks, jvs = tile_cross_kv(jnp.asarray(k), jnp.asarray(v)), None, None
        pk, pks, pv, pvs = _t(k), None, _t(v), None
    blocks = pwm.init_params(cfg, seed=2)["decoder"]["blocks"]
    if wq:
        blocks = tail.quantize_tail_weights(blocks)
    for layer in range(cfg.n_text_layer):
        ref = pallas_tail.fused_tail_layer(
            jnp.int32(layer), jnp.asarray(x), jnp.asarray(so),
            qpack["w8"] if wq else fpack["w"], fpack["b"], jk, jv,
            tail_ws=qpack["ws"] if wq else None, ks=jks, vs=jvs,
            beams=beams, ta_total=TA, interpret=True)
        got = tail.fused_tail_layer(layer, _t(x), _t(so), blocks, pk, pv, beams, TA,
                                    pks, pvs)
        if kvq:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=KVQ_FUSED_ATOL, rtol=0)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D,H", GEOMETRIES)
@pytest.mark.parametrize("beams", [1, 3])
def test_k6_over_int8_cache_matches_jax_k5_path(D, H, beams):
    """The K6 `kvq` form against the tail the JAX package runs under
    `quantize_cross_kv` alone: its XLA layer tail with the cross attention
    on the int8 Pallas kernel (K5)."""
    cfg, params, x, so, k, v = _tail_inputs(D, H, beams)
    k8, ks, v8, vs = tile_quantize_cross_kv(jnp.asarray(k), jnp.asarray(v))
    cross_fn, _, _ = jwm._cross_attend_factory(
        cfg, {"k8": k8, "ks": ks, "v8": v8, "vs": vs}, beams, jnp.float32, 1)
    blocks = pwm.init_params(cfg, seed=2)["decoder"]["blocks"]
    pq = attn.quantize_cross_kv(_t(k), _t(v))
    jblk = params["decoder"]["blocks"]
    for layer in range(cfg.n_text_layer):
        blk = {key: a[layer] for key, a in jblk.items()}
        ref = jwm._decoder_layer_tail(jnp.asarray(x), blk, jnp.asarray(so), cross_fn,
                                      None, None, jnp.int32(layer), cfg.n_text_head)
        got = tail.fused_tail_layer(layer, _t(x), _t(so), blocks, pq[0], pq[2], beams, TA,
                                    pq[1], pq[3])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_int8_wrappers_plain_only_on_cpu():
    """CPU tensors take the plain versions and count no launch; a tensor on
    any other device never reaches them; int8 payloads come with scales."""
    rng = np.random.default_rng(3)
    L, B, H, D = 2, 2, 2, 128
    k, v = (_t(rng.standard_normal((L, B, H, 40, 64))) for _ in range(2))
    q = _t(rng.standard_normal((B, 3, H, 64)))
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    before = (attn.cross_attn_layer_q8.launches, tail.fused_tail_layer.launches,
              tail.fused_tail_layer.launches_int8)
    torch.testing.assert_close(attn.cross_attn_layer_q8(1, q, k8, ks, v8, vs),
                               attn.cross_attn_layer_q8_plain(1, q, k8, ks, v8, vs),
                               rtol=0, atol=0)
    g = torch.Generator().manual_seed(0)
    blocks = tail.quantize_tail_weights(ag.random_blocks(L, D, g, "cpu", torch.float32))
    x = _t(rng.standard_normal((B, 1, D)))
    so = _t(rng.standard_normal((B, H, 1, 64)))
    torch.testing.assert_close(
        tail.fused_tail_layer(0, x, so, blocks, k8, v8, 1, 40, ks, vs),
        tail.fused_tail_layer_plain(0, x, so, blocks, k8, v8, 1, 40, ks, vs), rtol=0, atol=0)
    assert (attn.cross_attn_layer_q8.launches, tail.fused_tail_layer.launches,
            tail.fused_tail_layer.launches_int8) == before
    with pytest.raises(RuntimeError, match="no kernel"):
        attn.cross_attn_layer_q8(0, *[t.to("meta") for t in (q, k8, ks, v8, vs)])
    with pytest.raises(ValueError, match="scales"):
        tail.fused_tail_layer(0, x, so, blocks, k8, v8, 1, 40)
    mixed = dict(blocks, fc2_w=torch.zeros(L, 4 * D, D))
    with pytest.raises(TypeError, match="all int8"):
        tail.fused_tail_layer(0, x, so, mixed, k, v, 1, 40)


def test_int8_kernel_check_refuses_planted_faults():
    """The card's check (`kernels.agreement`, bf16, Dh 64) takes the K5 and
    K6 plain versions run in f32 and rounded once, and refuses every planted
    fault of `k5_faults` / `k6_faults` in each K6 form."""
    L, H, B, beams, Ta = 2, 4, 2, 5, 300
    D = 64 * H
    g = torch.Generator().manual_seed(8)
    bl = ag.random_blocks(L, D, g, "cpu")
    k, v = (ag.randn(g, "cpu", L, B, H, Ta, 64) for _ in range(2))
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    q = ag.randn(g, "cpu", B, 3 * beams, H, 64, scale=2.0)
    a5 = (L - 1, q, k8, ks, v8, vs, Ta)
    ref = attn.cross_attn_layer_q8_plain(*a5)
    loose = attn.cross_attn_layer_q8_plain(L - 1, q.float(), k8, ks, v8, vs, Ta)
    assert ag.agreement(loose.bfloat16(), ref).ok
    faults = list(ag.k5_faults(*a5))
    assert len(faults) == 5  # and a span of the key split dropped (its plan has >= 2)
    for name, bad in faults:
        assert not ag.agreement(ref, bad).ok, name

    N = B * beams
    x = ag.randn(g, "cpu", N, 1, D)
    so = ag.randn(g, "cpu", N, H, 1, 64, scale=0.3)
    q8 = tail.quantize_tail_weights(bl)
    for wq, kvq, n_faults in ((True, False, 2), (False, True, 2), (True, True, 4)):
        blocks = q8 if wq else bl
        cache = (k8, v8, ks, vs) if kvq else (k, v, None, None)
        a6 = (L - 1, x, so, blocks, cache[0], cache[1], beams, Ta, cache[2], cache[3])
        ref = tail.fused_tail_layer_plain(*a6)
        f32 = {key: t.float() if t.is_floating_point() else t for key, t in blocks.items()}
        loose = tail.fused_tail_layer_plain(L - 1, x.float(), so.float(), f32, *a6[4:])
        assert ag.agreement(loose.bfloat16(), ref, base=x).ok, (wq, kvq)
        faults = list(ag.k6_faults(*a6))
        assert len(faults) == n_faults
        for name, bad in faults:
            assert not ag.agreement(ref, bad, base=x).ok, (wq, kvq, name)


# --------------------------------------------------------------------------
# the slice: decode loops, TranscribeStep, Engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny test model, its encoded audio, and the port's
    same weights."""
    jp = jwm.init_params(TINY_TEST_CFG, seed=3)
    mel = jnp.asarray(np.random.default_rng(4).standard_normal((2, 80, 3000)), jnp.float32)
    xa = np.asarray(jwm.encode(jp, mel, TINY_TEST_CFG))
    return jp, pwm.init_params(TINY_TEST_CFG, seed=3), xa


def _first_near_tie(ps, xa, prompt, tokens, dc, margin):
    """Teacher-force `tokens` [B, T] through the port's step (its int8
    weights and cache); per row, the first step whose top-2 margin of the
    prepared logits is under `margin` (T if none)."""
    cfg = ps.cfg
    state = pdec.greedy_init(ps.params, cfg, dc, SP, xa, prompt, prompt.shape[1],
                             suppress_mask=ps._suppress, cross=ps.cross_cache(xa),
                             tail_q8=ps.tail_q8)
    logits = state["logits"]
    B, T = tokens.shape
    first = np.full(B, T)
    for t in range(T):
        prep = pdec._prepare_logits(logits, ps._suppress, SP, dc, t, *[None] * 4)
        top2 = torch.topk(prep, 2, dim=-1).values
        for b in np.nonzero((top2[:, 0] - top2[:, 1]).numpy() < margin)[0]:
            first[b] = min(first[b], t)
        logits = pwm.decode_step(ps.params, cfg, tokens[:, t:t + 1], prompt.shape[1] + t,
                                 state["cache"], state["cross"], tail_q8=ps.tail_q8)[:, 0]
    return first


@pytest.mark.parametrize("knobs", [dict(quantize_cross_kv=True, quantize_tail_weights=True),
                                   dict(quantize_tail_weights=True)],
                         ids=["kv+weights", "weights"])
def test_greedy_step_int8_matches_jax(tiny, knobs):
    """Greedy `TranscribeStep` with the int8 knobs (K5 at the prompt pass,
    K6 at every step) against the JAX TranscribeStep with its Pallas
    kernels and the int8 tail pack attached."""
    jp, pp, xa = tiny
    kw = dict(max_tokens=12, blank_id=32, with_timestamps=False, **knobs)
    js = JStep(jp, TINY_TEST_CFG, TK, strategy="greedy", enable_dtw=False,
               decode_config=jdec.DecodeConfig(pallas_cross=True, pallas_tail=True, **kw))
    ps = PStep(pp, TINY_TEST_CFG, TK, strategy="greedy", enable_dtw=False,
               decode_config=pdec.DecodeConfig(**kw))
    assert js.params["decoder"]["tail"]["w8"].dtype == jnp.int8
    assert ps.tail_q8["fc1_w"].dtype == torch.int8
    ref = js.decode(jnp.asarray(xa), "en", "transcribe")
    got = ps.decode(_t(xa), "en", "transcribe")
    jtok = torch.from_numpy(np.array(ref.tokens)).long()
    prompt = torch.tensor([TK.sot_sequence(language="en")] * 2)
    upto = _first_near_tie(ps, _t(xa), prompt, jtok, ps.dc, 1e-3)
    assert upto.min() >= 4, upto  # the check has tokens to compare
    tol = KVQ_FUSED_ATOL if knobs.get("quantize_cross_kv") else ATOL * 10
    for b in range(2):
        n = int(upto[b])
        np.testing.assert_array_equal(got.tokens[b, :n].numpy(), jtok[b, :n].numpy())
        np.testing.assert_allclose(got.token_probs[b, :n].numpy(),
                                   np.asarray(ref.token_probs)[b, :n], atol=tol, rtol=0)
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               atol=tol, rtol=0)


def test_beam_int8_cache_matches_jax(tiny):
    """Beam search over the int8 cross cache (K5 prompt pass, K4 + K6
    steps) against the JAX beam search over its int8 tiled cache (K5 at
    the prompt pass and every step, XLA tail): both run K5's numerics."""
    jp, pp, xa = tiny
    kw = dict(max_tokens=12, blank_id=32, beam_size=3, quantize_cross_kv=True)
    prompt = np.tile(np.array(TK.sot_sequence(language="en")), (2, 1))
    ref = jdec.beam_decode(jp, TINY_TEST_CFG, jdec.DecodeConfig(pallas_cross=True, **kw), SP,
                           jnp.asarray(xa), jnp.asarray(prompt, jnp.int32), 3)
    got = pdec.beam_decode(pp, TINY_TEST_CFG, pdec.DecodeConfig(**kw), SP, _t(xa),
                           torch.from_numpy(prompt), 3)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    for name in ("sum_logprob", "avg_logprob", "token_probs", "no_speech_prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4, rtol=0)


def test_beam_ignores_int8_tail_weights(tiny):
    """Under beam search `quantize_tail_weights` changes nothing (the JAX
    attach rule): no int8 weights attached, the same tokens and scores as
    without the knob, with and without the int8 cache."""
    _, pp, xa = tiny
    for kv in (False, True):
        base = pdec.DecodeConfig(max_tokens=10, blank_id=32, quantize_cross_kv=kv)
        runs = []
        for dc in (base, dataclasses.replace(base, quantize_tail_weights=True)):
            step = PStep(pp, TINY_TEST_CFG, TK, decode_config=dc, enable_dtw=False)
            assert step.tail_q8 is None
            runs.append(step.decode(_t(xa), "en", "transcribe"))
        np.testing.assert_array_equal(runs[0].tokens.numpy(), runs[1].tokens.numpy())
        np.testing.assert_array_equal(runs[0].sum_logprob.numpy(), runs[1].sum_logprob.numpy())


def test_engine_int8_decodes_on_int8_and_detects_on_bf16(snapshot, wav, tmp_path,  # noqa: F811
                                                          monkeypatch):
    """`EngineConfig(quantize_kv_cache=True)` on the CPU: every decode
    (the t = 0 beam search and the ladder's rungs) reads the int8 cache,
    language detection the bf16 one, and the cross K/V is built once per
    batch."""
    seen = {"decode": [], "detect": []}
    real_step, real_detect = pwm.decode_step_split, pwm.detect_language_logits

    def step(*a, **k):
        seen["decode"].append(sorted(a[6]))
        return real_step(*a, **k)

    def detect(params, cfg, xa, sot_id, cross=None):
        seen["detect"].append(sorted(cross))
        return real_detect(params, cfg, xa, sot_id, cross)

    monkeypatch.setattr(pwm, "decode_step_split", step)
    monkeypatch.setattr(pwm, "detect_language_logits", detect)
    eng = _engine(snapshot, tmp_path, quantize_kv_cache=True, temperature_fallback=True,
                  max_decode_tokens=6)
    cues = eng.transcribe_audio(wav, TranscribeOptions(enable_vad=False, lang="auto"))
    (st,) = eng._step_cache.values()
    assert st.dc.quantize_cross_kv and st.strategy == "beam_search"
    assert eng.last_run["windows"] >= 2
    assert seen["detect"] == [["k", "v"]]  # once: the stream's language latches
    assert seen["decode"] and all(s == ["k8", "ks", "v8", "vs"] for s in seen["decode"])
    for c in cues:
        assert 0.0 <= c.start <= c.end
    # greedy too, and the same Engine config without the knob decodes bf16
    eng.transcribe_audio(wav, TranscribeOptions(
        enable_vad=False, lang="en", advanced=AdvancedTranscribe(sampling_strategy="greedy")))
    assert all(s.dc.quantize_cross_kv for s in eng._step_cache.values())
