"""The port's beam search against the JAX package, on the CPU at f32: K4
(`ops/attn.py::split_self_attn_layer`, its plain version here) against the
Pallas kernel in interpret mode, `decode_step_split`, `_retire_eot_candidates`,
`beam_decode` and the Engine's default strategy (beam 5).

Same numpy inputs and weights on both sides. Tolerances: K4 atol 1e-5
(sums in another order); `decode_step_split` logits and cache atol 1e-4
(the JAX XLA path scales q and k by Dh^-0.25 each, K4 scales q by Dh^-0.5);
EOT retirement exact; beam tokens and lengths exact, log-probabilities atol
1e-4; Engine cues as in `test_torch_engine.py` (texts equal, times within
one DTW frame plus the formatter's rounding).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.ops.pallas_attn import split_self_attn_layer as jax_split_self
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu.types import AdvancedTranscribe, TranscribeOptions

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import attn
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.transcribe import TranscribeStep as PStep

from tests.test_torch_engine import (  # noqa: F401  (fixtures)
    _assert_cues_match, _engine, jax_engines, snapshot, wav)
from tests.test_whisper_model import TINY_TEST_CFG

torch.set_num_threads(2)

TK = DebugTokenizer()
SP = TK.specials


def _t(a):
    return torch.from_numpy(np.array(a))


def _ancestry(rng, N, K, Td, step):
    """What beam reindexing produces: identity for slots >= step, random
    rows of the same stream for the decoded ones."""
    anc = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, Td))
    anc[:, :step] = (np.arange(N)[:, None] // K) * K + rng.integers(0, K, size=(N, step))
    return anc


# --------------------------------------------------------------------------
# (a) K4 against the Pallas kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 15])
def test_k4_split_self_attn_matches_pallas(step):
    L, B, K, H, Dh, Tp, Td = 2, 2, 3, 2, 64, 5, 16
    N = B * K
    rng = np.random.default_rng(step)
    q = rng.standard_normal((B, K, H, Dh)).astype(np.float32) * 2
    pk, pv = (rng.standard_normal((L, B, H, Tp, Dh)).astype(np.float32) for _ in range(2))
    dk, dv = (rng.standard_normal((L, N, H, Td, Dh)).astype(np.float32) for _ in range(2))
    anc_j = (_ancestry(rng, N, K, Td, Td) % K).reshape(B, K, Td)
    row_pad = np.array([0, 2], np.int32)
    for layer in range(L):
        ref = jax_split_self(layer, *map(jnp.asarray, (q, pk, pv, dk, dv, anc_j)), step,
                             jnp.asarray(row_pad), Tp, interpret=True)
        got = attn.split_self_attn_layer(
            layer, *map(_t, (q, pk, pv, dk, dv)), _t(anc_j).long(), step,
            _t(row_pad).long(), Tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_k4_check_refuses_planted_faults():
    """The card's K4 check (`kernels.agreement`, bf16, Dh 64) takes the plain
    version run in f32 and rounded once, and refuses every planted fault."""
    g = torch.Generator().manual_seed(4)
    L, B, K, H, Tp, Td, step = 3, 2, 5, 4, 19, 32, 9
    q = ag.randn(g, "cpu", B, K, H, 64, scale=2.0)
    pk, pv = (ag.randn(g, "cpu", L, B, H, Tp, 64) for _ in range(2))
    dk, dv = (ag.randn(g, "cpu", L, B * K, H, Td, 64) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, dtype=torch.int32)
    row_pad = torch.tensor([3, 8], dtype=torch.int32)
    a = (1, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp - 2)
    ref = attn.split_self_attn_layer_plain(*a)
    f32 = [t.float() if torch.is_tensor(t) and t.is_floating_point() else t for t in a]
    loose = attn.split_self_attn_layer_plain(*f32)
    assert ag.agreement(loose.bfloat16(), ref).ok
    faults = list(ag.k4_faults(*a))
    assert len(faults) == 5
    for name, bad in faults:
        assert not ag.agreement(ref, bad).ok, name


def test_k4_wrapper_plain_only_on_cpu():
    rng = np.random.default_rng(3)
    L, B, K, H, Tp, Td = 2, 2, 2, 2, 4, 8
    args = [_t(rng.standard_normal(s).astype(np.float32)) for s in (
        (B, K, H, 64), (L, B, H, Tp, 64), (L, B, H, Tp, 64),
        (L, B * K, H, Td, 64), (L, B * K, H, Td, 64))]
    anc_j = torch.zeros((B, K, Td), dtype=torch.long)
    rp = torch.zeros((B,), dtype=torch.long)
    before = attn.split_self_attn_layer.launches
    torch.testing.assert_close(
        attn.split_self_attn_layer(1, *args, anc_j, 3, rp, Tp),
        attn.split_self_attn_layer_plain(1, *args, anc_j, 3, rp, Tp), rtol=0, atol=0)
    assert attn.split_self_attn_layer.launches == before
    with pytest.raises(RuntimeError, match="no kernel"):
        attn.split_self_attn_layer(1, *[t.to("meta") for t in args], anc_j, 3, rp, Tp)


# --------------------------------------------------------------------------
# (b) decode_step_split
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pallas_split", [False, True])
def test_decode_step_split_matches_jax(pallas_split):
    """Several beam steps with a reindex before each: the port's step (K4 +
    K3 plain versions, cache written in place) against JAX's, logits and
    the decode cache after every step; the prompt half is never written."""
    L, B, K, H, Dh, Tp, Td, V = 2, 2, 3, 2, 8, 5, 8, 64
    N, D = B * K, H * Dh
    cfg = jwm.WhisperConfig(
        n_mels=8, n_vocab=V, n_audio_ctx=16, n_audio_state=D, n_audio_head=H,
        n_audio_layer=L, n_text_ctx=64, n_text_state=D, n_text_head=H, n_text_layer=L)
    jp = jwm.init_params(cfg, seed=0)
    pp = pwm.init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    xa = rng.standard_normal((B, 16, D)).astype(np.float32)
    jcross = jwm.cross_kv(jp, jnp.asarray(xa), cfg)
    pcross = pwm.cross_kv(pp, _t(xa), cfg)
    pk, pv = (rng.standard_normal((L, B, H, Tp, Dh)).astype(np.float32) for _ in range(2))
    row_pad = np.repeat(rng.integers(0, Tp - 1, size=B), K)
    jdecode = {"k": jnp.zeros((L, N, H, Td, Dh)), "v": jnp.zeros((L, N, H, Td, Dh))}
    pdecode = pwm.init_self_cache(cfg, N, torch.float32, "cpu", Td)
    pprompt = {"k": _t(pk), "v": _t(pv)}
    anc = np.tile(np.arange(N)[:, None], (1, Td))
    for step in range(5):
        new_src = (np.arange(N) // K) * K + rng.integers(0, K, size=N)
        anc = anc[new_src]
        anc[:, step] = np.arange(N)
        tokens = rng.integers(0, V, size=(N, 1))
        ref, jdecode = jwm.decode_step_split(
            jp, cfg, jnp.asarray(tokens, jnp.int32), jnp.int32(step),
            {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}, jdecode, jcross, Tp,
            beams=K, row_pad=jnp.asarray(row_pad, jnp.int32), unroll=True,
            anc=jnp.asarray(anc, jnp.int32), pallas_split=pallas_split)
        got = pwm.decode_step_split(
            pp, cfg, _t(tokens), step, pprompt, pdecode, pcross, Tp, K,
            _t(row_pad), _t(anc))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        for key in ("k", "v"):
            np.testing.assert_allclose(pdecode[key].numpy(), np.asarray(jdecode[key]),
                                       atol=1e-4, rtol=0)
    np.testing.assert_array_equal(pprompt["k"].numpy(), pk)


# --------------------------------------------------------------------------
# (c) EOT retirement and the top-k tie order
# --------------------------------------------------------------------------

def test_retire_eot_candidates_matches_jax():
    rng = np.random.default_rng(7)
    B, K, T = 3, 4, 6
    N = B * K
    for trial in range(30):
        topv = np.sort(rng.standard_normal((B, 2 * K)).astype(np.float32), axis=1)[:, ::-1].copy()
        for b in range(B):  # -inf tails: ties among the trailing candidates
            n_inf = rng.integers(0, 2 * K)
            if n_inf:
                topv[b, -n_inf:] = -np.inf
        tok_idx = rng.integers(10, 100, (B, 2 * K))
        tok_idx[rng.random((B, 2 * K)) < 0.4] = SP.eot
        src_flat = np.arange(B)[:, None] * K + rng.integers(0, K, (B, 2 * K))
        args = [topv, tok_idx, src_flat,
                rng.integers(0, 100, (N, T)), rng.random((N, T)).astype(np.float32),
                rng.integers(0, T, N), np.full((B, K, T), -1),
                np.zeros((B, K, T), np.float32), np.full((B, K), -np.inf, np.float32),
                np.zeros((B, K), np.int64), rng.integers(0, K + 1, B)]
        ref = jdec._retire_eot_candidates(SP, K, *[
            jnp.asarray(a, jnp.int32) if a.dtype.kind == "i" else jnp.asarray(a) for a in args])
        got = pdec._retire_eot_candidates(SP, K, *map(_t, args))
        for r, g_ in zip(ref, got):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(r))


def test_top_k_keeps_jax_tie_order():
    """Rows with planted ties (-inf runs and equal finite values): values
    and indices equal `jax.lax.top_k`'s, lower index first."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    x[0, 5:] = -np.inf  # fewer finite entries than k
    x[1, ::2] = -np.inf
    x[2, [3, 9, 17, 30]] = 1.5  # a finite tie straddling the k-th place
    x[3] = -np.inf
    x[4, :] = 0.25
    x[5, 20:] = x[5, :20]
    for k in (1, 4, 10):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        v, i = pdec._top_k(_t(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


# --------------------------------------------------------------------------
# (d) beam_decode
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny test model and encoded audio, and the port's
    same weights; the audio states are handed to both as the same array."""
    jp = jwm.init_params(TINY_TEST_CFG, seed=3)
    mel = jnp.asarray(np.random.default_rng(4).standard_normal((2, 80, 3000)), jnp.float32)
    xa = np.asarray(jwm.encode(jp, mel, TINY_TEST_CFG))
    return jp, pwm.init_params(TINY_TEST_CFG, seed=3), xa


def _prompt(per_row: bool):
    """(prompt [2, P], row_pad or None): without and with per-row previous
    text, left-padded to a shared 8-bucket as TranscribeStep builds it."""
    seq = TK.sot_sequence(task="transcribe", language="en")
    if not per_row:
        return np.tile(np.array(seq), (2, 1)), None
    prefixes = [[SP.sot_prev, 65, 66, 67], []]
    pads = [8 - len(p) for p in prefixes]
    rows = [[SP.sot] * pad + p + seq for pad, p in zip(pads, prefixes)]
    return np.array(rows), np.array(pads)


def _suppress(few: bool) -> np.ndarray:
    """`few`: only three text tokens and a penalised EOT (no timestamps), so
    hypotheses finish at different lengths, patience and the length penalty
    change the choice, and at step 0 fewer than K candidates are finite
    (the -inf ties of the top-k pick active beams)."""
    if not few:
        return jdec.build_suppress_mask(SP, TINY_TEST_CFG.n_vocab)
    keep = {65, 66, 67, SP.eot}
    extra = [i for i in range(SP.timestamp_begin) if i not in keep]
    mask = jdec.build_suppress_mask(SP, TINY_TEST_CFG.n_vocab, extra)
    mask[SP.eot] = -2.0
    return mask


def _beam_pair(tiny, per_row, few, **kw):
    jp, pp, xa = tiny
    prompt, row_pad = _prompt(per_row)
    mask = _suppress(few)
    common = dict(max_tokens=16, blank_id=32, with_timestamps=not few, **kw)
    ref = jdec.beam_decode(
        jp, TINY_TEST_CFG, jdec.DecodeConfig(**common), SP, jnp.asarray(xa),
        jnp.asarray(prompt, jnp.int32), prompt.shape[1],
        suppress_mask=jnp.asarray(mask), sot_pos=prompt.shape[1] - 3,
        row_pad=None if row_pad is None else jnp.asarray(row_pad, jnp.int32))
    got = pdec.beam_decode(
        pp, TINY_TEST_CFG, pdec.DecodeConfig(**common), SP, _t(xa), _t(prompt),
        prompt.shape[1], suppress_mask=_t(mask), sot_pos=prompt.shape[1] - 3,
        row_pad=None if row_pad is None else _t(row_pad))
    return ref, got


def _assert_result_equal(ref, got):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    for name in ("sum_logprob", "avg_logprob", "token_probs", "no_speech_prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-4, rtol=0)


# every case compiles JAX's beam loop anew (the DecodeConfig is static), so
# K = 5 takes the full cross of the other options and K = 3 their edge case
_BEAM_CASES = [(5, patience, lp, per_row) for patience in (1.0, 0.5)
               for lp in (None, 0.6) for per_row in (False, True)] + [(3, 0.5, 0.6, True)]


@pytest.mark.parametrize("K,patience,length_penalty,per_row", _BEAM_CASES, ids=[
    f"{K}-{p}-{lp}-{'per-row' if r else 'one-prompt'}" for K, p, lp, r in _BEAM_CASES])
def test_beam_decode_matches_jax(tiny, K, patience, length_penalty, per_row):
    """The few-token model: hypotheses retire at different steps. The port's
    host looks for the patience target only every 32 steps (past the 16-step
    budget), so at patience 0.5 the steps after JAX's stop run and must
    change nothing."""
    ref, got = _beam_pair(tiny, per_row, True, beam_size=K, patience=patience,
                          length_penalty=length_penalty)
    _assert_result_equal(ref, got)
    assert (got.lengths.numpy() < 16).all()  # finished hypotheses were chosen


@pytest.mark.parametrize("per_row", [False, True], ids=["one-prompt", "per-row"])
def test_beam_decode_with_timestamps_matches_jax(tiny, per_row):
    """The default suppress mask and the timestamp grammar."""
    _assert_result_equal(*_beam_pair(tiny, per_row, False, beam_size=5))


def test_patience_stop_is_exact_at_any_poll(tiny):
    """The patience stop does not depend on where the host looks."""
    _, pp, xa = tiny
    prompt, _ = _prompt(False)
    dc = pdec.DecodeConfig(beam_size=5, patience=0.5, max_tokens=16, blank_id=32,
                           with_timestamps=False)
    runs = [pdec.beam_decode(pp, TINY_TEST_CFG, dc, SP, _t(xa), _t(prompt), 3,
                             suppress_mask=_t(_suppress(True)), poll_tokens=poll)
            for poll in (1, 5, 32)]
    for r in runs[1:]:
        _assert_result_equal(runs[0], r)
    full = pdec.beam_decode(pp, TINY_TEST_CFG, dataclasses.replace(dc, patience=1.0),
                            SP, _t(xa), _t(prompt), 3, suppress_mask=_t(_suppress(True)))
    assert not torch.equal(full.lengths, runs[0].lengths)  # the stop matters here


def test_beam1_equals_greedy(tiny):
    """One beam is greedy search (`tests/test_decode.py::test_beam1_matches_greedy`
    for JAX), and equals JAX's one-beam search."""
    jp, pp, xa = tiny
    prompt, _ = _prompt(False)
    dc = pdec.DecodeConfig(beam_size=1, max_tokens=12, blank_id=32)
    b = pdec.beam_decode(pp, TINY_TEST_CFG, dc, SP, _t(xa), _t(prompt), 3)
    g = pdec.greedy_decode(pp, TINY_TEST_CFG, pdec.DecodeConfig(max_tokens=12, blank_id=32),
                           SP, _t(xa), _t(prompt), 3)
    np.testing.assert_array_equal(b.tokens.numpy(), g.tokens.numpy())
    np.testing.assert_array_equal(b.lengths.numpy(), g.lengths.numpy())
    ref = jdec.beam_decode(jp, TINY_TEST_CFG, jdec.DecodeConfig(beam_size=1, max_tokens=12,
                                                               blank_id=32),
                           SP, jnp.asarray(xa), jnp.asarray(prompt, jnp.int32), 3)
    _assert_result_equal(ref, b)


# --------------------------------------------------------------------------
# (e) the Engine's default strategy, (f) K2 once per window
# --------------------------------------------------------------------------

@pytest.mark.parametrize("enable_vad,sequential", [(False, False), (True, False), (False, True)],
                         ids=["whole-file", "vad", "rolling-prompt"])
def test_engine_default_beam_matches_jax_engine(snapshot, wav, jax_engines, tmp_path,  # noqa: F811
                                                monkeypatch, enable_vad, sequential):
    """`advanced=None`: beam search, beam 5, on both engines."""
    monkeypatch.setenv("WDT_HOST_DTW", "1")
    opts = TranscribeOptions(enable_vad=enable_vad, lang="en")
    ref = jax_engines(sequential_prompt=sequential).transcribe_audio(wav, opts)
    eng = _engine(snapshot, tmp_path, sequential_prompt=sequential)
    got = eng.transcribe_audio(wav, opts)
    _assert_cues_match(ref, got)
    assert eng.last_run["windows"] >= 2
    (step,) = eng._step_cache.values()
    assert step.strategy == "beam_search" and step.dc.beam_size == 5
    # the greedy options get a step of their own
    eng.transcribe_audio(wav, TranscribeOptions(
        enable_vad=enable_vad, lang="en", advanced=AdvancedTranscribe(sampling_strategy="greedy")))
    assert sorted(s.strategy for s in eng._step_cache.values()) == ["beam_search", "greedy"]


def test_beam_ladder_builds_cross_cache_once(tiny, monkeypatch):
    """With the fallback ladder on, the window's cross K/V (K2) is built once
    and shared by the t = 0 beam search and every sampling rung."""
    _, pp, xa = tiny
    step = PStep(pp, TINY_TEST_CFG, TK, decode_config=pdec.DecodeConfig(
        max_tokens=8, blank_id=32))
    assert step.strategy == "beam_search"
    kw = dict(temperatures=(0.0, 0.4, 1.0), logprob_threshold=float("inf"))
    ref, ref_t = step.decode_with_fallback(_t(xa), "en", "transcribe", **kw)
    built = []
    real = pdec.build_cross_cache

    def counted(*a, **k):
        built.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pdec, "build_cross_cache", counted)
    got, got_t = step.decode_with_fallback(_t(xa), "en", "transcribe", **kw)
    assert len(built) == 1
    assert (got_t == np.float32(1.0)).all()  # every row went through 3 rungs
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(got_t, ref_t)


def test_engine_language_detection_shares_cross_cache(snapshot, wav, tmp_path,  # noqa: F811
                                                      monkeypatch):
    """`lang="auto"`: language detection and the beam decode with its ladder
    read one cross K/V build per decode batch (one window a batch here:
    whole-file windows follow each other's seek)."""
    built = []
    real = pwm.cross_kv

    def counted(*a, **k):
        built.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pwm, "cross_kv", counted)
    eng = _engine(snapshot, tmp_path, temperature_fallback=True, max_decode_tokens=6)
    eng.transcribe_audio(wav, TranscribeOptions(enable_vad=False, lang="auto"))
    assert eng.last_run["windows"] >= 2
    assert len(built) == eng.last_run["windows"]
