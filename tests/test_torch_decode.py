"""The PyTorch port's greedy decode loop, DTW and TranscribeStep against the
JAX package on the CPU (f32, same snapshot, same numpy inputs).

Tolerances: greedy tokens at temperature 0 exact; log-probabilities atol
1e-4; `alignment_cost_batch` atol 1e-5; DTW anchor times within one frame
(0.02 s: the two DPs sum in different orders, so a near-tie in the
backtrack may move an anchor by one frame). JAX's random bits cannot be
matched, so sampling (`sample_best_of`) is checked on the port alone:
reproducible from a seeded generator, and it keeps the candidate with the
highest average log-probability.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.ops import dtw as jdtw
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu.transcribe import TranscribeStep as JStep

from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.ops import dtw as pdtw
from whisper_diarize_tpu_torch.transcribe import TranscribeStep as PStep

torch.set_num_threads(2)

CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
TK = DebugTokenizer()
SP = TK.specials
FRAME = 0.02


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("snap")
    jweights.init_random_snapshot(d, cfg=CFG, seed=0)
    jp, jcfg = jweights.load_model(d)
    pp, pcfg = pweights.load_model(d)
    return jp, jcfg, pp, pcfg


def _audio(n_rows=2, seconds=3, seed=0):
    rng = np.random.default_rng(seed)
    audio = np.zeros((n_rows, 480000), np.float32)
    n = 16000 * seconds
    audio[:, :n] = rng.standard_normal((n_rows, n)).astype(np.float32) * 0.1
    return audio, n


def _printable_only_mask(n_vocab):
    """Suppress everything but printable ASCII: every sampled token is a
    visible text span (timestamps off), so DTW has words to place."""
    keep = set(range(33, 127))
    return [i for i in range(n_vocab) if i not in keep]


@pytest.fixture(scope="module")
def steps(models):
    jp, jcfg, pp, pcfg = models
    kw = dict(max_tokens=16, blank_id=32)
    js = JStep(jp, jcfg, TK, decode_config=jdec.DecodeConfig(**kw), strategy="greedy")
    ps = PStep(pp, pcfg, TK, decode_config=pdec.DecodeConfig(**kw), strategy="greedy")
    audio, n = _audio()
    jxa = js.encode(js.mel(audio))
    pxa = ps.encode(ps.mel(audio))
    return js, ps, jxa, pxa, n


@pytest.mark.parametrize("prev", [None, [[65, 66, 67], None]])
def test_greedy_decode_matches_jax(steps, prev):
    """t = 0 greedy through the port's loop (K1 prefill, K3 steps, plain
    versions) equals JAX's while_loop, with and without per-row left-padded
    prompts (row_pad)."""
    js, ps, jxa, pxa, _ = steps
    jp, jlen, jsot, jrp = js._build_prompt(2, "en", "transcribe", prev)
    pp_, plen, psot, prp = ps._build_prompt(2, "en", "transcribe", prev)
    assert (jlen, jsot) == (plen, psot)
    assert (jrp is None) == (prp is None) == (prev is None)
    np.testing.assert_array_equal(pp_.numpy(), np.asarray(jp))
    ref = jdec.greedy_decode(js.params, js.cfg, js.dc, SP, jxa, jp, jlen,
                             suppress_mask=js._suppress, sot_pos=jsot, row_pad=jrp)
    got = pdec.greedy_decode(ps.params, ps.cfg, ps.dc, SP, pxa, pp_, plen,
                             suppress_mask=ps._suppress, sot_pos=psot, row_pad=prp)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    for name in ("sum_logprob", "avg_logprob", "token_probs", "no_speech_prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-4)


def test_sample_best_of_seeded_and_picks_best(steps):
    js, ps, jxa, pxa, _ = steps
    dc = pdec.DecodeConfig(max_tokens=12, blank_id=32, temperature=0.8)
    prompt, plen, sot, rp = ps._build_prompt(2, "en", "transcribe")

    def run(fn, **kw):
        return fn(ps.params, ps.cfg, dc, SP, pxa, prompt, plen,
                  generator=torch.Generator().manual_seed(7),
                  suppress_mask=ps._suppress, sot_pos=sot, **kw)

    a = run(pdec.sample_best_of, best_of=4)
    b = run(pdec.sample_best_of, best_of=4)
    np.testing.assert_array_equal(a.tokens.numpy(), b.tokens.numpy())
    np.testing.assert_array_equal(a.avg_logprob.numpy(), b.avg_logprob.numpy())
    pool = run(pdec.greedy_decode, beams=4)  # the same draws, all candidates
    avg = pool.avg_logprob.view(2, 4)
    best = avg.argmax(dim=1)
    np.testing.assert_array_equal(a.avg_logprob.numpy(), avg.max(dim=1).values.numpy())
    for r in range(2):
        np.testing.assert_array_equal(a.tokens[r].numpy(),
                                      pool.tokens[r * 4 + int(best[r])].numpy())
    assert (pool.tokens.view(2, 4, -1)[:, 0] != pool.tokens.view(2, 4, -1)[:, 1]).any()


def test_decode_with_fallback_structure(steps):
    """The ladder re-decodes judged rows only, deterministically."""
    _, ps, _, pxa, _ = steps
    r1, t1 = ps.decode_with_fallback(pxa, "en", "transcribe", temperatures=(0.0, 0.5),
                                     logprob_threshold=float("inf"), n_valid_rows=1)
    r2, t2 = ps.decode_with_fallback(pxa, "en", "transcribe", temperatures=(0.0, 0.5),
                                     logprob_threshold=float("inf"), n_valid_rows=1)
    assert t1[0] == np.float32(0.5) and t1[1] == 0.0
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(r1.tokens.numpy(), r2.tokens.numpy())
    base = ps.decode(pxa, "en", "transcribe")
    np.testing.assert_array_equal(r1.tokens[1].numpy(), base.tokens[1].numpy())
    assert np.isfinite(r1.avg_logprob.numpy()).all()


def test_fallback_ladder_builds_cross_cache_once(steps, monkeypatch):
    """Every rung of the ladder decodes over the one cross K/V (K2) built
    for the window, and gives what a rung with its own cache gives."""
    _, ps, _, pxa, _ = steps
    kw = dict(temperatures=(0.0, 0.4, 1.0), logprob_threshold=float("inf"))
    ref, ref_t = ps.decode_with_fallback(pxa, "en", "transcribe", **kw)
    built = []
    real = pdec.build_cross_cache

    def counted(*a, **k):
        built.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pdec, "build_cross_cache", counted)
    got, got_t = ps.decode_with_fallback(pxa, "en", "transcribe", **kw)
    assert len(built) == 1
    np.testing.assert_array_equal(got_t, ref_t)
    assert (got_t == np.float32(1.0)).all()  # every row went through 3 rungs
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    ps.decode(pxa, "en", "transcribe")  # without a cache given, decode builds one
    assert len(built) == 2


@pytest.mark.parametrize("with_rows", [False, True])
def test_alignment_cost_batch_matches_jax(with_rows):
    rng = np.random.default_rng(4)
    qk = rng.standard_normal((2, 3, 10, 300)).astype(np.float32) * 3
    nf = np.array([250, 120], np.int64)
    nr = np.array([10, 6], np.int64) if with_rows else None
    ref = jdtw.alignment_cost_batch(
        jnp.asarray(qk), jnp.asarray(nf, jnp.int32),
        None if nr is None else jnp.asarray(nr, jnp.int32))
    got = pdtw.alignment_cost_batch(
        torch.from_numpy(qk), torch.from_numpy(nf),
        None if nr is None else torch.from_numpy(nr))
    for b in range(2):  # the valid region is what the host reads
        rows = nr[b] if with_rows else 10
        np.testing.assert_allclose(got[b, :rows, :nf[b]].numpy(),
                                   np.asarray(ref)[b, :rows, :nf[b]], atol=1e-5)


@pytest.mark.parametrize("native_dp", [True, False], ids=["native", "numpy"])
def test_host_dtw_matches_reference(native_dp, monkeypatch):
    """The port's host DTW — the native C++ DP when its library is built,
    else the numpy DP — gives the JAX package's anchors within one frame;
    the numpy DP's accumulated cost equals JAX's DP."""
    from whisper_diarize_tpu_torch import native

    if not native_dp:
        monkeypatch.setattr(native, "is_available", lambda: False)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20, 150)).astype(np.float32)
    np.testing.assert_allclose(pdtw.dtw_cost_matrix(x),
                               np.asarray(jdtw.dtw_cost_matrix(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-4)
    ti, tj = pdtw.dtw_path(x)
    assert ti[0] == tj[0] == 0 and ti[-1] == 19 and tj[-1] == 149
    assert (np.diff(ti) >= 0).all() and (np.diff(tj) >= 0).all()
    ref = jdtw.anchor_times_from_cost(x, 20)
    np.testing.assert_allclose(pdtw.anchor_times_from_cost(x, 20), ref, atol=FRAME + 1e-9)
    np.testing.assert_allclose(pdtw.median_filter(x, 7), jdtw.median_filter(x, 7))


def test_transcribe_step_decode_and_dtw_match_jax(models, monkeypatch):
    """One window through both TranscribeSteps (host DP on both sides):
    identical tokens and text, word times within one frame."""
    monkeypatch.setenv("WDT_HOST_DTW", "1")
    jp, jcfg, pp, pcfg = models
    kw = dict(max_tokens=16, blank_id=32, with_timestamps=False)
    js = JStep(jp, jcfg, TK, decode_config=jdec.DecodeConfig(**kw), strategy="greedy")
    ps = PStep(pp, pcfg, TK, decode_config=pdec.DecodeConfig(**kw), strategy="greedy")
    extra = _printable_only_mask(jcfg.n_vocab)
    js._suppress = jnp.asarray(jdec.build_suppress_mask(SP, jcfg.n_vocab, extra))
    ps._suppress = torch.from_numpy(pdec.build_suppress_mask(SP, pcfg.n_vocab, extra))
    audio, n = _audio(seed=1)
    jxa = js.encode(js.mel(audio))
    pxa = ps.encode(ps.mel(audio))
    assert ps.detect_language(pxa) == js.detect_language(jxa)
    jidx, jprobs = jdec.detect_language(jp, jcfg, SP, jxa)
    pidx, pprobs = pdec.detect_language(pp, pcfg, SP, pxa)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pprobs.numpy(), np.asarray(jprobs), atol=1e-5)
    jr = js.decode(jxa, "en", "transcribe")
    pr = ps.decode(pxa, "en", "transcribe")
    np.testing.assert_array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    jc = js.build_chunk_results(jr, jxa, [n, n], translated=False)
    pc = ps.build_chunk_results(pr, pxa, [n, n], translated=False)
    for a, b in zip(jc, pc):
        assert a.text == b.text and a.tokens == b.tokens and len(b.words) > 0
        assert [w.text for w in a.words] == [w.text for w in b.words]
        for wa, wb in zip(a.words, b.words):
            assert abs(wa.start - wb.start) <= FRAME + 1e-6
            assert abs(wa.end - wb.end) <= FRAME + 1e-6
            assert wb.probability == pytest.approx(wa.probability, abs=1e-4)
