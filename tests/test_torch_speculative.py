"""The port's speculative greedy decoding against its own greedy decode and
against the JAX package on the CPU (f32, the same numpy weights and inputs
on both sides).

- `decode_step_pos` against the JAX `decode_step_pos` at per-row positions
  with stale slots in the cache: logits and caches within 1e-4; with a
  constant `pos0` against the port's `decode_step` within 1e-6.
- `speculative_greedy_decode` equals the port's `greedy_decode`: tokens and
  lengths exactly, sum log-prob within 1e-4, token probabilities within
  1e-3 relative / 1e-4 absolute, no-speech probability within 1e-5 /
  1e-6 (the JAX package's own tolerances), for a self-draft at gamma 1, 3
  and 4, an unrelated random draft and a smaller-architecture draft.
- Tokens, lengths and the round count equal the JAX
  `speculative_greedy_run`'s; over the int8 cross cache too (both sides
  run K5's numerics in the verify pass).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.ops import speculative as jspec
from whisper_diarize_tpu.tokenizer import DebugTokenizer

from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.ops import speculative as pspec

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
TK = DebugTokenizer()
SP = TK.specials
DC = dict(max_tokens=16, blank_id=32)


def _port(tree):
    return pweights.params_from_jax(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


@pytest.fixture(scope="module")
def setup():
    """Target (seed 3), the unrelated draft (seed 99) and the smaller draft
    (DRAFT_CFG, seed 7), each as JAX and port params with its own encoded
    audio; the prompt; the port's greedy reference."""
    mel = np.random.default_rng(4).standard_normal((2, 80, 3000)).astype(np.float32)
    models = {}
    for name, cfg, seed in (("target", CFG, 3), ("unrelated", CFG, 99),
                            ("smaller", DRAFT_CFG, 7)):
        jp = jwm.init_params(cfg, seed=seed)
        pp = _port(jp)
        with torch.inference_mode():
            xa = pwm.encode(pp, torch.from_numpy(mel), cfg)
        models[name] = (cfg, jp, pp, xa)
    models["self"] = models["target"]
    prompt = torch.tensor([TK.sot_sequence(task="transcribe", language="en")] * 2)
    with torch.inference_mode():
        ref = pdec.greedy_decode(models["target"][2], CFG, pdec.DecodeConfig(**DC), SP,
                                 models["target"][3], prompt, prompt.shape[1])
    return models, prompt, ref


def _suppress(eot=False):
    return torch.from_numpy(pdec.build_suppress_mask(
        SP, CFG.n_vocab, extra_suppress=[SP.eot] if eot else None))


def _run(setup, draft, gamma, dc=None, **kw):
    models, prompt, _ = setup
    _, _, pt, xt = models["target"]
    cfg_d, _, pd, xd = models[draft]
    with torch.inference_mode():
        return pspec.speculative_greedy_run(
            pt, CFG, pd, cfg_d, dc or pdec.DecodeConfig(**DC), SP, xt, xd, prompt,
            prompt.shape[1], kw.pop("suppress", _suppress()), gamma=gamma, **kw)


def _assert_matches_greedy(res, ref):
    np.testing.assert_array_equal(res.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(res.lengths.numpy(), ref.lengths.numpy())
    np.testing.assert_allclose(res.sum_logprob.numpy(), ref.sum_logprob.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.token_probs.numpy(), ref.token_probs.numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.no_speech_prob.numpy(), ref.no_speech_prob.numpy(),
                               rtol=1e-5, atol=1e-6)


def _filled_caches(setup, n_slots):
    """Both packages' self caches with slots 0 .. n_slots - 1 of both rows
    filled by single-token steps (so a row placed below n_slots has stale
    slots above it), and both cross caches."""
    models, _, _ = setup
    _, jp, pp, xa = models["target"]
    jxa = jnp.asarray(xa.numpy())
    jcc = jwm.cross_kv(jp, jxa, CFG)
    pcc = pwm.cross_kv(pp, xa, CFG)
    jc = jwm.init_self_cache(CFG, 2, jnp.float32, 32)
    pc = pwm.init_self_cache(CFG, 2, torch.float32, "cpu", 32)
    toks = np.random.default_rng(10).integers(10, 200, (2, n_slots))
    for j in range(n_slots):
        _, jc = jwm.decode_step_pos(jp, CFG, jnp.asarray(toks[:, j:j + 1], jnp.int32),
                                    jnp.full((2,), j, jnp.int32), jc, jcc)
        pwm.decode_step_pos(pp, CFG, torch.from_numpy(toks[:, j:j + 1]),
                            torch.full((2,), j), pc, pcc)
    return (jp, jcc, jc), (pp, pcc, pc)


@pytest.mark.parametrize("S", [1, 3])
def test_decode_step_pos_matches_jax(setup, S):
    """Rows at slots 2 and 6 over a cache filled to slot 7: row 0 sees
    stale K/V at slots 3..7, which its causal mask must hide. S = 1 runs
    the layer tails on K3's plain version, S = 3 on `_decoder_layer_tail`
    (K1's plain version at Q = 3)."""
    (jp, jcc, jc), (pp, pcc, pc) = _filled_caches(setup, 8)
    for name in ("k", "v"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]), atol=1e-4, rtol=0)
    toks = np.random.default_rng(11).integers(10, 200, (2, S))
    pos = np.array([2, 6])
    jl, jc = jwm.decode_step_pos(jp, CFG, jnp.asarray(toks, jnp.int32),
                                 jnp.asarray(pos, jnp.int32), jc, jcc)
    with torch.inference_mode():
        pl = pwm.decode_step_pos(pp, CFG, torch.from_numpy(toks), torch.from_numpy(pos), pc, pcc)
    assert pl.shape == (2, S, CFG.n_vocab) and pl.dtype == torch.float32
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("S", [1, 3])
def test_decode_step_pos_constant_equals_decode_step(setup, S):
    """A constant pos0 gives `decode_step`'s logits and cache writes; slots
    past a row's position (clamped at Tc - 1) are written in place."""
    _, (pp, pcc, pc) = _filled_caches(setup, 4)
    ref_cache = {k: v.clone() for k, v in pc.items()}
    toks = torch.from_numpy(np.random.default_rng(12).integers(10, 200, (2, S)))
    with torch.inference_mode():
        want = pwm.decode_step(pp, CFG, toks, 4, ref_cache, pcc)
        got = pwm.decode_step_pos(pp, CFG, toks, torch.full((2,), 4), pc, pcc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(pc[name].numpy(), ref_cache[name].numpy(), atol=1e-6,
                                   rtol=0)
    # the last slot takes every clamped write
    with torch.inference_mode():
        pwm.decode_step_pos(pp, CFG, toks, torch.full((2,), 31), pc, pcc)
    assert pc["k"][:, :, :, 31].abs().sum() > 0


@pytest.mark.parametrize("draft,gamma", [("self", 1), ("self", 3), ("self", 4),
                                         ("unrelated", 3), ("smaller", 4)])
def test_speculative_matches_greedy(setup, draft, gamma):
    """Whatever the draft proposes, the output is the target's own greedy
    decode."""
    res, rounds = _run(setup, draft, gamma)
    _assert_matches_greedy(res, setup[2])
    assert 0 < int(rounds) <= int(res.lengths.max()) + 1
    with torch.inference_mode():
        models, prompt, ref = setup
        _, _, pt, xt = models["target"]
        cfg_d, _, pd, xd = models[draft]
        dec_res = pspec.speculative_greedy_decode(pt, CFG, pd, cfg_d, pdec.DecodeConfig(**DC),
                                                  SP, xt, xd, prompt, prompt.shape[1],
                                                  gamma=gamma)
    _assert_matches_greedy(dec_res, ref)


def _jax_run(setup, draft, gamma, dc):
    models, prompt, _ = setup
    _, jt, _, xt = models["target"]
    cfg_d, jd, _, xd = models[draft]
    sup = jnp.asarray(jdec.build_suppress_mask(SP, CFG.n_vocab))
    return jspec.speculative_greedy_run(
        jt, CFG, jd, cfg_d, dc, SP, jnp.asarray(xt.numpy()), jnp.asarray(xd.numpy()),
        jnp.asarray(prompt.numpy(), jnp.int32), prompt.shape[1], sup, gamma=gamma)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX `speculative_greedy_run` for a self-draft and the unrelated
    draft (gamma 4, one compile), and over the int8 cache (self-draft, gamma
    3; the JAX package's K5 path in interpret mode)."""
    out = {(d, 4, False): _jax_run(setup, d, 4, jdec.DecodeConfig(**DC))
           for d in ("self", "unrelated")}
    out[("self", 3, True)] = _jax_run(setup, "self", 3, jdec.DecodeConfig(
        pallas_cross=True, quantize_cross_kv=True, **DC))
    return out


@pytest.mark.parametrize("draft,gamma,int8", [("self", 4, False), ("unrelated", 4, False),
                                              ("self", 3, True)],
                         ids=["self-g4", "unrelated-g4", "int8-self-g3"])
def test_tokens_and_rounds_match_jax(setup, jax_runs, draft, gamma, int8):
    ref, jrounds = jax_runs[(draft, gamma, int8)]
    dc = pdec.DecodeConfig(quantize_cross_kv=int8, **DC)
    got, rounds = _run(setup, draft, gamma, dc=dc)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    assert int(rounds) == int(jrounds)
    for name in ("sum_logprob", "avg_logprob", "token_probs", "no_speech_prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4, rtol=0)


def test_round_count_reflects_acceptance(setup):
    """A self-draft needs about max_tokens / gamma rounds, an unrelated
    draft about one round a token."""
    _, rounds_self = _run(setup, "self", 4)
    res_bad, rounds_bad = _run(setup, "unrelated", 4)
    max_len = int(setup[2].lengths.max())
    assert int(rounds_self) <= int(rounds_bad)
    assert int(rounds_self) <= max(-(-max_len // 4) + 2, 3)


def test_sim_accept_round_structure(setup):
    """`sim_accept` (a timing instrument) shapes the rounds: at 1.0 the
    ceiling of max_tokens / gamma rounds, fewer accepted at 0.5, and every
    row still emits the whole budget with eot suppressed."""
    rounds = {}
    for alpha in (1.0, 0.5):
        res, r = _run(setup, "unrelated", 4, suppress=_suppress(eot=True), sim_accept=alpha)
        rounds[alpha] = int(r)
        assert (res.lengths.numpy() == DC["max_tokens"]).all()
    assert rounds[1.0] == -(-DC["max_tokens"] // 4)
    assert rounds[0.5] > rounds[1.0]
    again, r = _run(setup, "unrelated", 4, suppress=_suppress(eot=True), sim_accept=0.5)
    assert int(r) == rounds[0.5]  # seeded per round: reproducible


def test_temperature_rejected(setup):
    dc = pdec.DecodeConfig(temperature=0.7, **DC)
    with pytest.raises(ValueError, match="temperature"):
        _run(setup, "self", 4, dc=dc)


def test_cancellation_polls_between_round_budgets(setup):
    """With an unrelated draft (about a token a round) and windows of two
    rounds, a cancel at the first poll stops the loop after two rounds."""
    polls = []

    def cancel():
        polls.append(True)
        return True

    res, rounds = _run(setup, "unrelated", 3, suppress=_suppress(eot=True),
                       is_cancelled=cancel, poll_rounds=2)
    assert polls, "is_cancelled was never polled"
    assert int(rounds) <= 2
    assert (res.lengths.numpy() < DC["max_tokens"]).all()


def test_per_row_step_grammar_matches_scalar():
    """`_prepare_logits` with an [N] step applies the first-token rule to
    the rows at step 0 only: each row equals the scalar-step call."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((3, CFG.n_vocab)).astype(np.float32))
    sup = _suppress()
    g = (torch.tensor([False, True, False]), torch.tensor([False, False, True]),
         torch.tensor([SP.timestamp_begin, SP.timestamp_begin + 5, SP.timestamp_begin + 2]),
         torch.tensor([False, True, True]))
    steps = torch.tensor([0, 3, 0])
    for ts in (True, False):
        dc = pdec.DecodeConfig(with_timestamps=ts, **DC)
        got = pdec._prepare_logits(logits, sup, SP, dc, steps, *g)
        for b, st in enumerate(steps.tolist()):
            want = pdec._prepare_logits(logits[b:b + 1], sup, SP, dc, st,
                                        *(x[b:b + 1] for x in g))
            np.testing.assert_array_equal(got[b].numpy(), want[0].numpy())
        dcj = jdec.DecodeConfig(with_timestamps=ts, **DC)
        want = jdec._prepare_logits(jnp.asarray(logits.numpy()), jnp.asarray(sup.numpy()), SP,
                                    dcj, jnp.asarray(steps.numpy(), jnp.int32),
                                    *(jnp.asarray(x.numpy()) for x in g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
