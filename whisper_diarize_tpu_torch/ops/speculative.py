"""Speculative greedy decoding (counterpart of
`whisper_diarize_tpu/ops/speculative.py`): a small draft Whisper proposes
tokens, the target verifies them in one teacher-forced pass.

The output is the target's own: every emitted token is the target's
prepared argmax (matched proposals only let several of them come out of one
pass), so for any draft the result equals `ops.decode.greedy_decode` up to
the reduction order of the S = gamma verify pass, which can flip an argmax
whose top two logits tie to the last rounding.

A round, all rows in lockstep at per-row positions
(`models/whisper.py::decode_step_pos`):
  1. the draft feeds [pending, p1 .. p_{gamma-1}] one token at a time and
     proposes p1 .. p_gamma by prepared argmax under the same timestamp
     grammar (K3 on every single-token step);
  2. the target feeds the same gamma tokens in one pass (K1 at Q = gamma,
     K5 over the int8 cache; K3 at gamma = 1) and gives its choices for the
     next gamma positions;
  3. position i emits the target's choice t_i while every earlier t_j
     matched p_{j+1}; the first mismatch emits t_i as the correction and
     ends the row's round. The last emitted token is the next round's
     `pending`; stale K/V of rejected proposals stays masked and is
     overwritten in place later.

The JAX `lax.while_loop` becomes a Python loop whose bookkeeping stays on
the device (`torch.where` over rows). The host reads only between budget
windows of `poll_rounds` rounds, for `finished.all()` and `is_cancelled()`;
a round after every row has finished changes nothing and does not count.
Spans (`tracing`): `decode.prefill`, a `decode.round` a round,
`decode.poll`, `decode.finalize`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import tracing
from ..models import whisper as wm
from ..tokenizer import SpecialTokens
from . import decode as dec

GRAMMAR = ("last_was_ts", "penult_was_ts", "max_ts_tok", "ts_seen")
SIM_SEED = 7  # `sim_accept`'s generator: seeded SIM_SEED + round


def _advance_grammar(g: Dict[str, torch.Tensor], tok: torch.Tensor,
                     active: torch.Tensor, sp: SpecialTokens) -> Dict[str, torch.Tensor]:
    """One-token timestamp-grammar update; rows where ~active keep their
    state (greedy_run's bookkeeping)."""
    is_ts = (tok >= sp.timestamp_begin) & active
    return dict(
        last_was_ts=torch.where(active, tok >= sp.timestamp_begin, g["last_was_ts"]),
        penult_was_ts=torch.where(active, g["last_was_ts"], g["penult_was_ts"]),
        max_ts_tok=torch.where(is_ts, torch.maximum(g["max_ts_tok"], tok), g["max_ts_tok"]),
        ts_seen=g["ts_seen"] | is_ts,
    )


def speculative_init(
    params_t, cfg_t: wm.WhisperConfig, params_d, cfg_d: wm.WhisperConfig,
    dc: dec.DecodeConfig, sp: SpecialTokens,
    xa_t: torch.Tensor,  # [B, Ta, D_t] target-encoded audio
    xa_d: torch.Tensor,  # [B, Ta, D_d] draft-encoded audio
    prompt: torch.Tensor,  # [B, P] int64 (uniform across rows)
    prompt_len: int,
    suppress_mask: torch.Tensor,  # [V]
    gamma: int = 4,
    sot_pos: int = 0,
    cross: Optional[Dict[str, torch.Tensor]] = None,  # target's, from build_cross_cache
) -> Dict[str, Any]:
    """Prefill both models and build the round loop's state: both self
    caches and cross caches (the target's `cross` when given, else
    `build_cross_cache`, int8 with `quantize_cross_kv`; the draft's by
    `cross_kv`, K2), token buffers and grammar flags. The first token comes
    from the target's prefill."""
    B = xa_t.shape[0]
    dev = xa_t.device
    max_steps = dec._max_steps(dc, cfg_t, prompt_len)
    cross_t = cross if cross is not None else dec.build_cross_cache(params_t, cfg_t, dc, xa_t)
    cross_d = wm.cross_kv(params_d, xa_d, cfg_d)
    tlen = min(cfg_t.n_text_ctx, -(-(prompt_len + max_steps + gamma + 2) // 16) * 16)
    cache_t = wm.init_self_cache(cfg_t, B, xa_t.dtype, dev, tlen)
    cache_d = wm.init_self_cache(cfg_d, B, xa_d.dtype, dev, tlen)
    # only sot and the last position of the target's prefill are read; the
    # draft's prefill only fills its cache
    P = prompt.shape[1]
    pos_at = (sot_pos,) if sot_pos == P - 1 else (sot_pos, P - 1)
    logits_t = wm.decode_step(params_t, cfg_t, prompt, 0, cache_t, cross_t, logits_at=pos_at)
    wm.decode_step(params_d, cfg_d, prompt, 0, cache_d, cross_d, logits_at=(P - 1,))
    no_speech_prob = torch.softmax(logits_t[:, 0], dim=-1)[:, sp.no_speech]

    g0 = dict(
        last_was_ts=torch.zeros((B,), dtype=torch.bool, device=dev),
        penult_was_ts=torch.zeros((B,), dtype=torch.bool, device=dev),
        max_ts_tok=torch.full((B,), sp.timestamp_begin, dtype=torch.long, device=dev),
        ts_seen=torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    l0 = dec._prepare_logits(logits_t[:, -1], suppress_mask, sp, dc, 0,
                             *(g0[k] for k in GRAMMAR))
    t0 = torch.argmax(l0, dim=-1)
    lp0 = l0.gather(1, t0[:, None])[:, 0] - torch.logsumexp(l0, dim=-1)
    fin0 = t0 == sp.eot  # the step-0 rules ban eot; stay defensive
    tokens = torch.full((B, max_steps), sp.eot, dtype=torch.long, device=dev)
    tokens[:, 0] = t0
    probs = torch.zeros((B, max_steps), dtype=torch.float32, device=dev)
    probs[:, 0] = torch.exp(lp0)
    return dict(
        it=0,  # rounds run, the host's count (budget windows)
        rounds=torch.zeros((), dtype=torch.long, device=dev),  # rounds with a live row
        n_emitted=torch.ones((B,), dtype=torch.long, device=dev),
        pending=t0,
        finished=fin0 | (max_steps <= 1),
        tokens=tokens, probs=probs,
        sum_logprob=lp0,
        length=torch.where(fin0, 0, 1),
        cache_t=cache_t, cache_d=cache_d, cross_t=cross_t, cross_d=cross_d,
        no_speech_prob=no_speech_prob,
        sim_gen=None,
        **_advance_grammar(g0, t0, torch.ones((B,), dtype=torch.bool, device=dev), sp),
    )


def speculative_run(
    params_t, cfg_t: wm.WhisperConfig, params_d, cfg_d: wm.WhisperConfig,
    dc: dec.DecodeConfig, sp: SpecialTokens, state: Dict[str, Any],
    suppress_mask: torch.Tensor, prompt_len: int,
    budget: int,  # stop once `state["it"]` reaches this
    gamma: int = 4,
    sim_accept: Optional[float] = None,
) -> Dict[str, Any]:
    """Advance the round loop (state updated in place) up to `budget`
    rounds in all; no host synchronisation inside.

    `sim_accept` is a timing instrument for `tools/bench_speculative.py`
    only: the draft / target agreement at each position is replaced by a
    Bernoulli(sim_accept) draw (a `torch.Generator` seeded SIM_SEED + round),
    so random weights can measure the round structure at a chosen
    acceptance rate. It breaks the output's exactness (a simulated match
    emits target tokens conditioned on a proposal the target did not
    choose)."""
    s = state
    B, max_steps = s["tokens"].shape
    dev = s["tokens"].device
    b_idx = torch.arange(B, device=dev)
    stop = min(max_steps, budget)
    while s["it"] < stop:
        with tracing.span("decode.round"):
            active = ~s["finished"]
            base = prompt_len + s["n_emitted"] - 1  # slot of `pending`, per row
            if sim_accept is not None:
                if s["sim_gen"] is None:
                    s["sim_gen"] = torch.Generator(device=dev)
                s["sim_gen"].manual_seed(SIM_SEED + s["it"])
                sim_u = torch.rand((B, gamma), generator=s["sim_gen"], device=dev)

            # 1. the draft proposes gamma tokens, one step at a time
            g_d = {k: s[k] for k in GRAMMAR}
            feed, props = s["pending"], []
            for i in range(gamma):
                ld = wm.decode_step_pos(params_d, cfg_d, feed[:, None], base + i,
                                        s["cache_d"], s["cross_d"])
                li = dec._prepare_logits(ld[:, 0], suppress_mask, sp, dc, s["n_emitted"] + i,
                                         *(g_d[k] for k in GRAMMAR))
                feed = torch.argmax(li, dim=-1)
                props.append(feed)
                g_d = _advance_grammar(g_d, feed, active, sp)

            # 2. the target verifies them in one pass
            feed_t = torch.stack([s["pending"]] + props[:gamma - 1], dim=1)
            lt = wm.decode_step_pos(params_t, cfg_t, feed_t, base, s["cache_t"], s["cross_t"])

            # 3. accept while matching; the first divergence emits the target's
            # correction and ends the row's round
            g = {k: s[k] for k in GRAMMAR}
            reach = active
            n_emit = torch.zeros_like(s["n_emitted"])
            for i in range(gamma):
                li = dec._prepare_logits(lt[:, i], suppress_mask, sp, dc, s["n_emitted"] + i,
                                         *(g[k] for k in GRAMMAR))
                ti = torch.argmax(li, dim=-1)
                lpi = li.gather(1, ti[:, None])[:, 0] - torch.logsumexp(li, dim=-1)
                idx = s["n_emitted"] + i
                emit = reach & (idx < max_steps)
                wr = torch.clamp(idx, max=max_steps - 1)
                s["tokens"][b_idx, wr] = torch.where(emit, ti, s["tokens"][b_idx, wr])
                s["probs"][b_idx, wr] = torch.where(emit, torch.exp(lpi), s["probs"][b_idx, wr])
                s["sum_logprob"] = s["sum_logprob"] + torch.where(emit, lpi, 0.0)
                is_eot = emit & (ti == sp.eot)
                s["length"] = s["length"] + (emit & ~is_eot).long()
                g = _advance_grammar(g, ti, emit, sp)
                s["pending"] = torch.where(emit, ti, s["pending"])
                n_emit = n_emit + emit.long()
                s["finished"] = s["finished"] | is_eot
                matched = ti == props[i] if sim_accept is None else sim_u[:, i] < sim_accept
                reach = reach & matched & ~is_eot & (idx + 1 < max_steps)

            s["n_emitted"] = s["n_emitted"] + n_emit
            s["finished"] = s["finished"] | (s["n_emitted"] >= max_steps)
            s.update(g)
            s["rounds"] = s["rounds"] + active.any().long()
            s["it"] += 1
    return s


def speculative_finalize(final: Dict[str, Any]) -> Tuple[dec.DecodeResult, torch.Tensor]:
    """(DecodeResult, rounds with a live row: a 0-d tensor)."""
    avg = final["sum_logprob"] / torch.clamp(final["length"] + 1, min=1).float()
    result = dec.DecodeResult(
        tokens=final["tokens"], lengths=final["length"],
        sum_logprob=final["sum_logprob"], avg_logprob=avg,
        token_probs=final["probs"], no_speech_prob=final["no_speech_prob"],
    )
    return result, final["rounds"]


def speculative_greedy_run(
    params_t, cfg_t: wm.WhisperConfig, params_d, cfg_d: wm.WhisperConfig,
    dc: dec.DecodeConfig, sp: SpecialTokens,
    xa_t: torch.Tensor, xa_d: torch.Tensor,
    prompt: torch.Tensor, prompt_len: int,
    suppress_mask: torch.Tensor,
    gamma: int = 4,
    sot_pos: int = 0,
    sim_accept: Optional[float] = None,
    is_cancelled=None,  # host callback polled every poll_rounds rounds
    poll_rounds: int = 8,
    cross: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[dec.DecodeResult, torch.Tensor]:
    """Prefill, rounds in windows of `poll_rounds` (the host checks
    `finished.all()` and `is_cancelled` between them), finalize. Returns
    (the DecodeResult `greedy_decode` gives, rounds run with a live row:
    emitted tokens / rounds is the mean acceptance)."""
    assert cfg_t.n_vocab == cfg_d.n_vocab, "draft must share the vocabulary"
    if dc.temperature != 0:
        raise ValueError(
            "speculative decoding is greedy/argmax-only: "
            f"DecodeConfig.temperature must be 0 (got {dc.temperature})")
    max_steps = dec._max_steps(dc, cfg_t, prompt_len)
    with tracing.span("decode.prefill"):
        state = speculative_init(params_t, cfg_t, params_d, cfg_d, dc, sp, xa_t, xa_d,
                                 prompt, prompt_len, suppress_mask, gamma=gamma,
                                 sot_pos=sot_pos, cross=cross)
    while state["it"] < max_steps:
        budget = min(state["it"] + max(poll_rounds, 1), max_steps)
        state = speculative_run(params_t, cfg_t, params_d, cfg_d, dc, sp, state,
                                suppress_mask, prompt_len, budget, gamma=gamma,
                                sim_accept=sim_accept)
        if dec.poll(state["finished"].all()) or (is_cancelled and is_cancelled()):
            break
    with tracing.span("decode.finalize"):
        return speculative_finalize(state)


def speculative_greedy_decode(
    params_t, cfg_t, params_d, cfg_d, dc, sp, xa_t, xa_d, prompt, prompt_len,
    suppress_mask: Optional[torch.Tensor] = None,
    gamma: int = 4,
    sot_pos: int = 0,
    is_cancelled=None,
    poll_rounds: int = 8,
    cross: Optional[Dict[str, torch.Tensor]] = None,
) -> dec.DecodeResult:
    """`speculative_greedy_run` with `greedy_decode`'s result contract."""
    if suppress_mask is None:
        suppress_mask = torch.from_numpy(
            dec.build_suppress_mask(sp, cfg_t.n_vocab)).to(xa_t.device)
    result, _ = speculative_greedy_run(
        params_t, cfg_t, params_d, cfg_d, dc, sp, xa_t, xa_d, prompt, prompt_len,
        suppress_mask, gamma=gamma, sot_pos=sot_pos, is_cancelled=is_cancelled,
        poll_rounds=poll_rounds, cross=cross)
    return result
