"""KV-cached greedy / temperature decoding (counterpart of the greedy half
of `whisper_diarize_tpu/ops/decode.py`).

The JAX `lax.while_loop` becomes a Python step loop on device tensors: each
step masks the logits with whisper's timestamp grammar, picks a token
(argmax, or Gumbel-max sampling from a `torch.Generator` when temperature
> 0), and runs one `decode_step` that updates the KV cache in place. The
host reads `finished.all()` only every `poll_tokens` steps; a step after
every row has finished writes eot and adds nothing, so the result equals
the JAX loop that stops on the spot.

`sample_best_of` folds the best_of candidates into the batch as beams that
share their stream's cross K/V (K1 and K3 take the beam-folded rows), where
the JAX package repeated the encoded audio per candidate; the candidates
are identical in distribution. Beam search is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from whisper_diarize_tpu.tokenizer import SpecialTokens

from ..models import whisper as wm

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decode configuration; the fields of the JAX package's DecodeConfig.
    The TPU-specific knobs (pallas_*, unroll_layers, mesh, int8) are kept
    for a shared surface, and the port refuses any value but the default:
    it always runs its CUDA kernels on CUDA tensors and their plain
    versions on CPU tensors, with a per-layer Python loop."""

    beam_size: int = 5  # beams for beam search / best_of for sampling
    temperature: float = 0.0
    max_tokens: int = 224
    suppress_blank: bool = True
    with_timestamps: bool = True
    max_initial_timestamp: float = 1.0
    patience: float = 1.0
    length_penalty: Optional[float] = None
    blank_id: int = 220
    quantize_cross_kv: bool = False
    pallas_cross: bool = False
    pallas_split: Optional[bool] = None
    pallas_tail: Optional[bool] = None
    quantize_tail_weights: bool = False
    unroll_layers: Optional[bool] = None
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.quantize_cross_kv or self.quantize_tail_weights:
            raise NotImplementedError(
                "int8 cross-K/V / tail weights are not ported yet "
                "(ROADMAP Queue 1 item 5, kernels K5/K6)")
        if self.mesh is not None:
            raise NotImplementedError(
                "device meshes are not ported yet (ROADMAP Queue 1 item 7)")
        for knob, default in (("pallas_cross", False), ("pallas_split", None),
                              ("pallas_tail", None), ("unroll_layers", None)):
            if getattr(self, knob) != default:
                raise ValueError(
                    f"DecodeConfig.{knob} selects a TPU kernel or loop form of "
                    "the JAX package and has no counterpart in the port, which "
                    "always runs its CUDA kernels on CUDA tensors; leave it at "
                    f"{default!r}")


@dataclasses.dataclass
class DecodeResult:
    """Per-stream decode output (tensors on the decode device)."""

    tokens: torch.Tensor  # [B, max_tokens] int64, eot-padded
    lengths: torch.Tensor  # [B] int64, valid tokens (pre-eot)
    sum_logprob: torch.Tensor  # [B] f32
    avg_logprob: torch.Tensor  # [B] f32 (includes the eot step)
    token_probs: torch.Tensor  # [B, max_tokens] f32
    no_speech_prob: torch.Tensor  # [B] f32


def build_suppress_mask(
    sp: SpecialTokens, n_vocab: int, extra_suppress: Optional[List[int]] = None
) -> np.ndarray:
    """Static additive mask [V]: -inf at always-suppressed tokens."""
    mask = np.zeros((n_vocab,), np.float32)
    always = [sp.sot, sp.sot_lm, sp.sot_prev, sp.no_speech, sp.no_timestamps,
              sp.translate, sp.transcribe]
    always += [sp.sot + 1 + i for i in range(sp.num_languages)]
    for t in list(always) + list(extra_suppress or []):
        if t < n_vocab:
            mask[t] = NEG_INF
    return mask


def _timestamp_rule_mask(
    logits: torch.Tensor,  # [N, V] f32
    sp: SpecialTokens,
    step: int,
    last_was_ts: torch.Tensor,  # [N] bool
    penult_was_ts: torch.Tensor,
    max_ts_tok: torch.Tensor,  # [N] int64
    ts_seen: torch.Tensor,  # [N] bool
    max_initial_ts_idx: int,
    extra_first_ban: Optional[torch.Tensor] = None,  # [V] bool, step-0 bans
) -> torch.Tensor:
    """Whisper's timestamp grammar as one fused ban (pair rule,
    monotonicity, first-token rule) and then the probability rule:
    timestamps only when logsumexp(ts) > max(text) on the masked logits."""
    V = logits.shape[-1]
    ids = torch.arange(V, device=logits.device)
    is_ts = ids >= sp.timestamp_begin
    force_text = last_was_ts & penult_was_ts
    force_ts = last_was_ts & ~penult_was_ts
    strict = ~(last_was_ts & ~penult_was_ts)
    min_allowed = torch.where(
        ts_seen, max_ts_tok + strict.long(),
        torch.full_like(max_ts_tok, sp.timestamp_begin))
    banned = force_text[:, None] & is_ts[None, :]
    banned |= force_ts[:, None] & (ids < sp.eot)[None, :]
    banned |= is_ts[None, :] & (ids[None, :] < min_allowed[:, None])
    if step == 0:
        first_ban = ~is_ts | (ids > sp.timestamp_begin + max_initial_ts_idx)
        if extra_first_ban is not None:
            first_ban = first_ban | extra_first_ban
        banned |= first_ban[None, :]
    logits = logits.masked_fill(banned, NEG_INF)
    ts_lse = torch.logsumexp(logits[:, sp.timestamp_begin:], dim=-1)
    max_text = logits[:, : sp.timestamp_begin].amax(dim=-1)
    force = ts_lse > max_text
    return logits.masked_fill(force[:, None] & ~is_ts[None, :], NEG_INF)


def _prepare_logits(
    raw_logits: torch.Tensor,  # [N, V]
    suppress_mask: torch.Tensor,  # [V]
    sp: SpecialTokens,
    dc: DecodeConfig,
    step: int,
    last_was_ts, penult_was_ts, max_ts_tok, ts_seen,
) -> torch.Tensor:
    logits = raw_logits + suppress_mask[None, :]
    V = logits.shape[-1]
    ids = torch.arange(V, device=logits.device)
    blank_ban = ((ids == dc.blank_id) | (ids == sp.eot)) if dc.suppress_blank else None
    if dc.with_timestamps:
        return _timestamp_rule_mask(
            logits, sp, step, last_was_ts, penult_was_ts, max_ts_tok, ts_seen,
            int(round(dc.max_initial_timestamp / 0.02)), extra_first_ban=blank_ban)
    banned = ids >= sp.timestamp_begin
    if blank_ban is not None and step == 0:
        banned = banned | blank_ban
    return logits.masked_fill(banned[None, :], NEG_INF)


def build_cross_cache(params, cfg: wm.WhisperConfig, xa: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Cross K/V [L, B, H, Ta, Dh] of every layer (K2)."""
    return wm.cross_kv(params, xa, cfg)


def _max_steps(dc: DecodeConfig, cfg: wm.WhisperConfig, prompt_len: int) -> int:
    return min(dc.max_tokens, cfg.n_text_ctx - prompt_len - 1)


def greedy_init(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    xa: torch.Tensor,  # [B, Ta, D] encoded audio
    prompt: torch.Tensor,  # [B, P] int64
    prompt_len: int,
    generator: Optional[torch.Generator] = None,  # temperature > 0
    suppress_mask: Optional[torch.Tensor] = None,
    sot_pos: int = 0,
    row_pad: Optional[torch.Tensor] = None,  # [B]
    beams: int = 1,
    cross: Optional[Dict[str, torch.Tensor]] = None,  # from build_cross_cache
) -> Dict[str, Any]:
    """Build the cross cache (unless given one of `xa`), prefill the prompt
    and return the loop state. With `beams > 1` every stream decodes
    `beams` candidate rows (rows b * beams .. b * beams + beams - 1) over
    its one cross K/V."""
    B = xa.shape[0]
    N = B * beams
    dev = xa.device
    max_steps = _max_steps(dc, cfg, prompt_len)
    if suppress_mask is None:
        suppress_mask = torch.from_numpy(build_suppress_mask(sp, cfg.n_vocab)).to(dev)
    if generator is None:  # JAX's default PRNGKey(0) counterpart
        generator = torch.Generator(device=dev).manual_seed(0)
    if beams > 1:
        prompt = prompt.repeat_interleave(beams, dim=0)
        row_pad = row_pad.repeat_interleave(beams, dim=0) if row_pad is not None else None
    if cross is None:
        cross = build_cross_cache(params, cfg, xa)
    # cache sized to the decode budget, 16-aligned
    cache_len = min(cfg.n_text_ctx, -(-(prompt_len + max_steps + 1) // 16) * 16)
    cache = wm.init_self_cache(cfg, N, xa.dtype, dev, cache_len)
    P = prompt.shape[1]
    pos_at = (sot_pos,) if sot_pos == P - 1 else (sot_pos, P - 1)
    logits_all = wm.decode_step(params, cfg, prompt, 0, cache, cross, beams=beams,
                                row_pad=row_pad, logits_at=pos_at)
    no_speech_prob = torch.softmax(logits_all[:, 0], dim=-1)[:, sp.no_speech]
    return dict(
        step=0,
        beams=beams,
        logits=logits_all[:, -1],
        cache=cache,
        cross=cross,
        tokens=torch.full((N, max_steps), sp.eot, dtype=torch.long, device=dev),
        probs=torch.zeros((N, max_steps), dtype=torch.float32, device=dev),
        sum_logprob=torch.zeros((N,), dtype=torch.float32, device=dev),
        length=torch.zeros((N,), dtype=torch.long, device=dev),
        finished=torch.zeros((N,), dtype=torch.bool, device=dev),
        last_was_ts=torch.zeros((N,), dtype=torch.bool, device=dev),
        penult_was_ts=torch.zeros((N,), dtype=torch.bool, device=dev),
        max_ts_tok=torch.full((N,), sp.timestamp_begin, dtype=torch.long, device=dev),
        ts_seen=torch.zeros((N,), dtype=torch.bool, device=dev),
        generator=generator,
        no_speech_prob=no_speech_prob,
        row_pad=row_pad,
    )


def greedy_run(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    state: Dict[str, Any], suppress_mask: torch.Tensor, prompt_len: int,
    budget: int,
) -> Dict[str, Any]:
    """Advance the loop (state updated in place) until `budget` total steps
    or the token budget; no host synchronisation inside."""
    s = state
    eot = sp.eot
    stop = min(_max_steps(dc, cfg, prompt_len), budget)
    while s["step"] < stop:
        step = s["step"]
        logits = _prepare_logits(
            s["logits"], suppress_mask, sp, dc, step,
            s["last_was_ts"], s["penult_was_ts"], s["max_ts_tok"], s["ts_seen"])
        lse = torch.logsumexp(logits, dim=-1)
        if dc.temperature > 0:
            # Gumbel-max: argmax(logits / T + G) samples softmax(logits / T)
            u = torch.rand(logits.shape, generator=s["generator"], device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
            next_tok = torch.argmax(logits / dc.temperature + gumbel, dim=-1)
        else:
            next_tok = torch.argmax(logits, dim=-1)
        tok_logprob = logits.gather(1, next_tok[:, None])[:, 0] - lse
        was_finished = s["finished"]
        next_tok = torch.where(was_finished, torch.full_like(next_tok, eot), next_tok)
        now_finished = was_finished | (next_tok == eot)
        s["tokens"][:, step] = next_tok
        s["probs"][:, step] = torch.where(was_finished, 0.0, torch.exp(tok_logprob))
        s["sum_logprob"] = s["sum_logprob"] + torch.where(was_finished, 0.0, tok_logprob)
        s["length"] = s["length"] + (~now_finished).long()
        is_ts = next_tok >= sp.timestamp_begin
        live_ts = is_ts & ~was_finished
        s["penult_was_ts"] = torch.where(was_finished, s["penult_was_ts"], s["last_was_ts"])
        s["last_was_ts"] = torch.where(was_finished, s["last_was_ts"], is_ts)
        s["max_ts_tok"] = torch.where(
            live_ts, torch.maximum(s["max_ts_tok"], next_tok), s["max_ts_tok"])
        s["ts_seen"] = s["ts_seen"] | live_ts
        s["finished"] = now_finished
        logits_next = wm.decode_step(
            params, cfg, next_tok[:, None], prompt_len + step, s["cache"],
            s["cross"], beams=s["beams"], row_pad=s["row_pad"])
        s["logits"] = logits_next[:, 0]
        s["step"] = step + 1
    return s


def greedy_finalize(state: Dict[str, Any]) -> DecodeResult:
    length = state["length"]
    avg = state["sum_logprob"] / torch.clamp(length + 1, min=1).float()
    return DecodeResult(
        tokens=state["tokens"], lengths=length,
        sum_logprob=state["sum_logprob"], avg_logprob=avg,
        token_probs=state["probs"], no_speech_prob=state["no_speech_prob"],
    )


def greedy_decode(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    xa: torch.Tensor, prompt: torch.Tensor, prompt_len: int,
    generator: Optional[torch.Generator] = None,
    suppress_mask: Optional[torch.Tensor] = None,
    sot_pos: int = 0,
    is_cancelled=None,  # host callback polled every poll_tokens steps
    poll_tokens: int = 32,
    row_pad: Optional[torch.Tensor] = None,
    beams: int = 1,
    cross: Optional[Dict[str, torch.Tensor]] = None,
) -> DecodeResult:
    """Greedy / temperature sampling. The host checks `finished.all()` (and
    `is_cancelled`) between windows of `poll_tokens` steps."""
    if suppress_mask is None:
        suppress_mask = torch.from_numpy(
            build_suppress_mask(sp, cfg.n_vocab)).to(xa.device)
    state = greedy_init(params, cfg, dc, sp, xa, prompt, prompt_len,
                        generator=generator, suppress_mask=suppress_mask,
                        sot_pos=sot_pos, row_pad=row_pad, beams=beams,
                        cross=cross)
    max_steps = _max_steps(dc, cfg, prompt_len)
    while state["step"] < max_steps:
        budget = min(state["step"] + max(poll_tokens, 1), max_steps)
        state = greedy_run(params, cfg, dc, sp, state, suppress_mask,
                           prompt_len, budget)
        if bool(state["finished"].all()) or (is_cancelled and is_cancelled()):
            break
    return greedy_finalize(state)


def sample_best_of(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    xa: torch.Tensor, prompt: torch.Tensor, prompt_len: int,
    best_of: int = 5,
    generator: Optional[torch.Generator] = None,
    suppress_mask: Optional[torch.Tensor] = None,
    sot_pos: int = 0,
    row_pad: Optional[torch.Tensor] = None,
    cross: Optional[Dict[str, torch.Tensor]] = None,
) -> DecodeResult:
    """Temperature sampling with `best_of` candidates per stream, keeping
    the one with the highest average log-probability (openai-whisper's
    GreedyDecoder(n_group=best_of) on the fallback ladder)."""
    if best_of <= 1 or dc.temperature <= 0:
        return greedy_decode(params, cfg, dc, sp, xa, prompt, prompt_len,
                             generator=generator, suppress_mask=suppress_mask,
                             sot_pos=sot_pos, row_pad=row_pad, cross=cross)
    B = xa.shape[0]
    res = greedy_decode(params, cfg, dc, sp, xa, prompt, prompt_len,
                        generator=generator, suppress_mask=suppress_mask,
                        sot_pos=sot_pos, row_pad=row_pad, beams=best_of,
                        cross=cross)
    best = torch.argmax(res.avg_logprob.view(B, best_of), dim=-1)  # [B]
    rows = torch.arange(B, device=xa.device) * best_of + best

    return DecodeResult(**{
        f.name: getattr(res, f.name)[rows] for f in dataclasses.fields(DecodeResult)})


def detect_language(params, cfg: wm.WhisperConfig, sp: SpecialTokens,
                    xa: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Language ID: (lang_index [B], probs [B, num_languages])."""
    logits = wm.detect_language_logits(params, cfg, xa, sp.sot)
    lang_logits = logits[:, sp.sot + 1: sp.sot + 1 + sp.num_languages]
    return torch.argmax(lang_logits, dim=-1), torch.softmax(lang_logits, dim=-1)
