"""KV-cached greedy / temperature decoding and beam search (counterpart of
`whisper_diarize_tpu/ops/decode.py`).

The JAX `lax.while_loop` becomes a Python step loop on device tensors: each
step masks the logits with whisper's timestamp grammar, picks a token
(argmax, or Gumbel-max sampling when temperature > 0, from a
`prng.Threefry` stream: the JAX package's random bits), and runs one
`decode_step` that updates the KV cache in place. The host reads
`finished.all()` only every `poll_tokens` steps; a step after every row has
finished writes eot and adds nothing, so the result equals the JAX loop
that stops on the spot.

`sample_best_of` folds the best_of candidates into the batch as beams that
share their stream's cross K/V (K1 and K3 take the beam-folded rows), where
the JAX package repeated the encoded audio per candidate; the candidates
are identical in distribution.

Beam search (`beam_decode`) keeps the JAX package's algorithm: the prompt
prefilled once per stream, the split self-cache read through an ancestry
map on K4 (`models/whisper.py::decode_step_split`), the exact two-stage
top-2K in `jax.lax.top_k`'s tie order, vectorised EOT retirement into K
finished slots, the patience target, and ranking by average
log-probability or the length penalty.

Meshes (`DecodeConfig.mesh`, a `parallel/mesh.py::Mesh`): every rank calls
the decode with its own rows (`xa`, `prompt`, `row_pad`: its data slice of
the batch) and the whole batch's result comes back, all-gathered over the
data group after the loop. Ranks of one model group share rows and so take
every step together (their collectives stay in lockstep); data ranks stop on
their own. Sampling draws the whole batch's noise on every rank from the
same generator and takes the rank's rows, so a mesh samples what one device
samples.

Every loop carries the cross cache it is given, bf16 or int8
(`DecodeConfig.quantize_cross_kv`, `build_cross_cache`); `decode_step`
picks the kernels from its kind. The greedy loops also carry the int8 tail
weights they are given (`tail_q8`, which `TranscribeStep` builds with
`quantize_tail_weights`); beam search never takes them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import whisper as wm
from ..parallel.mesh import data_parallel, gather_data
from ..tokenizer import SpecialTokens
from .prng import Threefry

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decode configuration; the fields of the JAX package's DecodeConfig.
    `quantize_cross_kv` decodes over the int8 cross cache (K5 at the prompt
    pass, K6 at every step); `quantize_tail_weights` streams int8 tail
    weights through K6 where `TranscribeStep` attaches them (strategies other
    than beam search, as in the JAX package). `mesh` is the rank's
    `parallel/mesh.py::Mesh` (see the module docstring). The TPU-specific
    knobs (pallas_*, unroll_layers) are kept for a shared surface, and the
    port refuses any value but the default: it always runs its CUDA kernels
    on CUDA tensors and their plain versions on CPU tensors, with a
    per-layer Python loop."""

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


def _first_rows(step):
    """The rows at their first sampled token, as a mask that broadcasts
    against [N, V]: True for an int step 0, None for any other int, and
    `step == 0` per row [N, 1] for a tensor."""
    if isinstance(step, torch.Tensor):
        return (step == 0)[:, None]
    return True if step == 0 else None


def _timestamp_rule_mask(
    logits: torch.Tensor,  # [N, V] f32
    sp: SpecialTokens,
    step,  # int, or [N] (speculative rows sit at different sampled indices)
    last_was_ts: torch.Tensor,  # [N] bool
    penult_was_ts: torch.Tensor,
    max_ts_tok: torch.Tensor,  # [N] int64
    ts_seen: torch.Tensor,  # [N] bool
    max_initial_ts_idx: int,
    extra_first_ban: Optional[torch.Tensor] = None,  # [V] bool, step-0 bans
) -> torch.Tensor:
    """Whisper's timestamp grammar as one fused ban (pair rule,
    monotonicity, first-token rule) and then the probability rule:
    timestamps only when logsumexp(ts) > max(text) on the masked logits.
    The first-token rule applies where `step` is 0: to every row for an
    int, per row (a mask, no host read) for an [N] tensor."""
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
    first = _first_rows(step)
    if first is not None:
        first_ban = ~is_ts | (ids > sp.timestamp_begin + max_initial_ts_idx)
        if extra_first_ban is not None:
            first_ban = first_ban | extra_first_ban
        banned |= first & first_ban[None, :]
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
    step,  # int, or [N] per row
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
    banned = (ids >= sp.timestamp_begin)[None, :]
    first = _first_rows(step)
    if blank_ban is not None and first is not None:
        banned = banned | (first & blank_ban[None, :])
    return logits.masked_fill(banned, NEG_INF)


def _gather(res: DecodeResult, mesh) -> DecodeResult:
    """The whole batch's result from every data rank's rows."""
    if not data_parallel(mesh):
        return res
    return DecodeResult(**{f.name: gather_data(getattr(res, f.name), mesh)
                           for f in dataclasses.fields(DecodeResult)})


def _gumbel(shape, generator: Threefry, device, mesh) -> torch.Tensor:
    """Gumbel noise of the rank's rows, the JAX package's bits (the stream's
    key split once a step): under a data split the whole batch's draw, of
    which the rank takes its own rows."""
    full = shape if not data_parallel(mesh) else (shape[0] * mesh.n_data,) + tuple(shape[1:])
    g = generator.gumbel(full, device)
    if not data_parallel(mesh):
        return g
    n = shape[0]
    return g[mesh.data_rank * n:(mesh.data_rank + 1) * n]


def build_cross_cache(params, cfg: wm.WhisperConfig, dc: DecodeConfig,
                      xa: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The decode's cross K/V of every layer (K2), in the form `dc` selects:
    bf16 {"k", "v"}, or with `quantize_cross_kv` the int8 cache
    {"k8", "ks", "v8", "vs"} (`models/whisper.py::quantize_cross_cache`)."""
    return wm.cross_kv(params, xa, cfg, quantize=dc.quantize_cross_kv)


def _max_steps(dc: DecodeConfig, cfg: wm.WhisperConfig, prompt_len: int) -> int:
    return min(dc.max_tokens, cfg.n_text_ctx - prompt_len - 1)


def greedy_init(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    xa: torch.Tensor,  # [B, Ta, D] encoded audio
    prompt: torch.Tensor,  # [B, P] int64
    prompt_len: int,
    generator: Optional[Threefry] = None,  # temperature > 0
    suppress_mask: Optional[torch.Tensor] = None,
    sot_pos: int = 0,
    row_pad: Optional[torch.Tensor] = None,  # [B]
    beams: int = 1,
    cross: Optional[Dict[str, torch.Tensor]] = None,  # from build_cross_cache
    tail_q8: Optional[Dict[str, torch.Tensor]] = None,  # int8 tail weights
) -> Dict[str, Any]:
    """Build the cross cache (unless given one of `xa`, bf16 or int8, which
    the loop then carries as it is), prefill the prompt and return the loop
    state. With `beams > 1` every stream decodes `beams` candidate rows
    (rows b * beams .. b * beams + beams - 1) over its one cross K/V.
    `tail_q8` (from `ops/tail.py::quantize_tail_weights`) runs every
    single-token step's layer tails on int8 weights."""
    B = xa.shape[0]
    N = B * beams
    dev = xa.device
    max_steps = _max_steps(dc, cfg, prompt_len)
    if suppress_mask is None:
        suppress_mask = torch.from_numpy(build_suppress_mask(sp, cfg.n_vocab)).to(dev)
    if generator is None:  # JAX's default PRNGKey(0)
        generator = Threefry(0)
    if beams > 1:
        prompt = prompt.repeat_interleave(beams, dim=0)
        row_pad = row_pad.repeat_interleave(beams, dim=0) if row_pad is not None else None
    if cross is None:
        cross = build_cross_cache(params, cfg, dc, xa)
    # cache sized to the decode budget, 16-aligned
    cache_len = min(cfg.n_text_ctx, -(-(prompt_len + max_steps + 1) // 16) * 16)
    cache = wm.init_self_cache(cfg, N, xa.dtype, dev, cache_len,
                               n_head=wm.local_heads(params, cfg))
    P = prompt.shape[1]
    pos_at = (sot_pos,) if sot_pos == P - 1 else (sot_pos, P - 1)
    logits_all = wm.decode_step(params, cfg, prompt, 0, cache, cross, beams=beams,
                                row_pad=row_pad, logits_at=pos_at, mesh=dc.mesh)
    no_speech_prob = torch.softmax(logits_all[:, 0], dim=-1)[:, sp.no_speech]
    return dict(
        step=0,
        beams=beams,
        logits=logits_all[:, -1],
        cache=cache,
        cross=cross,
        tail_q8=tail_q8,
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
            gumbel = _gumbel(logits.shape, s["generator"], logits.device, dc.mesh)
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
            s["cross"], beams=s["beams"], row_pad=s["row_pad"], tail_q8=s["tail_q8"],
            mesh=dc.mesh)
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
    generator: Optional[Threefry] = None,
    suppress_mask: Optional[torch.Tensor] = None,
    sot_pos: int = 0,
    is_cancelled=None,  # host callback polled every poll_tokens steps
    poll_tokens: int = 32,
    row_pad: Optional[torch.Tensor] = None,
    beams: int = 1,
    cross: Optional[Dict[str, torch.Tensor]] = None,
    tail_q8: Optional[Dict[str, torch.Tensor]] = None,
) -> DecodeResult:
    """Greedy / temperature sampling. The host checks `finished.all()` (and
    `is_cancelled`) between windows of `poll_tokens` steps. Under
    `dc.mesh`, the rank's rows in and the whole batch out."""
    if suppress_mask is None:
        suppress_mask = torch.from_numpy(
            build_suppress_mask(sp, cfg.n_vocab)).to(xa.device)
    state = greedy_init(params, cfg, dc, sp, xa, prompt, prompt_len,
                        generator=generator, suppress_mask=suppress_mask,
                        sot_pos=sot_pos, row_pad=row_pad, beams=beams,
                        cross=cross, tail_q8=tail_q8)
    max_steps = _max_steps(dc, cfg, prompt_len)
    while state["step"] < max_steps:
        budget = min(state["step"] + max(poll_tokens, 1), max_steps)
        state = greedy_run(params, cfg, dc, sp, state, suppress_mask,
                           prompt_len, budget)
        if bool(state["finished"].all()) or (is_cancelled and is_cancelled()):
            break
    return _gather(greedy_finalize(state), dc.mesh)


def sample_best_of(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    xa: torch.Tensor, prompt: torch.Tensor, prompt_len: int,
    best_of: int = 5,
    generator: Optional[Threefry] = None,
    suppress_mask: Optional[torch.Tensor] = None,
    sot_pos: int = 0,
    row_pad: Optional[torch.Tensor] = None,
    cross: Optional[Dict[str, torch.Tensor]] = None,
    tail_q8: Optional[Dict[str, torch.Tensor]] = None,
) -> DecodeResult:
    """Temperature sampling with `best_of` candidates per stream, keeping
    the one with the highest average log-probability (openai-whisper's
    GreedyDecoder(n_group=best_of) on the fallback ladder)."""
    if best_of <= 1 or dc.temperature <= 0:
        return greedy_decode(params, cfg, dc, sp, xa, prompt, prompt_len,
                             generator=generator, suppress_mask=suppress_mask,
                             sot_pos=sot_pos, row_pad=row_pad, cross=cross,
                             tail_q8=tail_q8)
    res = greedy_decode(params, cfg, dc, sp, xa, prompt, prompt_len,
                        generator=generator, suppress_mask=suppress_mask,
                        sot_pos=sot_pos, row_pad=row_pad, beams=best_of,
                        cross=cross, tail_q8=tail_q8)
    B = res.avg_logprob.shape[0] // best_of  # the whole batch under a mesh
    best = torch.argmax(res.avg_logprob.view(B, best_of), dim=-1)  # [B]
    rows = torch.arange(B, device=xa.device) * best_of + best

    return DecodeResult(**{
        f.name: getattr(res, f.name)[rows] for f in dataclasses.fields(DecodeResult)})


# --------------------------------------------------------------------------
# Beam search
# --------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index: `jax.lax.top_k`'s order, which `torch.topk`
    does not promise. Ties do occur, at -inf (beams 1..K-1 start at -inf,
    EOT candidates are set to -inf before the keep-top-K)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _n_fin_target(dc: DecodeConfig) -> int:
    K = dc.beam_size
    return min(int(np.ceil(K * dc.patience)) if dc.patience > 0 else K, K)


def _retire_eot_candidates(
    sp: SpecialTokens,
    K: int,
    topv: torch.Tensor,  # [B, 2K] candidate scores, sorted descending
    tok_idx: torch.Tensor,  # [B, 2K] candidate token ids
    src_flat: torch.Tensor,  # [B, 2K] flat source-beam row per candidate
    tokens: torch.Tensor,  # [N, T] active-beam token buffers
    probs: torch.Tensor,  # [N, T]
    length: torch.Tensor,  # [N]
    fin_tokens, fin_probs, fin_scores, fin_lengths, fin_count,
):
    """Retire this step's EOT candidates into the finished slots, vectorised:
    the j-th finite EOT candidate (score order) goes to slot fin_count + j;
    overflow beyond the K slots is dropped."""
    retirable = (tok_idx == sp.eot) & torch.isfinite(topv)  # [B, 2K]
    rank = torch.cumsum(retirable.long(), dim=1) - 1
    write_pos = fin_count[:, None] + rank  # [B, 2K] target slot
    valid = retirable & (write_pos < K)
    # slot k's candidate: W[b, c, k] has at most one True along c
    W = valid[:, :, None] & (
        write_pos[:, :, None] == torch.arange(K, device=topv.device)[None, None, :])
    taken = W.any(dim=1)  # [B, K]
    cidx = torch.argmax(W.to(torch.uint8), dim=1)  # [B, K] (first True; 0 if none)
    bsrc = torch.gather(src_flat, 1, cidx)  # [B, K] source row
    fin_tokens = torch.where(taken[:, :, None], tokens[bsrc], fin_tokens)
    fin_probs = torch.where(taken[:, :, None], probs[bsrc], fin_probs)
    fin_scores = torch.where(taken, torch.gather(topv, 1, cidx), fin_scores)
    fin_lengths = torch.where(taken, length[bsrc], fin_lengths)
    fin_count = fin_count + valid.sum(dim=1)
    return fin_tokens, fin_probs, fin_scores, fin_lengths, fin_count


def beam_init(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    xa: torch.Tensor,  # [B, Ta, D]
    prompt: torch.Tensor,  # [B, P] int64
    prompt_len: int,
    sot_pos: int = 0,
    row_pad: Optional[torch.Tensor] = None,  # [B]
    cross: Optional[Dict[str, torch.Tensor]] = None,  # from build_cross_cache
) -> Dict[str, Any]:
    """Prefill the prompt once per stream and build the beam-search state.
    The cross K/V (built here unless given; bf16 or int8, carried as it is)
    and the prompt half of the split self-cache have B rows, shared by each
    stream's K beams; only the decode half [L, B*K, H, Td, Dh] is per beam."""
    B = xa.shape[0]
    K = dc.beam_size
    N = B * K
    dev = xa.device
    max_steps = _max_steps(dc, cfg, prompt_len)
    if cross is None:
        cross = build_cross_cache(params, cfg, dc, xa)
    H = wm.local_heads(params, cfg)
    prompt_cache = wm.init_self_cache(cfg, B, xa.dtype, dev, prompt_len, n_head=H)
    P = prompt.shape[1]
    pos_at = (sot_pos,) if sot_pos == P - 1 else (sot_pos, P - 1)
    logits_all = wm.decode_step(params, cfg, prompt, 0, prompt_cache, cross,
                                row_pad=row_pad, logits_at=pos_at, mesh=dc.mesh)
    td = min(cfg.n_text_ctx, -(-max_steps // 16) * 16)
    # the per-beam decode half [L, N, H, Td, Dh] (JAX: init_split_decode_cache)
    decode_cache = wm.init_self_cache(cfg, N, xa.dtype, dev, td, n_head=H)
    if row_pad is None:
        row_pad = torch.zeros((B,), dtype=torch.long, device=dev)
    # beam 0 starts at 0, the rest at -inf so the first expansion does not
    # produce K duplicates
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0

    def zeros(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return dict(
        step=0,
        logits=logits_all[:, -1].repeat_interleave(K, dim=0),  # [N, V]
        cache={"pk": prompt_cache["k"], "pv": prompt_cache["v"],
               "dk": decode_cache["k"], "dv": decode_cache["v"]},
        anc=torch.arange(N, device=dev)[:, None].repeat(1, td),
        cross=cross,
        no_speech_prob=torch.softmax(logits_all[:, 0], dim=-1)[:, sp.no_speech],
        tokens=torch.full((N, max_steps), sp.eot, dtype=torch.long, device=dev),
        probs=zeros(N, max_steps, dtype=torch.float32),
        scores=scores.view(N),
        length=zeros(N),
        last_was_ts=zeros(N, dtype=torch.bool),
        penult_was_ts=zeros(N, dtype=torch.bool),
        max_ts_tok=torch.full((N,), sp.timestamp_begin, dtype=torch.long, device=dev),
        ts_seen=zeros(N, dtype=torch.bool),
        fin_tokens=torch.full((B, K, max_steps), sp.eot, dtype=torch.long, device=dev),
        fin_probs=zeros(B, K, max_steps, dtype=torch.float32),
        fin_scores=torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev),
        fin_lengths=zeros(B, K),
        fin_count=zeros(B),
        row_pad=row_pad.repeat_interleave(K, dim=0),  # [N], constant per stream
    )


def beam_run(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    state: Dict[str, Any], suppress_mask: torch.Tensor, prompt_len: int,
    budget: int,
) -> Dict[str, Any]:
    """Advance the beam search (state updated in place) until `budget`
    total steps or the token budget; no host synchronisation inside.

    The JAX loop stops on the step where every stream holds the patience
    target of finished hypotheses; here the host looks only between calls.
    So from that step on the finished slots freeze (each step's retirement
    is masked on the device), and `beam_finalize`, which then reads only
    those slots, gives what the JAX loop gives."""
    s = state
    B, K, _ = s["fin_tokens"].shape
    N = B * K
    V = cfg.n_vocab
    dev = s["scores"].device
    target = _n_fin_target(dc)
    rows = torch.arange(N, device=dev)
    stop = min(_max_steps(dc, cfg, prompt_len), budget)
    while s["step"] < stop:
        step = s["step"]
        live = ~(s["fin_count"] >= target).all()  # JAX's loop condition
        logits = _prepare_logits(
            s["logits"], suppress_mask, sp, dc, step,
            s["last_was_ts"], s["penult_was_ts"], s["max_ts_tok"], s["ts_seen"])
        # exact two-stage top-2K: per beam over V, then pooled over K * 2K
        # (a global top-2K candidate is inside its own beam's top-2K); the
        # per-row order equals the logits' order, so only the 2K selected
        # values get the score and normaliser
        lse = torch.logsumexp(logits, dim=-1)
        v1, i1 = _top_k(logits, 2 * K)
        v1 = (v1 - lse[:, None] + s["scores"][:, None]).view(B, 2 * K * K)
        i1 = (i1 + (rows % K)[:, None] * V).view(B, 2 * K * K)
        topv, sel = _top_k(v1, 2 * K)  # [B, 2K]
        topi = torch.gather(i1, 1, sel)
        tok_idx = topi % V
        src_flat = torch.arange(B, device=dev)[:, None] * K + topi // V

        fin = _retire_eot_candidates(
            sp, K, topv, tok_idx, src_flat, s["tokens"], s["probs"], s["length"],
            s["fin_tokens"], s["fin_probs"], s["fin_scores"], s["fin_lengths"],
            s["fin_count"])
        for key, new in zip(("fin_tokens", "fin_probs", "fin_scores",
                             "fin_lengths", "fin_count"), fin):
            s[key] = torch.where(live, new, s[key])

        # keep the top-K non-EOT candidates as the new active beams
        active = topv.masked_fill(tok_idx == sp.eot, NEG_INF)
        keepv, keepi = _top_k(active, K)
        new_tok = torch.gather(tok_idx, 1, keepi).view(N)
        new_src = torch.gather(src_flat, 1, keepi).view(N)
        new_scores = keepv.reshape(N)
        tok_logprob = new_scores - s["scores"][new_src]
        s["tokens"] = s["tokens"][new_src]
        s["tokens"][:, step] = new_tok
        s["probs"] = s["probs"][new_src]
        s["probs"][:, step] = torch.exp(tok_logprob)
        s["length"] = s["length"][new_src] + 1
        is_ts = new_tok >= sp.timestamp_begin
        s["penult_was_ts"] = s["last_was_ts"][new_src]
        s["last_was_ts"] = is_ts
        max_ts = s["max_ts_tok"][new_src]
        s["max_ts_tok"] = torch.where(is_ts, torch.maximum(max_ts, new_tok), max_ts)
        s["ts_seen"] = s["ts_seen"][new_src] | is_ts
        s["scores"] = new_scores
        # the decode cache is never permuted: the ancestry map follows the
        # surviving beams and K4 reads each beam's rows through it
        s["anc"] = s["anc"][new_src]
        s["anc"][:, step] = rows
        c = s["cache"]
        logits_next = wm.decode_step_split(
            params, cfg, new_tok[:, None], step, {"k": c["pk"], "v": c["pv"]},
            {"k": c["dk"], "v": c["dv"]}, s["cross"], prompt_len, K,
            s["row_pad"], s["anc"], mesh=dc.mesh)
        s["logits"] = logits_next[:, 0]
        s["step"] = step + 1
    return s


def beam_finalize(dc: DecodeConfig, final: Dict[str, Any]) -> DecodeResult:
    """Each stream's hypothesis: the best finished slot by the ranking
    (average log-probability sum / (len + 1), or the length penalty
    ((5 + len) / 6) ** alpha), or its best active beam when none finished."""
    B, K, _ = final["fin_tokens"].shape
    act_scores = final["scores"].view(B, K)
    act_best = torch.argmax(act_scores, dim=-1)
    fin_lengths = final["fin_lengths"]
    if dc.length_penalty is None:
        fin_rank = final["fin_scores"] / torch.clamp(fin_lengths + 1, min=1).float()
    else:
        penalty = ((5.0 + fin_lengths.float()) / 6.0) ** dc.length_penalty
        fin_rank = final["fin_scores"] / torch.clamp(penalty, min=1e-6)
    fin_best = torch.argmax(fin_rank, dim=-1)
    has_fin = final["fin_count"] > 0
    b = torch.arange(B, device=act_best.device)

    def pick(fin_arr, act_arr):
        a, c = fin_arr[b, fin_best], act_arr.view((B, K) + act_arr.shape[1:])[b, act_best]
        return torch.where(has_fin.view((B,) + (1,) * (a.ndim - 1)), a, c)

    tokens = pick(final["fin_tokens"], final["tokens"])
    probs = pick(final["fin_probs"], final["probs"])
    lengths = pick(fin_lengths, final["length"])
    sum_lp = pick(final["fin_scores"], final["scores"])
    return DecodeResult(
        tokens=tokens, lengths=lengths, sum_logprob=sum_lp,
        avg_logprob=sum_lp / torch.clamp(lengths + 1, min=1).float(),
        token_probs=probs, no_speech_prob=final["no_speech_prob"],
    )


def beam_decode(
    params, cfg: wm.WhisperConfig, dc: DecodeConfig, sp: SpecialTokens,
    xa: torch.Tensor, prompt: torch.Tensor, prompt_len: int,
    suppress_mask: Optional[torch.Tensor] = None,
    sot_pos: int = 0,
    is_cancelled=None,  # host callback polled every poll_tokens steps
    poll_tokens: int = 32,
    row_pad: Optional[torch.Tensor] = None,  # [B] per-row prompt left pad
    cross: Optional[Dict[str, torch.Tensor]] = None,
) -> DecodeResult:
    """Beam search (beam_size K) folded into the batch axis. Finished
    hypotheses go to K fixed slots per stream; the host checks the patience
    target (and `is_cancelled`) between windows of `poll_tokens` steps.
    Under `dc.mesh`, the rank's rows in and the whole batch out."""
    if suppress_mask is None:
        suppress_mask = torch.from_numpy(
            build_suppress_mask(sp, cfg.n_vocab)).to(xa.device)
    state = beam_init(params, cfg, dc, sp, xa, prompt, prompt_len,
                      sot_pos=sot_pos, row_pad=row_pad, cross=cross)
    max_steps = _max_steps(dc, cfg, prompt_len)
    target = _n_fin_target(dc)
    while state["step"] < max_steps:
        budget = min(state["step"] + max(poll_tokens, 1), max_steps)
        state = beam_run(params, cfg, dc, sp, state, suppress_mask, prompt_len, budget)
        if bool((state["fin_count"] >= target).all()) or (is_cancelled and is_cancelled()):
            break
    return _gather(beam_finalize(dc, state), dc.mesh)


def detect_language(params, cfg: wm.WhisperConfig, sp: SpecialTokens,
                    xa: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Language ID of the rows of `xa`: (lang_index [B], probs [B,
    num_languages])."""
    logits = wm.detect_language_logits(params, cfg, xa, sp.sot, mesh=mesh)
    lang_logits = logits[:, sp.sot + 1: sp.sot + 1 + sp.num_languages]
    return torch.argmax(lang_logits, dim=-1), torch.softmax(lang_logits, dim=-1)
