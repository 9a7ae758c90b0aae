"""Transcription glue (counterpart of `whisper_diarize_tpu/transcribe.py`):
token streams -> word timestamps -> chunk results.

* `interpolate_word_timestamps`, `is_whole_control_token`, `token_spans`,
  `ChunkResult` — host helpers, copied because the JAX module imports JAX;
* `TranscribeStep` — one batched model invocation over a window of audio
  chunks (mel -> encode -> beam search or greedy decode with the
  temperature-fallback ladder -> DTW) for the Engine's scheduler, over the
  bf16 or the int8 cross cache and tail weights its DecodeConfig selects.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import whisper as wm
from .ops import decode as dec
from .ops import dtw as dtw_ops
from .ops.mel import SAMPLE_RATE, log_mel_spectrogram
from .types import WordTimestamp


def interpolate_word_timestamps(line: str, start: float, end: float) -> List[WordTimestamp]:
    """Distribute [start, end] across whitespace tokens weighted by their
    alphanumeric length (used for the translate task)."""
    dur = max(end - start, 0.0)
    if dur <= 0.0:
        return []
    tokens = [t for t in line.split() if t.strip("\0").strip()]
    if not tokens:
        return []
    weights = [max(sum(c.isalnum() for c in t), 1) for t in tokens]
    total = sum(weights)
    out: List[WordTimestamp] = []
    acc = 0
    for i, tok in enumerate(tokens):
        t0 = start + (acc / total) * dur
        t1 = end if i + 1 == len(tokens) else start + ((acc + weights[i]) / total) * dur
        acc += weights[i]
        out.append(WordTimestamp(text=tok, start=t0, end=t1, probability=None))
    return out


def is_whole_control_token(s: str) -> bool:
    """True when `s` is exactly a whisper.cpp control marker like "[_BEG_]"."""
    t = s.strip("\0").strip()
    if not (t.startswith("[_") and t.endswith("]")):
        return False
    inner = t[2:-1]
    return bool(inner) and all(c.isupper() or c.isdigit() or c == "_" for c in inner if c.isascii()) and all(c.isascii() for c in inner)


def token_spans(
    texts: Sequence[str],
    probs: Sequence[float],
    anchors: Sequence[Optional[float]],
    t0s: Sequence[float],
    t1s: Sequence[float],
) -> List[WordTimestamp]:
    """Per-token spans via the DTW midpoint rule: start = mid(anchor_{i-1},
    anchor_i), end = mid(anchor_i, anchor_{i+1}), else the t0 / t1 estimate."""
    n = len(texts)
    spans: List[WordTimestamp] = []
    for i in range(n):
        a_prev = anchors[i - 1] if i > 0 else None
        a_here = anchors[i]
        a_next = anchors[i + 1] if i + 1 < n else None
        start = 0.5 * (a_prev + a_here) if (a_prev is not None and a_here is not None) else t0s[i]
        end = 0.5 * (a_here + a_next) if (a_here is not None and a_next is not None) else t1s[i]
        spans.append(WordTimestamp(text=texts[i], start=start, end=end, probability=probs[i]))
    return spans


@dataclasses.dataclass
class ChunkResult:
    """Raw decode output for one audio chunk, in chunk-local time."""

    text: str
    words: List[WordTimestamp]
    seg_start: float
    seg_end: float
    avg_logprob: float
    no_speech_prob: float
    tokens: List[int]
    end_ts: Optional[float] = None  # last closing timestamp sampled


class TranscribeStep:
    """One batched transcription step: window of audio -> ChunkResults,
    on the device that holds `params`.

    With `quantize_tail_weights`, strategies other than beam search build
    the int8 tail weights once, here (`tail_q8`), and hand them to the
    greedy loops; under beam search the knob changes nothing. That is the JAX package's attach
    rule (its TranscribeStep attaches no tail pack under beam search)."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: wm.WhisperConfig,
        tokenizer,
        model_name: str = "",
        enable_dtw: bool = True,
        decode_config: Optional[dec.DecodeConfig] = None,
        strategy: str = "beam_search",
        max_text_ctx: Optional[int] = None,
    ):
        if strategy not in ("greedy", "beam_search"):
            raise ValueError(f"unknown sampling strategy {strategy!r}")
        self.params = params
        self.cfg = cfg
        self.tk = tokenizer
        self.sp = tokenizer.specials
        self.enable_dtw = enable_dtw
        self.dc = decode_config or dec.DecodeConfig()
        self.strategy = strategy
        self.max_text_ctx = max_text_ctx
        self.tail_q8 = None
        if self.dc.quantize_tail_weights and strategy != "beam_search":
            from .ops.tail import quantize_tail_weights

            self.tail_q8 = quantize_tail_weights(params["decoder"]["blocks"])
        self.heads = wm.alignment_heads_for(model_name, cfg)
        self.device = params["decoder"]["tok_emb"].device
        self._suppress = torch.from_numpy(dec.build_suppress_mask(
            self.sp, cfg.n_vocab, tokenizer.non_speech_tokens())).to(self.device)

    # -- model invocations ---------------------------------------------------
    def place_audio(self, audio_batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(audio_batch, np.float32)).to(self.device)

    def mel(self, audio_batch) -> torch.Tensor:
        """[B, N_SAMPLES] f32 (host or device) -> [B, n_mels, 3000]."""
        audio = audio_batch if isinstance(audio_batch, torch.Tensor) else self.place_audio(audio_batch)
        return log_mel_spectrogram(audio.to(self.device), n_mels=self.cfg.n_mels)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return wm.encode(self.params, mel, self.cfg)

    def _build_prompt(self, batch: int, language, task: str, prev_tokens=None
                      ) -> Tuple[torch.Tensor, int, int, Optional[torch.Tensor]]:
        """(prompt [B, P] int64, prompt_len, sot_pos, row_pad [B] or None).
        `language` and `prev_tokens` may be per row; rows are left-padded to
        a shared 8-bucket and `row_pad` carries each row's pad."""
        keep = self.cfg.n_text_ctx // 2 - 1
        if self.max_text_ctx is not None:
            keep = min(keep, max(self.max_text_ctx, 0))
        per_row = (
            prev_tokens is not None and len(prev_tokens) > 0
            and isinstance(prev_tokens[0], (list, tuple, np.ndarray, type(None)))
            and not isinstance(prev_tokens, (bytes, str))
        )
        if per_row:
            if len(prev_tokens) != batch:
                raise ValueError(f"{len(prev_tokens)} prompt rows for batch {batch}")
            rows_prev = list(prev_tokens)
        else:
            rows_prev = [prev_tokens] * batch

        def make_prefix(pt):
            if pt is None or len(pt) == 0 or keep <= 0:
                return []
            return [self.sp.sot_prev] + list(pt)[-keep:]

        prefixes = [make_prefix(pt) for pt in rows_prev]
        max_pref = max((len(p) for p in prefixes), default=0)
        pref_bucket = -(-max_pref // 8) * 8 if max_pref else 0
        if language is None or isinstance(language, str):
            langs = [language or "en"] * batch
        else:
            langs = [l or "en" for l in language]
            if len(langs) != batch:
                raise ValueError(f"{len(langs)} languages for batch {batch}")
        pads = [pref_bucket - len(p) for p in prefixes]
        rows = [
            [self.sp.sot] * pad + p + self.tk.sot_sequence(task=task, language=l)
            for pad, p, l in zip(pads, prefixes, langs)
        ]
        prompt = torch.tensor(rows, dtype=torch.long, device=self.device)
        row_pad = None
        if any(pads):
            row_pad = torch.tensor(pads, dtype=torch.long, device=self.device)
        return prompt, len(rows[0]), pref_bucket, row_pad

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def decode(self, xa: torch.Tensor, language, task: str,
               prev_tokens: Optional[Sequence[int]] = None,
               generator: Optional[torch.Generator] = None,
               is_cancelled=None,
               cross: Optional[Dict[str, torch.Tensor]] = None) -> dec.DecodeResult:
        """Decode one window batch; `cross` is the cross K/V of `xa` when
        the caller already built it (K2 runs once per window)."""
        B = xa.shape[0]
        prompt, prompt_len, sot_pos, row_pad = self._build_prompt(
            B, language, task, prev_tokens)
        if self.strategy == "beam_search":
            return dec.beam_decode(
                self.params, self.cfg, self.dc, self.sp, xa, prompt, prompt_len,
                suppress_mask=self._suppress, sot_pos=sot_pos,
                is_cancelled=is_cancelled, row_pad=row_pad, cross=cross)
        generator = generator or self._generator(0)
        if self.dc.temperature > 0 and self.dc.beam_size > 1:
            # best_of_or_beam_size doubles as best_of for sampling
            return dec.sample_best_of(
                self.params, self.cfg, self.dc, self.sp, xa, prompt, prompt_len,
                best_of=self.dc.beam_size, generator=generator,
                suppress_mask=self._suppress, sot_pos=sot_pos, row_pad=row_pad,
                cross=cross, tail_q8=self.tail_q8)
        return dec.greedy_decode(
            self.params, self.cfg, self.dc, self.sp, xa, prompt, prompt_len,
            generator=generator, suppress_mask=self._suppress, sot_pos=sot_pos,
            is_cancelled=is_cancelled, row_pad=row_pad, cross=cross,
            tail_q8=self.tail_q8)

    def decode_with_fallback(
        self, xa: torch.Tensor, language, task: str,
        prev_tokens: Optional[Sequence[int]] = None,
        temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: float = 2.4,
        logprob_threshold: float = -1.0,
        n_valid_rows: Optional[int] = None,
        best_of: Optional[int] = None,
        is_cancelled=None,
        cross: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[dec.DecodeResult, np.ndarray]:
        """Temperature fallback: decode at t=0 (beam search or greedy), then
        re-decode the rows whose text is degenerate (gzip ratio above
        threshold) or improbable (avg logprob below threshold) at rising
        temperatures with `best_of` candidates, with the same prompt; only
        rows < n_valid_rows are judged. The cross K/V of `xa` (`cross`, or
        built here) is shared by the t=0 decode and every rung. Returns
        (result, final temperature per row)."""
        if cross is None:
            cross = self.cross_cache(xa)
        result = self.decode(xa, language, task, prev_tokens=prev_tokens,
                             is_cancelled=is_cancelled, cross=cross)
        B = xa.shape[0]
        n_valid_rows = B if n_valid_rows is None else n_valid_rows
        best_of = best_of or self.dc.beam_size
        temps = np.zeros((B,), np.float32)

        def failures(res: dec.DecodeResult) -> np.ndarray:
            toks = res.tokens.cpu().numpy()
            lens = res.lengths.cpu().numpy()
            avg = res.avg_logprob.cpu().numpy()
            bad = np.zeros(toks.shape[0], bool)
            for b in range(min(toks.shape[0], n_valid_rows)):
                data = self.tk.decode([int(t) for t in toks[b, : lens[b]]]).encode("utf-8")
                if len(data) > 16 and len(data) / len(zlib.compress(data)) > compression_ratio_threshold:
                    bad[b] = True
                if avg[b] < logprob_threshold:
                    bad[b] = True
            return bad

        bad = failures(result)
        for ti, temp in enumerate(temperatures[1:], start=1):
            if not bad.any() or (is_cancelled and is_cancelled()):
                break
            retry_dc = dataclasses.replace(self.dc, temperature=float(temp), beam_size=1)
            prompt, prompt_len, sot_pos, row_pad = self._build_prompt(
                B, language, task, prev_tokens=prev_tokens)
            retry = dec.sample_best_of(
                self.params, self.cfg, retry_dc, self.sp, xa, prompt, prompt_len,
                best_of=best_of, generator=self._generator(ti),
                suppress_mask=self._suppress, sot_pos=sot_pos, row_pad=row_pad,
                cross=cross, tail_q8=self.tail_q8)
            sel = torch.from_numpy(bad).to(self.device)
            merged = {}
            for f in dataclasses.fields(dec.DecodeResult):
                old, new = getattr(result, f.name), getattr(retry, f.name)
                merged[f.name] = torch.where(sel.view((-1,) + (1,) * (old.ndim - 1)), new, old)
            result = dec.DecodeResult(**merged)
            temps[bad] = float(temp)
            bad = failures(result) & bad
        return result, temps

    def cross_cache(self, xa: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The decode's cross K/V of every decoder layer for `xa` (K2; int8
        with `quantize_cross_kv`), shared by the t = 0 decode and every rung
        of the ladder."""
        return dec.build_cross_cache(self.params, self.cfg, self.dc, xa)

    def exact_cross_cache(self, xa: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The bf16 cross K/V of `xa` (K2), for language detection; the
        decode then takes `decode_cache` of it."""
        return wm.cross_kv(self.params, xa, self.cfg)

    def decode_cache(self, cross: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`cross` in the form the decode runs on: quantized to int8 with
        `quantize_cross_kv` (the caller drops the bf16 copy), else as is."""
        return wm.quantize_cross_cache(cross) if self.dc.quantize_cross_kv else cross

    def detect_language(self, xa: torch.Tensor,
                        cross: Optional[Dict[str, torch.Tensor]] = None) -> List[str]:
        """Language per row, on the exact weights and the bf16 cross cache
        (`cross`, from `exact_cross_cache`, or built here)."""
        from .tokenizer import LANGUAGES

        logits = wm.detect_language_logits(self.params, self.cfg, xa, self.sp.sot, cross)
        idx = logits[:, self.sp.sot + 1: self.sp.sot + 1 + self.sp.num_languages].argmax(-1)
        return [LANGUAGES[int(i)] for i in idx.cpu().numpy()]

    # -- result assembly -----------------------------------------------------
    def start_alignment(self, result: dec.DecodeResult, xa: torch.Tensor,
                        chunk_samples: Sequence[int], translated: bool):
        """Enqueue the teacher-forced alignment pass and its cost reduction on
        the device; return a host thunk that fetches the [B, S, Ta] cost and
        runs the DTW backtrack per row (None when DTW is off / empty /
        translated). The Engine runs the thunk on a worker thread."""
        if not (self.enable_dtw and not translated):
            return None
        tokens = result.tokens.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        B = tokens.shape[0]
        max_len = int(lengths.max()) if B else 0
        if max_len == 0:
            return None
        max_len = min(-(-max_len // 32) * 32, self.cfg.n_text_ctx - 8)
        sot = self.tk.sot_sequence(language="en")  # timing-only pass
        pad = np.full((B, max_len), self.sp.eot, np.int64)
        for b in range(B):
            pad[b, : lengths[b]] = tokens[b, : lengths[b]]
        seq = np.concatenate([np.tile(np.array(sot, np.int64), (B, 1)), pad], axis=1)
        n_frames = np.array([
            max(min(int(np.ceil(chunk_samples[b] / (SAMPLE_RATE * dtw_ops.FRAME_SECONDS))),
                    self.cfg.n_audio_ctx), 1)
            for b in range(B)], np.int64)
        n_rows = np.minimum(len(sot) + lengths.astype(np.int64) + 1, seq.shape[1])
        sot_len = len(sot)
        dev = self.device
        qk = wm.alignment_cross_attn(
            self.params, self.cfg, torch.from_numpy(seq).to(dev), xa, self.heads)
        cost_dev = dtw_ops.alignment_cost_batch(
            qk, torch.from_numpy(n_frames).to(dev), torch.from_numpy(n_rows).to(dev))

        def backtrack() -> List[Optional[np.ndarray]]:
            cost = cost_dev.cpu().numpy()
            anchors_all: List[Optional[np.ndarray]] = [None] * B
            for b in range(B):
                n_tok = int(lengths[b])
                if n_tok == 0:
                    continue
                cost_b = cost[b][sot_len: sot_len + n_tok, : n_frames[b]]
                anchors_all[b] = dtw_ops.anchor_times_from_cost(
                    np.ascontiguousarray(cost_b), n_tok)
            return anchors_all

        return backtrack

    def build_chunk_results(
        self, result: dec.DecodeResult, xa: torch.Tensor,
        chunk_samples: Sequence[int], translated: bool,
        anchors_all: Optional[List[Optional[np.ndarray]]] = None,
    ) -> List[ChunkResult]:
        """Host side: token ids -> text + token-level word spans per chunk.
        `anchors_all` from a `start_alignment` thunk; None runs it inline."""
        tokens = result.tokens.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        probs = result.token_probs.cpu().numpy()
        avg_lp = result.avg_logprob.cpu().numpy()
        nsp = result.no_speech_prob.cpu().numpy()
        B = tokens.shape[0]
        if anchors_all is None:
            thunk = self.start_alignment(result, xa, chunk_samples, translated)
            anchors_all = thunk() if thunk is not None else [None] * B

        out: List[ChunkResult] = []
        for b in range(B):
            n = int(lengths[b])
            toks = [int(t) for t in tokens[b, :n]]
            chunk_dur = chunk_samples[b] / SAMPLE_RATE
            ts_values = [self.sp.timestamp_value(t) for t in toks if self.sp.is_timestamp(t)]
            seg_start = ts_values[0] if ts_values else 0.0
            seg_end = ts_values[-1] if len(ts_values) > 1 else chunk_dur
            end_ts = ts_values[-1] if len(ts_values) > 1 else None
            text_idx = [i for i, t in enumerate(toks) if t < self.sp.eot]
            texts = [self.tk.decode_token(toks[i]) for i in text_idx]
            tprobs = [float(probs[b, i]) for i in text_idx]
            weights = [max(sum(c.isalnum() for c in t), 1) for t in texts]
            total_w = max(sum(weights), 1)
            t0s, t1s = [], []
            acc = 0
            for w in weights:
                t0s.append(seg_start + (seg_end - seg_start) * acc / total_w)
                acc += w
                t1s.append(seg_start + (seg_end - seg_start) * acc / total_w)
            anchors: List[Optional[float]] = [None] * len(text_idx)
            if anchors_all[b] is not None:
                aa = anchors_all[b]
                anchors = [float(aa[i]) if i < len(aa) else None for i in text_idx]
            words = token_spans(texts, tprobs, anchors, t0s, t1s)
            words = [w for w in words if w.text.strip("\0").strip()]
            out.append(ChunkResult(
                text="".join(texts).lstrip(), words=words, seg_start=seg_start,
                seg_end=seg_end, avg_logprob=float(avg_lp[b]),
                no_speech_prob=float(nsp[b]), tokens=toks, end_ts=end_ts))
        return out
