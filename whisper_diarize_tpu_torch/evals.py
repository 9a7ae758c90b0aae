"""Evaluation metrics: WER/CER for transcription, DER for diarization.

The PyTorch port's own copy of `whisper_diarize_tpu/evals.py`;
the port imports nothing of the JAX package.

The reference ships no evaluation tooling (SURVEY.md §6: no benchmarks, no
CI); the targets (BASELINE.md) are measured with this module:
word-error-rate against reference transcripts, word-timestamp MAE, and
diarization error rate (missed speech + false alarm + speaker confusion over
an optimal speaker mapping) on RTTM-style turn lists.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "normalize_text",
    "wer",
    "cer",
    "word_timestamp_mae",
    "Turn",
    "der",
]


_PUNCT_RE = re.compile(r"[^\w\s']", re.UNICODE)


def normalize_text(text: str) -> str:
    """Lightweight normalization for WER: lowercase, strip punctuation
    (keeping intra-word apostrophes), collapse whitespace."""
    text = text.lower()
    text = _PUNCT_RE.sub(" ", text)
    return " ".join(text.split())


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with O(min) rolling rows."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def wer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    """Word error rate. Empty reference with non-empty hypothesis -> 1.0."""
    ref = normalize_text(reference) if normalize else reference
    hyp = normalize_text(hypothesis) if normalize else hypothesis
    ref_words = ref.split()
    hyp_words = hyp.split()
    if not ref_words:
        return 0.0 if not hyp_words else 1.0
    return _edit_distance(ref_words, hyp_words) / len(ref_words)


def cer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    ref = normalize_text(reference) if normalize else reference
    hyp = normalize_text(hypothesis) if normalize else hypothesis
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(list(ref), list(hyp)) / len(ref)


def word_timestamp_mae(
    ref_words: Sequence[Tuple[str, float, float]],
    hyp_words: Sequence[Tuple[str, float, float]],
) -> Optional[float]:
    """Mean absolute error (seconds) over start+end of aligned matching
    words (aligned by the WER alignment; only substitution-free matches
    count). Returns None when nothing aligns."""
    ref_texts = [normalize_text(w[0]) for w in ref_words]
    hyp_texts = [normalize_text(w[0]) for w in hyp_words]

    # DP alignment (match/sub/ins/del) with backtrace
    n, m = len(ref_texts), len(hyp_texts)
    D = np.zeros((n + 1, m + 1), np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost = 0 if ref_texts[i - 1] == hyp_texts[j - 1] else 1
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1, D[i - 1, j - 1] + cost)
    errs = []
    i, j = n, m
    while i > 0 and j > 0:
        if (
            ref_texts[i - 1] == hyp_texts[j - 1]
            and D[i, j] == D[i - 1, j - 1]
        ):
            r, h = ref_words[i - 1], hyp_words[j - 1]
            errs.append(abs(r[1] - h[1]))
            errs.append(abs(r[2] - h[2]))
            i, j = i - 1, j - 1
        elif D[i, j] == D[i - 1, j - 1] + 1:
            i, j = i - 1, j - 1
        elif D[i, j] == D[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
    return float(np.mean(errs)) if errs else None


@dataclass(frozen=True)
class Turn:
    """One speaker turn (RTTM-style)."""

    speaker: str
    start: float
    end: float


def _events(turns: Sequence[Turn]):
    ev = []
    for t in turns:
        if t.end > t.start:
            ev.append((t.start, 1, t.speaker))
            ev.append((t.end, -1, t.speaker))
    return ev


def der(
    reference: Sequence[Turn],
    hypothesis: Sequence[Turn],
    collar: float = 0.25,
) -> Dict[str, float]:
    """Diarization error rate with a no-score collar around reference turn
    boundaries. Returns dict with missed/false_alarm/confusion/der (rates
    over total reference speech time).

    Speaker mapping is optimal 1:1 (Hungarian over pairwise overlap), the
    standard NIST protocol.
    """
    # collect boundary collar regions to exclude
    collars: List[Tuple[float, float]] = []
    for t in reference:
        collars.append((t.start - collar, t.start + collar))
        collars.append((t.end - collar, t.end + collar))
    collars.sort()
    merged: List[List[float]] = []
    for s, e in collars:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])

    # timeline sweep over all region boundaries
    points = set()
    for t in list(reference) + list(hypothesis):
        points.add(t.start)
        points.add(t.end)
    for s, e in merged:
        points.add(s)
        points.add(e)
    timeline = sorted(points)

    ref_speakers = sorted({t.speaker for t in reference})
    hyp_speakers = sorted({t.speaker for t in hypothesis})
    overlap = np.zeros((len(ref_speakers), len(hyp_speakers)))
    r_idx = {s: i for i, s in enumerate(ref_speakers)}
    h_idx = {s: i for i, s in enumerate(hyp_speakers)}

    def active(turns, a, b):
        return {t.speaker for t in turns if t.start < b and t.end > a}

    def in_collar(a, b):
        for s, e in merged:
            if s <= a and b <= e:
                return True
        return False

    # first pass: accumulate overlap matrix for the speaker mapping (no collar)
    for a, b in zip(timeline[:-1], timeline[1:]):
        dur = b - a
        if dur <= 0:
            continue
        for rs in active(reference, a, b):
            for hs in active(hypothesis, a, b):
                overlap[r_idx[rs], h_idx[hs]] += dur

    mapping: Dict[str, str] = {}
    if len(ref_speakers) and len(hyp_speakers):
        from scipy.optimize import linear_sum_assignment

        ri, hi = linear_sum_assignment(-overlap)
        for i, j in zip(ri, hi):
            if overlap[i, j] > 0:
                mapping[ref_speakers[i]] = hyp_speakers[j]

    total = missed = false_alarm = confusion = 0.0
    for a, b in zip(timeline[:-1], timeline[1:]):
        dur = b - a
        if dur <= 0 or in_collar(a, b):
            continue
        refs = active(reference, a, b)
        hyps = active(hypothesis, a, b)
        nr, nh = len(refs), len(hyps)
        total += dur * nr
        missed += dur * max(nr - nh, 0)
        false_alarm += dur * max(nh - nr, 0)
        # confusion: ref speakers present whose mapped hyp speaker isn't
        matched = sum(1 for rs in refs if mapping.get(rs) in hyps)
        confusion += dur * (min(nr, nh) - min(matched, min(nr, nh)))

    denom = max(total, 1e-9)
    return {
        "missed": missed / denom,
        "false_alarm": false_alarm / denom,
        "confusion": confusion / denom,
        "der": (missed + false_alarm + confusion) / denom,
        "total_speech": total,
    }
