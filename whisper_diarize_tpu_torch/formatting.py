"""Subtitle post-processing: turn word-timestamped segments into readable cues.

The PyTorch port's own copy of `whisper_diarize_tpu/formatting.py`;
the port imports nothing of the JAX package.

Re-implements the behavior of the reference's `src/formatting.rs` (671 LoC,
the largest pure-logic component — see SURVEY.md §2.2) from its observable
semantics:

* token normalization with trailing-punctuation split (`formatting.rs:359-372`)
* BPE continuation merging (`formatting.rs:325-357`)
* tiny-word clamping/merging with VAD-oracle edge snapping
  (`formatting.rs:380-444`)
* grouping at terminal punctuation / long gaps (`formatting.rs:457-470`)
* greedy cue windowing under CPS/CPL/duration caps (`formatting.rs:472-507`)
* scored two-line splitting (`formatting.rs:522-596`, penalties at
  `formatting.rs:618-643`)
* language/script presets and per-field overrides (`formatting.rs:36-197`)
* silence oracles (`formatting.rs:199-237`)

Fidelity notes (intentional, matching the reference as-built):
* `split_trailing_punct` in the reference scans *bytes* and casts each byte
  to char (`formatting.rs:364-370`), so the CJK punctuation listed there can
  never match; only the ASCII subset actually splits.  We reproduce that.
* `enforce_kinsoku` is set by profiles (`formatting.rs:154`) but never read
  by the splitter; kept as a config field for surface parity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import regex as _regex

from .types import Segment, WordTimestamp

__all__ = [
    "PostProcessConfig",
    "FormattingOverrides",
    "ScriptProfile",
    "apply_overrides",
    "apply_profile",
    "profile_for_lang",
    "SilenceOracle",
    "NoSilence",
    "VadMaskOracle",
    "process_segments",
]

_GRAPHEME_RE = _regex.compile(r"\X")


def _round3(x: float) -> float:
    # f64::round is half-away-from-zero (`formatting.rs:33`)
    y = x * 1000.0
    return (math.floor(y + 0.5) if y >= 0 else math.ceil(y - 0.5)) / 1000.0


@dataclass
class _Tok:
    """Internal working token (`formatting.rs:21-30`)."""

    word: str
    punc: str
    start: float
    end: float
    prob: Optional[float]
    speaker: Optional[str]
    leading_space: bool


@dataclass
class FormattingOverrides:
    """Option-per-field overlay over a preset (`formatting.rs:36-51`)."""

    max_chars_per_line: Optional[int] = None
    max_lines: Optional[int] = None
    cps_cap: Optional[float] = None
    split_gap_sec: Optional[float] = None
    comma_min_chars_before_allow: Optional[int] = None
    min_word_dur: Optional[float] = None
    min_sub_dur: Optional[float] = None
    max_sub_dur: Optional[float] = None
    soft_max_words_per_line: Optional[int] = None
    insert_interword_space: Optional[bool] = None
    use_grapheme_len: Optional[bool] = None
    enforce_kinsoku: Optional[bool] = None
    allow_comma_split: Optional[bool] = None


class ScriptProfile:
    """Script presets (`formatting.rs:136-137`)."""

    LATIN = "Latin"
    CJK = "CJK"
    SE_ASIAN_NO_SPACE = "SEAsianNoSpace"
    RTL = "RTL"
    INDIC = "Indic"


@dataclass
class PostProcessConfig:
    """Formatter knobs with reference defaults (`formatting.rs:95-113`)."""

    max_chars_per_line: int = 38
    max_lines: int = 1
    cps_cap: float = 17.0
    split_gap_sec: float = 0.5
    comma_min_chars_before_allow: int = 55
    min_word_dur: float = 0.10
    min_sub_dur: float = 1.0
    max_sub_dur: float = 6.0
    soft_max_words_per_line: int = 0
    insert_interword_space: bool = True
    use_grapheme_len: bool = True
    enforce_kinsoku: bool = False
    allow_comma_split: bool = True

    @classmethod
    def with_profile(cls, profile: str) -> "PostProcessConfig":
        cfg = cls()
        apply_profile(cfg, profile)
        return cfg

    @classmethod
    def for_language(cls, lang: str) -> "PostProcessConfig":
        return cls.with_profile(profile_for_lang(lang))

    @classmethod
    def latin(cls) -> "PostProcessConfig":
        return cls.with_profile(ScriptProfile.LATIN)

    @classmethod
    def cjk(cls) -> "PostProcessConfig":
        return cls.with_profile(ScriptProfile.CJK)

    @classmethod
    def se_asian_no_space(cls) -> "PostProcessConfig":
        return cls.with_profile(ScriptProfile.SE_ASIAN_NO_SPACE)

    @classmethod
    def rtl(cls) -> "PostProcessConfig":
        return cls.with_profile(ScriptProfile.RTL)

    @classmethod
    def indic(cls) -> "PostProcessConfig":
        return cls.with_profile(ScriptProfile.INDIC)


def apply_overrides(cfg: PostProcessConfig, ov: FormattingOverrides) -> None:
    """Apply non-None override fields onto cfg (`formatting.rs:53-67`)."""
    for name in (
        "max_chars_per_line",
        "max_lines",
        "cps_cap",
        "split_gap_sec",
        "comma_min_chars_before_allow",
        "min_word_dur",
        "min_sub_dur",
        "max_sub_dur",
        "soft_max_words_per_line",
        "insert_interword_space",
        "use_grapheme_len",
        "enforce_kinsoku",
        "allow_comma_split",
    ):
        v = getattr(ov, name)
        if v is not None:
            setattr(cfg, name, v)


# Profile constants: `formatting.rs:139-182`.
_PROFILES = {
    ScriptProfile.LATIN: dict(
        max_chars_per_line=38, cps_cap=17.0, insert_interword_space=True,
        use_grapheme_len=True, enforce_kinsoku=False, allow_comma_split=True,
    ),
    ScriptProfile.CJK: dict(
        max_chars_per_line=20, cps_cap=11.5, insert_interword_space=False,
        use_grapheme_len=True, enforce_kinsoku=True, allow_comma_split=True,
    ),
    ScriptProfile.SE_ASIAN_NO_SPACE: dict(
        max_chars_per_line=22, cps_cap=13.0, insert_interword_space=True,
        use_grapheme_len=True, enforce_kinsoku=False, allow_comma_split=False,
    ),
    ScriptProfile.RTL: dict(
        max_chars_per_line=28, cps_cap=14.0, insert_interword_space=True,
        use_grapheme_len=True, enforce_kinsoku=False, allow_comma_split=True,
    ),
    ScriptProfile.INDIC: dict(
        max_chars_per_line=30, cps_cap=15.0, insert_interword_space=True,
        use_grapheme_len=True, enforce_kinsoku=False, allow_comma_split=True,
    ),
}


def apply_profile(cfg: PostProcessConfig, profile: str) -> None:
    for k, v in _PROFILES[profile].items():
        setattr(cfg, k, v)


def profile_for_lang(lang: str) -> str:
    """Language code -> script profile (`formatting.rs:184-197`)."""
    if lang in ("zh", "zh-CN", "zh-TW", "ja", "ko"):
        return ScriptProfile.CJK
    if lang in ("th", "lo", "km", "my"):
        return ScriptProfile.SE_ASIAN_NO_SPACE
    if lang in ("ar", "fa", "ur", "he"):
        return ScriptProfile.RTL
    if lang in ("hi", "bn", "ta", "te", "ml", "mr", "gu", "pa", "kn", "or", "si"):
        return ScriptProfile.INDIC
    return ScriptProfile.LATIN


class SilenceOracle:
    """`formatting.rs:200-203`."""

    def is_silence(self, t0: float, t1: float) -> bool:
        raise NotImplementedError


class NoSilence(SilenceOracle):
    """`formatting.rs:206-207`."""

    def is_silence(self, t0: float, t1: float) -> bool:
        return False


class VadMaskOracle(SilenceOracle):
    """Speech-interval-backed oracle (`formatting.rs:212-237`)."""

    def __init__(self, mask: Sequence[Tuple[float, float]]):
        mask = [(s, e) for (s, e) in mask if e > s]
        mask.sort(key=lambda p: p[0])
        self.mask: List[Tuple[float, float]] = mask

    def is_silence(self, t0: float, t1: float) -> bool:
        if t1 <= t0:
            return True
        for s0, s1 in self.mask:
            if s1 <= t0:
                continue
            if s0 >= t1:
                break
            if s1 > t0 and s0 < t1:
                return False
        return True


# Only the ASCII subset can actually match in the reference's byte-wise scan
# (`formatting.rs:364-370`); see module docstring.
_TRAILING_PUNC = set(".!?,;:)]}\"")


def _split_trailing_punct(s: str) -> Tuple[str, str]:
    cut = len(s)
    for idx in range(len(s) - 1, -1, -1):
        if s[idx] in _TRAILING_PUNC:
            cut = idx
        else:
            break
    if cut < len(s):
        return s[:cut], s[cut:]
    return s, ""


def _is_terminal_punct(p: str) -> bool:
    # `formatting.rs:374-376`
    return p in (".", "!", "?", "…", "。", "！", "？")


def _is_comma_like(p: str) -> bool:
    # `formatting.rs:378`
    return p in (",", "，", "、", ";")


def _is_ascii_word(s: str) -> bool:
    # `formatting.rs:318-320`
    return bool(s) and all(("a" <= c <= "z") or ("A" <= c <= "Z") or c == "'" for c in s)


def _join_tokens(a: _Tok, b: _Tok, insert_space: bool) -> Tuple[str, str, bool]:
    """`formatting.rs:446-455`: returns (word, punc, leading_space)."""
    s = ""
    if a.word:
        s += a.word
    if a.punc:
        s += a.punc
    if insert_space and b.leading_space and b.word and not s.endswith(" "):
        s += " "
    s += b.word
    return s, b.punc, a.leading_space


def _merge_continuations(toks: List[_Tok]) -> List[_Tok]:
    """Merge punctuation-only and BPE continuation tokens (`formatting.rs:325-357`)."""
    out: List[_Tok] = []
    for t in toks:
        if out:
            prev = out[-1]
            # Case 1: punctuation-only token merges into previous without space.
            if not t.word and t.punc:
                w, p, _ls = _join_tokens(prev, t, False)
                prev.word, prev.punc = w, p
                prev.end = max(prev.end, t.end)
                continue
            right_cont = not t.leading_space
            both_ascii = _is_ascii_word(prev.word) and _is_ascii_word(t.word)
            no_prev_punc = not prev.punc
            tiny_gap = (t.start - prev.end) <= 0.03
            if right_cont and both_ascii and no_prev_punc and tiny_gap:
                w, p, _ls = _join_tokens(prev, t, False)
                prev.word, prev.punc = w, p
                prev.end = max(prev.end, t.end)
                continue
        out.append(t)
    return out


def _clamp_and_merge_tiny_words(
    toks: List[_Tok], cfg: PostProcessConfig, oracle: SilenceOracle
) -> List[_Tok]:
    """`formatting.rs:380-444`."""
    if not toks:
        return toks

    # First pass: grow tiny words symmetrically, clamp against neighbor
    # midpoints, snap edges abutting oracle-confirmed silence.
    for i in range(len(toks)):
        dur = toks[i].end - toks[i].start
        if dur < cfg.min_word_dur:
            grow = (cfg.min_word_dur - dur) / 2.0
            toks[i].start -= grow
            toks[i].end += grow
        if i > 0:
            mid = 0.5 * (toks[i - 1].end + toks[i].start)
            toks[i - 1].end = min(toks[i - 1].end, mid)
            toks[i].start = max(toks[i].start, mid)
        if i + 1 < len(toks):
            mid = 0.5 * (toks[i].end + toks[i + 1].start)
            toks[i].end = min(toks[i].end, mid)
            toks[i + 1].start = max(toks[i + 1].start, mid)
        pad = 0.02
        if oracle.is_silence(toks[i].start - pad, toks[i].start):
            toks[i].start += pad
        if oracle.is_silence(toks[i].end, toks[i].end + pad):
            toks[i].end -= pad

    # Second pass: merge words still below min duration into next (preferred)
    # or previous.
    out: List[_Tok] = []
    i = 0
    while i < len(toks):
        dur = toks[i].end - toks[i].start
        if dur < cfg.min_word_dur and i + 1 < len(toks):
            nxt = _Tok(**vars(toks[i + 1]))
            w, p, ls = _join_tokens(toks[i], nxt, cfg.insert_interword_space)
            nxt.word, nxt.punc = w, p
            nxt.start = min(toks[i].start, nxt.start)
            nxt.leading_space = ls
            out.append(nxt)
            i += 2
        elif dur < cfg.min_word_dur and i > 0:
            prev = out.pop()
            w, p, ls = _join_tokens(prev, toks[i], cfg.insert_interword_space)
            prev.word, prev.punc = w, p
            prev.end = max(prev.end, toks[i].end)
            prev.leading_space = ls
            out.append(prev)
            i += 1
        else:
            out.append(toks[i])
            i += 1
    return out


def _split_into_groups(toks: List[_Tok], cfg: PostProcessConfig) -> List[List[_Tok]]:
    """Break at terminal punctuation or >= split_gap_sec gaps (`formatting.rs:457-470`)."""
    groups: List[List[_Tok]] = []
    cur: List[_Tok] = []
    for i, t in enumerate(toks):
        cur.append(t)
        strong_p = _is_terminal_punct(t.punc)
        long_gap = i + 1 < len(toks) and (toks[i + 1].start - t.end) >= cfg.split_gap_sec
        if strong_p or long_gap:
            if cur:
                groups.append(cur)
                cur = []
    if cur:
        groups.append(cur)
    return groups


def _render_token(t: _Tok) -> str:
    return t.word + t.punc


def _render_slice(slice_: Sequence[_Tok], cfg: PostProcessConfig) -> str:
    # `formatting.rs:598-606`
    parts: List[str] = []
    for i, t in enumerate(slice_):
        if cfg.insert_interword_space and t.leading_space and i > 0:
            parts.append(" ")
        parts.append(t.word)
        parts.append(t.punc)
    return "".join(parts)


def _grapheme_len(s: str) -> int:
    return len(_GRAPHEME_RE.findall(s))


def _slice_chars(slice_: Sequence[_Tok], cfg: PostProcessConfig) -> int:
    # `formatting.rs:608-616`; the non-grapheme branch counts *bytes* in Rust.
    if cfg.use_grapheme_len:
        core = sum(_grapheme_len(t.word) + _grapheme_len(t.punc) for t in slice_)
    else:
        core = sum(len(t.word.encode("utf-8")) + len(t.punc.encode("utf-8")) for t in slice_)
    spaces = (
        sum(1 for t in slice_[1:] if t.leading_space)
        if cfg.insert_interword_space
        else 0
    )
    return core + spaces


def _slice_stats(slice_: Sequence[_Tok], cfg: PostProcessConfig) -> Tuple[float, float, int]:
    t0 = slice_[0].start if slice_ else 0.0
    t1 = slice_[-1].end if slice_ else t0
    return t0, t1, _slice_chars(slice_, cfg)


def _length_penalty(chars: int, cap: int) -> float:
    # quadratic CPL overflow (`formatting.rs:618-620`)
    if chars <= cap:
        return 0.0
    d = float(chars - cap)
    return 0.02 * d * d


def _soft_cap_penalty(v: int, cap: int) -> float:
    # `formatting.rs:622-624`
    if v <= cap:
        return 0.0
    d = float(v - cap)
    return 0.01 * d * d


_SHORT_FUNCT = (
    "i", "to", "a", "the", "and", "or", "of", "in", "on", "for", "with", "at",
)


def _syntax_penalty(left: str, right: str) -> float:
    # 12-word stop list, +0.3 bad start / +0.25 bad end (`formatting.rs:626-643`)
    rwords = right.split()
    lwords = left.split()
    pen = 0.0
    if rwords and rwords[0].lower() in _SHORT_FUNCT:
        pen += 0.3
    if lwords and lwords[-1].lower() in _SHORT_FUNCT:
        pen += 0.25
    return pen


def _split_into_lines(slice_: Sequence[_Tok], cfg: PostProcessConfig) -> List[str]:
    """Choose the best two-line split by scored candidates (`formatting.rs:522-596`)."""
    if not slice_:
        return [""]
    if cfg.max_lines <= 1:
        return [_render_slice(slice_, cfg)]

    total_chars = _slice_chars(slice_, cfg)
    if total_chars <= cfg.max_chars_per_line:
        return [_render_slice(slice_, cfg)]

    cands: List[int] = []
    n = len(slice_)
    for k in range(1, n):
        left_term = slice_[k - 1].punc
        is_term = _is_terminal_punct(left_term)
        gap = slice_[k].start - slice_[k - 1].end
        long_gap = gap >= cfg.split_gap_sec
        comma_ok = (
            _is_comma_like(left_term)
            and _slice_chars(slice_, cfg) >= cfg.comma_min_chars_before_allow
        )
        if is_term or long_gap or comma_ok or k % 2 == 0 or k == n // 2:
            cands.append(k)
    if not cands:
        return [_render_slice(slice_, cfg)]

    best_k = cands[0]
    best_score = math.inf
    for k in cands:
        lchars = _slice_chars(slice_[:k], cfg)
        rchars = _slice_chars(slice_[k:], cfg)
        ltext = _render_slice(slice_[:k], cfg)
        rtext = _render_slice(slice_[k:], cfg)
        lwords = k
        rwords = n - k

        len_pen = _length_penalty(lchars, cfg.max_chars_per_line) + _length_penalty(
            rchars, cfg.max_chars_per_line
        )
        word_pen = (
            _soft_cap_penalty(lwords, cfg.soft_max_words_per_line)
            + _soft_cap_penalty(rwords, cfg.soft_max_words_per_line)
            if cfg.soft_max_words_per_line > 0
            else 0.0
        )
        syntax_pen = _syntax_penalty(ltext, rtext)

        left_term = slice_[k - 1].punc
        is_term = 1 if _is_terminal_punct(left_term) else 0
        is_comma = 1 if _is_comma_like(left_term) else 0
        gap = slice_[k].start - slice_[k - 1].end
        long_gap = 1 if gap >= cfg.split_gap_sec else 0
        bonus = -0.6 * is_term + -0.3 * long_gap + 0.15 * is_comma

        continuation_pen = 0.0 if slice_[k].leading_space else 5.0

        score = len_pen + word_pen + syntax_pen + bonus + continuation_pen
        if score < best_score:
            best_score = score
            best_k = k

    return [_render_slice(slice_[:best_k], cfg), _render_slice(slice_[best_k:], cfg)]


def _build_cue(
    group: Sequence[_Tok], start_idx: int, cfg: PostProcessConfig
) -> Tuple[int, Segment]:
    """Greedy window growth under duration/CPS/CPL caps (`formatting.rs:472-507`)."""
    j = start_idx + 1
    while True:
        w_slice = group[start_idx:j]
        t0, t1, chars = _slice_stats(w_slice, cfg)
        dur = max(t1 - t0, 0.001)
        cps = chars / dur
        next_ok = (
            j < len(group)
            and dur < cfg.max_sub_dur
            and (cps <= cfg.cps_cap or chars < cfg.max_chars_per_line * cfg.max_lines)
        )
        if next_ok:
            j += 1
        else:
            break

    w_slice = group[start_idx:j]
    t0, t1, _chars = _slice_stats(w_slice, cfg)

    lines = _split_into_lines(w_slice, cfg)
    text = "\n".join(lines)
    speaker = w_slice[0].speaker if w_slice else None

    words = [
        WordTimestamp(
            text=_render_token(t),
            start=_round3(t.start),
            end=_round3(t.end),
            probability=t.prob,
        )
        for t in w_slice
    ]

    cue = Segment(
        start=_round3(max(t0, 0.0)),
        end=_round3(t1),
        text=text,
        words=words,
        speaker_id=speaker,
    )
    return j, cue


def process_segments(
    segments: Sequence[Segment],
    cfg: PostProcessConfig,
    oracle: Optional[SilenceOracle] = None,
) -> List[Segment]:
    """Main entry: post-process segments into subtitle cues (`formatting.rs:240-313`)."""
    oracle = oracle if oracle is not None else NoSilence()

    # 1) Flatten words across segments, carrying speaker_id.
    all_words: List[Tuple[Optional[str], WordTimestamp]] = []
    for seg in segments:
        speaker = seg.speaker_id
        if seg.words is not None:
            for w in seg.words:
                all_words.append((speaker, w))
        else:
            if seg.text.strip():
                all_words.append(
                    (
                        speaker,
                        WordTimestamp(
                            text=seg.text, start=seg.start, end=seg.end, probability=None
                        ),
                    )
                )
    if not all_words:
        return []

    # 2) Normalize tokens: trailing punct split, leading-space flag, U+FFFD strip.
    toks: List[_Tok] = []
    for speaker, w in all_words:
        core_raw, punc_raw = _split_trailing_punct(w.text)
        leading_space = core_raw.startswith(" ") or core_raw.startswith("\n")
        core = core_raw.lstrip(" \n")
        core = core.replace("�", "")
        punc = punc_raw.replace("�", "")
        if not core and not punc:
            continue
        toks.append(
            _Tok(
                word=core,
                punc=punc,
                start=w.start,
                end=w.end,
                prob=w.probability,
                speaker=speaker,
                leading_space=leading_space,
            )
        )

    # 3) Merge subword continuation pieces.
    toks = _merge_continuations(toks)

    # 4) Clamp tiny words.
    toks = _clamp_and_merge_tiny_words(toks, cfg, oracle)

    # 5) Partition into groups.
    groups = _split_into_groups(toks, cfg)

    # 6) Build cues per group.
    cues: List[Segment] = []
    for g in groups:
        i = 0
        while i < len(g):
            j, cue = _build_cue(g, i, cfg)
            cues.append(cue)
            i = j
    return cues
