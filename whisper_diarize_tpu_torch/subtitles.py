"""Subtitle file writers: SRT, WebVTT, and plain text.

The PyTorch port's own copy of `whisper_diarize_tpu/subtitles.py`;
the port imports nothing of the JAX package.

The reference emits cue JSON only (its `segments.json` golden artifact);
these exporters render the same `Segment` cues into standard subtitle
formats, with the reference's cue semantics (3-dp times, '\n' line breaks,
optional speaker prefixes from diarization).
"""

from __future__ import annotations

from typing import List, Sequence

from .types import Segment

__all__ = ["to_srt", "to_vtt", "to_txt"]


def _ts(t: float, sep: str) -> str:
    ms = int(round(max(t, 0.0) * 1000))
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def _speaker_prefix(seg: Segment, with_speakers: bool) -> str:
    return f"[{seg.speaker_id}] " if (with_speakers and seg.speaker_id) else ""


def to_srt(cues: Sequence[Segment], with_speakers: bool = True) -> str:
    blocks = []
    for i, c in enumerate(cues, 1):
        blocks.append(
            f"{i}\n{_ts(c.start, ',')} --> {_ts(c.end, ',')}\n"
            f"{_speaker_prefix(c, with_speakers)}{c.text}\n"
        )
    return "\n".join(blocks)


def to_vtt(cues: Sequence[Segment], with_speakers: bool = True) -> str:
    lines = ["WEBVTT", ""]
    for c in cues:
        lines.append(f"{_ts(c.start, '.')} --> {_ts(c.end, '.')}")
        if with_speakers and c.speaker_id:
            # WebVTT voice tag
            lines.append(f"<v Speaker {c.speaker_id}>{c.text}")
        else:
            lines.append(c.text)
        lines.append("")
    return "\n".join(lines)


def to_txt(cues: Sequence[Segment], with_speakers: bool = False) -> str:
    return "\n".join(
        f"{_speaker_prefix(c, with_speakers)}{c.text.replace(chr(10), ' ')}"
        for c in cues
    )
