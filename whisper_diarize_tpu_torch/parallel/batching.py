"""Chunk scheduler: speech segments -> padded 30 s windows -> device batches.

A copy of `whisper_diarize_tpu/parallel/batching.py` for the PyTorch port
(the JAX package reaches JAX through `parallel/__init__.py` and
`ops/mel.py`); it keeps its own N_SAMPLES / SAMPLE_RATE constants.

The reference decodes VAD chunks serially through one whisper.cpp state
(the reference's `src/transcribe.rs:376-389`). Here chunks become a batch
axis: every chunk is split into <= 30 s windows, windows are packed into
fixed-size batches (compiled once per batch size), padded to the whisper
window, and decoded together — the throughput story from SURVEY.md §5
("long-context": time-domain chunking becomes a batch axis, not a serial
loop).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..types import SpeechSegment

SAMPLE_RATE = 16_000
N_SAMPLES = 30 * SAMPLE_RATE  # one 30 s whisper window


@dataclass
class ChunkWindow:
    """One <= 30 s decode window cut from a speech segment."""

    chunk_idx: int  # index into the original SpeechSegment list
    window_idx: int  # position of this window within its chunk
    start: float  # absolute start time (seconds) in the full audio
    samples: np.ndarray  # int16, <= N_SAMPLES
    stream_idx: int = 0  # which audio stream this window belongs to
    # stride already applied at schedule time (deterministic windows: final
    # partials, or seek disabled) — advance()/replay() become no-ops
    committed: bool = False


def plan_windows(
    segments: Sequence[SpeechSegment],
    max_window_samples: int = N_SAMPLES,
    stream_idx: int = 0,
) -> List[ChunkWindow]:
    """Cut each speech segment into fixed-size windows.

    whisper.cpp internally seeks through > 30 s inputs; here the cut is
    explicit so every window is an independent batch element.
    """
    windows: List[ChunkWindow] = []
    for ci, seg in enumerate(segments):
        samples = np.asarray(seg.samples, np.int16)
        n = len(samples)
        if n == 0:
            continue
        w = 0
        for off in range(0, n, max_window_samples):
            part = samples[off : off + max_window_samples]
            windows.append(
                ChunkWindow(
                    chunk_idx=ci,
                    window_idx=w,
                    start=seg.start + off / SAMPLE_RATE,
                    samples=part,
                    stream_idx=stream_idx,
                )
            )
            w += 1
    return windows


def plan_windows_multi(
    per_stream_segments: Sequence[Sequence[SpeechSegment]],
    max_window_samples: int = N_SAMPLES,
) -> List[ChunkWindow]:
    """Windows for many audio streams, interleaved round-robin so every
    batch mixes streams (keeps per-stream latency roughly uniform)."""
    per_stream = [
        plan_windows(segs, max_window_samples, stream_idx=i)
        for i, segs in enumerate(per_stream_segments)
    ]
    out: List[ChunkWindow] = []
    max_len = max((len(lst) for lst in per_stream), default=0)
    for k in range(max_len):
        for lst in per_stream:
            if k < len(lst):
                out.append(lst[k])
    return out


def pack_batch(
    group: Sequence[ChunkWindow], batch_size: int
) -> Tuple[np.ndarray, List[int]]:
    """(padded_audio [batch_size, N_SAMPLES] f32, n_valid per row).

    Short groups are padded with silent rows up to `batch_size` so the jit
    cache sees exactly one batch shape; `n_valid` lists real sample counts
    (padding rows get 0)."""
    audio = np.zeros((batch_size, N_SAMPLES), np.float32)
    n_valid: List[int] = []
    for j, w in enumerate(group):
        audio[j, : len(w.samples)] = w.samples.astype(np.float32) / 32768.0
        n_valid.append(len(w.samples))
    n_valid += [0] * (batch_size - len(group))
    return audio, n_valid


def iter_batches(
    windows: Sequence[ChunkWindow], batch_size: int
) -> Iterator[Tuple[List[ChunkWindow], np.ndarray, List[int]]]:
    """Yield (windows, padded_audio [batch_size, N_SAMPLES] f32, n_valid)."""
    for i in range(0, len(windows), batch_size):
        group = list(windows[i : i + batch_size])
        audio, n_valid = pack_batch(group, batch_size)
        yield group, audio, n_valid


class _ChunkCursor:
    """Decode position inside one speech chunk."""

    __slots__ = ("stream_idx", "chunk_idx", "start", "samples", "offset",
                 "window_idx", "in_flight")

    def __init__(self, stream_idx: int, chunk_idx: int, start: float,
                 samples: np.ndarray):
        self.stream_idx = stream_idx
        self.chunk_idx = chunk_idx
        self.start = start
        self.samples = samples
        self.offset = 0  # samples consumed
        self.window_idx = 0
        self.in_flight = False

    @property
    def done(self) -> bool:
        return self.offset >= len(self.samples)


class WindowScheduler:
    """Dynamic window planner with whisper.cpp seek semantics.

    whisper.cpp advances through >30 s audio by seeking to the last emitted
    timestamp of each decoded window (`state.full`, relied on by the
    reference at `src/transcribe.rs:46,389`) — so a window
    boundary never lands mid-word. Windows of one chunk are therefore
    SERIAL (the next start depends on the previous seek); windows of
    different chunks/streams are independent and fill the batch.

    `one_per_stream=True` additionally serializes each stream (at most one
    of its windows per batch) — required for rolling prompt carry, where a
    window's prompt is the previous window's text (`transcribe.rs:384-386`).
    With >= batch_size streams the batches stay full: per-stream prompt
    carry at TPU batch sizes.
    """

    def __init__(
        self,
        per_stream_segments: Sequence[Sequence[SpeechSegment]],
        max_window_samples: int = N_SAMPLES,
        one_per_stream: bool = False,
        seek: bool = True,
        min_seek_samples: int = SAMPLE_RATE,  # >=1 s progress guarantee
    ):
        self.max_window = max_window_samples
        self.one_per_stream = one_per_stream
        self.seek_enabled = seek
        self.min_seek = min_seek_samples
        self._by_stream: List[List[_ChunkCursor]] = []
        for si, segs in enumerate(per_stream_segments):
            row = []
            for ci, seg in enumerate(segs):
                samples = np.asarray(seg.samples, np.int16)
                if len(samples) == 0:
                    continue
                row.append(_ChunkCursor(si, ci, seg.start, samples))
            self._by_stream.append(row)
        self._cursors = {
            (c.stream_idx, c.chunk_idx): c
            for row in self._by_stream for c in row
        }
        self._rr = 0

    # ------------------------------------------------------------------
    def stream_chunks(self, stream_idx: int) -> List[_ChunkCursor]:
        """The stream's chunk cursors in chronological order (for ordered
        result emission)."""
        return self._by_stream[stream_idx]

    def estimated_windows(self) -> int:
        """Progress denominator: windows done so far + remaining estimate
        (changes as seek shortens effective window strides)."""
        total = 0
        for row in self._by_stream:
            for c in row:
                remaining = max(len(c.samples) - c.offset, 0)
                total += c.window_idx + -(-remaining // self.max_window)
        return total

    def pending(self) -> bool:
        return any(
            not c.done for row in self._by_stream for c in row
        )

    def next_batch(self, batch_size: int) -> List[ChunkWindow]:
        """Up to batch_size next windows (round-robin over streams, then
        chunks). Returns [] when everything is done or in flight."""
        group: List[ChunkWindow] = []
        S = len(self._by_stream)
        if S == 0:
            return group
        start = self._rr
        used_streams = set()
        progress = True
        while len(group) < batch_size and progress:
            progress = False
            for k in range(S):
                si = (start + k) % S
                if self.one_per_stream and si in used_streams:
                    continue
                cur = next(
                    (c for c in self._by_stream[si]
                     if not c.done and not c.in_flight),
                    None,
                )
                if cur is None:
                    continue
                part = cur.samples[cur.offset: cur.offset + self.max_window]
                w = ChunkWindow(
                    chunk_idx=cur.chunk_idx,
                    window_idx=cur.window_idx,
                    start=cur.start + cur.offset / SAMPLE_RATE,
                    samples=part,
                    stream_idx=cur.stream_idx,
                )
                if self.seek_enabled and len(part) == self.max_window:
                    # the next window's start depends on this decode's seek
                    cur.in_flight = True
                else:
                    # deterministic stride (final partial window, or seek
                    # off): commit now so MORE windows of this chunk can
                    # join the same batch
                    cur.offset += len(part)
                    cur.window_idx += 1
                    w.committed = True
                group.append(w)
                used_streams.add(si)
                progress = True
                if len(group) >= batch_size:
                    break
            if self.one_per_stream:
                break  # one window per stream per batch
        self._rr = (start + 1) % S
        return group

    def advance(self, window: ChunkWindow, seek_samples: Optional[int] = None) -> int:
        """Consume the decoded window. `seek_samples` = the last sampled
        timestamp (window-local); None or a committed (deterministic-stride)
        window consumes fully. Returns the stride applied (for the resume
        journal)."""
        n = len(window.samples)
        if window.committed:
            return n  # stride applied at schedule time
        cur = self._cursors[(window.stream_idx, window.chunk_idx)]
        if seek_samples is None or not self.seek_enabled:
            step = n
        else:
            step = int(np.clip(seek_samples, self.min_seek, n))
        cur.offset += step
        cur.window_idx += 1
        cur.in_flight = False
        return step

    def replay(self, window: ChunkWindow, step: int) -> None:
        """Re-apply a journaled advance without decoding (resume path)."""
        if window.committed:
            return
        cur = self._cursors[(window.stream_idx, window.chunk_idx)]
        cur.offset += max(int(step), 1)
        cur.window_idx += 1
        cur.in_flight = False
