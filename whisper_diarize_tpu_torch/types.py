"""Core data types of the framework.

The PyTorch port's own copy of `whisper_diarize_tpu/types.py`;
the port imports nothing of the JAX package.

Mirrors the reference crate's public types and defaults
(the reference crate's `src/types.rs:5-98`) so that a user of
`whisper-diarize-rs` finds the same surface here: `ProgressType`,
`AdvancedTranscribe`, `TranscribeOptions`, `WordTimestamp`, `Segment`,
`SpeechSegment`, `DiarizeOptions`, plus the `Callbacks` bundle that the
reference defines in `src/engine.rs:35-50`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, asdict
from typing import Callable, Optional, List

import numpy as np


class ProgressType(enum.Enum):
    """Stage label attached to every progress callback.

    Reference: `src/types.rs:5-9`.
    """

    DOWNLOAD = "Download"
    TRANSCRIBE = "Transcribe"
    TRANSLATE = "Translate"


# Callback signatures (reference: `src/types.rs:12-13`).
#   progress(percent: int, kind: ProgressType, label: str) -> None
LabeledProgressFn = Callable[[int, ProgressType, str], None]
#   new_segment(segment: Segment) -> None
NewSegmentFn = Callable[["Segment"], None]
#   is_cancelled() -> bool
IsCancelledFn = Callable[[], bool]


@dataclass
class AdvancedTranscribe:
    """Optional decoding knobs (reference: `src/types.rs:16-24`)."""

    sampling_strategy: Optional[str] = None  # "beam_search" (default) or "greedy"
    best_of_or_beam_size: Optional[int] = None  # defaults to 5, clamped to >= 1
    n_threads: Optional[int] = None  # host-thread knob; advisory on the card
    temperature: Optional[float] = None
    max_text_ctx: Optional[int] = None  # max tokens kept in text context
    init_prompt: Optional[str] = None
    diarize_threshold: Optional[float] = None


@dataclass
class TranscribeOptions:
    """Per-request options with the reference's defaults
    (`src/types.rs:47-61`): model "base", lang "auto", VAD on, offset 0.
    """

    offset: Optional[float] = 0.0
    model: str = "base"
    lang: Optional[str] = "auto"
    # Use Whisper's built-in translate-to-English task during transcription.
    whisper_to_english: Optional[bool] = False
    # Post-pass translation target (Google endpoint); takes precedence when "en".
    translate_target: Optional[str] = None
    enable_vad: Optional[bool] = True
    enable_diarize: Optional[bool] = None
    max_speakers: Optional[int] = None
    advanced: Optional[AdvancedTranscribe] = None


@dataclass
class WordTimestamp:
    """One word (or token-level span before formatting) with times in seconds.

    Reference: `src/types.rs:64-70`. `probability` is omitted from JSON when None.
    """

    text: str
    start: float
    end: float
    probability: Optional[float] = None

    def to_dict(self) -> dict:
        d = {"text": self.text, "start": self.start, "end": self.end}
        if self.probability is not None:
            d["probability"] = float(self.probability)
        return d


@dataclass
class Segment:
    """A transcription segment / subtitle cue (reference: `src/types.rs:73-82`)."""

    start: float
    end: float
    text: str
    words: Optional[List[WordTimestamp]] = None
    speaker_id: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"start": self.start, "end": self.end, "text": self.text}
        if self.words is not None:
            d["words"] = [w.to_dict() for w in self.words]
        if self.speaker_id is not None:
            d["speaker_id"] = self.speaker_id
        return d


@dataclass
class SpeechSegment:
    """Internal VAD/diarization chunk with raw int16 samples.

    Reference: `src/types.rs:86-90`. `samples` is a numpy int16 array here
    instead of Vec<i16>.
    """

    start: float
    end: float
    samples: np.ndarray  # int16, mono, 16 kHz


@dataclass
class DiarizeOptions:
    """Reference: `src/types.rs:93-98`."""

    segment_model_path: str
    embedding_model_path: str
    threshold: float
    max_speakers: int


@dataclass
class Callbacks:
    """Bundle of user callbacks (reference: `src/engine.rs:35-50`)."""

    progress: Optional[LabeledProgressFn] = None
    new_segment_callback: Optional[NewSegmentFn] = None
    is_cancelled: Optional[IsCancelledFn] = None


def segments_to_json(segments: List[Segment]) -> list:
    """Serialize segments the way the reference's serde derive does
    (skip-none fields; see `segments.json` at the reference root)."""
    return [s.to_dict() for s in segments]
