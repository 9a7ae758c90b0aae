"""The one general traffic generator: a traffic file's parameters and a
seed -> the audio files of a run and the order of each call's files.

Every seed gives the same set of file lengths (the quantiles of the length
law) in the same order (a permutation drawn from the traffic's
`order_seed`, the same for every call and every run), so the work a call
does, down to the packing of its decode batches, is the same from call to
call and from seed to seed; the seed draws each file's samples. The files
are written once a run, as mono 16 kHz int16 WAV files, and every call
reuses them: a run writes one pool's bytes (~115 MB at 48 files of 30-150
s), not one a call.

`check_keys` refuses a traffic file with a key the harness does not read
(a key ending in `_note` is a comment), so that a setting a file states is
never silently dropped.
"""

from __future__ import annotations

import os
import wave
from typing import Dict, List

import numpy as np

KEYS = {"why", "loop", "files_per_call", "length_s_min", "length_s_max", "length_dist",
        "order_seed", "amplitude", "batch_size", "strategy", "beam_size", "tokens_per_window",
        "lang", "vad", "dtw", "diarize", "long_form_seek", "intra_op_threads", "engine",
        "advanced", "handling", "config_source"}
HANDLING = {"suppress", "fallback_ladder", "full_window_seek", "one_turn_per_file"}

SAMPLE_RATE = 16_000
WINDOW = 30 * SAMPLE_RATE  # a decode window
SEG_WINDOW = 10 * SAMPLE_RATE  # a segmentation window


def lengths(tr: Dict) -> List[int]:
    """The file lengths in samples, shortest first."""
    n = int(tr["files_per_call"])
    lo, hi = float(tr["length_s_min"]), float(tr["length_s_max"])
    if tr["length_dist"] != "log_uniform_grid":
        raise ValueError(f"unknown length_dist {tr['length_dist']!r}")
    q = (np.arange(n) + 0.5) / n
    secs = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    return [int(round(s * SAMPLE_RATE)) for s in secs]


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *stream])


def make_audio(tr: Dict, seed: int) -> List[np.ndarray]:
    """The run's files: one int16 array a length, Gaussian noise of the
    traffic's amplitude drawn from the seed."""
    rng = _rng(seed, 0)
    amp = float(tr["amplitude"])
    out = []
    for n in lengths(tr):
        x = rng.standard_normal(n, dtype=np.float32) * amp
        out.append(np.clip(np.rint(x), -32768, 32767).astype(np.int16))
    return out


def call_order(tr: Dict) -> List[int]:
    """The order in which every call hands the pool's files to the program:
    one permutation drawn from the traffic's `order_seed` (a folder's
    order, unrelated to the files' lengths), whatever the run's seed."""
    rng = np.random.default_rng(int(tr["order_seed"]))
    return [int(i) for i in rng.permutation(int(tr["files_per_call"]))]


def _unknown(d: Dict, known) -> List[str]:
    return sorted(k for k in d if k not in known and not k.endswith("_note"))


def check_keys(tr: Dict) -> None:
    """Refuse a key of the traffic file, or of its `handling`, that the
    harness does not read."""
    bad = _unknown(tr, KEYS) + [f"handling.{k}" for k in _unknown(tr["handling"], HANDLING)]
    if bad:
        raise ValueError(f"traffic keys the harness does not read: {bad}")


def write_wav(path: str, samples: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(np.asarray(samples, "<i2").tobytes())


def write_pool(audio: List[np.ndarray], workdir: str) -> List[str]:
    paths = []
    for i, x in enumerate(audio):
        p = os.path.join(workdir, f"file{i:03d}.wav")
        write_wav(p, x)
        paths.append(p)
    return paths


def suppressed_ids(tr: Dict, eot: int, timestamp_begin: int) -> List[int]:
    """The token ids the traffic's random-weight handling suppresses on top
    of the decoder's own set: "eot", and "mid_timestamps" (every timestamp
    but <|0.00|>, which opens a window, and the window's last, 30.00 s)."""
    out: List[int] = []
    for name in tr["handling"]["suppress"]:
        if name == "eot":
            out.append(eot)
        elif name == "mid_timestamps":
            out.extend(range(timestamp_begin + 1, timestamp_begin + 1500))
        else:
            raise ValueError(f"unknown suppression {name!r}")
    return out


def audio_seconds(tr: Dict) -> float:
    return sum(lengths(tr)) / SAMPLE_RATE

