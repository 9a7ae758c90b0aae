"""Inputs of the offline quality goldens, for the port (counterpart of the
builders in the repository's `tools/make_quality_golden.py`).

The goldens score the pipeline with no network: a tiny checkpoint of
seeded random weights through the real Whisper topology (`TINY_CFG_KW`,
`SEED`), a deterministic WAV, and two patches of
`ops.decode.build_suppress_mask` that make random weights decode to
printable text (and, for the DER golden, to no timestamps). The committed
fixtures `tests/fixtures/quality/expected.txt` and `expected_words.json`
are the JAX pipeline's output on that checkpoint in the config-2 shape
(DTW word timestamps and subtitle formatting, `MAX_TOKENS` tokens a window);
the port replays it through `tools/run_config.py`. There is no
regeneration entry point here: the fixtures stay the JAX generator's.

Every builder takes the snapshot directory as an argument. `write_snapshot`
writes one with the port's `models/whisper.py::init_params`, which draws
the same numpy values in the same order as the JAX package's init.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np

from ..audio import write_wav
from ..ops import decode as dec

TINY_CFG_KW = dict(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
SEED = 0
MAX_TOKENS = 12

DER_BLOCKS = ["A", "C", "A", "C"]  # 10 s a block, aligned to the 10 s
#              segmentation window so no chunk crosses a speaker turn
DER_THRESHOLD = 0.96
DER_MAX_SPEAKERS = 2


def write_snapshot(snap: str) -> str:
    """The golden checkpoint (`TINY_CFG_KW`, seed `SEED`) as a native
    snapshot directory; returns `snap`."""
    from ..models import weights
    from ..models import whisper as wm

    cfg = wm.WhisperConfig(**TINY_CFG_KW)
    weights.save_params(wm.init_params(cfg, seed=SEED), cfg, snap)
    return snap


def build_fixture_inputs(tmpdir: str, snap: str) -> Tuple[str, str]:
    """(snap, wav_path): the WER / MAE golden's 4 s WAV (noise in the
    middle 2 s) beside the caller's snapshot."""
    rng = np.random.default_rng(SEED)
    x = np.zeros(16000 * 4, np.int16)
    x[16000: 16000 * 3] = (rng.standard_normal(16000 * 2) * 6000).astype(np.int16)
    wav = os.path.join(tmpdir, "quality.wav")
    write_wav(wav, x)
    return snap, wav


def _patch_suppression(extra_ids: Callable) -> Callable[[], None]:
    """Patch `ops.decode.build_suppress_mask` to suppress `extra_ids(sp,
    n_vocab)` too; returns the undo callable."""
    orig = dec.build_suppress_mask

    def patched(sp, n_vocab, extra_suppress=None):
        return orig(sp, n_vocab, list(extra_suppress or []) + extra_ids(sp, n_vocab))

    dec.build_suppress_mask = patched

    def undo():
        dec.build_suppress_mask = orig

    return undo


def _non_printable(sp, n_vocab):
    return [i for i in range(min(sp.eot, n_vocab)) if not 33 <= i < 127]


def apply_printable_suppression() -> Callable[[], None]:
    """Suppress every text token outside printable ASCII (ids < eot outside
    33..126): random weights otherwise decode to control bytes that trim to
    empty segments. Timestamps, eot and the grammar are untouched. The same
    patch made the golden. Returns an undo callable."""
    return _patch_suppression(_non_printable)


def apply_der_suppression() -> Callable[[], None]:
    """The printable suppression plus every timestamp token: with no
    sampled timestamps each cue spans its diarization chunk, so DER scores
    the chunking and clustering rather than random-weight timestamp noise.
    Returns an undo callable."""
    return _patch_suppression(
        lambda sp, n_vocab: _non_printable(sp, n_vocab) + list(range(sp.timestamp_begin, n_vocab)))


def _bandpass(x, lo: float, hi: float):
    from numpy.fft import irfft, rfft

    n = len(x)
    X = rfft(x)
    f = np.fft.rfftfreq(n, 1 / 16000)
    X[(f < lo) | (f > hi)] = 0
    return irfft(X, n)


def make_speaker_block(kind: str, seed: int, secs: int = 10) -> np.ndarray:
    """One 10 s block of a synthetic 'speaker': spectrally distinct signals
    whose random-weight CAM++ embeddings form separable clusters (within a
    speaker chunk cosine >= ~0.97, across <= ~0.956: threshold 0.96 splits
    them)."""
    r = np.random.default_rng(seed)
    n = 16000 * secs
    if kind == "A":  # band-limited rumble
        x = _bandpass(r.standard_normal(n), 60, 300)
    elif kind == "C":  # mid-band click train
        x = np.zeros(n)
        idx = r.random(n) < 0.002
        x[idx] = r.standard_normal(int(idx.sum())) * 3
        x = _bandpass(x, 500, 2000)
    else:
        raise ValueError(kind)
    return x / (np.abs(x).max() + 1e-9) * 0.5


def build_der_fixture_inputs(tmpdir: str, snap: str) -> Tuple[str, str, str]:
    """(snap, wav_path, rttm_path) of the DER golden: a deterministic
    two-speaker WAV (`DER_BLOCKS`, 10 s each) and its designed RTTM."""
    sig = np.concatenate([make_speaker_block(k, 7 * i + 3) for i, k in enumerate(DER_BLOCKS)])
    wav = os.path.join(tmpdir, "der.wav")
    write_wav(wav, (sig * 20000).astype(np.int16))
    rttm = os.path.join(tmpdir, "der.rttm")
    with open(rttm, "w") as f:
        for i, k in enumerate(DER_BLOCKS):
            f.write(f"SPEAKER der 1 {10.0 * i:.2f} 10.00 <NA> <NA> spk_{k} <NA> <NA>\n")
    return snap, wav, rttm
