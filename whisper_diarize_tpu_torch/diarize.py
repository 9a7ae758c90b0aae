"""Speaker diarization: segmentation windows, online speaker assignment and
batch spectral clustering (counterpart of `whisper_diarize_tpu/diarize.py`).

* `get_segments(_batch)`: every stream's 10 s windows through the
  segmentation net (`models/segmentation.py`) on the caller's device in
  batches of at most MAX_WINDOWS_PER_BATCH, the powerset argmax -> per-frame
  speaker activity -> contiguous runs of one speaker set -> `SpeechSegment`s;
* `EmbeddingManager`: incremental cosine clustering with the reference's
  policy (`search_speaker(embedding, threshold)` under `max_speakers`, then
  `get_best_speaker_match`); ids are 1-based;
* `spectral_cluster`: offline eigengap spectral clustering.

The host policy and the clustering are the JAX package's, copied (numpy);
the windows run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .audio import int16_to_float32
from .models import segmentation
from .types import SpeechSegment
from .utils import default_device

SAMPLE_RATE = 16_000
MAX_WINDOWS_PER_BATCH = 128  # 10 s windows per forward (~5 MB of activations each)


def get_segments(
    int_samples: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    seg_params: Optional[Dict[str, Any]] = None,
    min_duration_s: float = 0.2,
    device=None,
) -> List[SpeechSegment]:
    """Speaker-segmentation pass of one stream: i16 audio -> SpeechSegments.
    A segment boundary is drawn wherever the active-speaker set changes, so
    speaker turns split without silence between them."""
    return get_segments_batch([int_samples], sample_rate, seg_params, min_duration_s,
                              device)[0]


def get_segments_batch(
    streams: List[np.ndarray],
    sample_rate: int = SAMPLE_RATE,
    seg_params: Optional[Dict[str, Any]] = None,
    min_duration_s: float = 0.2,
    device=None,
) -> List[List[SpeechSegment]]:
    """Every stream's 10 s windows (the last zero-padded) in one device batch,
    cut into forwards of at most MAX_WINDOWS_PER_BATCH windows; windows are
    independent, so each stream's result equals `get_segments` of it. Runs
    on `device` (CUDA device 0 unless given one; raises without a card),
    where `seg_params` must lie; None draws the random weights of seed 0."""
    if sample_rate != SAMPLE_RATE:
        raise ValueError("expected 16 kHz input")
    device = default_device(device, "diarize.get_segments")
    params = seg_params if seg_params is not None else segmentation.init_params(device=device)
    W = segmentation.WINDOW_SAMPLES

    arrays = [np.asarray(x) for x in streams]
    spans: List[Tuple[int, int]] = []  # per stream: (first window, count)
    windows: List[np.ndarray] = []
    for x in arrays:
        n_windows = -(-len(x) // W) if len(x) else 0
        spans.append((len(windows), n_windows))
        if n_windows:
            padded = np.zeros((n_windows * W,), np.float32)
            padded[:len(x)] = int16_to_float32(x)
            windows.extend(padded.reshape(n_windows, W))
    if not windows:
        return [[] for _ in arrays]

    batch = np.stack(windows)  # [sum NW, W]
    acts = []
    for c0 in range(0, batch.shape[0], MAX_WINDOWS_PER_BATCH):
        chunk = torch.from_numpy(batch[c0:c0 + MAX_WINDOWS_PER_BATCH]).to(device)
        acts.append(segmentation.powerset_to_activity(segmentation.forward(params, chunk)))
    activity = np.concatenate(acts, axis=0)  # [sum NW, frames, 3]
    return [_activity_to_segments(x, activity[w0:w0 + nw], min_duration_s) if nw else []
            for x, (w0, nw) in zip(arrays, spans)]


def _activity_to_segments(
    x: np.ndarray, activity: np.ndarray, min_duration_s: float
) -> List[SpeechSegment]:
    """[NW, F, 3] speaker activity -> SpeechSegments of one stream:
    contiguous frames of one non-empty speaker set, at least
    `min_duration_s` long."""
    n = len(x)
    W = segmentation.WINDOW_SAMPLES
    frame_step = segmentation.FRAME_STEP_SAMPLES
    segments: List[SpeechSegment] = []
    for w in range(activity.shape[0]):
        act = activity[w]  # [F, 3]
        n_frames = act.shape[0]
        set_id = act[:, 0] * 1 + act[:, 1] * 2 + act[:, 2] * 4  # 0 = silence
        start_f = 0
        for f in range(1, n_frames + 1):
            if f == n_frames or set_id[f] != set_id[start_f]:
                if set_id[start_f] != 0:
                    s0 = min(w * W + start_f * frame_step, n)
                    s1 = min(w * W + f * frame_step, n)
                    start_sec, end_sec = s0 / SAMPLE_RATE, s1 / SAMPLE_RATE
                    if end_sec - start_sec >= min_duration_s and s1 > s0:
                        segments.append(SpeechSegment(start=start_sec, end=end_sec,
                                                      samples=x[s0:s1]))
                start_f = f
    return segments


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


@dataclass
class Speaker:
    id: int
    centroid: np.ndarray
    count: int = 1


class EmbeddingManager:
    """Incremental cosine speaker clustering (pyannote-rs semantics):
    `search_speaker(embedding, threshold)` until `max_speakers` speakers
    exist, then `get_best_speaker_match(embedding)`. Ids are 1-based."""

    def __init__(self, max_speakers: int):
        self.max_speakers = max_speakers
        self.speakers: Dict[int, Speaker] = {}

    def get_all_speakers(self) -> Dict[int, Speaker]:
        return self.speakers

    def _best(self, embedding: np.ndarray) -> Tuple[Optional[int], float]:
        best_id, best_sim = None, -1.0
        for sid, sp in self.speakers.items():
            sim = cosine_similarity(embedding, sp.centroid)
            if sim > best_sim:
                best_id, best_sim = sid, sim
        return best_id, best_sim

    def search_speaker(self, embedding: np.ndarray, threshold: float) -> Optional[int]:
        """Assign to the best speaker at or above `threshold` (its centroid
        moves to the running mean), else create a new speaker while under
        the cap. Returns the speaker id, or None at the cap."""
        embedding = np.asarray(embedding, np.float64)
        best_id, best_sim = self._best(embedding)
        if best_id is not None and best_sim >= threshold:
            sp = self.speakers[best_id]
            sp.centroid = (sp.centroid * sp.count + embedding) / (sp.count + 1)
            sp.count += 1
            return best_id
        if len(self.speakers) < self.max_speakers:
            new_id = len(self.speakers) + 1
            self.speakers[new_id] = Speaker(id=new_id, centroid=embedding.copy())
            return new_id
        return None

    def get_best_speaker_match(self, embedding: np.ndarray) -> Optional[int]:
        """Best existing speaker regardless of the threshold (at the cap)."""
        best_id, _ = self._best(np.asarray(embedding, np.float64))
        return best_id


def spectral_cluster(
    embeddings: np.ndarray,  # [N, D]
    max_speakers: int = 8,
    min_speakers: int = 1,
) -> np.ndarray:
    """Offline spectral clustering with eigengap model selection: cosine
    affinity -> normalized Laplacian -> k from the largest eigengap (within
    [min_speakers, max_speakers]) -> k-means on the spectral embedding.
    Returns labels [N] (0-based)."""
    n = embeddings.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    if n == 1:
        return np.zeros((1,), np.int64)

    X = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-9)
    A = np.clip(X @ X.T, 0.0, 1.0)
    np.fill_diagonal(A, 0.0)

    d = A.sum(1)
    d_inv = 1.0 / np.sqrt(np.maximum(d, 1e-9))
    L = np.eye(n) - d_inv[:, None] * A * d_inv[None, :]

    from scipy.linalg import eigh

    vals, vecs = eigh(L)
    kmax = min(max_speakers, n)
    gaps = np.diff(vals[: kmax + 1])
    k = (int(np.argmax(gaps[min_speakers - 1: kmax]) + min_speakers)
         if kmax > min_speakers else min_speakers)
    k = max(min(k, kmax), min_speakers)

    V = vecs[:, :k]
    V = V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True), 1e-9)

    # lightweight k-means (k is small)
    rng = np.random.default_rng(0)
    centers = V[rng.choice(n, size=k, replace=False)]
    labels = np.zeros(n, np.int64)
    for it in range(50):
        dist = ((V[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = dist.argmin(1)
        if (new_labels == labels).all() and it > 0:
            break
        labels = new_labels
        for c in range(k):
            sel = labels == c
            if sel.any():
                centers[c] = V[sel].mean(0)
    return labels
