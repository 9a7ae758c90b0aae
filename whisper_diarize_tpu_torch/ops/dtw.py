"""DTW word-timestamp alignment (counterpart of
`whisper_diarize_tpu/ops/dtw.py`).

openai-whisper `find_alignment` semantics: alignment-head QK logits ->
frames sliced (masked) to the valid audio -> softmax over frames ->
standardize over tokens (biased std) -> median filter (width 7, reflect)
-> head average -> monotonic DTW through -cost; a token's anchor is the
first frame its row is entered, at 20 ms per encoder frame.

`alignment_cost_batch` runs on the device and reduces [B, K, S, Ta] maps to
a [B, S, Ta] cost; the DP and backtrack run on the host — the native C++
DP (`whisper_diarize_tpu_torch.native`, built on first use) when its library
builds, otherwise the
numpy DP below (the JAX package's `WDT_HOST_DTW=1` path). The on-device DP
(`dtw_anchor_frames_batch`) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

FRAME_SECONDS = 0.02  # one encoder position = 2 mel frames = 20 ms


def median_filter(x, width: int = 7) -> np.ndarray:
    """Median filter along the last axis with reflect padding (host numpy)."""
    x = np.asarray(x)
    if width <= 1 or x.shape[-1] <= width // 2:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    idx = np.arange(x.shape[-1])[:, None] + np.arange(width)[None, :]
    return np.median(xp[..., idx], axis=-1)


def dtw_cost_matrix(x: np.ndarray) -> np.ndarray:
    """Accumulated cost of monotonic DTW over x [N, M]:
    c[i, j] = x[i, j] + min(c[i-1, j], c[i-1, j-1], c[i, j-1]).

    Row by row in f64: with a[j] = x[j] + min(c_prev[j], c_prev[j-1]) and
    P = cumsum(x_row), the in-row recurrence c[j] = min(a[j], x[j] + c[j-1])
    unrolls to c[j] = P[j] + min_{k<=j}(a[k] - P[k]), a running minimum."""
    x = np.asarray(x, np.float64)
    N, M = x.shape
    cost = np.empty((N, M), np.float64)
    cost[0] = np.cumsum(x[0])
    for i in range(1, N):
        prev = cost[i - 1]
        b = prev.copy()
        b[1:] = np.minimum(prev[1:], prev[:-1])
        a = x[i] + b
        P = np.cumsum(x[i])
        cost[i] = P + np.minimum.accumulate(a - P)
    return cost


def dtw_backtrack(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walk the accumulated cost from (N-1, M-1) back to (0, 0); ties prefer
    the diagonal, then up, then left. Returns (text_idx, time_idx) forward."""
    N, M = cost.shape
    i, j = N - 1, M - 1
    ti, tj = [i], [j]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            diag = cost[i - 1, j - 1]
            up = cost[i - 1, j]
            left = cost[i, j - 1]
            m = min(diag, up, left)
            if m == diag:
                i -= 1
                j -= 1
            elif m == up:
                i -= 1
            else:
                j -= 1
        ti.append(i)
        tj.append(j)
    return np.array(ti[::-1], np.int64), np.array(tj[::-1], np.int64)


def dtw_path(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Full DTW path over a cost matrix [N, M] on the host."""
    from .. import native

    if native.is_available():
        out = native.dtw_path(np.asarray(x, np.float32))
        if out is not None:
            return out
    return dtw_backtrack(dtw_cost_matrix(x))


def alignment_cost_batch(
    qk: torch.Tensor,  # [B, K, S, Ta] scaled QK logits
    n_frames: torch.Tensor,  # [B] valid encoder frames per row
    n_rows: torch.Tensor = None,  # [B] valid token rows; None = all
    medfilt_width: int = 7,
) -> torch.Tensor:
    """Batched device reduction of alignment maps to DTW costs [B, S, Ta] f32.

    Pad frames are masked to -inf before the softmax (openai's frame slice),
    standardization runs over each row's valid tokens, and the median filter
    reflects at each row's own n_frames boundary. Columns >= n_frames and
    rows >= n_rows hold garbage the host slices off."""
    B, K, S, Ta = qk.shape
    dev = qk.device
    cols = torch.arange(Ta, device=dev)
    frame_ok = cols[None, None, None, :] < n_frames[:, None, None, None]
    logits = torch.where(frame_ok, qk.float(), torch.tensor(float("-inf"), device=dev))
    w = torch.softmax(logits, dim=-1)
    if n_rows is None:
        mean = w.mean(dim=2, keepdim=True)
        std = w.std(dim=2, keepdim=True, correction=0)
    else:
        row_ok = (torch.arange(S, device=dev)[None, None, :, None]
                  < n_rows[:, None, None, None]).to(w.dtype)
        cnt = torch.clamp(row_ok.sum(dim=2, keepdim=True), min=1.0)
        mean = (w * row_ok).sum(dim=2, keepdim=True) / cnt
        var = (torch.square(w - mean) * row_ok).sum(dim=2, keepdim=True) / cnt
        std = torch.sqrt(var)
    w = (w - mean) / torch.clamp(std, min=1e-9)

    pad = medfilt_width // 2
    taps = (cols[:, None] + torch.arange(-pad, pad + 1, device=dev)[None, :]).abs()
    last = (n_frames.long() - 1)[:, None, None]  # [B, 1, 1]
    taps_b = torch.clamp(last - (last - taps[None]).abs(), 0, Ta - 1)  # [B, Ta, W]
    idx = taps_b[:, None, None].expand(B, K, S, Ta, medfilt_width)
    win = torch.gather(w[..., None].expand(B, K, S, Ta, medfilt_width), 3, idx)
    w = win.median(dim=-1).values
    return -w.mean(dim=1)


def anchor_times_from_cost(cost_np: np.ndarray, S: int) -> np.ndarray:
    """DTW + jump extraction over a [S, n_frames] cost -> anchor seconds [S]."""
    text_idx, time_idx = dtw_path(cost_np)
    anchors = np.zeros((S,), np.float64)
    jumps = np.pad(np.diff(text_idx), (1, 0), constant_values=1).astype(bool)
    jump_rows = text_idx[jumps]
    jump_times = time_idx[jumps] * FRAME_SECONDS
    for r, t in zip(jump_rows, jump_times):
        anchors[r] = t
    seen = set(jump_rows.tolist())
    for k in range(1, S):
        if k not in seen:
            anchors[k] = max(anchors[k], anchors[k - 1])
    return anchors
