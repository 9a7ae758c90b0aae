"""DTW word-timestamp alignment (counterpart of
`whisper_diarize_tpu/ops/dtw.py`).

openai-whisper `find_alignment` semantics: alignment-head QK logits ->
frames sliced (masked) to the valid audio -> softmax over frames ->
standardize over tokens (biased std) -> median filter (width 7, reflect)
-> head average -> monotonic DTW through -cost; a token's anchor is the
first frame its row is entered, at 20 ms per encoder frame.

`alignment_cost_batch` reduces [B, K, S, Ta] maps to a [B, S, Ta] cost on
the device. Two paths take it from there, as in the JAX package:

* by default the DP and the backtrack run on the device too
  (`dtw_anchor_frames_batch`: on a CUDA tensor the kernel of
  `csrc/dtw.cu`, on a CPU tensor its plain version below), and only the
  [B, N] int32 anchor frames reach the host;
* with `WDT_HOST_DTW=1` the host fetches the cost and runs the DP and the
  backtrack per row (`anchor_times_from_cost`): the native C++ DP
  (`whisper_diarize_tpu_torch.native`, built on first use) when its library
  builds, else the numpy DP below.

Both DPs are cell-wise, one f32 add a cell (`c[i,j] = x[i,j] + min(c[i-1,j-1],
c[i-1,j], c[i,j-1])`), and walk back with the same tie rule (diagonal, then
up, then left), so in the port the two paths give the same anchors bit for
bit. (The JAX package's device DP is an associative min-plus scan, whose
sums group otherwise: its anchors may differ from these by a frame on a
near tie.) The numpy DP of the host fallback sums in float64.

`alignment_cost` and `token_anchor_times` are the host utilities over one
row's [K, S, Ta] logits.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from .attn import _require_cuda

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


def alignment_cost(
    qk: np.ndarray,  # [K, S, Ta] scaled QK logits of the alignment heads
    n_frames: int,  # valid encoder frames (audio_len / 320)
    medfilt_width: int = 7,
) -> np.ndarray:
    """Slice + softmax + standardize + filter + head-average one row's QK
    logits into a DTW cost [S, n_frames] on the host, in openai's
    `find_alignment` order: frames sliced before the softmax,
    standardization over tokens with the biased std, reflect padding."""
    qk = np.asarray(qk, np.float32)[:, :, : max(int(n_frames), 1)]
    qk = qk - qk.max(axis=-1, keepdims=True)
    w = np.exp(qk)
    w /= w.sum(axis=-1, keepdims=True)
    mean = w.mean(axis=1, keepdims=True)
    std = w.std(axis=1, keepdims=True)
    w = (w - mean) / np.maximum(std, 1e-9)
    w = median_filter(w, medfilt_width)
    return np.asarray(-w.mean(axis=0), np.float32)


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

    return -median_filter_batch(w, n_frames, medfilt_width).mean(dim=1)


def median_filter_batch(w: torch.Tensor, n_frames: torch.Tensor,
                        width: int = 7) -> torch.Tensor:
    """The width-`width` median of w [B, K, S, Ta] along Ta, reflecting at
    each row's own n_frames, one head at a time: the window gather is
    [B, S, Ta, width] (not [B, K, S, Ta, width], 727 MiB at B 8, K 10, S 227).
    A median selects, so the values equal the gather of all heads at once."""
    B, K, S, Ta = w.shape
    dev = w.device
    pad = width // 2
    cols = torch.arange(Ta, device=dev)
    taps = (cols[:, None] + torch.arange(-pad, pad + 1, device=dev)[None, :]).abs()
    last = (n_frames.long() - 1)[:, None, None]  # [B, 1, 1]
    taps_b = torch.clamp(last - (last - taps[None]).abs(), 0, Ta - 1)  # [B, Ta, W]
    idx = taps_b[:, None].expand(B, S, Ta, width)
    out = torch.empty_like(w)
    for k in range(K):
        win = torch.gather(w[:, k, ..., None].expand(B, S, Ta, width), 2, idx)
        out[:, k] = win.median(dim=-1).values
        del win  # freed before the next head's gather allocates
    return out


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


def token_anchor_times(
    qk: np.ndarray,  # [K, S, Ta] scaled QK logits
    n_frames: int,
    medfilt_width: int = 7,
) -> np.ndarray:
    """Per-token DTW anchor times in seconds (length S): the time of the
    first path cell in each token row (whisper.cpp's per-token `t_dtw`)."""
    cost_np = alignment_cost(qk, n_frames, medfilt_width)
    return anchor_times_from_cost(cost_np, qk.shape[1])


# --------------------------------------------------------------------------
# The device DP and backtrack: the kernel (csrc/dtw.cu) and its plain version
# --------------------------------------------------------------------------

CODE_DIAG, CODE_UP, CODE_LEFT = 0, 1, 2
DTW_MAX_ROWS = 1024  # one lane a text row, 32 warps
DTW_SMEM_LIMIT = 232448  # the shared memory an H100 block may use
DTW_CHUNK = 8  # 4-column blocks a chunk: the kernel's loop and handoff unit
DTW_RING = 4  # chunks in a warp pair's ring
# a ring of 4-column f32 blocks and a full and an empty mbarrier a slot
_DTW_PAIR_BYTES = DTW_RING * DTW_CHUNK * 16 + 2 * DTW_RING * 8
_DTW_COST_RING_BYTES = DTW_CHUNK * 32 * 16  # a warp's ring of costs: 8 blocks a lane


class DtwPlan(NamedTuple):
    """The kernel's launch (`csrc/dtw.cu::make_plan`): `warps` warps of 32
    text rows; row 32w + 31 handed to warp w + 1 through a ring of `ring`
    chunks of `chunk` 4-column blocks; `words` 32-bit code words a text
    row; `smem` bytes of shared memory."""
    warps: int
    chunk: int
    ring: int
    words: int
    smem: int


def _dtw_code_words(Ta: int) -> int:
    """Code words a text row: 16 2-bit codes a word, row i's words starting
    at column -4 (i % 4) (`csrc/dtw.cu::code_words`)."""
    return (Ta + 27) // 16


def dtw_smem_bytes(N: int, Ta: int) -> int:
    """Shared memory the kernel takes at (N, Ta): the codes (N rows of
    `_dtw_code_words(Ta)` words, padded to 16 bytes), each warp's ring of
    costs, and a ring with a full and an empty barrier a slot for each pair
    of neighbouring warps."""
    warps = -(-N // 32)
    return (-(-N * _dtw_code_words(Ta) * 4 // 16) * 16 + warps * _DTW_COST_RING_BYTES
            + (warps - 1) * _DTW_PAIR_BYTES)


def dtw_plan(N: int, Ta: int) -> DtwPlan:
    """The plan the kernel launches with for N text rows and Ta frames
    (the mirror of `csrc/dtw.cu::make_plan`, exported as `wdt_dtw_plan`).
    Raises ValueError where there is none: N outside [1, 1024], Ta < 1, or
    more shared memory than an H100 block may use."""
    if not 1 <= N <= DTW_MAX_ROWS or Ta < 1:
        raise ValueError(f"dtw_plan: {N} text rows, {Ta} frames; the kernel takes 1 to "
                         f"{DTW_MAX_ROWS} rows and at least one frame")
    smem = dtw_smem_bytes(N, Ta)
    if smem > DTW_SMEM_LIMIT:
        raise ValueError(f"dtw_plan: codes of {N} x {Ta} cells take {smem} bytes of shared "
                         f"memory, above the block's {DTW_SMEM_LIMIT}")
    return DtwPlan(-(-N // 32), DTW_CHUNK, DTW_RING, _dtw_code_words(Ta), smem)


def dtw_accumulate(x: torch.Tensor, nt: torch.Tensor, nf: torch.Tensor) -> torch.Tensor:
    """Accumulated cost [B, N, Ta] f32 of each row's valid box (rows < nt[b],
    columns < nf[b]; cells outside it are zeroed first and hold garbage),
    cell by cell over anti-diagonals, vectorised over B: one f32 add a cell,
    as the host DP and the kernel round it. P is c padded with a row and a
    column of +inf (P[:, 0, 0] = -0.0, so c[0, 0] = x[0, 0] exactly)."""
    B, N, Ta = x.shape
    dev = x.device
    ok = ((torch.arange(N, device=dev)[None, :, None] < nt[:, None, None])
          & (torch.arange(Ta, device=dev)[None, None, :] < nf[:, None, None]))
    x = torch.where(ok, x.float(), 0.0)
    P = torch.full((B, N + 1, Ta + 1), float("inf"), dtype=torch.float32, device=dev)
    P[:, 0, 0] = -0.0
    rows = torch.arange(N, device=dev)
    for d in range(int((nt + nf).max()) - 1):
        i = rows[max(0, d - Ta + 1): min(d, N - 1) + 1]
        j = d - i
        best = torch.minimum(torch.minimum(P[:, i + 1, j], P[:, i, j]), P[:, i, j + 1])
        P[:, i + 1, j + 1] = x[:, i, j] + best
    return P[:, 1:, 1:]


def choose_step(diag: torch.Tensor, up: torch.Tensor, left: torch.Tensor) -> torch.Tensor:
    """The walk's move from a cell off the top row and left column: the
    diagonal when diag <= up and diag <= left, else up when up <= left,
    else left (the kernel's 2-bit codes)."""
    return torch.where((diag <= up) & (diag <= left), CODE_DIAG,
                       torch.where(up <= left, CODE_UP, CODE_LEFT))


def dtw_walk(c: torch.Tensor, nt: torch.Tensor, nf: torch.Tensor,
             choose=choose_step) -> torch.Tensor:
    """Walk each row's accumulated cost back from (nt-1, nf-1) to (0, 0),
    vectorised over B: left along the top row, up along the left column,
    else `choose`. Writing the column at every cell, each text row keeps
    its first-entered frame; rows >= nt read 0. -> [B, N] int32."""
    B, N, Ta = c.shape
    dev = c.device
    b = torch.arange(B, device=dev)
    anchors = torch.zeros((B, N), dtype=torch.int32, device=dev)
    i, j = nt - 1, nf - 1
    for _ in range(int((nt + nf).max())):
        anchors[b, i] = j.int()
        top, left_col = i == 0, j == 0
        im, jm = (i - 1).clamp_min(0), (j - 1).clamp_min(0)
        code = choose(c[b, im, jm], c[b, im, j], c[b, i, jm])
        code = torch.where(top, CODE_LEFT, torch.where(left_col, CODE_UP, code))
        done = top & left_col
        i = torch.where(done | (code == CODE_LEFT), i, i - 1)
        j = torch.where(done | (code == CODE_UP), j, j - 1)
    return anchors


def dtw_anchor_frames_plain(cost: torch.Tensor, n_tok, n_frames, sot_len: int,
                            choose=choose_step) -> torch.Tensor:
    """The plain version of `dtw_anchor_frames_batch`, on any device."""
    B, S, Ta = cost.shape
    nt = torch.as_tensor(n_tok, device=cost.device).long().clamp(1, S - sot_len)
    nf = torch.as_tensor(n_frames, device=cost.device).long().clamp(1, Ta)
    return dtw_walk(dtw_accumulate(cost[:, sot_len:], nt, nf), nt, nf, choose)


def dtw_anchor_frames_batch(
    cost: torch.Tensor,  # [B, S, Ta] f32, `alignment_cost_batch`'s output
    n_tok,  # [B] sampled text tokens per row (the DP's rows)
    n_frames,  # [B] valid encoder frames per row
    sot_len: int,
) -> torch.Tensor:
    """DTW DP + backtrack of every row on the cost's device -> anchor frames
    [B, N] int32, N = S - sot_len.

    anchors[b, r] is the first frame the path enters text row r of the
    submatrix cost[b, sot_len : sot_len + n_tok[b], : n_frames[b]], the
    slice the host path (`anchor_times_from_cost`) takes; n_tok is clipped
    to [1, N] and n_frames to [1, Ta]; rows >= n_tok read 0; cells outside
    the submatrix are never read. On a CPU tensor the plain version runs;
    on a CUDA tensor the kernel (`csrc/dtw.cu`, one launch) runs or this
    raises. Off the CPU a shape `dtw_plan` refuses raises ValueError before
    the device is looked at."""
    if cost.device.type == "cpu":
        return dtw_anchor_frames_plain(cost, n_tok, n_frames, sot_len)
    name = "dtw_anchor_frames_batch"
    B, S, Ta = cost.shape
    N = S - sot_len
    if sot_len < 0:
        raise ValueError(f"{name}: sot_len {sot_len}")
    try:
        dtw_plan(N, Ta)
    except ValueError as e:
        raise ValueError(f"{name}: S {S} - sot_len {sot_len}: {e}") from None
    _require_cuda(name, cost, dtype=torch.float32)
    nt = torch.as_tensor(n_tok, device=cost.device).to(torch.int32).contiguous()
    nf = torch.as_tensor(n_frames, device=cost.device).to(torch.int32).contiguous()
    if nt.shape != (B,) or nf.shape != (B,):
        raise ValueError(f"{name}: n_tok {tuple(nt.shape)} and n_frames {tuple(nf.shape)} "
                         f"must be [{B}]")
    out = torch.empty((B, N), dtype=torch.int32, device=cost.device)
    lib = kernels.library()
    with torch.cuda.device(cost.device):
        kernels.check(lib.wdt_dtw_anchors(
            cost.data_ptr(), nt.data_ptr(), nf.data_ptr(), B, S, Ta, sot_len,
            out.data_ptr(), kernels.stream_ptr(cost.device)), name)
    dtw_anchor_frames_batch.launches += 1
    return out


dtw_anchor_frames_batch.launches = 0
