"""Whisper in plain PyTorch and NumPy, f32: the benchmark's reference.

It follows the published model (openai-whisper `model.py`, `audio.py`,
`timing.py`): the log-mel of `audio.py` (periodic Hann, 400-point DFT, hop
160, reflect padding, the librosa Slaney filterbank, log10, the row's max
less 8, (x + 4) / 4); the encoder's two GELU convolutions, sinusoidal
positions and pre-norm blocks; the decoder's learned positions, causal
self attention, cross attention and tied output embedding; GELU exact (the
published `nn.GELU()`). The decode's logit rules are whisper's: the
special tokens and the benchmark's traffic suppressions, blank and
end-of-text banned at the first token, the timestamp pair and
monotonicity rules, the first timestamp at most 1 s, and timestamps forced
where their log-sum-exp beats every text token. The pair rule is the
system's (the JAX package's `ops/decode.py::_timestamp_rule_mask`, which
the port keeps): a lone first timestamp forces a second, where
openai-whisper and whisper.cpp count the sequence's start as a timestamp
and force text; the departure is the program's, listed in PERF.md. The alignment is
`find_alignment`'s: the alignment heads' scaled QK logits over the valid
frames, softmax, standardized over the sequence's tokens, a width-7
median filter, the heads' mean, DTW over the text rows.

The weights are drawn again from the seed with a copy of the random init
the benchmark serves: the weights of a product [.., n_in, n_out] N(0,
1 / n_in), the conv stem N(0, 1 / (3 n_in)), `tok_emb` N(0, 1 / d),
`pos_emb` N(0, 0.01^2), layer norms 1, biases 0, the encoder's sinusoids,
one `torch.Generator` on the device seeded once and drawn leaf by leaf in
the layout's order; then rounded to the type they are served in (bf16 on
the card) and held in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import fp8_cols, fp8_rows

N_FFT, HOP, N_FRAMES = 400, 160, 3000
SAMPLE_RATE = 16_000
N_SAMPLES = 30 * SAMPLE_RATE
FRAME_SECONDS = 0.02
MAX_INITIAL_TS = 50  # the first timestamp is at most 1.00 s (50 steps of 20 ms)


class Specials:
    """The special token ids of a Whisper vocabulary of `vocab_size` with
    `num_languages` language tokens (multilingual from 51865 ids)."""

    def __init__(self, c: Dict):
        vocab, langs = int(c["vocab_size"]), int(c["num_languages"])
        self.multilingual = vocab >= 51865
        self.eot = 50257 if self.multilingual else 50256
        self.sot = self.eot + 1
        self.en = self.sot + 1
        self.num_languages = langs
        self.translate = self.sot + 1 + langs
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1
        self.vocab = vocab

    def sot_sequence(self) -> List[int]:
        return [self.sot, self.en, self.transcribe] if self.multilingual else [self.sot]

    def suppress_mask(self, extra: Sequence[int], device) -> torch.Tensor:
        """Additive [V] mask: -inf at the special tokens whisper never
        samples and at `extra`."""
        ids = [self.sot, self.sot_lm, self.sot_prev, self.no_speech, self.no_timestamps,
               self.translate, self.transcribe]
        ids += [self.sot + 1 + i for i in range(self.num_languages)]
        mask = torch.zeros(self.vocab, device=device)
        idx = torch.tensor([t for t in list(ids) + list(extra) if t < self.vocab],
                           dtype=torch.long, device=device)
        mask[idx] = float("-inf")
        return mask


# -- weights -------------------------------------------------------------------

def param_shapes(c: Dict) -> Dict:
    """Leaf shapes in the served layout and draw order ([in, out] products,
    layers stacked on a leading axis, the conv stem [k, in, out])."""
    d, mels, ta = int(c["d_model"]), int(c["num_mel_bins"]), int(c["max_source_positions"])
    le, ld = int(c["encoder_layers"]), int(c["decoder_layers"])
    enc = {k: (le, d) for k in ("ln1_s", "ln1_b", "q_b", "v_b", "o_b", "ln2_s", "ln2_b", "fc2_b")}
    enc.update({k: (le, d, d) for k in ("q_w", "k_w", "v_w", "o_w")})
    enc.update(fc1_w=(le, d, 4 * d), fc1_b=(le, 4 * d), fc2_w=(le, 4 * d, d))
    dec = {k: (ld, d) for k in ("ln1_s", "ln1_b", "q_b", "v_b", "o_b", "ln2_s", "ln2_b",
                                "cq_b", "cv_b", "co_b", "ln3_s", "ln3_b", "fc2_b")}
    dec.update({k: (ld, d, d) for k in ("q_w", "k_w", "v_w", "o_w", "cq_w", "ck_w",
                                        "cv_w", "co_w")})
    dec.update(fc1_w=(ld, d, 4 * d), fc1_b=(ld, 4 * d), fc2_w=(ld, 4 * d, d))
    return {
        "encoder": {"conv1_w": (3, mels, d), "conv1_b": (d,), "conv2_w": (3, d, d),
                    "conv2_b": (d,), "pos": (ta, d), "blocks": enc,
                    "ln_post_s": (d,), "ln_post_b": (d,)},
        "decoder": {"tok_emb": (int(c["vocab_size"]), d),
                    "pos_emb": (int(c["max_target_positions"]), d),
                    "blocks": dec, "ln_s": (d,), "ln_b": (d,)},
    }


def sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_weights(c: Dict, seed: int, device) -> Dict:
    """The served weights of `seed` in f32: rounded to the configuration's
    `served_dtype` first (bf16 on the card)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    served = getattr(torch, c["served_dtype"])

    def fill(name: str, shape) -> torch.Tensor:
        if name.endswith("_s"):
            t = torch.ones(shape, device=device)
        elif name.endswith("_b"):
            t = torch.zeros(shape, device=device)
        elif name == "pos":
            t = torch.from_numpy(sinusoids(*shape)).to(device)
        else:
            std = {"tok_emb": shape[-1] ** -0.5, "pos_emb": 0.01}.get(name)
            if std is None:
                std = (shape[-2] * (3 if name.startswith("conv") else 1)) ** -0.5
            t = torch.randn(shape, generator=gen, device=device) * std
        if name in ("conv1_w", "conv2_w"):
            t = t.permute(2, 1, 0).contiguous()  # [out, in, k] for conv1d
        return t.to(served).float()

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v) for k, v in node.items()}

    return walk(param_shapes(c))


# -- products at either precision -------------------------------------------------

def mm(x: torch.Tensor, w: torch.Tensor, lowp: bool) -> torch.Tensor:
    """x @ w; `lowp`: fp8 operands (x a scale a row, w a column)."""
    return fp8_rows(x) @ fp8_cols(w) if lowp else x @ w


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
           lowp: bool) -> torch.Tensor:
    if lowp:
        x = fp8_rows(x.transpose(1, 2)).transpose(1, 2)  # a scale a position
        w = fp8_rows(w.reshape(w.shape[0], -1)).reshape(w.shape)  # a scale an output
    return F.conv1d(x, w, b, stride=stride, padding=1)


def attend(q, k, v, mask, lowp: bool) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + mask) v over [.., T, Dh]."""
    scale = q.shape[-1] ** -0.5
    s = mm(q, k.transpose(-1, -2), lowp) * scale
    if mask is not None:
        s = s + mask
    return mm(torch.softmax(s, dim=-1), v, lowp)


def layer_norm(x, s, b):
    return F.layer_norm(x, (x.shape[-1],), s, b, 1e-5)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.view(B, T, h, D // h).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def _mlp(x, blk, l, prefix_ln, lowp):
    h = layer_norm(x, blk[prefix_ln + "_s"][l], blk[prefix_ln + "_b"][l])
    h = F.gelu(mm(h, blk["fc1_w"][l], lowp) + blk["fc1_b"][l])
    return x + mm(h, blk["fc2_w"][l], lowp) + blk["fc2_b"][l]


# -- the frontend and the encoder -------------------------------------------------

def _slaney_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _slaney_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa `filters.mel(sr=16000, n_fft=400, n_mels)` (Slaney scale and
    area normalization), openai-whisper's `mel_filters.npz`: [n_mels, 201]."""
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    hz = _slaney_hz(np.linspace(_slaney_mel(0.0), _slaney_mel(SAMPLE_RATE / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    return w * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """audio [B, N_SAMPLES] f32 in [-1, 1] -> [B, n_mels, 3000]: the DFT
    and the filterbank as f32 products (TF32 where the caller's precision
    context allows it)."""
    dev = audio.device
    n = np.arange(N_FFT)[:, None]
    k = np.arange(N_FFT // 2 + 1)[None, :]
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))[:, None]
    ang = 2.0 * np.pi * n * k / N_FFT
    bases = torch.from_numpy(np.concatenate([np.cos(ang) * win, -np.sin(ang) * win],
                                            axis=1).astype(np.float32)).to(dev)
    fb = torch.from_numpy(mel_filters(n_mels).T.astype(np.float32)).to(dev)
    x = F.pad(audio[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :N_FRAMES]  # [B, 3000, 400]
    spec = frames @ bases
    nb = N_FFT // 2 + 1
    power = spec[..., :nb] ** 2 + spec[..., nb:] ** 2
    logm = torch.log10(torch.clamp(power @ fb, min=1e-10))
    logm = torch.maximum(logm, logm.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((logm + 4.0) / 4.0).transpose(1, 2)


def encode(W: Dict, c: Dict, mel: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> audio states [B, Ta, d], a row at a time."""
    enc, H = W["encoder"], int(c["encoder_attention_heads"])
    out = []
    for b in range(mel.shape[0]):
        x = F.gelu(conv1d(mel[b:b + 1], enc["conv1_w"], enc["conv1_b"], 1, lowp))
        x = F.gelu(conv1d(x, enc["conv2_w"], enc["conv2_b"], 2, lowp))
        x = x.transpose(1, 2) + enc["pos"]
        blk = enc["blocks"]
        for l in range(int(c["encoder_layers"])):
            h = layer_norm(x, blk["ln1_s"][l], blk["ln1_b"][l])
            q = _heads(mm(h, blk["q_w"][l], lowp) + blk["q_b"][l], H)
            k = _heads(mm(h, blk["k_w"][l], lowp), H)
            v = _heads(mm(h, blk["v_w"][l], lowp) + blk["v_b"][l], H)
            x = x + mm(_merge(attend(q, k, v, None, lowp)), blk["o_w"][l], lowp) + blk["o_b"][l]
            x = _mlp(x, blk, l, "ln2", lowp)
        out.append(layer_norm(x, enc["ln_post_s"], enc["ln_post_b"]))
    return torch.cat(out)


def cross_kv(W: Dict, xa: torch.Tensor, layer: int, lowp: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder layer `layer`'s cross K and V of the audio states [B, Ta, d]."""
    blk = W["decoder"]["blocks"]
    return (mm(xa, blk["ck_w"][layer], lowp),
            mm(xa, blk["cv_w"][layer], lowp) + blk["cv_b"][layer])


# -- the decoder --------------------------------------------------------------

def decoder(W: Dict, c: Dict, tokens: torch.Tensor, xa: torch.Tensor, lowp: bool = False,
            heads: Optional[Sequence[Tuple[int, int]]] = None) -> torch.Tensor:
    """Teacher-forced decoder over tokens [B, S] and audio states [B, Ta, d]
    -> f32 logits [B, S, V]; with `heads`, the scaled QK logits of those
    (layer, head) cross-attention heads [B, K, S, Ta] instead (the pass
    stops after the deepest)."""
    dec, H = W["decoder"], int(c["decoder_attention_heads"])
    B, S = tokens.shape
    x = dec["tok_emb"][tokens] + dec["pos_emb"][:S]
    ar = torch.arange(S, device=tokens.device)
    causal = torch.where(ar[None, :] <= ar[:, None], 0.0, float("-inf")).to(x.dtype)
    blk = dec["blocks"]
    captured: Dict[Tuple[int, int], torch.Tensor] = {}
    last = max(l for l, _ in heads) if heads else int(c["decoder_layers"]) - 1
    for l in range(last + 1):
        h = layer_norm(x, blk["ln1_s"][l], blk["ln1_b"][l])
        q = _heads(mm(h, blk["q_w"][l], lowp) + blk["q_b"][l], H)
        k = _heads(mm(h, blk["k_w"][l], lowp), H)
        v = _heads(mm(h, blk["v_w"][l], lowp) + blk["v_b"][l], H)
        x = x + mm(_merge(attend(q, k, v, causal, lowp)), blk["o_w"][l], lowp) + blk["o_b"][l]
        h = layer_norm(x, blk["ln2_s"][l], blk["ln2_b"][l])
        cq = _heads(mm(h, blk["cq_w"][l], lowp) + blk["cq_b"][l], H)
        ck_, cv_ = cross_kv(W, xa, l, lowp)
        ck, cv = _heads(ck_, H), _heads(cv_, H)
        if heads:
            scale = cq.shape[-1] ** -0.5
            for (hl, hh) in heads:
                if hl == l:
                    captured[(hl, hh)] = (cq[:, hh] @ ck[:, hh].transpose(-1, -2)) * scale
        x = x + mm(_merge(attend(cq, ck, cv, None, lowp)), blk["co_w"][l], lowp) + blk["co_b"][l]
        x = _mlp(x, blk, l, "ln3", lowp)
    if heads:
        return torch.stack([captured[(l, h)] for l, h in heads], dim=1)
    x = layer_norm(x, dec["ln_s"], dec["ln_b"])
    return mm(x, dec["tok_emb"].t(), lowp)


def masked_logits(raw: torch.Tensor, tokens: torch.Tensor, sp: Specials,
                  suppress: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Whisper's logit rules along a token sequence: raw [B, T, V] (the
    logits that chose tokens [B, T]) -> the logits the decode chose from,
    banned entries at -inf. The rules at step t read tokens < t."""
    B, T, V = raw.shape
    dev = raw.device
    ids = torch.arange(V, device=dev)
    is_ts = ids >= sp.timestamp_begin
    tsb = sp.timestamp_begin
    last = torch.zeros(B, dtype=torch.bool, device=dev)
    penult = torch.zeros_like(last)
    seen = torch.zeros_like(last)
    max_ts = torch.full((B,), tsb, dtype=torch.long, device=dev)
    first_ban = ~is_ts | (ids > tsb + MAX_INITIAL_TS) | (ids == blank_id) | (ids == sp.eot)
    out = torch.empty_like(raw)
    for t in range(T):
        lg = raw[:, t] + suppress[None]
        strict = ~(last & ~penult)
        min_allowed = torch.where(seen, max_ts + strict.long(), torch.full_like(max_ts, tsb))
        banned = ((last & penult)[:, None] & is_ts[None]) \
            | ((last & ~penult)[:, None] & (ids < sp.eot)[None]) \
            | (is_ts[None] & (ids[None] < min_allowed[:, None]))
        if t == 0:
            banned = banned | first_ban[None]
        lg = lg.masked_fill(banned, float("-inf"))
        force = torch.logsumexp(lg[:, tsb:], dim=-1) > lg[:, :tsb].amax(dim=-1)
        out[:, t] = lg.masked_fill(force[:, None] & ~is_ts[None], float("-inf"))
        tok = tokens[:, t]
        tts = tok >= tsb
        penult, last = last, tts
        max_ts = torch.where(tts, torch.maximum(max_ts, tok), max_ts)
        seen = seen | tts
    return out


# -- alignment and DTW ----------------------------------------------------------

def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Width-`width` median along the last axis, reflect padding."""
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    idx = np.arange(x.shape[-1])[:, None] + np.arange(width)[None, :]
    return np.median(xp[..., idx], axis=-1)


def alignment_matrix(qk: np.ndarray, n_frames: int, n_rows: int, width: int) -> np.ndarray:
    """One row's [K, S, Ta] scaled QK logits -> the DTW cost [n_rows,
    n_frames] (find_alignment: frames sliced, softmax over them,
    standardized over the sequence's rows, median filter, heads' mean,
    negated)."""
    w = np.asarray(qk[:, :n_rows, :n_frames], np.float64)
    w = np.exp(w - w.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    w = (w - w.mean(axis=1, keepdims=True)) / np.maximum(w.std(axis=1, keepdims=True), 1e-9)
    return -median_filter(w, width).mean(axis=0)


def dtw_accumulated(cost: np.ndarray) -> np.ndarray:
    """The accumulated cost [N + 1, M + 1] of monotonic DTW over cost [N, M]
    (steps diagonal, down, right), float64, row 0 and column 0 at +inf but
    the origin."""
    N, M = cost.shape
    acc = np.full((N + 1, M + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, N + 1):
        prev = acc[i - 1]
        a = cost[i - 1] + np.minimum(prev[1:], prev[:-1])  # from above or the diagonal
        P = np.cumsum(cost[i - 1])
        acc[i, 1:] = P + np.minimum.accumulate(a - P)  # rightward moves: a running minimum
    return acc


def anchored_excess(cost: np.ndarray, first: np.ndarray) -> float:
    """How far the cheapest path that enters each row at the given frames
    lies above the cheapest path: (its cost - the optimum) over the path's
    steps (N + M) times the cost's standard deviation; inf where no
    monotonic path enters the rows there."""
    N, M = cost.shape
    a = np.asarray(first, np.int64)
    if a[0] != 0 or (np.diff(a) < 0).any() or a[-1] >= M:
        return float("inf")
    total = cost[N - 1, a[-1]:].sum()
    for i in range(N - 1):
        total += cost[i, a[i]:a[i + 1]].sum()
        # into row i + 1 down from (i, a[i+1]) or diagonally from (i, a[i+1] - 1)
        step = cost[i, a[i + 1]]
        total += step if a[i + 1] == a[i] else min(step, 0.0)
    best = dtw_accumulated(cost)[N, M]
    return float((total - best) / ((N + M) * max(float(cost.std()), 1e-12)))


def dtw_anchor_frames(cost: np.ndarray) -> np.ndarray:
    """Monotonic DTW over cost [N, M] (steps diagonal, down, right; ties to
    the diagonal, then up, then left on the walk back) -> the first frame
    the path enters in each row [N]."""
    N, M = cost.shape
    acc = dtw_accumulated(cost)
    i, j = N, M
    first = np.zeros(N, np.int64)
    while i > 0 and j > 0:
        first[i - 1] = j - 1
        if i == 1:
            j -= 1
            continue
        if j == 1:
            i -= 1
            continue
        diag, up, left = acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]
        if diag <= up and diag <= left:
            i, j = i - 1, j - 1
        elif up <= left:
            i -= 1
        else:
            j -= 1
    return first


def n_align_frames(n_samples: int, ta: int) -> int:
    """The encoder frames a window's audio covers (20 ms a frame)."""
    return max(min(int(math.ceil(n_samples / (SAMPLE_RATE * FRAME_SECONDS))), ta), 1)
