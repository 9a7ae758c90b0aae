"""The yardstick's arithmetic: the card's peaks, the union of device
intervals, and the operations and bytes of the work a cell does, counted
from the configuration's shapes whatever kernel serves the work.

The peaks and the bound rule are the port's `tools/timing.py` arithmetic,
copied here so that a change to the program cannot move the yardstick:
the H100 SXM data sheet's dense bf16 tensor rate and memory rate, and a
call's least time as the larger of its bytes over the memory rate and its
operations over the peak rate. A byte is counted once for each input read
and each output written, whatever the kernel reads again.

`c` below is a configuration file's dict (`configs/<name>.json`): the
published `config.json` keys `d_model`, `encoder_layers`,
`decoder_layers`, `num_mel_bins`, `vocab_size`, `max_source_positions`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# H100 SXM data sheet (dense, no sparsity), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
BF16_BYTES = 2
MEL_FRAMES = 3000  # a 30 s window's log-mel frames (hop 160 at 16 kHz)


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals: their summed
    lengths less any overlap."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def least_s(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS) -> float:
    """The least time the card could take for the work."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def _dims(c: Dict) -> Tuple[int, int, int, int, int]:
    return (int(c["d_model"]), int(c["max_source_positions"]), int(c["encoder_layers"]),
            int(c["decoder_layers"]), int(c["vocab_size"]))


# -- the decoder tail's skinny GEMMs: a decode step's products ----------------

def tail_products(d: int) -> Tuple[Tuple[int, int], ...]:
    """(in, out) of the five products of a decoder layer's tail at one
    token a row: self-attention out, cross-attention q and out, fc1, fc2."""
    return ((d, d), (d, d), (d, d), (d, 4 * d), (4 * d, d))


def tail_gemm_work(c: Dict, rows: int) -> Tuple[float, float]:
    """(bytes, operations) of one decode step's tail products over every
    decoder layer at `rows` rows: each weight streamed once, each product's
    input read and output written once, in bf16."""
    d, _, _, layers, _ = _dims(c)
    nbytes = flops = 0.0
    for din, dout in tail_products(d):
        nbytes += BF16_BYTES * (din * dout + rows * din + rows * dout)
        flops += 2.0 * rows * din * dout
    return layers * nbytes, layers * flops


# -- cross attention over the cross K/V cache ---------------------------------

def cross_attn_work(c: Dict, batch: int, queries: int) -> Tuple[float, float]:
    """(bytes, operations) of one pass of cross attention over every decoder
    layer: `batch` streams, `queries` query rows a stream (the beams of a
    step, or the prompt's tokens), the stream's bf16 K and V of
    `max_source_positions` positions read once, q read and the output
    written once; two products of 2 Ta D operations a query row."""
    d, ta, _, layers, _ = _dims(c)
    nbytes = BF16_BYTES * (2 * batch * queries * d + 2 * batch * ta * d)
    flops = 4.0 * batch * queries * ta * d
    return layers * nbytes, layers * flops


# -- model operations of a window's work, for the whole step's share ----------

def encoder_flops(c: Dict) -> float:
    """One 30 s window through the conv stem and every encoder layer."""
    d, ta, enc_layers, _, _ = _dims(c)
    mels = int(c["num_mel_bins"])
    stem = 2.0 * mels * d * 3 * MEL_FRAMES + 2.0 * d * d * 3 * ta
    layer = 2.0 * ta * 12 * d * d + 4.0 * ta * ta * d
    return stem + enc_layers * layer


def cross_kv_flops(c: Dict) -> float:
    """Every decoder layer's cross K and V of one window."""
    d, ta, _, layers, _ = _dims(c)
    return layers * 2.0 * ta * 2 * d * d


def _decoder_token_flops(c: Dict, n_keys: int, layers: int) -> float:
    """One token through `layers` decoder layers, its self attention over
    `n_keys` keys, without the cross K/V (counted once a window)."""
    d, ta, _, _, _ = _dims(c)
    per_layer = 2.0 * 14 * d * d + 4.0 * ta * d + 4.0 * n_keys * d
    return layers * per_layer


def logits_flops(c: Dict) -> float:
    d, _, _, _, vocab = _dims(c)
    return 2.0 * d * vocab


def prompt_flops(c: Dict, prompt_len: int, n_logits: int) -> float:
    """The prompt pass of one stream: `prompt_len` tokens, the logits at
    `n_logits` positions."""
    layers = _dims(c)[3]
    body = sum(_decoder_token_flops(c, p + 1, layers) for p in range(prompt_len))
    return body + n_logits * logits_flops(c)


def decode_flops(c: Dict, prompt_len: int, steps: int, rows: int) -> float:
    """`steps` single-token steps of `rows` rows a stream (the beams)."""
    layers = _dims(c)[3]
    per_row = sum(_decoder_token_flops(c, prompt_len + s + 1, layers) + logits_flops(c)
                  for s in range(steps))
    return rows * per_row


def alignment_flops(c: Dict, n_tokens: int, last_layer: int) -> float:
    """The teacher-forced alignment pass of one window: `n_tokens` tokens
    through the decoder layers up to `last_layer` (the deepest alignment
    head), no logits, the cross K/V not counted again."""
    return sum(_decoder_token_flops(c, t + 1, last_layer + 1) for t in range(n_tokens))


def window_flops(c: Dict, prompt_len: int, n_logits: int, steps: int, rows: int,
                 align_tokens: int) -> float:
    """The model operations of one decoded window: encoder, cross K/V,
    prompt pass, the decode steps of its `rows` rows, and the alignment
    pass (none where `align_tokens` is 0)."""
    last = max(int(h[0]) for h in c["alignment_heads"])
    total = (encoder_flops(c) + cross_kv_flops(c) + prompt_flops(c, prompt_len, n_logits)
             + decode_flops(c, prompt_len, steps, rows))
    if align_tokens:
        total += alignment_flops(c, align_tokens, last)
    return total
