"""JAX's default random bits in PyTorch: threefry2x32 keys, `split` and the
Gumbel noise of `jax.random.categorical`, bit for bit.

The JAX package samples the temperature-fallback ladder from
`jax.random.PRNGKey(rung)`: each step splits the key and draws Gumbel noise
over the [rows, vocab] logits. A `Threefry` stream given to the port's
decode loops draws the same bits, so a sampled rung picks the tokens the
JAX package picks (up to float ties in the logits), and golden outputs
made by the JAX package replay on the port.

The words are uint32; PyTorch holds them in int32 tensors, whose adds wrap
as uint32 adds do and whose right shifts are masked to be logical, updated
in place (five times the speed of masked int64 on the CPU). Only the
partitionable form of threefry (`jax_threefry_partitionable`, JAX's
default) is reproduced: a draw of shape S hashes the 64-bit flat index of
each element as the counter pair (hi, lo).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _i32(v: int) -> int:
    """A uint32 word as the int32 of the same bits."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1), int32
    tensors updated in place, under key (k1, k2), as
    `jax._src.prng._threefry2x32_lowering`."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0.add_(_i32(ks[0]))
    x1.add_(_i32(ks[1]))
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=tmp)  # x1 rotated left by r
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x1.bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(_i32(ks[(i + 1) % 3]))
        x1.add_(_i32(ks[(i + 2) % 3] + i + 1))
    return x0, x1


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of the flat indices 0 .. n - 1 (n < 2^31)."""
    return (torch.zeros(n, dtype=torch.int32, device=device),
            torch.arange(n, dtype=torch.int32, device=device))


class Threefry:
    """A JAX PRNG key, `jax.random.PRNGKey(seed)`, as a stream: `gumbel`
    does what a JAX decode step does with its key (`key, sub =
    jax.random.split(key)`, then `jax.random.gumbel(sub, shape)`) and keeps
    the new key."""

    def __init__(self, seed: int = 0, key: Tuple[int, int] = None):
        self.key = key if key is not None else ((seed >> 32) & _M32, seed & _M32)

    def split(self, num: int = 2):
        """`jax.random.split(key, num)` as `num` keys."""
        hi, lo = _counters(num, "cpu")
        b1, b2 = threefry2x32(*self.key, hi, lo)
        return [Threefry(key=(a & _M32, b & _M32)) for a, b in zip(b1.tolist(), b2.tolist())]

    def bits(self, shape, device) -> torch.Tensor:
        """`jax.random.bits(key, shape)`: the uint32 words as int32."""
        n = int(np.prod(shape))
        b1, b2 = threefry2x32(*self.key, *_counters(n, device))
        return (b1 ^ b2).reshape(shape)

    def uniform_tiny(self, shape, device) -> torch.Tensor:
        """`jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)`:
        the 23 high bits as the mantissa of a float in [1, 2), minus 1."""
        mant = (self.bits(shape, device) >> 9) & 0x7FFFFF | 0x3F800000
        f = mant.view(torch.float32) - 1.0
        return torch.clamp_min(f * (1.0 - _TINY_F32) + _TINY_F32, _TINY_F32)

    def gumbel(self, shape, device) -> torch.Tensor:
        """Advance the stream one split and return the Gumbel noise that
        `jax.random.categorical(sub, logits)` adds to f32 logits of `shape`."""
        self.key, sub = (k.key for k in self.split())
        return -torch.log(-torch.log(Threefry(key=sub).uniform_tiny(shape, device)))
