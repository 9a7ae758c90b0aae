"""Precision contexts of the reference: exact f32 products (TF32 off for
cuBLAS and cuDNN), or TF32 for the f32 stages' control; and the fp8
rounding of the bf16 stages' control (e4m3, the H100's next tensor-core
type below bf16, with a scale a row or a column as an fp8 product takes
it)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_products(tf32: bool = False):
    """Every f32 product and convolution inside the block in IEEE f32, or
    in TF32 where `tf32`; the flags are restored on exit."""
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        torch.backends.cudnn.allow_tf32 = prev_cudnn


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale a row (the last axis), the
    row's largest magnitude at e4m3's largest (448)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_cols(w: torch.Tensor) -> torch.Tensor:
    """A weight [.., in, out] rounded to fp8 e4m3, one scale a column."""
    return fp8_rows(w.transpose(-1, -2)).transpose(-1, -2)
