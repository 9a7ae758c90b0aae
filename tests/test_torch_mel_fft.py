"""K7's FFT on the CPU: `ops/mel.py::log_mel_fft_walk`, the stages of
`csrc/mel.cu` in plain PyTorch on the very tables the wrapper hands the
kernel (`mel.fft_tables`: the window, the 5- and 8-point constants, the
four-step and split twiddles, the sparse filterbank) and its reflect
indexing (`mel.reflect_index`).

- The tables: every entry its float64 value rounded once to f32; the sparse
  filterbank equal to `mel_filterbank(n_mels)` bit for bit.
- The reflect indexing equal to the center reflect padding of the plain
  version, sample for sample.
- The walk in f32 at 80 and 128 mels against the float64 plain log-mel
  (`log_mel_fused_plain(audio.double())`) within `agreement.F32_ATOL`, the
  bound the card holds K7 to, over every frame and over the first and the
  last two frames (where the reflection acts); and against the JAX
  package's Pallas kernel (`tools/pallas_mel.py::log_mel_pallas`, interpret
  mode) within 5e-5 after whisper's scaling (the JAX test's own bound).
  Audio lengths: 337 frames; 12 frames, shorter than one CTA's span (32
  frames, 5,360 samples); 500 frames. Each has a quiet stretch (small
  powers).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import mel

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from pallas_mel import log_mel_pallas  # noqa: E402 (quarantined kernel, tools/)

torch.set_num_threads(2)

LENGTHS = [337 * 160 + 57, 12 * 160 + 83, 16000 * 5]


def _audio(T: int, n_mels: int) -> np.ndarray:
    rng = np.random.default_rng(T + n_mels)
    x = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    x[:, : T // 4] *= 0.01  # a quiet stretch
    return x


@pytest.mark.parametrize("n_mels,nnz", [(80, 391), (128, 394)])
def test_sparse_filterbank_is_the_filterbank(n_mels, nnz):
    tab, itab = mel.fft_tables(n_mels)
    fb = mel.mel_filterbank(n_mels)
    assert itab.shape == (3, n_mels) and tab.size == mel.T_MELW + nnz
    dense = np.zeros_like(fb)
    for m, (k0, n, off) in enumerate(itab.T):
        dense[m, k0:k0 + n] = tab[mel.T_MELW + off:mel.T_MELW + off + n]
    nz = fb != 0  # (mel_filterbank has -0.0 entries: zeros compare by value)
    assert np.array_equal(dense != 0, nz)
    assert np.array_equal(dense[nz].view(np.uint32), fb[nz].view(np.uint32))
    assert (itab[1] >= 1).all() and (np.count_nonzero(fb, axis=0) <= 2).all()


def test_fft_tables_are_float64_rounded_once():
    tab, _ = mel.fft_tables(80)

    def roots(n, m):  # (re, im) of W_n^m, W_n = e^(-2 pi i / n)
        ang = -2.0 * np.pi * np.asarray(m, np.float64) / n
        return np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32).reshape(-1)

    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(400) / 400))
    want = {
        (mel.T_WIN, 400): hann.astype(np.float32),
        (mel.T_W5, 4): np.array([np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5),
                                 np.cos(4 * np.pi / 5), np.sin(4 * np.pi / 5)], np.float32),
        (mel.T_R8, 1): np.array([np.sqrt(0.5)], np.float32),
        (mel.T_W25, 50): roots(25, np.arange(25)),
        (mel.T_W200, 400): roots(200, np.outer(np.arange(8), np.arange(25))),
        (mel.T_W400, 402): roots(400, np.arange(201)),
    }
    for (off, n), ref in want.items():
        assert np.array_equal(tab[off:off + n], ref), off


@pytest.mark.parametrize("T", [201, 333, 4001] + LENGTHS)
def test_reflect_index_is_the_center_reflect_padding(T):
    audio = torch.arange(T, dtype=torch.float64)[None]
    n_frames = T // mel.HOP_LENGTH
    padded = F.pad(audio[:, None], (200, 200), mode="reflect")[:, 0]
    frames = padded.unfold(-1, mel.N_FFT, mel.HOP_LENGTH)[:, :n_frames]
    assert torch.equal(audio[:, mel.reflect_index(T, n_frames)], frames)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("T", LENGTHS)
def test_fft_walk_matches_float64_plain(n_mels, T):
    """Every frame, and the two at each edge alone, within `F32_ATOL`."""
    x = torch.from_numpy(_audio(T, n_mels))
    walk = mel.log_mel_fft_walk(x, n_mels)
    exact = mel.log_mel_fused_plain(x.double(), n_mels)
    assert walk.dtype == torch.float32 and tuple(walk.shape) == (2, T // 160, n_mels)
    for rows in (slice(None), slice(0, 2), slice(-2, None)):
        a = ag.agreement(walk[:, rows], exact[:, rows], atol=ag.F32_ATOL)
        assert a.ok, (rows, a)
    # the float64 walk on the f32 tables: the tables' own rounding only
    assert (mel.log_mel_fft_walk(x.double(), n_mels) - exact).abs().max() < 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("T", LENGTHS[:2])
def test_fft_walk_matches_pallas(n_mels, T):
    x = _audio(T, n_mels)
    ref = np.asarray(log_mel_pallas(jnp.asarray(x), n_mels=n_mels, interpret=True))
    got = mel._normalize(mel.log_mel_fft_walk(torch.from_numpy(x), n_mels)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
