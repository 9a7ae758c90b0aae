"""The port's on-device DTW (`ops/dtw.py::dtw_anchor_frames_batch`: the DP
and backtrack whose CUDA kernel is `csrc/dtw.cu`; here its plain version,
since the tensors lie on the CPU) against the JAX package, and the Engine's
default alignment path against the JAX Engine's.

Tolerances: anchors equal exactly to the JAX host path (`anchor_times_from_
cost`, a cell-wise f32 DP like the port's) on integer and on float costs,
and to the JAX device path on integer costs (every sum exact in f32);
within one frame of the JAX device path on float costs (its associative
min-plus scan groups the sums otherwise, `whisper_diarize_tpu/ops/dtw.py`,
the caveat of `dtw_anchor_frames_batch`); `alignment_cost` and
`token_anchor_times` within 1e-5; Engine cues equal in text, times within
one frame (0.02 s) plus the formatter's 3-decimal rounding.

The kernel's launch plan (`dtw_plan`, the mirror of `csrc/dtw.cu::make_plan`)
fits every shape the Engine feeds; the kernel's algorithm, walked in numpy
(`_wavefront_model`), gives the plain version's anchors exactly; the
alignment stage's median a head at a time equals the gather of every head
bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu.audio import write_wav
from whisper_diarize_tpu.engine import Engine as JEngine
from whisper_diarize_tpu.engine import EngineConfig as JEngineConfig
from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import dtw as jdtw
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu_torch.engine import Engine, EngineConfig
from whisper_diarize_tpu_torch.ops import dtw as tdtw
from whisper_diarize_tpu_torch.types import AdvancedTranscribe, TranscribeOptions

torch.set_num_threads(2)
FRAME = tdtw.FRAME_SECONDS
TOL = 0.02 + 1e-3


def _port(cost, n_tok, n_frames, sot_len):
    return tdtw.dtw_anchor_frames_batch(
        torch.from_numpy(cost), torch.from_numpy(np.asarray(n_tok)),
        torch.from_numpy(np.asarray(n_frames)), sot_len).numpy()


def _jax_device(cost, n_tok, n_frames, sot_len):
    return np.asarray(jdtw.dtw_anchor_frames_batch(
        jnp.asarray(cost), jnp.asarray(n_tok, jnp.int32), jnp.asarray(n_frames, jnp.int32),
        sot_len))


def _jax_host(cost, n_tok, n_frames, sot_len, b):
    """The JAX host path's anchor seconds of row b (n_frames clipped to Ta,
    as the device paths clip it)."""
    nt = int(n_tok[b])
    nf = min(int(n_frames[b]), cost.shape[2])
    sub = np.ascontiguousarray(cost[b][sot_len: sot_len + nt, :nf])
    return jdtw.anchor_times_from_cost(sub, nt)


def _int_case(high: int = 9):
    """`tests/test_dtw.py`'s integer shapes (costs in [0, high)), plus a row
    at n_tok 1, one at n_frames < Ta and one at n_frames > Ta (clipped)."""
    rng = np.random.default_rng(7)
    B, S, Ta, sot_len = 4, 24, 41, 3
    cost = rng.integers(0, high, size=(B + 3, S, Ta)).astype(np.float32)
    n_tok = np.concatenate([rng.integers(1, S - sot_len + 1, size=(B,)), [1, 9, S - sot_len]])
    n_frames = np.concatenate([rng.integers(4, Ta + 1, size=(B,)), [17, 5, Ta + 30]])
    return cost, n_tok.astype(np.int32), n_frames.astype(np.int32), sot_len


@pytest.mark.parametrize("high", [9, 2], ids=["0-8", "ties"])
def test_anchor_frames_match_jax_on_integer_costs(high):
    cost, n_tok, n_frames, sot_len = _int_case(high)
    got = _port(cost, n_tok, n_frames, sot_len)
    assert got.dtype == np.int32 and got.shape == (cost.shape[0], cost.shape[1] - sot_len)
    np.testing.assert_array_equal(got, _jax_device(cost, n_tok, n_frames, sot_len))
    for b in range(cost.shape[0]):
        nt = int(n_tok[b])
        np.testing.assert_array_equal(got[b, :nt] * FRAME,
                                      _jax_host(cost, n_tok, n_frames, sot_len, b))
        assert (got[b, nt:] == 0).all()
    assert got[-1].max() <= cost.shape[2] - 1  # n_frames > Ta was clipped


@pytest.mark.parametrize("seed,shape", [(11, (3, 18, 33, 2)), (5, (4, 40, 150, 4)),
                                        (9, (2, 72, 300, 8))])
def test_anchor_frames_on_float_costs(seed, shape):
    """Exactly the JAX host path; within one frame of the JAX device path."""
    B, S, Ta, sot_len = shape
    rng = np.random.default_rng(seed)
    cost = rng.standard_normal((B, S, Ta)).astype(np.float32)
    n_tok = np.array([S - sot_len, 5, 1, 17][:B], np.int32)
    n_frames = np.array([Ta, 9, 3, Ta // 2][:B], np.int32)
    got = _port(cost, n_tok, n_frames, sot_len)
    dev = _jax_device(cost, n_tok, n_frames, sot_len)
    assert np.abs(got.astype(np.int64) - dev).max() <= 1
    for b in range(B):
        nt = int(n_tok[b])
        np.testing.assert_array_equal(got[b, :nt] * FRAME,
                                      _jax_host(cost, n_tok, n_frames, sot_len, b))
        assert (got[b, nt:] == 0).all()


def test_anchor_frames_match_the_ports_host_path():
    """The device path and the port's own `WDT_HOST_DTW=1` path (native DP,
    else numpy) give the same anchors bit for bit at a large-v3 width."""
    rng = np.random.default_rng(3)
    B, S, Ta, sot_len = 3, 232, 1500, 8
    cost = rng.standard_normal((B, S, Ta)).astype(np.float32)
    n_tok = np.array([224, 60, 1], np.int32)
    n_frames = np.array([1500, 700, 1200], np.int32)
    got = _port(cost, n_tok, n_frames, sot_len)
    for b in range(B):
        nt, nf = int(n_tok[b]), int(n_frames[b])
        host = tdtw.anchor_times_from_cost(
            np.ascontiguousarray(cost[b][sot_len: sot_len + nt, :nf]), nt)
        np.testing.assert_array_equal(got[b, :nt] * FRAME, host)


def test_nan_in_garbage_cells_changes_no_anchor():
    cost, n_tok, n_frames, sot_len = _int_case()
    clean = _port(cost, n_tok, n_frames, sot_len)
    dirty = cost.copy()
    for b in range(cost.shape[0]):
        dirty[b, :sot_len] = np.nan  # the sot rows
        dirty[b, sot_len + n_tok[b]:] = np.nan  # rows >= n_tok
        dirty[b, :, min(n_frames[b], cost.shape[2]):] = np.nan  # cols >= n_frames
    np.testing.assert_array_equal(_port(dirty, n_tok, n_frames, sot_len), clean)


def test_up_first_fault_is_refused():
    """The planted fault of the card's check (up preferred over the diagonal
    on ties) moves anchors on integer costs with many ties."""
    cost, n_tok, n_frames, sot_len = _int_case(2)

    def up_first(diag, up, left):
        return torch.where((up <= diag) & (up <= left), tdtw.CODE_UP,
                           torch.where(diag <= left, tdtw.CODE_DIAG, tdtw.CODE_LEFT))

    good = _port(cost, n_tok, n_frames, sot_len)
    bad = tdtw.dtw_anchor_frames_plain(torch.from_numpy(cost), torch.from_numpy(n_tok),
                                       torch.from_numpy(n_frames), sot_len, up_first).numpy()
    assert (good != bad).any()


def test_wrapper_raises_off_the_cpu():
    """A tensor that is on no CUDA device and not on the CPU has no kernel:
    the wrapper raises (it never falls back); the kernel's shared memory
    at the largest shape fits the block."""
    cost = torch.zeros((1, 10, 20), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tdtw.dtw_anchor_frames_batch(cost, [3], [20], 2)
    assert tdtw.dtw_plan(440, 1500).smem == 232032 <= tdtw.DTW_SMEM_LIMIT
    assert tdtw.dtw_smem_bytes(1024, 1500) > tdtw.DTW_SMEM_LIMIT


# --------------------------------------------------------------------------
# The kernel's plan and its algorithm, on the CPU
# --------------------------------------------------------------------------

def _engine_shapes():
    """Every (N, Ta) `TranscribeStep.start_alignment` can hand the kernel:
    the tokens rounded up to 32, at most n_text_ctx - 8 = 440 (every
    Whisper model's n_text_ctx is 448), and up to 1500 frames."""
    return sorted({min(-(-n // 32) * 32, 448 - 8) for n in range(1, 449)})


def test_plan_fits_every_engine_shape():
    for N in _engine_shapes():
        for Ta in (1, 3, 4, 5, 17, 750, 1499, 1500):
            plan = tdtw.dtw_plan(N, Ta)
            assert plan.warps == -(-N // 32) and plan.warps * 32 >= N
            assert (plan.chunk, plan.ring) == (tdtw.DTW_CHUNK, tdtw.DTW_RING)
            # row i's words hold columns from -4 (i % 4): the last column fits
            assert (Ta - 1 + 12) // 16 < plan.words
            assert plan.smem == tdtw.dtw_smem_bytes(N, Ta) <= tdtw.DTW_SMEM_LIMIT
            assert plan.smem >= N * plan.words * 4
    assert tdtw.dtw_plan(440, 1500) == (14, 8, 4, 95, 232032)
    assert tdtw.dtw_plan(32, 1500).smem == 32 * 95 * 4 + 8 * 512  # one warp: no pair


@pytest.mark.parametrize("N,Ta", [(0, 1500), (1025, 10), (5, 0), (600, 1500), (1024, 1000)])
def test_plan_and_wrapper_refuse_what_the_kernel_cannot_take(N, Ta):
    """Shapes over the kernel's limits: `dtw_plan` raises ValueError, and so
    does the wrapper off the CPU before it looks at the device."""
    with pytest.raises(ValueError):
        tdtw.dtw_plan(N, Ta)
    cost = torch.zeros((1, 2 + N, Ta), device="meta")
    with pytest.raises(ValueError, match="dtw_anchor_frames_batch"):
        tdtw.dtw_anchor_frames_batch(cost, [1], [1], 2)


def _wavefront_model(cost, n_tok, n_frames, sot_len, seed=0):
    """`csrc/dtw.cu`'s algorithm in numpy f32, step by step: a warp's 32
    lanes as arrays, lane l on the 4-column block t - l at step t, `up` and
    `diag` from lane l - 1's block of the step before (lane 0: row 32w - 1's
    blocks as warp w - 1 hands them on, NaN past the last block, +inf above
    row 0), the row's first block left of column 0, the costs read as x + 0,
    each cell's two code bits (the sign bits of min - diag and of left - up)
    shifted in at the bottom of a word stored every four steps at word
    t // 4 - l // 4, words never stored left random; then the walk's bit
    scan of each row's words. -> [B, N] int32."""
    B, S, Ta = cost.shape
    N = S - sot_len
    words = tdtw.dtw_plan(N, Ta).words
    rng = np.random.default_rng(seed)
    inf = np.float32(np.inf)
    lanes = np.arange(32)
    out = np.zeros((B, N), np.int32)
    np_err = np.seterr(invalid="ignore")  # inf - inf left of column 0
    for b in range(B):
        nt, nf = int(np.clip(n_tok[b], 1, N)), int(np.clip(n_frames[b], 1, Ta))
        nblk = -(-nf // 4)
        n_steps = -(-(nblk + 31) // 8) * 8
        codes = rng.integers(0, 2 ** 32, size=(N, words), dtype=np.uint64)
        above = None
        for w in range(-(-nt // 32)):
            i = 32 * w + lanes
            rows = cost[b, sot_len + np.minimum(i, N - 1)].astype(np.float32)
            c = np.full((4, 32), inf, np.float32)
            pu3 = np.where(i == 0, np.float32(-0.0), inf).astype(np.float32)
            word = np.zeros(32, np.uint64)
            last = np.full((n_steps + 32, 4), np.nan, np.float32)  # row 32w + 31 by block
            for t in range(n_steps):
                k = t - lanes
                x = np.zeros((4, 32), np.float32)
                kc = np.clip(k, 0, nblk - 1)
                for e in range(4):
                    ok = 4 * kc + e < Ta
                    x[e, ok] = rows[ok, 4 * kc[ok] + e] + np.float32(0)
                u = np.empty((4, 32), np.float32)
                u[:, 1:] = c[:, :-1]
                u[:, 0] = inf if w == 0 else above[t]
                d = [pu3, u[0], u[1], u[2]]
                pu3 = u[3].copy()
                left = c[3]
                for e in range(4):
                    dg, up = d[e], u[e]
                    m = np.fmin(np.fmin(dg, up), left)
                    for diff in (m - dg, left - up):
                        word = (word << np.uint64(1)) | np.signbit(diff).astype(np.uint64)
                    c[e] = x[e] + m
                    left = c[e]
                word &= np.uint64(0xFFFFFFFF)
                if t % 4 == 3:
                    wi = t // 4 - lanes // 4
                    st = (i < nt) & (wi >= 0) & (wi < words)
                    codes[i[st], wi[st]] = word[st]
                if 0 <= t - 31 < nblk:
                    last[t - 31] = c[:, 31]
            above = last
        r, col = nt - 1, nf - 1
        while r > 0:
            o = 4 * (r & 3)
            pos = col + o
            wi = pos >> 4
            wd = int(codes[r, wi])
            m = ~(wd & (wd >> 1)) & 0x55555555 & ((0xFFFFFFFF << (30 - 2 * (pos & 15))) & 0xFFFFFFFF)
            while m == 0 and wi > 0:
                wi -= 1
                wd = int(codes[r, wi])
                m = ~(wd & (wd >> 1)) & 0x55555555
            lb = (m & -m).bit_length() - 1
            cc = 16 * wi + 15 - (lb >> 1) - o if m else 0
            out[b, r] = max(cc, 0)
            diag = cc > 0 and not (wd >> (lb + 1)) & 1
            col = cc - 1 if diag else max(cc, 0)
            r -= 1
    np.seterr(**np_err)
    return out


def _model_case(kind: str):
    """(cost, n_tok, n_frames, sot_len): N not a multiple of 32, N > 32 with
    rows at n_tok <= 32 and at 33 (the handoff's edges), n_frames < Ta,
    Ta % 4 != 0 (the kernel's scalar loads), costs with many ties."""
    rng = np.random.default_rng(len(kind))
    if kind == "ints-Ta37":
        B, N, Ta, sot_len = 5, 20, 37, 3
        cost = rng.integers(0, 9, size=(B, sot_len + N, Ta)).astype(np.float32)
        n_tok, n_frames = [20, 1, 7, 20, 13], [37, 1, 36, 2, 33]
    elif kind == "ties-N70":
        B, N, Ta, sot_len = 6, 70, 150, 4
        cost = (rng.random((B, sot_len + N, Ta)) < 0.02).astype(np.float32)
        n_tok, n_frames = [70, 1, 33, 32, 64, 70], [150, 1, 77, 149, 5, 150]
    elif kind == "floats-N64":
        B, N, Ta, sot_len = 3, 64, 100, 2
        cost = rng.standard_normal((B, sot_len + N, Ta)).astype(np.float32)
        n_tok, n_frames = [64, 31, 40], [100, 99, 3]
    else:  # "nan-garbage-N33": NaN in every cell outside the submatrix
        B, N, Ta, sot_len = 3, 33, 60, 3
        cost = rng.standard_normal((B, sot_len + N, Ta)).astype(np.float32)
        n_tok, n_frames = [33, 32, 10], [57, 60, 21]
        for b in range(B):
            cost[b, :sot_len] = np.nan
            cost[b, sot_len + n_tok[b]:] = np.nan
            cost[b, :, n_frames[b]:] = np.nan
    return cost, np.array(n_tok, np.int32), np.array(n_frames, np.int32), sot_len


@pytest.mark.parametrize("kind", ["ints-Ta37", "ties-N70", "floats-N64", "nan-garbage-N33"])
def test_wavefront_model_matches_plain(kind):
    """The kernel's wavefront, skewed code words and bit-scan walk, walked
    in numpy, give the plain version's anchors exactly."""
    cost, n_tok, n_frames, sot_len = _model_case(kind)
    want = _port(cost, n_tok, n_frames, sot_len)
    np.testing.assert_array_equal(_wavefront_model(cost, n_tok, n_frames, sot_len), want)


def test_wavefront_model_matches_plain_at_engine_width():
    """At Ta 1500 (375 blocks a row) and N 40 (two warps, the handoff)."""
    rng = np.random.default_rng(12)
    cost = rng.standard_normal((2, 44, 1500)).astype(np.float32)
    n_tok, n_frames = np.array([40, 35], np.int32), np.array([1500, 1234], np.int32)
    np.testing.assert_array_equal(_wavefront_model(cost, n_tok, n_frames, 4),
                                  _port(cost, n_tok, n_frames, 4))


@pytest.mark.parametrize("variant", ["probe", "no-ring", "no-code-stores", "no-copies",
                                     "no-shuffles", "no-ring-code-stores-copies"])
def test_bench_probe_edits_apply_to_the_kernel_source(variant):
    """`tools/bench_dtw.py --probe` builds its copies of `csrc/dtw.cu` by
    text edits that must each match the source once (the card builds them)."""
    from whisper_diarize_tpu_torch import kernels
    from whisper_diarize_tpu_torch.tools import bench_dtw

    src = (kernels.CSRC / "dtw.cu").read_text()
    edits = bench_dtw._PROBE + bench_dtw._ABLATIONS.get(variant, [])
    out = bench_dtw._edit(src, edits)
    assert "g_probe[0] = clock64() - clk;" in out and out.count("g_probe[1]") == 1


# --------------------------------------------------------------------------
# The alignment stage's median filter
# --------------------------------------------------------------------------

def _median_gather_form(w, n_frames, width=7):
    """The earlier form: every head's windows gathered at once,
    [B, K, S, Ta, width], then `median`."""
    B, K, S, Ta = w.shape
    pad = width // 2
    cols = torch.arange(Ta)
    taps = (cols[:, None] + torch.arange(-pad, pad + 1)[None, :]).abs()
    last = (n_frames.long() - 1)[:, None, None]
    taps_b = torch.clamp(last - (last - taps[None]).abs(), 0, Ta - 1)
    idx = taps_b[:, None, None].expand(B, K, S, Ta, width)
    win = torch.gather(w[..., None].expand(B, K, S, Ta, width), 3, idx)
    return win.median(dim=-1).values


def test_median_filter_batch_equals_the_gather_form():
    """Bit for bit, at reflect edges of every row's own n_frames (1 to Ta)."""
    rng = np.random.default_rng(21)
    w = torch.from_numpy(rng.standard_normal((5, 3, 6, 40)).astype(np.float32))
    w[1, :, :, 5:9] = 0.25  # ties inside a window
    nf = torch.tensor([40, 1, 2, 4, 23])
    got = tdtw.median_filter_batch(w, nf)
    assert torch.equal(got.view(torch.int32), _median_gather_form(w, nf).view(torch.int32))


def test_alignment_cost_batch_new_median_matches_gather_and_jax(monkeypatch):
    """`alignment_cost_batch` (its median a head at a time) with mixed
    n_frames and n_rows: bit for bit the cost of the gather form; within
    1e-5 of JAX's `alignment_cost` (the host form, on each row's valid
    rows and frames) and of JAX's `alignment_cost_batch`."""
    rng = np.random.default_rng(8)
    B, K, S, Ta = 4, 3, 12, 200
    qk = (rng.standard_normal((B, K, S, Ta)) * 3).astype(np.float32)
    nf = np.array([200, 57, 9, 130], np.int64)
    nr = np.array([12, 5, 9, 1], np.int64)
    args = torch.from_numpy(qk), torch.from_numpy(nf), torch.from_numpy(nr)
    got = tdtw.alignment_cost_batch(*args)
    monkeypatch.setattr(tdtw, "median_filter_batch", _median_gather_form)
    ref = tdtw.alignment_cost_batch(*args)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    jb = np.asarray(jdtw.alignment_cost_batch(jnp.asarray(qk), jnp.asarray(nf, jnp.int32),
                                              jnp.asarray(nr, jnp.int32)))
    for b in range(B):
        rows, cols = int(nr[b]), int(nf[b])
        np.testing.assert_allclose(got[b, :rows, :cols].numpy(),
                                   jdtw.alignment_cost(qk[b, :, :rows], cols),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[b, :rows, :cols].numpy(), jb[b, :rows, :cols],
                                   rtol=0, atol=1e-5)


def test_alignment_cost_and_token_anchor_times_match_jax():
    rng = np.random.default_rng(2)
    qk = (rng.standard_normal((3, 20, 200)) * 3).astype(np.float32)
    for n_frames in (200, 77, 2):
        np.testing.assert_allclose(tdtw.alignment_cost(qk, n_frames),
                                   jdtw.alignment_cost(qk, n_frames), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tdtw.token_anchor_times(qk, n_frames),
                                   jdtw.token_anchor_times(qk, n_frames), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# The Engine's default path
# --------------------------------------------------------------------------

CFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The JAX random init with printable bytes favoured (as
    `tests/test_torch_engine.py`), so DTW has words to place."""
    d = tmp_path_factory.mktemp("snap")
    p = jax.tree.map(np.asarray, jwm.init_params(CFG, seed=0))
    emb = p["decoder"]["tok_emb"].copy()
    emb[33:127] *= np.random.default_rng(0).uniform(2.0, 4.0, (94, 1)).astype(np.float32)
    emb[256:DebugTokenizer().specials.eot] = 0.0
    p["decoder"]["tok_emb"] = emb
    jweights.save_params(p, CFG, d)
    return str(d)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """40 s of noise with a 3 s gap: two seek-advanced 30 s windows."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(16000 * 40) * 4000).astype(np.int16)
    x[16000 * 12:16000 * 15] = 0
    p = tmp_path_factory.mktemp("audio") / "in.wav"
    write_wav(str(p), x)
    return str(p)


def _kw(snapshot, tmp_path):
    return dict(cache_dir=str(tmp_path / "cache"), whisper_model_path=snapshot,
                enable_dtw=True, batch_size=2, max_decode_tokens=32,
                vad_model_path="__random__", temperature_fallback=False)


def _cues(cues):
    return [(c.text, c.start, c.end, [(w.text, w.start, w.end) for w in c.words or []])
            for c in cues]


@pytest.mark.parametrize("enable_vad", [False, True], ids=["whole-file", "vad"])
def test_default_alignment_matches_jax_engine(snapshot, wav, tmp_path, monkeypatch, enable_vad):
    """No `WDT_HOST_DTW` on either side: the JAX Engine's on-device DTW
    against the port's (the plain version on the CPU), greedy."""
    monkeypatch.delenv("WDT_HOST_DTW", raising=False)
    opts = TranscribeOptions(enable_vad=enable_vad, lang="en",
                             advanced=AdvancedTranscribe(sampling_strategy="greedy"))
    ref = JEngine(JEngineConfig(**_kw(snapshot, tmp_path / "jax"))).transcribe_audio(wav, opts)
    got = Engine(EngineConfig(use_gpu=False, **_kw(snapshot, tmp_path))).transcribe_audio(
        wav, opts)
    assert got and any(c.words for c in got)
    assert [c.text for c in got] == [c.text for c in ref]
    for a, b in zip(ref, got):
        assert abs(a.start - b.start) <= TOL and abs(a.end - b.end) <= TOL
        assert [w.text for w in a.words or []] == [w.text for w in b.words or []]
        for wa, wb in zip(a.words or [], b.words or []):
            assert abs(wa.start - wb.start) <= TOL and abs(wa.end - wb.end) <= TOL


@pytest.mark.parametrize("advanced", [None, AdvancedTranscribe(sampling_strategy="greedy")],
                         ids=["beam", "greedy"])
def test_host_and_device_paths_give_identical_cues(snapshot, wav, tmp_path, monkeypatch,
                                                   advanced):
    """The port with and without `WDT_HOST_DTW=1`: the same cues and words,
    to the bit. The default path runs the device DP and fetches only [B, N]
    int32 anchors (never the host DP); the host path runs no device DP."""
    calls = {"device": [], "host": 0}
    dev_fn, host_fn = tdtw.dtw_anchor_frames_batch, tdtw.anchor_times_from_cost

    def device(*a, **k):
        out = dev_fn(*a, **k)
        calls["device"].append((out.dtype, out.dim()))
        return out

    def host(*a, **k):
        calls["host"] += 1
        return host_fn(*a, **k)

    monkeypatch.setattr(tdtw, "dtw_anchor_frames_batch", device)
    monkeypatch.setattr(tdtw, "anchor_times_from_cost", host)
    opts = TranscribeOptions(enable_vad=False, lang="en", advanced=advanced)
    eng = Engine(EngineConfig(use_gpu=False, **_kw(snapshot, tmp_path)))
    monkeypatch.delenv("WDT_HOST_DTW", raising=False)
    default = eng.transcribe_audio(wav, opts)
    assert calls["device"] and set(calls["device"]) == {(torch.int32, 2)}
    assert calls["host"] == 0
    n_device = len(calls["device"])
    monkeypatch.setenv("WDT_HOST_DTW", "1")
    hosted = eng.transcribe_audio(wav, opts)
    assert len(calls["device"]) == n_device and calls["host"] > 0
    assert any(c.words for c in default)
    assert _cues(default) == _cues(hosted)
