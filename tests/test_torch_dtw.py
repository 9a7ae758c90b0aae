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
    assert tdtw.dtw_smem_bytes(440, 1500) == 172480 <= tdtw.DTW_SMEM_LIMIT
    assert tdtw.dtw_smem_bytes(1024, 1500) > tdtw.DTW_SMEM_LIMIT


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
