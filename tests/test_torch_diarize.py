"""Diarization in the PyTorch port against the JAX package on the CPU: the
kaldi fbank, the segmentation net, CAM++, the window batching of
`get_segments_batch`, the speaker clustering, and the check the card's run
is held to (`models/net_check.py`) with its planted faults.

Inputs are drawn with numpy from a seed; weights are the JAX package's
`init_params` carried across with `params_from_jax` (and the port's
`init_params_np` draws the same arrays). Tolerances: fbank 1e-3 absolute
(log domain, int16-scale input), segmentation log-probs 2e-4, embeddings
5e-4 and cosine >= 0.9999, activity and clustering exact.

Decisions at thresholds: at random weights the log-probs are nearly
uniform and many frames have a top-2 gap under 1e-3, so a fixed gap cannot
be asserted. Tests that compare segments first assert, on the
JAX side, that every frame's top-2 gap exceeds twice the largest
log-prob difference between the packages measured in the same run (below
that the argmax could flip without a fault); a near-tie fails loudly as a
precondition instead of passing by luck.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu import diarize as jdz
from whisper_diarize_tpu.models import campplus as jcp
from whisper_diarize_tpu.models import segmentation as jseg
from whisper_diarize_tpu.ops import mel as jmel
from whisper_diarize_tpu_torch import diarize as tdz
from whisper_diarize_tpu_torch.models import campplus as tcp
from whisper_diarize_tpu_torch.models import net_check
from whisper_diarize_tpu_torch.models import segmentation as tseg
from whisper_diarize_tpu_torch.ops import mel as tmel

torch.set_num_threads(2)
W = jseg.WINDOW_SAMPLES


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def seg():
    """(JAX params, port params) of the segmentation net, seed 0."""
    jp = jseg.init_params(0)
    return jp, tseg.params_from_jax(_np(jp))


@pytest.fixture(scope="module")
def cp():
    """(JAX params, port params) of CAM++, seed 0."""
    jp = jcp.init_params(0)
    return jp, tcp.params_from_jax(_np(jp))


def _speechlike(seconds: float, seed: int) -> np.ndarray:
    """i16 noise bursts: 1.5 s of a buzz in noise every 2 s."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    x = rng.standard_normal(n) * 0.02
    x += ((t % 2.0) < 1.5) * np.sin(2 * np.pi * 180.0 * t) * (0.3 + 0.2 * rng.standard_normal(n))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


@pytest.mark.parametrize("net", ["segmentation", "campplus"])
def test_init_params_np_equal_jax(net):
    jmod, tmod = {"segmentation": (jseg, tseg), "campplus": (jcp, tcp)}[net]
    ref = jax.tree.leaves(_np(jmod.init_params(3)))
    got = jax.tree.leaves(tmod.init_params_np(3))
    assert len(got) == len(ref) > 10
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["batch", "int16-1d"])
def test_kaldi_fbank_matches_jax(form):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 40000)) * 3000).astype(np.float32)
    if form == "int16-1d":
        x = (x[0] + 1).astype(np.int16)
    ref = np.asarray(jmel.kaldi_fbank(np.asarray(x, np.float32)))
    got = tmel.kaldi_fbank(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="too short"):
        tmel.kaldi_fbank(np.zeros(399, np.float32))


@pytest.mark.parametrize("window", ["sincnet", "torch", "hann", "kernel", "env"])
def test_segmentation_forward_matches_jax(seg, window, monkeypatch):
    """Full width, two 10 s windows. "kernel": the converted-filterbank form
    (`params["sinc"]["kernel"]`); "env": the default read from
    WDT_SINC_WINDOW."""
    jp, tp = seg
    x = (np.random.default_rng(2).standard_normal((2, W)) * 0.1).astype(np.float32)
    kw = {"sinc_window": window}
    if window == "kernel":
        jp = dict(jp, sinc={"kernel": jseg._sinc_kernel(jp["sinc"]["low_hz"],
                                                        jp["sinc"]["band_hz"], "torch")})
        tp = tseg.params_from_jax(_np(jp))
        kw = {}
    elif window == "env":
        monkeypatch.setenv("WDT_SINC_WINDOW", "hann")
        kw = {}
    ref = np.asarray(jseg.forward(jp, x, **kw))
    with torch.inference_mode():
        got = tseg.forward(tp, x, **kw).numpy()
    assert got.shape == ref.shape == (2, tseg.n_out_frames(W), tseg.N_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    if window == "env":
        with pytest.raises(ValueError, match="window_mode"):
            tseg.forward(tp, x[:1], sinc_window="blackman")


def test_powerset_to_activity_exact(seg):
    rng = np.random.default_rng(3)
    lp = rng.standard_normal((3, 50, 7)).astype(np.float32)
    np.testing.assert_array_equal(tseg.powerset_to_activity(torch.from_numpy(lp)),
                                  jseg.powerset_to_activity(lp))
    assert tseg.powerset_to_activity(lp).shape == (3, 50, 3)


def _close_embeddings(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    cos = (got * ref).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() >= 0.9999


def test_embed_from_fbank_matches_jax(cp):
    """B 2, about 300 frames, the second row masked after 180."""
    jp, tp = cp
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 301, 80)).astype(np.float32)
    mask = np.ones((2, 301), np.float32)
    mask[1, 180:] = 0.0
    feats[1, 180:] = 0.0
    ref = jcp.embed_from_fbank(jp, jnp.asarray(feats), jnp.asarray(mask))
    with torch.inference_mode():
        got = tcp.embed_from_fbank(tp, torch.from_numpy(feats), torch.from_numpy(mask))
    _close_embeddings(got, ref)


def test_embed_from_audio_matches_jax(cp):
    """One row valid to its end, one with fewer than 400 samples valid
    (frame 0 forced), one empty."""
    jp, tp = cp
    audio = (np.random.default_rng(5).standard_normal((3, 48240)) * 0.1).astype(np.float32)
    n_valid = np.array([48240, 250, 0])
    ref = jcp.embed_from_audio(jp, jnp.asarray(audio), jnp.asarray(n_valid, jnp.int32))
    with torch.inference_mode():
        got = tcp.embed_from_audio(tp, torch.from_numpy(audio), n_valid)
    _close_embeddings(got, ref)


def test_compute_embeddings_batch_matches_jax(cp):
    """Segments of 300 frames, 125 frames, and one shorter than a frame;
    the single-segment entry point too."""
    jp, tp = cp
    rng = np.random.default_rng(6)
    segs = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (48240, 20000, 300)]
    with torch.inference_mode():
        got = tcp.compute_embeddings_batch(tp, segs, device="cpu")
        one = tcp.compute_embedding(tp, segs[1], device="cpu")
    _close_embeddings(got, jcp.compute_embeddings_batch(jp, segs))
    _close_embeddings(one[None], jcp.compute_embedding(jp, segs[1])[None])


def _record(monkeypatch, module, sink):
    """Wrap `module.forward` so every call's log-probs land in `sink`."""
    inner = module.forward

    def forward(params, audio, *a, **kw):
        out = inner(params, audio, *a, **kw)
        sink.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "forward", forward)


def assert_decision_margin(jax_lp, port_lp):
    """Precondition: every frame's top-2 gap on the JAX side exceeds twice
    the largest log-prob difference between the packages."""
    err = float(np.abs(jax_lp - port_lp).max())
    top2 = np.sort(jax_lp, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert err < 1e-4, f"log-probs differ by {err}"
    assert gap.min() > 2 * err, (
        f"precondition: a near-tie (top-2 gap {gap.min():.3g} <= 2 x {err:.3g}) "
        "could flip the powerset argmax")


@pytest.mark.parametrize("max_windows", [128, 2], ids=["one-batch", "window-bound"])
def test_get_segments_batch_matches_jax(seg, monkeypatch, max_windows):
    """A 25 s and a 3 s stream (four windows, the last of each zero-padded)
    in one batch; with MAX_WINDOWS_PER_BATCH = 2 the 25 s stream spans two
    forwards. Each stream's segments equal the JAX `get_segments` of that
    stream alone, the contract `get_segments_batch` states. (The JAX
    `get_segments_batch` itself hands a stream the windows that start at
    the count of earlier streams, not of earlier windows, so behind a
    stream of more than one window it reads another stream's windows: a
    fault of the reference, ROADMAP Queue 3, which the port does not copy.)"""
    jp, tp = seg
    streams = [_speechlike(25.0, 7), _speechlike(3.0, 8)]
    monkeypatch.setattr(jdz, "MAX_WINDOWS_PER_BATCH", max_windows)
    monkeypatch.setattr(tdz, "MAX_WINDOWS_PER_BATCH", max_windows)
    jcalls, tlp = [], []
    _record(monkeypatch, jdz.segmentation, jcalls)
    _record(monkeypatch, tdz.segmentation, tlp)
    ref, jlp = [], []
    for x in streams:
        ref.append(jdz.get_segments(x, 16000, jp))
        jlp.append(np.concatenate(jcalls)[:-(-len(x) // W)])  # bucket rows dropped
        jcalls.clear()
    with torch.inference_mode():
        got = tdz.get_segments_batch(streams, 16000, tp, device="cpu")
    assert len(tlp) == (1 if max_windows > 4 else 2)
    assert_decision_margin(np.concatenate(jlp), np.concatenate(tlp))
    assert all(ref) and len(got) == len(ref)
    for r, g in zip(ref, got):
        assert [(s.start, s.end) for s in g] == [(s.start, s.end) for s in r]
        for a, b in zip(r, g):
            np.testing.assert_array_equal(a.samples, b.samples)
    with torch.inference_mode():
        single = tdz.get_segments(streams[1], seg_params=tp, device="cpu")
    assert [(s.start, s.end) for s in single] == [(s.start, s.end) for s in got[1]]
    assert tdz.get_segments_batch([np.zeros(0, np.int16)], device="cpu") == [[]]
    with pytest.raises(ValueError, match="16 kHz"):
        tdz.get_segments(streams[1], 8000, tp, device="cpu")


def test_embedding_manager_matches_jax():
    """The same embedding stream through both managers: the same ids at the
    threshold and at the cap, the same centroids."""
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((4, 32))
    embs = [centers[i % 4] + 0.3 * rng.standard_normal(32) for i in range(40)]
    for max_speakers, threshold in ((3, 0.5), (8, 0.7), (2, 0.9)):
        jm, tm = jdz.EmbeddingManager(max_speakers), tdz.EmbeddingManager(max_speakers)
        ids = []
        for e in embs:
            pair = []
            for m in (jm, tm):
                if len(m.get_all_speakers()) == max_speakers:
                    pair.append(m.get_best_speaker_match(e))
                else:
                    pair.append(m.search_speaker(e, threshold))
            assert pair[0] == pair[1]
            ids.append(pair[0])
        assert len(set(ids)) > 1
        for sid, sp in jm.get_all_speakers().items():
            np.testing.assert_array_equal(tm.get_all_speakers()[sid].centroid, sp.centroid)
    assert tdz.cosine_similarity(np.zeros(3), np.ones(3)) == 0.0


def test_spectral_cluster_matches_jax():
    rng = np.random.default_rng(10)
    centers = rng.standard_normal((3, 16)) * 3
    embs = np.concatenate([c + 0.4 * rng.standard_normal((7, 16)) for c in centers])
    for kw in ({}, {"max_speakers": 2}, {"min_speakers": 2, "max_speakers": 5}):
        np.testing.assert_array_equal(tdz.spectral_cluster(embs, **kw),
                                      jdz.spectral_cluster(embs, **kw))
    assert tdz.spectral_cluster(np.zeros((0, 4))).shape == (0,)
    assert tdz.spectral_cluster(np.ones((1, 4))).tolist() == [0]


def test_net_check_refuses_the_planted_faults(seg, cp):
    """The card's check (`net_check.check`) run with the CPU on both sides:
    the outputs agree and each planted fault is refused."""
    _, sp = seg
    _, ep = cp
    with torch.inference_mode():
        lines = net_check.check(sp, ep, sp, ep, _speechlike(22.0, 11), batch=3)
    assert set(lines) == {"fbank", "log_probs", "embeddings", "fbank without pre-emphasis",
                          "BiLSTM backward direction run forward", "CAM++ frame mask ignored"}


def test_exact_f32_restores_the_flags():
    from whisper_diarize_tpu_torch.utils import exact_f32

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with exact_f32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
