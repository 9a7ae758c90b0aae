"""The hand-written CUDA kernels on the card (marker `cuda`; skipped where
torch sees no CUDA device). Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Each kernel against its plain version in bf16 on the same device, at small
shapes with Dh = 64, a ragged audio length (K1-K3, K5, K6 in its three int8
forms) and ragged prompt and decode lengths with row pads and a random
ancestry (K4, at K 1 - 8, through its ring at long steps, bit for bit
across two calls, NaN for a beam with a bad ancestor only, its plan equal
to `attn.split_self_plan`), the fused greedy path's kernels (K7 log-mel, K8 decoder
front, K10 encoder attention in both forms), the diagnostic kernels (K9a /
K9c / K9d, K1's forms; the stream sums K9b and K11a / K11b, held to their
float64 value by `agreement.compare_sum`), with the tolerance of
`whisper_diarize_tpu_torch/kernels/agreement.py` (a few bf16 ulps per
element and 1e-2 relative L2 of the update; K3 is judged on the update it
adds to x; K7, an f32 kernel, on an absolute bound), and the planted faults
that check must refuse. K1 / K5 also at the key splits of the served
shapes (Q 1, 5 and 64, B 1 and 8, ta not a multiple of a span) with the
split's faults; K10 at T 1500 with a fault of its TMA ring; K2 at every
preset width over ragged streams, and at 1, 3 and 5 heads (a head split's
local heads: each half's 64-column edge tile), its tile walk equal to
its mirror; K3 / K6 / K8 (the split skinny GEMM) at
N 1 - 80 with the split's faults, and both bit for bit across two calls.
The diarization nets (kaldi fbank, segmentation, CAM++: plain PyTorch, no
kernel) on the card against their f32 CPU run with TF32 left at PyTorch's
defaults and with TF32 allowed everywhere (`models/net_check.py`: fbank
1e-3, log-probs 1e-3 with the argmax equal where the CPU's top-2 gap
exceeds 1e-3, embeddings cosine >= 0.9999; its planted faults refused),
and a diarized Engine request at the tiny preset through K1 - K3.
Speculative greedy decoding at the tiny preset on the card (K1 - K3) held
to the margin check of `chip_smoke.spec_gap`, its planted fault refused;
the checkpoint-file loaders onto the card. The DTW kernel (`csrc/dtw.cu`)
against its plain version, anchors equal exactly, on float and tie-heavy
costs with clipped and ragged rows, bit for bit across two calls, the
shapes it refuses. The f32 forms: each against its
f32 plain version by `agreement.F32` (`F32_Q8` over the int8 cache), with
the TF32 and bf16-rounding faults refused by `F32_REFUSAL`; the f32 skinny
GEMM at N 1 - 80 and K2-f32 at every preset width, bit for bit across two
calls too. The tracer's clock: a span that synchronizes holds the kernel
launched inside it, as the profiler recorded it. The beam step as one CUDA
graph (`ops/beam_graph.py`): K4 reading the step and the prompt's length
from device memory (its launch planned for the whole caches) gives the
ints' bits, agrees with its plain version in a prompt buffer longer than
the prompt, its faults refused, NaN for a value out of range;
`beam_decode` with the graph equals the eager path at large-v3 widths (B
16, K 5, 64 steps; bf16, f32, int8 cross K/V), one capture a shape,
whatever the prompt's length.
"""

import dataclasses
import itertools

import pytest
import torch

from whisper_diarize_tpu_torch import tracing
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import (attn, attn_probe, beam_graph, encoder_attn, front,
                                           mel, stream, tail)
from whisper_diarize_tpu_torch.ops import decode as dec
from whisper_diarize_tpu_torch.ops import dtw as dtw_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,Ta,Q", [(2, 100, 3), (3, 1500, 17)])
def test_kernels_match_plain_on_card(dev, B, Ta, Q):
    g = torch.Generator(device=dev).manual_seed(B)
    L, H, Dh = 2, 2, 64
    D = H * Dh
    blocks = ag.random_blocks(L, D, g, dev)
    xa = ag.randn(g, dev, B, Ta, D)
    a = (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    before = attn.cross_kv_build.launches
    k, v = attn.cross_kv_build(*a)
    assert attn.cross_kv_build.launches == before + 1
    ag.compare("K2 k", k, attn.cross_kv_build_plain(*a)[0])
    ag.compare("K2 v", v, attn.cross_kv_build_plain(*a)[1])
    for name, i, bad in ag.k2_faults(*a):
        ag.reject(name, (k, v)[i], bad)
    q = ag.randn(g, dev, B, Q, H, Dh, scale=2.0)
    for layer in range(L):
        got = attn.cross_attn_layer(layer, q, k, v, Ta - 7)
        ag.compare("K1", got, attn.cross_attn_layer_plain(layer, q, k, v, Ta - 7))
        for name, bad in ag.k1_faults(layer, q, k, v, Ta - 7):
            ag.reject(name, got, bad)
        for beams in (1, 3):
            x = ag.randn(g, dev, B * beams, 1, D)
            so = ag.randn(g, dev, B * beams, H, 1, Dh, scale=0.3)
            args = (layer, x, so, blocks, k, v, beams, Ta)
            got = tail.fused_tail_layer(*args)
            ag.compare("K3 update", got, tail.fused_tail_layer_plain(*args), base=x)
            for name, bad in ag.k3_faults(*args):
                ag.reject(name, got, bad, base=x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,Ta,Q", [(2, 100, 3), (3, 1500, 17)])
def test_int8_kernels_match_plain_on_card(dev, B, Ta, Q):
    """K5 over the int8 cache, and K6 with int8 weights, the int8 cache, or
    both, against their plain versions; their planted faults refused."""
    g = torch.Generator(device=dev).manual_seed(10 + B)
    L, H, Dh = 2, 2, 64
    D = H * Dh
    blocks = ag.random_blocks(L, D, g, dev)
    q8w = tail.quantize_tail_weights(blocks)
    k, v = (ag.randn(g, dev, L, B, H, Ta, Dh) for _ in range(2))
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    q = ag.randn(g, dev, B, Q, H, Dh, scale=2.0)
    for layer in range(L):
        a = (layer, q, k8, ks, v8, vs, Ta - 7)
        before = attn.cross_attn_layer_q8.launches
        got = attn.cross_attn_layer_q8(*a)
        assert attn.cross_attn_layer_q8.launches == before + 1
        ag.compare("K5", got, attn.cross_attn_layer_q8_plain(*a))
        for name, bad in ag.k5_faults(*a):
            ag.reject(name, got, bad)
        for beams in (1, 3):
            x = ag.randn(g, dev, B * beams, 1, D)
            so = ag.randn(g, dev, B * beams, H, 1, Dh, scale=0.3)
            for wts, cache in ((q8w, (k, v, None, None)), (blocks, (k8, v8, ks, vs)),
                               (q8w, (k8, v8, ks, vs))):
                args = (layer, x, so, wts, cache[0], cache[1], beams, Ta, cache[2], cache[3])
                before = (tail.fused_tail_layer.launches, tail.fused_tail_layer.launches_int8)
                got = tail.fused_tail_layer(*args)
                assert (tail.fused_tail_layer.launches,
                        tail.fused_tail_layer.launches_int8) == (before[0], before[1] + 1)
                ag.compare("K6 update", got, tail.fused_tail_layer_plain(*args), base=x)
                for name, bad in ag.k6_faults(*args):
                    ag.reject(name, got, bad, base=x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,Q,Ta,ta", [(1, 1, 1500, 1500), (1, 5, 1500, 1493), (2, 64, 1500, 1500),
                                        (8, 5, 1500, 1500), (2, 3, 700, 650)])
def test_k1_k5_key_split_on_card(dev, B, Q, Ta, ta):
    """K1 and K5 with their keys split across a cluster (`cross_attn_plan`:
    several spans at each shape; ta not a multiple of a span where it is
    1493 or 650) against their plain versions and the plain model of the
    split; the split's planted faults (a span dropped, the spans combined
    without their rescale) refused; two calls give the same bits (the
    combine runs in span order)."""
    g = torch.Generator(device=dev).manual_seed(B * 1000 + Q)
    L, H = 2, 3
    assert attn.cross_attn_plan(B, H, Q, ta).n_span > 1
    q = ag.randn(g, dev, B, Q, H, 64, scale=2.0)
    k, v = (ag.randn(g, dev, L, B, H, Ta, 64) for _ in range(2))
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    for layer in range(L):
        got = attn.cross_attn_layer(layer, q, k, v, ta)
        assert torch.equal(got, attn.cross_attn_layer(layer, q, k, v, ta))
        ag.compare(f"K1 B={B} Q={Q} ta={ta}", got, attn.cross_attn_layer_plain(layer, q, k, v, ta))
        ag.compare("K1 vs the split model", got, attn.cross_attn_split_plain(layer, q, k, v, ta))
        names = [name for name, bad in ag.k1_faults(layer, q, k, v, ta)
                 if not ag.reject(name, got, bad).ok]
        assert "K1 spans combined without their rescale" in names
        got = attn.cross_attn_layer_q8(layer, q, k8, ks, v8, vs, ta)
        assert torch.equal(got, attn.cross_attn_layer_q8(layer, q, k8, ks, v8, vs, ta))
        ag.compare(f"K5 B={B} Q={Q} ta={ta}", got,
                   attn.cross_attn_layer_q8_plain(layer, q, k8, ks, v8, vs, ta))
        names = [name for name, bad in ag.k5_faults(layer, q, k8, ks, v8, vs, ta)
                 if not ag.reject(name, got, bad).ok]
        assert "K5 a span dropped" in names
    torch.cuda.synchronize()


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    q = torch.zeros(1, 1, 2, 32, dtype=torch.bfloat16, device=dev)  # Dh 32
    k = torch.zeros(1, 1, 2, 10, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        attn.cross_attn_layer(0, q, k, k)
    with pytest.raises(TypeError):
        attn.cross_attn_layer(0, q.float(), k, k)  # f32 q over a bf16 cache: mixed
    q64 = torch.zeros(1, 2, 2, 64, dtype=torch.bfloat16, device=dev)
    p64 = torch.zeros(1, 1, 2, 4, 64, dtype=torch.bfloat16, device=dev)
    d64 = torch.zeros(1, 2, 2, 8, 64, dtype=torch.bfloat16, device=dev)
    anc = torch.zeros(1, 2, 8, dtype=torch.int32, device=dev)
    rp = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        attn.split_self_attn_layer(0, q64, p64, p64, d64, d64, anc.float(), 0, rp, 4)
    with pytest.raises(ValueError):
        attn.split_self_attn_layer(0, q64, p64, p64, d64, d64, anc, 8, rp, 4)
    with pytest.raises(ValueError):
        attn.split_self_attn_layer(0, q64, p64, p64, d64, d64, anc[:, :, :4], 0, rp, 4)
    k8 = torch.zeros(1, 1, 2, 4, 64, dtype=torch.int8, device=dev)
    s8 = torch.zeros(1, 1, 2, 4, dtype=torch.float32, device=dev)
    q1 = q64[:, :1]
    with pytest.raises(TypeError):  # scales must be f32
        attn.cross_attn_layer_q8(0, q1, k8, s8.bfloat16(), k8, s8.bfloat16())
    with pytest.raises(TypeError):  # payloads must be int8
        attn.cross_attn_layer_q8(0, q1, p64, s8, p64, s8)
    with pytest.raises(ValueError):
        attn.cross_attn_layer_q8(0, q1, k8, s8[..., :3], k8, s8[..., :3])


@pytest.mark.parametrize("B,K,Tp,Td", [(2, 3, 11, 32), (1, 5, 3, 64), (3, 5, 19, 224),
                                     (2, 1, 11, 32), (2, 8, 11, 32), (1, 1, 19, 224),
                                     (2, 8, 19, 224)])
def test_k4_matches_plain_on_card(dev, B, K, Tp, Td):
    """At Td 224 the middle and last steps run K4's ring
    (`attn.split_self_plan`), at K 1 and 8 too."""
    g = torch.Generator(device=dev).manual_seed(B * 100 + Td + K)
    L, H = 2, 3
    q = ag.randn(g, dev, B, K, H, 64, scale=2.0)
    pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64) for _ in range(2))
    dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, device=dev)  # int64: converted
    row_pad = torch.randint(0, Tp - 2, (B,), generator=g, device=dev)
    for step in sorted({0, Td // 2 - 1, Td // 2, Td - 1}):
        for layer in range(L):
            a = (layer, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp - 1)
            before = attn.split_self_attn_layer.launches
            got = attn.split_self_attn_layer(*a)
            assert attn.split_self_attn_layer.launches == before + 1
            ag.compare(f"K4 B={B} K={K} step={step}", got, attn.split_self_attn_layer_plain(*a))
            if step and Tp > 3 and K > 1:  # the faults are the truth at K 1
                for name, bad in ag.k4_faults(*a):
                    ag.reject(name, got, bad)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("Td,step", [(64, 31), (224, 111), (224, 223)])
def test_k4_same_bits_and_bad_ancestor_on_card(dev, dtype, Td, step):
    """Two calls give the same bits (one load phase at step 31, the ring at
    Td 224); an ancestor set to K in one beam makes that beam's output NaN,
    and the other beams still match the plain version."""
    g = torch.Generator(device=dev).manual_seed(Td + step)
    L, B, K, H, Tp = 2, 3, 5, 4, 19
    q = ag.randn(g, dev, B, K, H, 64, scale=2.0, dtype=dtype)
    pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64, dtype=dtype) for _ in range(2))
    dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64, dtype=dtype) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, device=dev, dtype=torch.int32)
    row_pad = torch.tensor([2, 0, 16], dtype=torch.int32, device=dev)
    a = (1, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp)
    got = attn.split_self_attn_layer(*a)
    assert torch.equal(got, attn.split_self_attn_layer(*a))
    bad = anc_j.clone()
    bad[1, 2, step // 2] = K
    nan = attn.split_self_attn_layer(1, q, pk, pv, dk, dv, bad, step, row_pad, Tp)
    assert bool(nan[1, 2].isnan().all())
    keep = torch.ones(B, K, dtype=torch.bool, device=dev)
    keep[1, 2] = False
    assert not bool(nan[keep].isnan().any())
    tol = ag.F32 if dtype == torch.float32 else ag.BF16
    ag.compare(f"K4 {dtype} bad ancestor, other beams", nan[keep],
               attn.split_self_attn_layer_plain(*a)[keep], tol=tol)
    torch.cuda.synchronize()


def test_k4_plan_matches_its_mirror_on_card(dev):
    """`csrc/split_self.cu::make_plan` (the C entry `wdt_split_self_plan`)
    gives the plan `attn.split_self_plan` mirrors, over K 1 - 8, prompts
    of 1, 3, 19 and 227 slots and every step of 224, both dtypes."""
    import ctypes

    from whisper_diarize_tpu_torch import kernels

    lib = kernels.library()
    out = (ctypes.c_int * 4)()
    for f32 in (False, True):
        for K in range(1, 9):
            for P in (1, 3, 19, 227):
                for step in range(224):
                    assert lib.wdt_split_self_plan(K, P, step, int(f32), out) == 0
                    assert tuple(out) == attn.split_self_plan(K, P, P, step, f32), (K, P, step)
    assert lib.wdt_split_self_plan(200, 227, 223, 0, out) != 0


def test_top_k_tie_order_on_card(dev):
    x = torch.randn(4, 51866, device=dev).clamp(max=2.0)
    x[0, 7:] = float("-inf")
    x[1, 100:200] = 3.0
    x[2] = float("-inf")
    x[3, ::3] = 0.5
    v, i = dec._top_k(x, 10)
    ref_v, ref_i = dec._top_k(x.cpu(), 10)
    assert torch.equal(v.cpu(), ref_v) and torch.equal(i.cpu(), ref_i)
    assert i[1].tolist() == list(range(100, 110)) and i[2].tolist() == list(range(10))


@pytest.mark.parametrize("B,T,n_mels", [(2, 16000 * 3 + 4800, 80), (3, 480000, 128),
                                         (2, 333, 80), (3, 337 * 160 + 3, 128)])
def test_k7_matches_plain_on_card(dev, B, T, n_mels):
    """K7 (f32 on the CUDA cores) against its plain version, within
    `agreement.F32_ATOL`; its planted faults refused. T 333: two frames, one
    CTA whose span passes both ends of the audio; T 337 x 160 + 3: rows not
    16-byte aligned, so every CTA stages its span sample by sample."""
    g = torch.Generator(device=dev).manual_seed(T)
    audio = torch.randn(B, T, generator=g, device=dev) * 0.3
    audio[:, : T // 4] *= 0.01  # a quiet stretch: small powers
    before = mel.log_mel_fused.launches
    got = mel.log_mel_fused(audio, n_mels)
    assert mel.log_mel_fused.launches == before + 1
    ag.compare("K7", got, mel.log_mel_fused_plain(audio, n_mels), atol=ag.F32_ATOL)
    for name, bad in ag.k7_faults(audio, n_mels):
        ag.reject(name, got, bad, atol=ag.F32_ATOL)
    torch.testing.assert_close(mel.frontend(audio, n_mels),
                               mel.log_mel_spectrogram(audio, n_mels), rtol=0, atol=5e-5)
    torch.cuda.synchronize()


def test_k7_one_kernel_and_the_same_bits_on_card(dev):
    """A `log_mel_fused` call at the fused path's shape (B 8 x 30 s, 128
    mels) launches one kernel (no padded copy of the audio), and two calls
    give the same bits."""
    from whisper_diarize_tpu_torch.tools import timing

    g = torch.Generator(device=dev).manual_seed(16)
    audio = torch.randn(8, 480000, generator=g, device=dev) * 0.1
    launched = timing.device_ms_by_kernel(lambda: mel.log_mel_fused(audio, 128))
    assert list(launched) == ["log_mel_kernel"], launched
    assert torch.equal(mel.log_mel_fused(audio, 128), mel.log_mel_fused(audio, 128))


@pytest.mark.parametrize("N,Tc,pos", [(3, 16, 0), (6, 48, 9), (40, 448, 300)])
def test_k8_matches_plain_on_card(dev, N, Tc, pos):
    """K8 against its plain version (self_out, k_new, v_new and the caches
    it leaves), with row pads; its planted faults refused where pos > 0."""
    g = torch.Generator(device=dev).manual_seed(N * 1000 + pos)
    L, H = 2, 4
    D = 64 * H
    fw = ag.random_front(L, D, g, dev)
    x = ag.randn(g, dev, N, 1, D)
    kc, vc = (ag.randn(g, dev, L, N, H, Tc, 64) for _ in range(2))
    row_pad = torch.randint(0, pos + 1, (N,), generator=g, device=dev)
    for layer in range(L):
        ck, cv, pk, pv = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        before = front.fused_front_layer.launches
        got = front.fused_front_layer(layer, pos, row_pad, x, fw, ck, cv)
        assert front.fused_front_layer.launches == before + 1
        ref = front.fused_front_layer_plain(layer, pos, row_pad, x, fw, pk, pv)
        for name, a, b in zip(("self_out", "k_new", "v_new"), got, ref):
            ag.compare(f"K8 {name}", a, b)
        ag.compare("K8 k cache", ck, pk)
        ag.compare("K8 v cache", cv, pv)
        if pos:
            for name, bad in ag.k8_faults(layer, pos, row_pad, x, fw, kc, vc):
                ag.reject(name, got[0], bad)
    torch.cuda.synchronize()


@pytest.mark.parametrize("single_pass", [True, False])
@pytest.mark.parametrize("B,H,T,ta", [(1, 2, 200, 200), (2, 3, 600, 550), (1, 2, 1500, 1500)])
def test_k10_matches_plain_on_card(dev, B, H, T, ta, single_pass):
    """K10 in both forms against their plain versions, on contiguous
    [B, H, T, 64] inputs and on the encoder's strided head views; its
    planted faults refused where T is not a multiple of 512."""
    g = torch.Generator(device=dev).manual_seed(T + int(single_pass))
    for scale in (0.5, 1.0):
        q, k, v = (ag.randn(g, dev, B, H, T, 64, scale=s) for s in (scale, scale, 1.0))
        before = encoder_attn.encoder_self_attention.launches
        got = encoder_attn.encoder_self_attention(q, k, v, ta, single_pass)
        assert encoder_attn.encoder_self_attention.launches == before + 1
        ref = encoder_attn.encoder_self_attention_plain(q, k, v, ta, single_pass)
        ag.compare(f"K10 T={T} scale={scale}", got, ref)
        views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
        torch.testing.assert_close(encoder_attn.encoder_self_attention(*views, ta, single_pass),
                                   got, rtol=0, atol=0)
        if scale == 0.5 and T % 512 and ta == T:
            for name, bad in ag.k10_faults(q, k, v, ta, single_pass):
                ag.reject(name, got, bad)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,Q,Ta,ta", [(2, 1, 1536, 1500), (3, 3, 1500, 1500), (2, 17, 700, 650)])
def test_k9_attention_matches_plain_on_card(dev, B, Q, Ta, ta):
    """K9a (also over one 512-key tile), K9c and K9d against their plain
    versions; their planted faults refused (key padding where Ta > ta)."""
    g = torch.Generator(device=dev).manual_seed(B * 10 + Q)
    L, H, lay = 3, 2, attn_probe.CONST_LAYER
    q = ag.randn(g, dev, B, Q, H, 64, scale=2.0)
    k, v = (ag.randn(g, dev, L, B, H, Ta, 64) for _ in range(2))
    k1, v1 = (t[lay, :, :, :512].contiguous() for t in (k, v))
    forms = (
        (attn_probe.cross_attn_presliced, (q, k[lay], v[lay], ta),
         attn_probe.cross_attn_presliced_plain, lay),
        (attn_probe.cross_attn_presliced, (q, k1, v1, ta),
         attn_probe.cross_attn_presliced_plain, None),
        (attn_probe.cross_attn_const_layer, (q, k, v, ta),
         attn_probe.cross_attn_const_layer_plain, lay),
        (attn_probe.cross_attn_flat, (0, q, k, v, ta), attn_probe.cross_attn_flat_plain, 0),
        (attn_probe.cross_attn_flat, (2, q, k, v, ta), attn_probe.cross_attn_flat_plain, 2),
    )
    for fn, a, plain, layer in forms:
        before = fn.launches
        got = fn(*a)
        assert fn.launches == before + 1
        ag.compare(f"{fn.__name__} Ta={Ta}", got, plain(*a))
        if layer is None:
            continue
        for name, bad in ag.k9_faults(layer, q, k, v, ta, fn is attn_probe.cross_attn_flat):
            if Ta > ta or "padding" not in name:
                ag.reject(name, got, bad)
    torch.cuda.synchronize()


@pytest.mark.parametrize("numel", [48 * 2 * 64 * 512, 1003, 800005])
def test_k11_matches_plain_on_card(dev, numel):
    """K11a and K11b (every ring of the tool) against the float64 sum, with
    lengths that are no multiple of 8 or of a stage; the planted faults
    refused at s = 0 on the large array."""
    g = torch.Generator(device=dev).manual_seed(numel)
    x = ag.stream_input(g, dev, numel)
    for s in (0.0, 0.3):
        ref, mass = ag.stream_terms(x, s)
        before = stream.stream_sum.launches
        got = stream.stream_sum(x, s)
        assert stream.stream_sum.launches == before + 1
        ag.compare_sum(f"K11a n={numel} s={s}", got, ref, mass)
        if s == 0.0 and numel > 10 ** 6:
            for name, bad in ag.k11a_faults(x, s, stream.SUM_CTAS_PER_SM * stream.sm_count(dev)):
                ag.reject_sum(name, got, bad, mass)
        for nbuf in (2, 3, 4, 6, 8):
            for stage in (16384, 24576):
                got = stream.stream_sum_pipelined(x, s, nbuf, stage)
                ag.compare_sum(f"K11b n={numel} s={s} nbuf={nbuf} stage={stage}", got, ref, mass)
                if s == 0.0 and numel > 10 ** 6 and (nbuf, stage) == (4, 16384):
                    for name, bad in ag.k11b_faults(x, s, nbuf, stage, stream.sm_count(dev)):
                        ag.reject_sum(name, got, bad, mass)
    torch.cuda.synchronize()


@pytest.mark.parametrize("Ta", [1536, 1500, 100])
def test_k9b_matches_plain_on_card(dev, Ta):
    g = torch.Generator(device=dev).manual_seed(Ta)
    k, v = (ag.stream_input(g, dev, 2, 3, 2, Ta, 64) for _ in range(2))
    for s in (0.0, -0.4):
        ref, mass = ag.kv_terms(1, k, v, s)
        before = stream.kv_stream_sum.launches
        got = stream.kv_stream_sum(1, k, v, s)
        assert stream.kv_stream_sum.launches == before + 1
        ag.compare_sum(f"K9b Ta={Ta} s={s}", got, ref, mass)
        if s == 0.0:
            for name, bad in ag.k9b_faults(1, k, v, s):
                ag.reject_sum(name, got, bad, mass)
    torch.cuda.synchronize()


def test_probe_wrappers_reject_what_they_do_not_take(dev):
    x = torch.zeros(64, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        stream.stream_sum(x, 0.0)
    k32 = torch.zeros(2, 1, 2, 10, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        stream.kv_stream_sum(0, k32, k32, 0.0)
    q = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16, device=dev)
    k1 = torch.zeros(1, 1, 2, 10, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # one layer: K9c reads layer 1
        attn_probe.cross_attn_const_layer(q, k1, k1)
    with pytest.raises(ValueError):
        attn_probe.cross_attn_flat(1, q, k1, k1)


_WIDTHS = {"tiny": (384, 6), "base": (512, 8), "small": (768, 12), "medium": (1024, 16),
           "large-v3": (1280, 20), "turbo": (1280, 20)}  # (D, H) of each preset's decoder


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("H", [1, 3, 5])
def test_k2_at_odd_local_head_counts(dev, H, f32):
    """K2 at the decoder heads a head split leaves a rank (1: base.en over
    8; 3: tiny.en over 2; 5: large-v3 over 4), each half's last head a
    64-column edge tile, at large-v3's D 1280, Ta 1500 and L 32 (B 2), in
    both forms: against its plain version by the agreement check, its
    faults refused (the edge tile left unwritten or written with its
    neighbour head among them; the f32 ones by `F32_REFUSAL`), two calls
    the same bits; the C tile walk (`wdt_cross_kv_tile`) equal to its
    mirror `attn.cross_kv_tile` at every tile, and refusing the tile past
    the walk."""
    import ctypes

    from whisper_diarize_tpu_torch import kernels

    D, L, Ta, B, HD = 1280, 32, 1500, 2, 64 * H
    dtype, tol = (torch.float32, ag.F32) if f32 else (torch.bfloat16, ag.BF16)
    g = torch.Generator(device=dev).manual_seed(H + 100 * f32)
    ck, cv = (ag.randn(g, dev, L, D, HD, scale=D ** -0.5, dtype=dtype) for _ in range(2))
    cb = ag.randn(g, dev, L, HD, scale=ag.BIAS_SCALE, dtype=torch.float32).to(dtype)
    xa = ag.randn(g, dev, B, Ta, D, dtype=dtype)
    a = (xa, ck, cv, cb, H)
    k, v = attn.cross_kv_build(*a)
    k2, v2 = attn.cross_kv_build(*a)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    ref = attn.cross_kv_build_plain(*a)
    faults = list(ag.k2_faults(*a)) + (list(ag.k2_f32_faults(*a)) if f32 else [])
    assert {"K2 the edge tile left unwritten",
            "K2 the edge tile written with its neighbour head"} <= {n for n, _, _ in faults}
    for i in range(2):
        ag.compare(f"K2 {'kv'[i]} H={H} f32={f32}", (k, v)[i], ref[i], tol=tol)
        for name, j, bad in faults:
            if j == i:
                factor = ag.F32_REFUSAL if ("TF32" in name or "bf16" in name) else 1.0
                ag.reject(name, (k, v)[i], bad, tol=tol, factor=factor)
    lib, out = kernels.library(), (ctypes.c_int * 6)()
    n = attn.cross_kv_tiles(L, B, Ta, HD, f32)
    for i in range(n):
        assert lib.wdt_cross_kv_tile(i, L, B, Ta, H, int(f32), out) == 0
        assert tuple(out) == (*attn.cross_kv_tile(i, L, B, Ta, HD, f32), n), i
    assert lib.wdt_cross_kv_tile(n, L, B, Ta, H, int(f32), out) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("preset", sorted(_WIDTHS))
@pytest.mark.parametrize("B,Ta", [(1, 1500), (3, 1493)])
def test_k2_ragged_at_every_width(dev, preset, B, Ta):
    """K2 (TMA + wgmma tiles of 192 rows of one stream) at each preset's
    width, two layers, streams whose length is no multiple of a tile; its
    planted faults (a tile stored to the wrong stream among them, B > 1)
    refused; two calls give the same bits."""
    D, H = _WIDTHS[preset]
    g = torch.Generator(device=dev).manual_seed(B * 7 + D)
    blocks = {key: t for key, t in ag.random_blocks(2, D, g, dev).items()
              if key in ("ck_w", "cv_w", "cv_b")}
    xa = ag.randn(g, dev, B, Ta, D)
    a = (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    k, v = attn.cross_kv_build(*a)
    k2, v2 = attn.cross_kv_build(*a)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    pk, pv = attn.cross_kv_build_plain(*a)
    ag.compare(f"K2 k {preset} B={B} Ta={Ta}", k, pk)
    ag.compare(f"K2 v {preset} B={B} Ta={Ta}", v, pv)
    names = [name for name, i, bad in ag.k2_faults(*a) if not ag.reject(name, (k, v)[i], bad).ok]
    assert ("K2 a tile written to the wrong stream" in names) == (B > 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("N", [1, 5, 8, 40, 80])
def test_skinny_gemm_family_at_every_row_count(dev, N):
    """K3, K6 (its three forms) and K8 at large-v3 width (D 1280, its split
    `tail.skinny_plan`), N rows, two layers: against their plain versions,
    the split's planted faults refused where it splits, and two calls give
    the same bits (the cluster combine adds the spans in order)."""
    g = torch.Generator(device=dev).manual_seed(N)
    L, D, H, Ta = 2, 1280, 20, 300
    blocks = ag.random_blocks(L, D, g, dev)
    q8w = tail.quantize_tail_weights(blocks)
    beams = 5 if N % 5 == 0 else 1
    k, v = (ag.randn(g, dev, L, N // beams, H, Ta, 64) for _ in range(2))
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    x = ag.randn(g, dev, N, 1, D)
    so = ag.randn(g, dev, N, H, 1, 64, scale=0.3)
    for wts, cache in ((blocks, (k, v, None, None)), (q8w, (k, v, None, None)),
                       (blocks, (k8, v8, ks, vs)), (q8w, (k8, v8, ks, vs))):
        a = (1, x, so, wts, cache[0], cache[1], beams, Ta, cache[2], cache[3])
        got = tail.fused_tail_layer(*a)
        assert torch.equal(got, tail.fused_tail_layer(*a))
        ag.compare(f"K3 / K6 N={N}", got, tail.fused_tail_layer_plain(*a), base=x)
        tag = "K6" if wts is q8w or cache[2] is not None else "K3"
        names = [name for name, bad in ag.tail_split_faults(tag, *a)
                 if not ag.reject(name, got, bad, base=x).ok]
        assert len(names) == 3
    fw = ag.random_front(L, D, g, dev)
    kc, vc = (ag.randn(g, dev, L, N, H, 16, 64) for _ in range(2))
    row_pad = torch.randint(0, 4, (N,), generator=g, device=dev)
    got = front.fused_front_layer(1, 5, row_pad, x, fw, kc.clone(), vc.clone())
    again = front.fused_front_layer(1, 5, row_pad, x, fw, kc.clone(), vc.clone())
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = front.fused_front_layer_plain(1, 5, row_pad, x, fw, kc.clone(), vc.clone())
    for name, a, b in zip(("self_out", "k_new", "v_new"), got, ref):
        ag.compare(f"K8 {name} N={N}", a, b)
    torch.cuda.synchronize()


def test_skinny_gemm_refuses_a_plan_that_does_not_cover(dev):
    """The C entry points check the split they are given."""
    from whisper_diarize_tpu_torch import kernels
    from whisper_diarize_tpu_torch.ops import front as fr

    g = torch.Generator(device=dev).manual_seed(0)
    L, D, H, N = 1, 128, 2, 3
    fw = ag.random_front(L, D, g, dev)
    x = ag.randn(g, dev, N, 1, D)
    kc = ag.randn(g, dev, L, N, H, 8, 64)
    qkv = torch.empty(N, 3 * D, dtype=torch.bfloat16, device=dev)
    out = torch.empty(N, H, 1, 64, dtype=torch.bfloat16, device=dev)
    rp = torch.zeros(N, dtype=torch.int32, device=dev)
    ints = fr.front_int_args(0, N, D, H, 8, 2)
    lib = kernels.library()
    # short, bn, empty span, ragged span, ring too shallow, too deep
    for bad in ((64, 1, 64, 4), (48, 1, 128, 4), (64, 3, 64, 4), (64, 1, 96, 4), (64, 1, 128, 2),
                (64, 1, 128, 9)):
        code = lib.wdt_fused_front(x.data_ptr(), *[fw[key].data_ptr() for key in fr._FRONT_KEYS],
                                   qkv.data_ptr(), kc.data_ptr(), kc.clone().data_ptr(),
                                   rp.data_ptr(), out.data_ptr(), *ints[:6], *bad,
                                   kernels.stream_ptr(dev))
        assert code != 0, bad
    torch.cuda.synchronize()


@pytest.fixture(params=["defaults", "tf32-everywhere"])
def tf32_flags(request):
    """The process-wide TF32 flags at PyTorch's defaults (cuDNN may take
    TF32, cuBLAS may not) or allowing TF32 everywhere; restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = request.param != "defaults"
    torch.backends.cudnn.allow_tf32 = True
    yield request.param
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _speechlike(seconds: float, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = rng.standard_normal(t.size) * 0.02
    x += ((t % 2.0) < 1.5) * np.sin(2 * np.pi * 180.0 * t) * (0.3 + 0.2 * rng.standard_normal(t.size))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def test_diarize_nets_match_cpu_on_card(tf32_flags):
    from whisper_diarize_tpu_torch.models import campplus, net_check, segmentation

    dev = torch.device("cuda")
    with torch.inference_mode():
        lines = net_check.check(segmentation.init_params(0, dev), campplus.init_params(0, dev),
                                segmentation.init_params(0), campplus.init_params(0),
                                _speechlike(31.0, 3))
    assert len(lines) == 6
    torch.cuda.synchronize()


def test_diarized_engine_request_on_card(tmp_path):
    import numpy as np

    import whisper_diarize_tpu_torch as wdt
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wav = str(tmp_path / "in.wav")
    wdt.write_wav(wav, _speechlike(12.0, 4))
    eng = Engine(EngineConfig(
        cache_dir=str(tmp_path / "cache"), whisper_model_path="__random__:tiny",
        diarize_segment_model_path="__random__", diarize_embedding_model_path="__random__",
        batch_size=4, max_decode_tokens=8, temperature_fallback=False))
    before = (attn.cross_attn_layer.launches, attn.cross_kv_build.launches,
              tail.fused_tail_layer.launches)
    cues = eng.transcribe_audio(wav, wdt.TranscribeOptions(
        enable_diarize=True, lang="en", advanced=wdt.AdvancedTranscribe(sampling_strategy="greedy")))
    after = (attn.cross_attn_layer.launches, attn.cross_kv_build.launches,
             tail.fused_tail_layer.launches)
    assert eng.last_run["windows"] >= 1 and all(a > b for a, b in zip(after, before))
    assert all(isinstance(c.speaker_id, str) for c in cues)
    assert np.isfinite([c.end for c in cues]).all()


@pytest.mark.parametrize("draft", ["self", "unrelated"])
def test_speculative_margin_on_card(dev, draft):
    """Speculative greedy decoding on the card (the draft's steps on K3,
    the verify pass on K1 at Q = 4) at the tiny preset: every emitted token
    within 2e-2 x max|logit| of its position's best token, the target
    teacher-forced over the emitted tokens on the card
    (`chip_smoke.spec_gap`); `sim_accept=1.0` with the unrelated draft (its
    proposals taken unchecked) must fail that check."""
    import chip_smoke
    from whisper_diarize_tpu_torch.models import weights
    from whisper_diarize_tpu_torch.models import whisper as wm
    from whisper_diarize_tpu_torch.ops import speculative
    from whisper_diarize_tpu_torch.tokenizer import DebugTokenizer

    cfg = wm.PRESETS["tiny"]
    target = weights.params_from_jax(wm.init_params_np(cfg, seed=0), dev, torch.bfloat16)
    other = weights.params_from_jax(wm.init_params_np(cfg, seed=99), dev, torch.bfloat16)
    sp = DebugTokenizer().specials
    dc = dec.DecodeConfig(max_tokens=24, blank_id=32)
    g = torch.Generator(device=dev).manual_seed(0)
    mel_in = torch.randn((2, 80, 3000), generator=g, device=dev)
    xa = wm.encode(target, mel_in, cfg)
    pd, xd = (target, xa) if draft == "self" else (other, wm.encode(other, mel_in, cfg))
    prompt = torch.tensor([DebugTokenizer().sot_sequence(language="en")] * 2, device=dev)
    sup = torch.from_numpy(dec.build_suppress_mask(sp, cfg.n_vocab)).to(dev)
    before = (attn.cross_attn_layer.launches, tail.fused_tail_layer.launches)
    with torch.inference_mode():
        res, rounds = speculative.speculative_greedy_run(
            target, cfg, pd, cfg, dc, sp, xa, xd, prompt, prompt.shape[1], sup, gamma=4)
    assert all(a > b for a, b in zip(
        (attn.cross_attn_layer.launches, tail.fused_tail_layer.launches), before))
    assert 0 < int(rounds) <= dc.max_tokens
    gap = chip_smoke.spec_gap(target, cfg, dc, sp, sup, xa, prompt, res)
    assert gap <= chip_smoke.TOKEN_GAP, gap
    if draft == "unrelated":
        with torch.inference_mode():
            bad, _ = speculative.speculative_greedy_run(
                target, cfg, pd, cfg, dc, sp, xa, xd, prompt, prompt.shape[1], sup, gamma=4,
                sim_accept=1.0)
        assert chip_smoke.spec_gap(target, cfg, dc, sp, sup, xa, prompt, bad) > chip_smoke.TOKEN_GAP


def test_checkpoint_files_load_on_card(dev, tmp_path):
    """`load_ggml` and `load_openai_pt` load onto the card by default; the
    params equal the CPU load cast to the dtype asked for."""
    from whisper_diarize_tpu_torch.models import ggml, weights
    from whisper_diarize_tpu_torch.models import whisper as wm

    cfg = wm.PRESETS["tiny"]
    sd = weights.openai_state_dict(weights.params_from_jax(wm.init_params_np(cfg, seed=0), "cpu",
                                                           torch.float32))
    dims = {k: getattr(cfg, k) for k in (
        "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
        "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer", "n_mels")}
    ggml.write_ggml(tmp_path / "g.bin", sd, dims, torch.zeros(80, 201).numpy(), [b"a"],
                    quantize="q8_0")
    torch.save({"dims": dims, "model_state_dict": {k: torch.tensor(v) for k, v in sd.items()}},
               tmp_path / "m.pt")
    for load, path in ((ggml.load_ggml, tmp_path / "g.bin"),
                       (weights.load_openai_pt, tmp_path / "m.pt")):
        got = load(path, dtype=torch.bfloat16)[0]
        want = load(path, device="cpu")[0]
        flat, ref = weights._flatten(got), weights._flatten(want)
        assert sorted(flat) == sorted(ref)
        for k in ref:
            assert flat[k].device.type == "cuda" and flat[k].dtype == torch.bfloat16, k
            assert torch.equal(flat[k].cpu(), ref[k].to(torch.bfloat16)), k


# --------------------------------------------------------------------------
# The f32 forms of K1 - K6, K8, K10 (`kernels.agreement.F32`; `F32_Q8` for K5 and K6
# `kvq`, held to the split model, `agreement.split_attend`): each against
# its f32 plain version with TF32 off, its two f32 faults refused by
# `F32_REFUSAL` and its earlier faults refused; an f32 Engine request
# --------------------------------------------------------------------------

def _refuse(got, faults, tol=ag.F32, base=None):
    for name, bad in faults:
        factor = ag.F32_REFUSAL if ("TF32" in name or "bf16" in name) else 1.0
        ag.reject(name, got, bad, base=base, tol=tol, factor=factor)


@pytest.mark.parametrize("B,Ta,Q", [(2, 100, 3), (3, 1500, 17), (8, 1500, 1), (2, 1500, 64),
                                   (2, 1500, 227)])
def test_f32_forms_k1_k2_k3_on_card(dev, B, Ta, Q):
    g = torch.Generator(device=dev).manual_seed(B + 50)
    L, H = 2, 4
    D = H * 64
    f32 = torch.float32
    blocks = ag.random_blocks(L, D, g, dev, dtype=f32)
    xa = ag.randn(g, dev, B, Ta, D, dtype=f32)
    a = (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    before = attn.cross_kv_build.launches_f32
    k, v = attn.cross_kv_build(*a)
    assert attn.cross_kv_build.launches_f32 == before + 1
    ref = attn.cross_kv_build_plain(*a)
    faults = list(itertools.chain(ag.k2_f32_faults(*a), ag.k2_faults(*a)))
    for i in range(2):
        ag.compare("K2 f32", (k, v)[i], ref[i], tol=ag.F32)
        _refuse((k, v)[i], [(n, bad) for n, j, bad in faults if j == i])
    q = ag.randn(g, dev, B, Q, H, 64, scale=2.0, dtype=f32)
    for layer in range(L):
        got = attn.cross_attn_layer(layer, q, k, v, Ta - 7)
        ag.compare("K1 f32", got, attn.cross_attn_layer_plain(layer, q, k, v, Ta - 7), tol=ag.F32)
        _refuse(got, itertools.chain(ag.k1_f32_faults(layer, q, k, v, Ta - 7),
                                     ag.k1_faults(layer, q, k, v, Ta - 7)))
        for beams in (1, 3):
            x = ag.randn(g, dev, B * beams, 1, D, dtype=f32)
            so = ag.randn(g, dev, B * beams, H, 1, 64, scale=0.3, dtype=f32)
            args = (layer, x, so, blocks, k, v, beams, Ta)
            got = tail.fused_tail_layer(*args)
            ag.compare("K3 f32 update", got, tail.fused_tail_layer_plain(*args), base=x,
                       tol=ag.F32)
            _refuse(got, itertools.chain(ag.tail_f32_faults("K3", *args), ag.k3_faults(*args)),
                    base=x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("K,Td,step", [(5, 64, 0), (5, 64, 31), (5, 64, 63), (1, 64, 31),
                                      (8, 64, 63), (5, 224, 0), (5, 224, 111), (5, 224, 223),
                                      (1, 224, 223), (8, 224, 111)])
def test_f32_form_k4_on_card(dev, K, Td, step):
    """K 1 - 8; past step 40 (K 5) the f32 rows run through K4's ring."""
    g = torch.Generator(device=dev).manual_seed(step + 7 + K * Td)
    L, B, H, Tp = 2, 3, 4, 19
    f32 = torch.float32
    q = ag.randn(g, dev, B, K, H, 64, scale=2.0, dtype=f32)
    pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64, dtype=f32) for _ in range(2))
    dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64, dtype=f32) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, device=dev, dtype=torch.int32)
    row_pad = torch.tensor([2, 0, 5], dtype=torch.int32, device=dev)
    a = (1, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp)
    got = attn.split_self_attn_layer(*a)
    ag.compare("K4 f32", got, attn.split_self_attn_layer_plain(*a), tol=ag.F32)
    _refuse(got, itertools.chain(ag.k4_f32_faults(*a), ag.k4_faults(*a) if step and K > 1 else ()))


@pytest.mark.parametrize("form", ["wq", "kvq", "wq+kvq"])
def test_f32_forms_k5_k6_on_card(dev, form):
    """At large-v3 widths (20 heads, 1500 keys), where a bf16 flip of K5's
    query weighs little (`agreement.REL_L2_Q8`)."""
    g = torch.Generator(device=dev).manual_seed(11)
    L, B, H, Ta, beams = 2, 2, 20, 1500, 5
    D, f32 = H * 64, torch.float32
    blocks = ag.random_blocks(L, D, g, dev, dtype=f32)
    xa = ag.randn(g, dev, B, Ta, D, dtype=f32)
    k, v = attn.cross_kv_build(xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    if "kvq" in form:
        q = ag.randn(g, dev, B, 3, H, 64, scale=2.0, dtype=f32)
        a = (1, q, k8, ks, v8, vs, Ta - 7)
        got = attn.cross_attn_layer_q8(*a)
        ag.compare("K5 f32", got, ag.split_attend(1, q, k8, v8, Ta - 7, ks, vs), tol=ag.F32_Q8)
        _refuse(got, itertools.chain(ag.k5_f32_faults(*a), ag.k5_faults(*a)), tol=ag.F32_Q8)
    w = tail.quantize_tail_weights(blocks) if form.startswith("wq") else blocks
    cache = (k8, v8, ks, vs) if "kvq" in form else (k, v, None, None)
    x = ag.randn(g, dev, B * beams, 1, D, dtype=f32)
    so = ag.randn(g, dev, B * beams, H, 1, 64, scale=0.3, dtype=f32)
    a = (1, x, so, w, cache[0], cache[1], beams, Ta, cache[2], cache[3])
    before = tail.fused_tail_layer.launches_int8_f32
    got = tail.fused_tail_layer(*a)
    assert tail.fused_tail_layer.launches_int8_f32 == before + 1
    tol = ag.F32_Q8 if "kvq" in form else ag.F32
    ag.compare(f"K6 f32 {form}", got, tail.fused_tail_layer_plain(
        *a, attend=ag.split_attend if "kvq" in form else None), base=x, tol=tol)
    _refuse(got, itertools.chain(ag.tail_f32_faults("K6", *a), ag.k6_faults(*a)), tol=tol,
            base=x)


@pytest.mark.parametrize("N", [1, 5, 8, 40, 80])
def test_f32_skinny_gemm_family_at_every_row_count(dev, N):
    """The f32 skinny GEMM (3xTF32 mma.sync) in K3-f32, K6-f32 (its three
    forms) and K8-f32 at large-v3 width (D 1280, its f32 split
    `tail.skinny_plan(..., f32=True)`, 32- and 64-column strips, ragged m16
    row tiles), N rows, two layers, 1500 keys (where a bf16 flip of K5's
    query weighs little): against their f32 plain versions (`F32`;
    `F32_Q8` over the int8 cache), the split's planted faults refused and,
    over the f32 cache, the f32 faults; two calls give the same bits."""
    g = torch.Generator(device=dev).manual_seed(N + 70)
    L, D, H, Ta, f32 = 2, 1280, 20, 1500, torch.float32
    blocks = ag.random_blocks(L, D, g, dev, dtype=f32)
    q8w = tail.quantize_tail_weights(blocks)
    beams = 5 if N % 5 == 0 else 1
    k, v = (ag.randn(g, dev, L, N // beams, H, Ta, 64, dtype=f32) for _ in range(2))
    k8, ks, v8, vs = attn.quantize_cross_kv(k, v)
    x = ag.randn(g, dev, N, 1, D, dtype=f32)
    so = ag.randn(g, dev, N, H, 1, 64, scale=0.3, dtype=f32)
    for wts, cache in ((blocks, (k, v, None, None)), (q8w, (k, v, None, None)),
                       (blocks, (k8, v8, ks, vs)), (q8w, (k8, v8, ks, vs))):
        a = (1, x, so, wts, cache[0], cache[1], beams, Ta, cache[2], cache[3])
        kvq = cache[2] is not None
        got = tail.fused_tail_layer(*a)
        assert torch.equal(got, tail.fused_tail_layer(*a))
        tol = ag.F32_Q8 if kvq else ag.F32
        tag = "K6" if wts is q8w or kvq else "K3"
        ag.compare(f"{tag} f32 N={N}", got, tail.fused_tail_layer_plain(
            *a, attend=ag.split_attend if kvq else None), base=x, tol=tol)
        names = [name for name, bad in ag.tail_split_faults(tag, *a)
                 if not ag.reject(name, got, bad, base=x, tol=tol).ok]
        assert len(names) == 3
        if not kvq:
            _refuse(got, ag.tail_f32_faults(tag, *a), base=x)
    fw = ag.random_front(L, D, g, dev, dtype=f32)
    kc, vc = (ag.randn(g, dev, L, N, H, 16, 64, dtype=f32) for _ in range(2))
    row_pad = torch.randint(0, 4, (N,), generator=g, device=dev)
    got = front.fused_front_layer(1, 5, row_pad, x, fw, kc.clone(), vc.clone())
    again = front.fused_front_layer(1, 5, row_pad, x, fw, kc.clone(), vc.clone())
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = front.fused_front_layer_plain(1, 5, row_pad, x, fw, kc.clone(), vc.clone())
    for name, a, b in zip(("self_out", "k_new", "v_new"), got, ref):
        ag.compare(f"K8 f32 {name} N={N}", a, b, tol=ag.F32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("preset", sorted(_WIDTHS))
@pytest.mark.parametrize("B,Ta", [(1, 1500), (3, 1493)])
def test_f32_k2_ragged_at_every_width(dev, preset, B, Ta):
    """K2-f32 (3xTF32 wgmma tiles of 128 rows of one stream) at each
    preset's width, two layers, ragged streams: against its f32 plain
    version, its f32 faults and earlier faults (a tile stored to the wrong
    stream among them, B > 1) refused; two calls give the same bits."""
    D, H = _WIDTHS[preset]
    g = torch.Generator(device=dev).manual_seed(B * 7 + D + 1)
    blocks = {key: t for key, t in ag.random_blocks(2, D, g, dev, dtype=torch.float32).items()
              if key in ("ck_w", "cv_w", "cv_b")}
    xa = ag.randn(g, dev, B, Ta, D, dtype=torch.float32)
    a = (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    k, v = attn.cross_kv_build(*a)
    k2, v2 = attn.cross_kv_build(*a)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    pk, pv = attn.cross_kv_build_plain(*a)
    ag.compare(f"K2 f32 k {preset} B={B} Ta={Ta}", k, pk, tol=ag.F32)
    ag.compare(f"K2 f32 v {preset} B={B} Ta={Ta}", v, pv, tol=ag.F32)
    _refuse(k, [(n, bad) for n, i, bad in ag.k2_f32_faults(*a) if i == 0])
    names = [name for name, i, bad in ag.k2_faults(*a)
             if not ag.reject(name, (k, v)[i], bad, tol=ag.F32).ok]
    assert ("K2 a tile written to the wrong stream" in names) == (B > 1)
    torch.cuda.synchronize()


def test_f32_wrappers_refuse_mixed_dtypes_and_k8_k10(dev):
    """One float dtype a call, K8 and K10 as every other wrapper: a mix of
    bf16 and f32 raises TypeError, whichever operand carries which."""
    f32 = torch.float32
    q = torch.zeros(1, 1, 2, 64, dtype=f32, device=dev)
    k = torch.zeros(1, 1, 2, 64, 64, dtype=f32, device=dev)
    with pytest.raises(TypeError):
        attn.cross_attn_layer(0, q, k.bfloat16(), k.bfloat16())
    with pytest.raises(TypeError):
        attn.cross_kv_build(q[0], k[0, 0].bfloat16(), k[0, 0].bfloat16(),
                            k[0, 0, 0].bfloat16(), 1)
    qe = torch.zeros(1, 2, 64, 64, dtype=f32, device=dev)
    for mixed in ((qe, qe.bfloat16(), qe), (qe.bfloat16(), qe.bfloat16(), qe)):
        with pytest.raises(TypeError):
            encoder_attn.encoder_self_attention(*mixed)
    g = torch.Generator(device=dev).manual_seed(0)
    pack = ag.random_front(1, 128, g, dev, dtype=f32)
    cache = torch.zeros(1, 2, 2, 16, 64, dtype=f32, device=dev)
    x = torch.zeros(2, 1, 128, dtype=f32, device=dev)
    for args in ((x.bfloat16(), pack, cache, cache.clone()),
                 (x, pack, cache.bfloat16(), cache.bfloat16()),
                 (x, dict(pack, w=pack["w"].bfloat16()), cache, cache.clone())):
        with pytest.raises(TypeError):
            front.fused_front_layer(0, 0, None, *args)


@pytest.mark.parametrize("N,Tc,pos", [(3, 16, 0), (8, 48, 19), (40, 448, 300)])
def test_f32_form_k8_on_card(dev, N, Tc, pos):
    """K8's f32 form against its f32 plain version (self_out, k_new, v_new
    and the caches), with row pads; where pos > 0 its f32 faults refused by
    `F32_REFUSAL` and its earlier faults refused."""
    g = torch.Generator(device=dev).manual_seed(N * 1000 + pos + 1)
    L, H, f32 = 2, 20, torch.float32
    D = 64 * H
    fw = ag.random_front(L, D, g, dev, dtype=f32)
    x = ag.randn(g, dev, N, 1, D, dtype=f32)
    kc, vc = (ag.randn(g, dev, L, N, H, Tc, 64, dtype=f32) for _ in range(2))
    row_pad = torch.randint(0, pos + 1, (N,), generator=g, device=dev)
    for layer in range(L):
        ck, cv, pk, pv = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        before = front.fused_front_layer.launches_f32
        got = front.fused_front_layer(layer, pos, row_pad, x, fw, ck, cv)
        assert front.fused_front_layer.launches_f32 == before + 1
        ref = front.fused_front_layer_plain(layer, pos, row_pad, x, fw, pk, pv)
        for name, a, b in zip(("self_out", "k_new", "v_new"), got, ref):
            ag.compare(f"K8 f32 {name}", a, b, tol=ag.F32)
        ag.compare("K8 f32 k cache", ck, pk, tol=ag.F32)
        ag.compare("K8 f32 v cache", cv, pv, tol=ag.F32)
        if pos:  # at pos 0 the one slot takes weight 1: every fault is the truth
            _refuse(got[0], itertools.chain(ag.k8_f32_faults(layer, pos, row_pad, x, fw, kc, vc),
                                            ag.k8_faults(layer, pos, row_pad, x, fw, kc, vc)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("single_pass", [True, False])
@pytest.mark.parametrize("B,H,T,ta", [(1, 2, 200, 200), (2, 3, 600, 550), (1, 2, 1500, 1500)])
def test_f32_form_k10_on_card(dev, B, H, T, ta, single_pass):
    """K10's f32 form in both forms against their f32 plain versions, on
    contiguous inputs and on the encoder's strided head views (the same
    result bit for bit); its f32 faults refused by `F32_REFUSAL`, its
    earlier faults where T is not a multiple of 512."""
    g = torch.Generator(device=dev).manual_seed(T + int(single_pass) + 1)
    for scale in (0.5, 1.0):
        q, k, v = (ag.randn(g, dev, B, H, T, 64, scale=s, dtype=torch.float32)
                   for s in (scale, scale, 1.0))
        before = encoder_attn.encoder_self_attention.launches_f32
        got = encoder_attn.encoder_self_attention(q, k, v, ta, single_pass)
        assert encoder_attn.encoder_self_attention.launches_f32 == before + 1
        assert got.dtype == torch.float32
        ref = encoder_attn.encoder_self_attention_plain(q, k, v, ta, single_pass)
        ag.compare(f"K10 f32 T={T} scale={scale}", got, ref, tol=ag.F32)
        views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
        torch.testing.assert_close(encoder_attn.encoder_self_attention(*views, ta, single_pass),
                                   got, rtol=0, atol=0)
        faults = ag.k10_f32_faults(q, k, v, ta, single_pass)
        if scale == 0.5 and T % 512 and ta == T:
            faults = itertools.chain(faults, ag.k10_faults(q, k, v, ta, single_pass))
        _refuse(got, faults)
    torch.cuda.synchronize()


def test_f32_engine_request_on_card(tmp_path):
    """`EngineConfig(dtype="float32")` on the card: a beam-5 request at the
    tiny preset through the f32 forms of K1 - K4, cues out."""
    import numpy as np

    import whisper_diarize_tpu_torch as wdt
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wav = str(tmp_path / "in.wav")
    wdt.write_wav(wav, _speechlike(12.0, 5))
    eng = Engine(EngineConfig(
        cache_dir=str(tmp_path / "cache"), whisper_model_path="__random__:tiny",
        vad_model_path="__random__", dtype="float32", batch_size=4, max_decode_tokens=8,
        temperature_fallback=False))
    fns = (attn.cross_attn_layer, attn.cross_kv_build, tail.fused_tail_layer,
           attn.split_self_attn_layer)
    before = [f.launches_f32 for f in fns]
    cues = eng.transcribe_audio(wav, wdt.TranscribeOptions(enable_vad=False, lang="en"))
    assert all(f.launches_f32 > b for f, b in zip(fns, before))
    (params, _, _), = eng._whisper_cache.values()
    assert params["decoder"]["tok_emb"].dtype == torch.float32
    assert eng.last_run["windows"] >= 1 and np.isfinite([c.end for c in cues]).all()


def test_one_rank_mesh_engine_equals_no_mesh_on_card(tmp_path):
    """`EngineConfig(mesh_shape=(1, 1))` on the card (a one-rank NCCL group):
    the same kernels on the same rows, so a beam-5 request's cues and
    decodes (tokens, log-probabilities) equal the no-mesh Engine's bit for
    bit, and K1, K2, K3 and K4 launched."""
    import numpy as np
    import torch.distributed as dist

    import whisper_diarize_tpu_torch as wdt
    from whisper_diarize_tpu_torch.parallel import dryrun

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wav = str(tmp_path / "in.wav")
    wdt.write_wav(wav, _speechlike(12.0, 6))
    kw = dict(wavs=[wav], cache=str(tmp_path / "cache"), greedy=False, use_gpu=True,
              snapshot="__random__:tiny", batch_size=4, max_decode_tokens=8)
    try:
        out = dryrun.mesh_rank(0, 1, [("ref", "engine", None, kw),
                                      ("mesh", "engine", (1, 1), kw)])
        assert dist.get_backend() == "nccl"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ref, got = out["ref"], out["mesh"]
    assert all(got["launches"][k] > 0 for k in ("K1", "K2", "K3", "K4")), got["launches"]
    assert got["cues"] == ref["cues"] and len(got["decodes"]) == len(ref["decodes"]) > 0
    for a, b in zip(got["decodes"], ref["decodes"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("B,N,Ta,ties", [(3, 20, 37, False), (4, 60, 1500, True),
                                         (2, 440, 1500, False), (4, 32, 1500, False),
                                         (4, 64, 1500, True), (4, 33, 1497, False),
                                         (8, 100, 1500, True)])
def test_dtw_kernel_matches_plain_on_card(dev, B, N, Ta, ties):
    """N 32 and 64 (one and two warps), N 33 and 100 (not multiples of 32)
    with rows at n_tok 32 and 33 and at 64 and 65 (the warps' handoff at its
    edges), Ta % 4 != 0 (the kernel's scalar loads)."""
    g = torch.Generator(device=dev).manual_seed(N)
    sot_len = 3
    if ties:
        cost = (torch.rand((B, sot_len + N, Ta), generator=g, device=dev) < 0.02).float()
    else:
        cost = torch.randn((B, sot_len + N, Ta), generator=g, device=dev)
    n_tok = torch.tensor([N, 1, N // 2, N + 9, 32, 33, 64, 65][:B], device=dev)
    n_frames = torch.tensor([Ta, Ta // 3, 1, Ta + 40, 5, Ta - 1, 777, Ta][:B], device=dev)
    got = dtw_ops.dtw_anchor_frames_batch(cost, n_tok, n_frames, sot_len)
    ref = dtw_ops.dtw_anchor_frames_plain(cost, n_tok, n_frames, sot_len)
    assert got.dtype == torch.int32 and got.shape == (B, N)
    assert torch.equal(got, ref)
    assert torch.equal(dtw_ops.dtw_anchor_frames_batch(cost, n_tok, n_frames, sot_len), got)


def test_dtw_plan_matches_its_mirror_on_card(dev):
    """`csrc/dtw.cu::make_plan` (the C entry `wdt_dtw_plan`) gives the plan
    `dtw_ops.dtw_plan` mirrors at every N the Engine feeds and more, and
    refuses what the mirror refuses."""
    import ctypes

    from whisper_diarize_tpu_torch import kernels

    lib = kernels.library()
    out = (ctypes.c_int * 5)()
    for N in (1, 5, 31, 32, 33, 64, 100, 224, 416, 440, 1024):
        for Ta in (1, 3, 4, 37, 1497, 1500):
            try:
                want = dtw_ops.dtw_plan(N, Ta)
            except ValueError:
                assert lib.wdt_dtw_plan(N, Ta, out) != 0, (N, Ta)
                continue
            assert lib.wdt_dtw_plan(N, Ta, out) == 0 and tuple(out) == want, (N, Ta)


def test_dtw_kernel_refuses_what_it_cannot_take(dev):
    cost = torch.zeros((1, 8, 100), device=dev)
    with pytest.raises(TypeError):
        dtw_ops.dtw_anchor_frames_batch(cost.double(), [3], [100], 2)
    with pytest.raises(ValueError):
        dtw_ops.dtw_anchor_frames_batch(torch.zeros((1, 1030, 10), device=dev), [3], [10], 2)
    with pytest.raises(ValueError):
        dtw_ops.dtw_anchor_frames_batch(torch.zeros((1, 900, 1500), device=dev), [3], [10], 2)
    with pytest.raises(ValueError):
        dtw_ops.dtw_anchor_frames_batch(cost, [3, 4], [100], 2)


@pytest.mark.parametrize("activities", ["cuda", "cpu+cuda"])
def test_span_holds_its_kernel_on_the_profilers_clock(dev, activities):
    """`tracing`'s spans, stamped by the monotonic clock and mapped onto
    the profiler's, hold the device work launched inside them: a span that
    synchronizes starts before its kernel's profiled start and ends after
    its end. Recording switches on under a CUDA-only session too (the
    benchmark's traced call)."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_diarize_tpu_torch import tracing

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if activities == "cpu+cuda" else [])
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with tracing.span("card"):
            b = a @ a
            torch.cuda.synchronize()
    span = [e for e in tracing.events(tracing.stretch()) if e["name"] == "card"][-1]
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels and b.shape == a.shape
    for k in kernels:
        start, end = k.start_ns(), k.start_ns() + k.duration_ns()
        print(f"{activities} {k.name()[:40]}: span start to kernel start "
              f"{(start - span['start_ns']) / 1e3:.1f} us, kernel end to span end "
              f"{(span['end_ns'] - end) / 1e3:.1f} us")
        assert span["start_ns"] < start and end < span["end_ns"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k4_device_step_agrees_with_host_step_on_card(dev, dtype):
    """K4 reads the step and the prompt's length from device memory, its
    launch planned for the whole caches: one-element tensors give the
    ints' bits; at steps 0, 31 and 63, a prompt filling its buffer or
    shorter (a graph's buffer), it agrees with the plain version and its
    planted faults are refused; a step out of [0, Td) or a prompt length
    out of [1, Tp] gives NaN everywhere."""
    g = torch.Generator(device=dev).manual_seed(25)
    L, B, K, H, Tp, Td = 2, 3, 5, 4, 19, 64
    f32 = dtype == torch.float32
    tol = ag.F32 if f32 else ag.BF16
    q = ag.randn(g, dev, B, K, H, 64, scale=2.0, dtype=dtype)
    pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64, dtype=dtype) for _ in range(2))
    dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64, dtype=dtype) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, device=dev, dtype=torch.int32)
    row_pad = torch.tensor([2, 0, 16], dtype=torch.int32, device=dev)

    def on_dev(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    head = (1, q, pk, pv, dk, dv, anc_j)
    for P, step in itertools.product((Tp, Tp - 2), (0, 31, 63)):
        a = (*head, step, row_pad, P)
        got = attn.split_self_attn_layer(*a)
        assert torch.equal(got, attn.split_self_attn_layer(*head, on_dev(step), row_pad,
                                                           on_dev(P))), (P, step)
        ag.compare(f"K4 prompt {P} of {Tp}, step {step}", got,
                   attn.split_self_attn_layer_plain(*a), tol=tol)
        faults = itertools.chain(ag.k4_f32_faults(*a) if f32 else (),
                                 ag.k4_faults(*a) if step else ())
        if f32:
            _refuse(got, faults)
        else:
            for name, bad in faults:
                ag.reject(name, got, bad)
    for P, step in ((Tp, -1), (Tp, Td), (0, 3), (Tp + 1, 3)):
        out = attn.split_self_attn_layer(*head, on_dev(step), row_pad, on_dev(P))
        assert bool(out.isnan().all()), (P, step)
    torch.cuda.synchronize()


def _beam_model(dev, dtype):
    """large-v3's decoder widths and vocabulary with two layers, seeded
    weights; audio states drawn at the served shape (B 16, 1500 frames)."""
    from whisper_diarize_tpu_torch.models import whisper as wm
    from whisper_diarize_tpu_torch.tokenizer import DebugTokenizer

    cfg = dataclasses.replace(wm.PRESETS["large-v3"], n_audio_layer=1, n_text_layer=2)
    params = wm.init_params(cfg, seed=25, device=dev, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(26)
    xa = ag.randn(g, dev, 16, cfg.n_audio_ctx, cfg.n_audio_state, dtype=dtype)
    tk = DebugTokenizer()
    sp = tk.specials
    sup = torch.from_numpy(dec.build_suppress_mask(sp, cfg.n_vocab)).to(dev)
    sup[sp.eot] = float("-inf")  # no beam finishes: all 64 steps run
    prompt = torch.tensor([tk.sot_sequence(language="en")] * 16, device=dev)
    return cfg, params, xa, sp, sup, prompt


@pytest.mark.parametrize("form", ["bf16", "f32", "int8"])
def test_beam_graph_equals_eager_on_card(dev, form, monkeypatch):
    """`beam_decode` at B 16, beam 5, 64 steps with the step's forward as
    a CUDA graph against the eager path: tokens and lengths equal, scores
    and probabilities bit for bit where K4's plan for the graph's caches
    cuts every step's chunks as the eager caches' plan does (else within
    the check); two batches of one shape: one capture, 128 replays, the
    same result; a new prompt length replays the same graph."""
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    cfg, params, xa, sp, sup, prompt = _beam_model(dev, dtype)
    dc = dec.DecodeConfig(max_tokens=64, quantize_cross_kv=form == "int8")

    def run(p, sot_pos=0):
        with torch.inference_mode():
            return dec.beam_decode(params, cfg, dc, sp, xa, p, p.shape[1], suppress_mask=sup,
                                   sot_pos=sot_pos)

    launches = attn.split_self_attn_layer.launches
    with tracing.request() as req:
        got, again = run(prompt), run(prompt)
        counters = dict(req.summary()["counters"])
    assert counters["decode.graph_captures"] == 1, counters
    assert counters["decode.graph_replays"] == counters["decode.steps"] == 128, counters
    # every step's K4 launches (the first step's also run eagerly before its capture)
    assert attn.split_self_attn_layer.launches - launches == (2 * 64 + 1) * cfg.n_text_layer
    P = prompt.shape[1]
    longer = torch.cat([torch.full((16, 1), sp.sot_prev, device=dev), prompt], dim=1)
    with tracing.request() as req:
        run(longer, sot_pos=1)
        run(prompt)
        counters = dict(req.summary()["counters"])
    assert "decode.graph_captures" not in counters and counters["decode.graph_replays"] == 128
    with monkeypatch.context() as m:
        m.setattr(beam_graph, "engages", lambda device, mesh: False)
        with tracing.request() as req:
            ref = run(prompt)
            assert "decode.graph_replays" not in req.summary()["counters"]
    f32 = dtype == torch.float32
    slots = beam_graph.prompt_slots(cfg)
    same_chunks = all(
        [attn.split_self_chunk(c, p.cap, 5, P, s) for c in range(p.chunks)] ==
        [attn.split_self_chunk(c, q.cap, 5, P, s) for c in range(q.chunks)]
        for s in range(64)
        for p, q in [(attn.split_self_plan_at(5, P, 64, P, s, f32),
                      attn.split_self_plan_at(5, slots, 64, P, s, f32))])
    for res in (got, again):
        assert torch.equal(res.tokens, ref.tokens) and torch.equal(res.lengths, ref.lengths)
        for name in ("sum_logprob", "avg_logprob", "token_probs", "no_speech_prob"):
            a, b = getattr(res, name), getattr(ref, name)
            if same_chunks:
                assert torch.equal(a, b), name
            else:
                ag.compare(f"beam graph {form} {name}", a, b, tol=ag.F32 if f32 else ag.BF16)
    assert torch.equal(again.token_probs, got.token_probs)
    torch.cuda.synchronize()
