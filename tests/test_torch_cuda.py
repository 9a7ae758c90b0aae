"""The hand-written CUDA kernels on the card (marker `cuda`; skipped where
torch sees no CUDA device). Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Each kernel against its plain version in bf16 on the same device, at small
shapes with Dh = 64, a ragged audio length (K1-K3, K5, K6 in its three int8
forms) and ragged prompt and decode lengths with row pads and a random
ancestry (K4), with the tolerance of
`whisper_diarize_tpu_torch/kernels/agreement.py` (a few bf16 ulps per
element and 1e-2 relative L2 of the update; K3 is judged on the update it
adds to x), and the planted faults that check must refuse.
"""

import pytest
import torch

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, tail
from whisper_diarize_tpu_torch.ops import decode as dec

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


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    q = torch.zeros(1, 1, 2, 32, dtype=torch.bfloat16, device=dev)  # Dh 32
    k = torch.zeros(1, 1, 2, 10, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        attn.cross_attn_layer(0, q, k, k)
    with pytest.raises(TypeError):
        attn.cross_attn_layer(0, q.float(), k.float(), k.float())
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


@pytest.mark.parametrize("B,K,Tp,Td", [(2, 3, 11, 32), (1, 5, 3, 64), (3, 5, 19, 224)])
def test_k4_matches_plain_on_card(dev, B, K, Tp, Td):
    g = torch.Generator(device=dev).manual_seed(B * 100 + Td)
    L, H = 2, 3
    q = ag.randn(g, dev, B, K, H, 64, scale=2.0)
    pk, pv = (ag.randn(g, dev, L, B, H, Tp, 64) for _ in range(2))
    dk, dv = (ag.randn(g, dev, L, B * K, H, Td, 64) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, device=dev)  # int64: converted
    row_pad = torch.randint(0, Tp - 2, (B,), generator=g, device=dev)
    for step in (0, Td // 2, Td - 1):
        for layer in range(L):
            a = (layer, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp - 1)
            before = attn.split_self_attn_layer.launches
            got = attn.split_self_attn_layer(*a)
            assert attn.split_self_attn_layer.launches == before + 1
            ag.compare(f"K4 B={B} K={K} step={step}", got, attn.split_self_attn_layer_plain(*a))
            if step and Tp > 3:
                for name, bad in ag.k4_faults(*a):
                    ag.reject(name, got, bad)
    torch.cuda.synchronize()


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
