"""The numerics plan of the f32 forms of K1 and K10 on the CPU: 3xTF32
products on the tensor cores, in each kernel's order.

Each f32 operand splits into hi = tf32(x) and lo = tf32(x - hi); a product
is lo hi' + hi lo' + hi hi' in f32 (`agreement.tf32x3_split`,
`tf32x3_matmul`). The models run the card's orders with those products:

- K1 (`agreement.k1_tf32x3_model`): the key split of
  `cross_attn_plan(f32=True)`, the running max moving once a 64-key tile,
  the cluster's combine;
- K10 (`agreement.k10_tf32x3_model`): one sweep of 64-key tiles for both
  forms.

Each model must pass the unchanged f32 check (`agreement.F32`) against the
unchanged plain versions, and the check must still refuse the TF32-inputs
fault by `F32_REFUSAL` or more: the split keeps f32's accuracy, plain TF32
does not. At most 4 heads, so the file runs in a few seconds.
"""

import pytest
import torch

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, encoder_attn

torch.set_num_threads(2)
F32 = torch.float32


def test_split_is_two_tf32_values_that_sum_to_x():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * torch.logspace(-3, 3, 4096)
    hi, lo = ag.tf32x3_split(x)
    for part in (hi, lo):  # the low 13 mantissa bits are zero: TF32 values
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi, ag.tf32_round(x))
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
    # lo's rounding and the dropped lo lo' keep each product within 2^-21
    y = torch.randn(4096, generator=g)
    (xh, xl), (yh, yl) = (tuple(t.double() for t in ag.tf32x3_split(z)) for z in (x, y))
    xy = x.double() * y.double()
    err = (xl * yh + xh * yl + xh * yh - xy).abs()
    assert bool((err <= 2.0 ** -21 * xy.abs()).all())
    # tf32x3_matmul is that sum of three TF32 products
    a, b = x[:64].reshape(8, 8), y[:64].reshape(8, 8)
    (ah, al), (bh, bl) = ag.tf32x3_split(a), ag.tf32x3_split(b)
    assert torch.equal(ag.tf32x3_matmul(a, b), (al @ bh + ah @ bl) + ah @ bh)


@pytest.mark.parametrize("ta", [1500, 1493])
@pytest.mark.parametrize("Q", [3, 64, 227])
def test_k1_model_passes_the_f32_check(Q, ta):
    """K1 at a sampling step (Q 3, the key split over eight spans), a
    prompt of previous text (Q 64) and the longest prompt the Engine sends
    (Q 227: 223 previous tokens, sot_prev and the SOT sequence)."""
    g = torch.Generator().manual_seed(1000 * Q + ta)
    L, B, H, Ta = 2, 2, 4, 1500
    q = ag.randn(g, "cpu", B, Q, H, 64, scale=2.0, dtype=F32)
    k, v = (ag.randn(g, "cpu", L, B, H, Ta, 64, dtype=F32) for _ in range(2))
    a = (1, q, k, v, ta)
    got = ag.k1_tf32x3_model(*a)
    assert got.shape == q.shape and got.dtype == F32
    ref = attn.cross_attn_layer_plain(*a)
    assert ag.compare(f"K1 3xTF32 model Q={Q} ta={ta}", got, ref, tol=ag.F32).ok
    fault = dict(ag.k1_f32_faults(*a))["K1 TF32 inputs"]
    ag.reject("K1 TF32 inputs", got, fault, tol=ag.F32, factor=ag.F32_REFUSAL)


@pytest.mark.parametrize("single_pass", [True, False], ids=["one-pass", "two-pass"])
@pytest.mark.parametrize("scale", [0.5, 1.0])
@pytest.mark.parametrize("ta", [1500, 1493])
def test_k10_model_passes_the_f32_check(single_pass, scale, ta):
    """K10's one sweep against each form's plain version (the row's final
    max; 512-key blocks) at the encoder's T 1500, q and k at 0.5 and 1.0 as
    the card's check draws them."""
    g = torch.Generator().manual_seed(int(10 * scale) + ta)
    q, k, v = (ag.randn(g, "cpu", 1, 2, 1500, 64, scale=s, dtype=F32)
               for s in (scale, scale, 1.0))
    a = (q, k, v, ta, single_pass)
    got = ag.k10_tf32x3_model(q, k, v, ta)
    assert got.shape == q.shape and got.dtype == F32
    ref = encoder_attn.encoder_self_attention_plain(*a)
    assert ag.compare(f"K10 3xTF32 model {single_pass=} {scale=} {ta=}", got, ref,
                      tol=ag.F32).ok
    fault = dict(ag.k10_f32_faults(*a))["K10 TF32 inputs"]
    ag.reject("K10 TF32 inputs", got, fault, tol=ag.F32, factor=ag.F32_REFUSAL)


def test_plain_tf32_products_miss_the_check():
    """The same K1 order with one TF32 product each (hi hi' alone) misses
    the f32 check: the check sees the split."""
    g = torch.Generator().manual_seed(5)
    q = ag.randn(g, "cpu", 1, 3, 2, 64, scale=2.0, dtype=F32)
    k, v = (ag.randn(g, "cpu", 1, 1, 2, 1500, 64, dtype=F32) for _ in range(2))
    ref = attn.cross_attn_layer_plain(0, q, k, v)
    tq, tk, tv = ag.tf32_inputs(q, k, v)
    hi_only = attn.cross_attn_split_plain(0, tq, tk, tv)
    assert not ag.agreement(hi_only, ref, tol=ag.F32).ok
    assert ag.agreement(ag.k1_tf32x3_model(0, q, k, v), ref, tol=ag.F32).ok


def test_bench_f32_attn_builds_its_rows_on_the_cpu():
    """`tools/bench_f32_attn.py` (the card's timing of K1-f32, K3-f32 and
    K10-f32, also over an older checkout's package): its rows at a small
    size on the CPU, where the wrappers run their plain versions; without a
    card `main` refuses to time."""
    from whisper_diarize_tpu_torch.tools import bench_f32_attn

    rows = bench_f32_attn.cases(torch.device("cpu"), L=2, B=2, H=2, Ta=130, queries=(3, 20))
    names = [name for name, _, _ in rows]
    assert names == ["K1-f32 B=2 Q=3", "K1-f32 B=2 Q=20", "K1-f32 B=1 Q=3", "K3-f32 N=2",
                     "K3-f32 N=10", "K10-f32 single pass", "K10-f32 two pass"]
    for name, fn, library in rows:
        out = fn()
        assert out.dtype == F32 and bool(torch.isfinite(out).all()), name
        if library is not None:
            assert library().shape[-1] == 64, name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_f32_attn.main([])
