"""The numerics plan of the f32 forms of K1, K2, K3 (with K6 `wq` and K8,
which share its skinny GEMM) and K10 on the CPU: 3xTF32 products on the
tensor cores, in each kernel's order.

Each f32 operand splits into hi = tf32(x) and lo = tf32(x - hi); a product
is lo hi' + hi lo' + hi hi' in f32 (`agreement.tf32x3_split`,
`tf32x3_matmul`). The models run the card's orders with those products:

- K1 (`agreement.k1_tf32x3_model`): the key split of
  `cross_attn_plan(f32=True)`, the running max moving once a 64-key tile,
  the cluster's combine;
- K10 (`agreement.k10_tf32x3_model`): one sweep of 64-key tiles for both
  forms;
- K2 (`agreement.k2_tf32x3_model`): each 32-k ring slot's products from
  zero, the slots' sums added in f32 in slot order;
- the skinny GEMM (`agreement.skinny_tf32x3_model`, the tail's products
  through `skinny_tf32x3_proj`): each 16-row group from zero, the warps'
  and the spans' partials in order; int8 weights in two products.

The tensor cores add into their accumulator truncating. `rz=True` models
that accumulator (each k8 step's products added and rounded toward zero):
with it, the kernels' slot-from-zero order passes the check where one
running accumulator over K2's 1280 k rows does not.

Each model must pass the unchanged f32 check (`agreement.F32`) against the
unchanged plain versions, and the check must still refuse the TF32-inputs
fault by `F32_REFUSAL` or more: the split keeps f32's accuracy, plain TF32
does not. The attention models take at most 4 heads; K2 and the tail run at
large-v3 widths (D 1280) on a few hundred rows.
"""

import pytest
import torch

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, encoder_attn, tail

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


F64 = torch.float64
D_LV3, H_LV3 = 1280, 20  # large-v3's decoder width and heads


def _double(*args):
    """args with every float tensor (and those of a dict) in float64: the
    plain versions' exact reference."""
    def d(a):
        if isinstance(a, dict):
            return {key: d(t) for key, t in a.items()}
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.double()
        return a
    return [d(a) for a in args]


def _k2_inputs(seed: int, Ta: int = 200):
    g = torch.Generator().manual_seed(seed)
    blocks = ag.random_blocks(1, D_LV3, g, "cpu", dtype=F32)
    xa = ag.randn(g, "cpu", 1, Ta, D_LV3, dtype=F32)
    return (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H_LV3)


def test_k2_model_passes_the_f32_check():
    """K2-f32's order (32-k slots from zero) at large-v3 width, one layer,
    against the float64 plain version; its f32 faults refused by
    `F32_REFUSAL`."""
    a = _k2_inputs(7)
    got = ag.k2_tf32x3_model(*a)
    ref = attn.cross_kv_build_plain(*_double(*a))
    for i in range(2):
        assert got[i].shape == ref[i].shape and got[i].dtype == F32
        assert ag.compare(f"K2 3xTF32 model {'kv'[i]}", got[i], ref[i], tol=ag.F32).ok
    for name, i, bad in ag.k2_f32_faults(*a):
        ag.reject(name, got[i], bad, tol=ag.F32, factor=ag.F32_REFUSAL)


def _tail_inputs(N: int, beams: int, seed: int, Ta: int = 300):
    g = torch.Generator().manual_seed(seed)
    blocks = ag.random_blocks(1, D_LV3, g, "cpu", dtype=F32)
    k, v = (ag.randn(g, "cpu", 1, N // beams, H_LV3, Ta, 64, dtype=F32) for _ in range(2))
    x = ag.randn(g, "cpu", N, 1, D_LV3, dtype=F32)
    so = ag.randn(g, "cpu", N, H_LV3, 1, 64, scale=0.3, dtype=F32)
    return (0, x, so, blocks, k, v, beams, Ta)


def _k1_attend(layer, q, k, v, ta_total, ks, vs):
    return ag.k1_tf32x3_model(layer, q, k, v, ta_total)


@pytest.mark.parametrize("N,beams", [(8, 1), (40, 5)])
def test_k3_model_passes_the_f32_check(N, beams):
    """K3-f32's products in the skinny GEMM's order (`skinny_tf32x3_proj`
    on `tail_plans(N, D, f32=True)`) and its K1-f32 in K1's, at large-v3
    width, against the float64 plain tail; its f32 faults refused."""
    a = _tail_inputs(N, beams, N)
    got = tail.fused_tail_layer_plain(*a, proj=ag.skinny_tf32x3_proj(N, D_LV3),
                                      attend=_k1_attend)
    ref = tail.fused_tail_layer_plain(*_double(*a))
    x = a[1]
    assert ag.compare(f"K3 3xTF32 model N={N}", got, ref, base=x, tol=ag.F32).ok
    for name, bad in ag.tail_f32_faults("K3", *a):
        ag.reject(name, got, bad, base=x, tol=ag.F32, factor=ag.F32_REFUSAL)


@pytest.mark.parametrize("name,ln", [("o", False), ("fc1", True), ("fc2", False)])
def test_skinny_model_with_int8_weights_passes_the_f32_check(name, ln):
    """K6-f32 `wq`'s two products (int8 weights exact in TF32: a_lo w +
    a_hi w) on each strip width its plans take, against float64."""
    g = torch.Generator().manual_seed(len(name))
    Din, Dout = {"o": (D_LV3, D_LV3), "fc1": (D_LV3, 4 * D_LV3), "fc2": (4 * D_LV3, D_LV3)}[name]
    h = ag.randn(g, "cpu", 40, Din, dtype=F32)
    w = torch.randint(-127, 128, (Din, Dout), generator=g, dtype=torch.int8)
    plan = tail.skinny_plan(40, Din, Dout, int8=True, ln=ln, f32=True)
    got = ag.skinny_tf32x3_model(h, w, plan)
    ref = h.double() @ w.double()
    assert ag.compare(f"K6 wq {name} model, {plan}", got, ref, tol=ag.F32).ok
    assert not ag.agreement(ag.tf32_round(h) @ w.float(), ref, tol=ag.F32).ok  # TF32 a


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_plain_tf32_products_miss_the_check_in_k2_and_k3(kernel):
    """K2's and the skinny GEMM's order with one TF32 product each (hi hi')
    miss the f32 check; the 3xTF32 split of the same order passes."""
    if kernel == "K2":
        a = _k2_inputs(11, Ta=64)
        ref = attn.cross_kv_build_plain(*_double(*a))[1]
        one, three = (ag.k2_tf32x3_model(*a, products=p)[1] for p in (1, 3))
        base = None
    else:
        a = _tail_inputs(8, 1, 12, Ta=64)
        ref = tail.fused_tail_layer_plain(*_double(*a))
        one, three = (tail.fused_tail_layer_plain(
            *a, proj=ag.skinny_tf32x3_proj(8, D_LV3, products=p), attend=_k1_attend)
            for p in (1, 3))
        base = a[1]
    assert not ag.agreement(one, ref, base=base, tol=ag.F32).ok
    assert ag.agreement(three, ref, base=base, tol=ag.F32).ok


def test_truncating_accumulator_model():
    """A model of the tensor cores' truncating accumulation (`rz`: each k8
    step's products added, rounded toward zero). The kernels' order, each
    32-k slot (K2, D 1280) or 16-row group (fc2's spans at N 40) from zero
    and the sums added on the CUDA cores, passes `REL_L2_F32`; one running
    accumulator over K2's D lands past it (the card's finding on K10-f32's
    188-step chain, 1.05e-5), over a warp's rows of an fc2 span short of it.
    The distances are printed (`pytest -s`)."""
    a = _k2_inputs(13)
    ref = attn.cross_kv_build_plain(*_double(*a))[0]
    slot = ag.agreement(ag.k2_tf32x3_model(*a, rz=True)[0], ref, tol=ag.F32)
    running = ag.agreement(ag.k2_tf32x3_model(*a, rz=True, chain=D_LV3)[0], ref, tol=ag.F32)
    print(f"K2 D {D_LV3}, truncating accumulator: slots from zero rel_l2 {slot.rel_l2:.3g}, "
          f"one running accumulator {running.rel_l2:.3g} "
          f"({running.rel_l2 / ag.REL_L2_F32:.3g}x REL_L2_F32)")
    assert slot.ok and slot.rel_l2 <= ag.REL_L2_F32
    assert running.rel_l2 > ag.REL_L2_F32
    g = torch.Generator().manual_seed(14)
    N, Din = 40, 4 * D_LV3
    h = ag.randn(g, "cpu", N, Din, scale=0.5, dtype=F32)
    w = ag.randn(g, "cpu", Din, D_LV3, scale=Din ** -0.5, dtype=F32)
    plan = tail.skinny_plan(N, Din, D_LV3, f32=True)
    ref = h.double() @ w.double()
    group = ag.agreement(ag.skinny_tf32x3_model(h, w, plan, rz=True), ref, tol=ag.F32)
    run = ag.agreement(ag.skinny_tf32x3_model(h, w, plan, rz=True, running=True), ref,
                       tol=ag.F32)
    print(f"fc2 N {N} {plan}, truncating accumulator: groups from zero rel_l2 "
          f"{group.rel_l2:.3g}, one running accumulator a warp {run.rel_l2:.3g} "
          f"({run.rel_l2 / ag.REL_L2_F32:.3g}x REL_L2_F32)")
    assert group.ok and group.rel_l2 <= ag.REL_L2_F32
    assert run.rel_l2 > group.rel_l2


def test_bench_f32_attn_builds_its_rows_on_the_cpu():
    """`tools/bench_f32_attn.py` (the card's timing of K2-f32, K1-f32,
    K3-f32, K6-f32, K8-f32, K10-f32, K4, K4-f32 and K7, also over an older checkout's
    package): its rows at a small size on the CPU, where the wrappers run
    their plain versions; K7's library row (the cuFFT route) computes K7's
    function; without a card `main` refuses to time."""
    from whisper_diarize_tpu_torch.tools import bench_f32_attn

    rows = bench_f32_attn.cases(torch.device("cpu"), L=2, B=2, H=2, Ta=130, queries=(3, 20),
                                k2_layers=(2, 1), Tc=24, mel_T=4000)
    names = [name for name, _, _ in rows]
    assert names == ["K2-f32 L=2", "K2-f32 L=1", "K1-f32 B=2 Q=3", "K1-f32 B=2 Q=20",
                     "K1-f32 B=1 Q=3", "K3-f32 N=2", "K3-f32 N=10", "K6-f32 kvq N=10",
                     "K6-f32 wq+kvq N=10", "K8-f32 N=2", "K8-f32 N=10", "K10-f32 single pass",
                     "K10-f32 two pass"] + [f"{tag} Td={Td} step={step}" for tag in ("K4", "K4-f32")
                                            for Td, step in ((64, 0), (64, 31), (64, 63),
                                                             (224, 223))] + [
                     "K7 mels=128", "K7 mels=80"]
    for name, fn, library in rows:
        out = fn()
        if name.startswith("K7"):  # [B, F, n_mels]; the library [B, n_mels, F]
            n_mels = int(name.split("=")[1])
            assert out.dtype == F32 and out.shape == (2, 25, n_mels), name
            assert ag.agreement(library().transpose(-1, -2), out, atol=ag.F32_ATOL).ok, name
            continue
        if name.startswith("K2"):  # (k, v) [L, B, H, Ta, 64]; the library: [B Ta, L 2 H 64]
            L = int(name.split("=")[1])
            assert all(t.dtype == F32 and t.shape == (L, 2, 2, 130, 64) for t in out), name
            lib = library()
            assert lib.shape == (2 * 130, L * 2 * 128), name
            k_lib = lib.view(2, 130, L, 2, 2, 64)[:, :, :, 0].permute(2, 0, 3, 1, 4)
            assert torch.allclose(k_lib, out[0], atol=1e-4), name
            continue
        if name.startswith("K4 "):  # the bf16 form: [B, K, H, 64]
            assert out.dtype == torch.bfloat16 and out.shape == (2, 5, 2, 64), name
            assert bool(torch.isfinite(out.float()).all()), name
            continue
        assert out.dtype == F32 and bool(torch.isfinite(out).all()), name
        if library is not None:
            assert library().shape[-1] == 64, name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_f32_attn.main([])
