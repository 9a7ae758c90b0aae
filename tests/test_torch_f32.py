"""The f32 forms of K1-K6, K8 and K10 on the CPU: the f32 check of `kernels.agreement`
(`F32`, and `F32_Q8` for K5 and K6 `kvq`, whose products stay bf16) and the
plain versions it holds the card's f32 kernels to.

- The check accepts each plain version run in f32 against the same plain
  version computed in float64 (the plain versions keep float64 inputs in
  float64), and refuses the two f32 faults by at least `F32_REFUSAL` (the
  inputs in TF32; the bf16 form's rounding points) and every earlier fault
  of the kernel, at each of K1-K6's shapes: K1 at Q 1, 3, 15 and 64 and at
  B 1; K2 and K3 / K6 `wq` at D 1280 (the longest dot products, D and 4D);
  K4 at steps 0, mid and last; K5 and K6 `kvq` at 1500 keys; K8 at N 8
  and 40 (D 1280, a 48-slot cache); K10 in both forms at T 1500.
- K1's split model (`cross_attn_split_plain`) at f32 against the JAX
  package's Pallas `cross_attn_layer` in interpret mode at f32, to 1e-5.
- K4's plain version at f32 against the JAX `split_self_attn_layer` in
  interpret mode at f32, by the f32 check.

Inputs are drawn from seeded generators (numpy for what JAX sees too).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_diarize_tpu.ops.pallas_attn import cross_attn_layer as jax_cross_attn
from whisper_diarize_tpu.ops.pallas_attn import split_self_attn_layer as jax_split_self
from whisper_diarize_tpu.ops.pallas_attn import tile_cross_kv
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, encoder_attn, front, tail

torch.set_num_threads(2)
F32 = torch.float32


def _f64(*args):
    """`args` with every f32 tensor (and every f32 tensor of a dict) in float64."""
    def wide(a):
        if isinstance(a, dict):
            return {key: wide(t) for key, t in a.items()}
        if isinstance(a, torch.Tensor) and a.dtype == F32:
            return a.double()
        return a
    return [wide(a) for a in args]


def _check(tag, got, ref, faults, tol=ag.F32, base=None):
    assert ag.compare(tag, got, ref, base=base, tol=tol).ok
    names = []
    for name, bad in faults:
        factor = ag.F32_REFUSAL if ("TF32" in name or "bf16" in name) else 1.0
        ag.reject(name, got, bad, base=base, tol=tol, factor=factor)
        names.append(name)
    assert any("TF32" in n for n in names) and any("bf16" in n for n in names)


@pytest.mark.parametrize("B,Q", [(2, 1), (2, 3), (2, 15), (2, 64), (1, 3)])
def test_f32_check_k1(B, Q):
    g = torch.Generator().manual_seed(10 * B + Q)
    L, H, Ta = 2, 4, 700
    q = ag.randn(g, "cpu", B, Q, H, 64, scale=2.0, dtype=F32)
    k, v = (ag.randn(g, "cpu", L, B, H, Ta, 64, dtype=F32) for _ in range(2))
    a = (1, q, k, v, Ta - 7)
    _check(f"K1 B={B} Q={Q}", attn.cross_attn_layer_plain(*a),
           attn.cross_attn_layer_plain(*_f64(*a)),
           itertools.chain(ag.k1_f32_faults(*a), ag.k1_faults(*a)))


def test_f32_check_k2():
    g = torch.Generator().manual_seed(2)
    L, B, Ta, D = 2, 2, 64, 1280
    blocks = ag.random_blocks(L, D, g, "cpu", dtype=F32)
    xa = ag.randn(g, "cpu", B, Ta, D, dtype=F32)
    a = (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], D // 64)
    got, ref = attn.cross_kv_build_plain(*a), attn.cross_kv_build_plain(*_f64(*a))
    faults = list(itertools.chain(ag.k2_f32_faults(*a), ag.k2_faults(*a)))
    for i, name in enumerate(("k", "v")):
        _check(f"K2 {name}", got[i], ref[i], [(n, bad) for n, j, bad in faults if j == i])


@pytest.mark.parametrize("N,beams", [(8, 1), (10, 5)])
def test_f32_check_k3_and_k6_wq(N, beams):
    g = torch.Generator().manual_seed(N)
    L, D, Ta = 2, 1280, 64
    H = D // 64
    blocks = ag.random_blocks(L, D, g, "cpu", dtype=F32)
    k, v = (ag.randn(g, "cpu", L, N // beams, H, Ta, 64, dtype=F32) for _ in range(2))
    x = ag.randn(g, "cpu", N, 1, D, dtype=F32)
    so = ag.randn(g, "cpu", N, H, 1, 64, scale=0.3, dtype=F32)
    a = (1, x, so, blocks, k, v, beams, Ta - 3)
    _check(f"K3 N={N}", tail.fused_tail_layer_plain(*a),
           tail.fused_tail_layer_plain(*_f64(*a)),
           itertools.chain(ag.tail_f32_faults("K3", *a), ag.k3_faults(*a),
                           ag.tail_split_faults("K3", *a)), base=x)
    a = (1, x, so, tail.quantize_tail_weights(blocks), k, v, beams, Ta - 3)
    _check(f"K6 wq N={N}", tail.fused_tail_layer_plain(*a),
           tail.fused_tail_layer_plain(*_f64(*a)),
           itertools.chain(ag.tail_f32_faults("K6", *a), ag.k6_faults(*a)), base=x)


@pytest.mark.parametrize("step", [0, 15, 31])
def test_f32_check_k4(step):
    g = torch.Generator().manual_seed(step)
    L, B, K, H, Tp, Td = 2, 2, 5, 4, 19, 32
    q = ag.randn(g, "cpu", B, K, H, 64, scale=2.0, dtype=F32)
    pk, pv = (ag.randn(g, "cpu", L, B, H, Tp, 64, dtype=F32) for _ in range(2))
    dk, dv = (ag.randn(g, "cpu", L, B * K, H, Td, 64, dtype=F32) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, dtype=torch.int32)
    row_pad = torch.tensor([3, 0], dtype=torch.int32)
    a = (1, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp)
    # the earlier faults are the truth at step 0 (no decode slot to slip)
    _check(f"K4 step={step}", attn.split_self_attn_layer_plain(*a),
           attn.split_self_attn_layer_plain(*_f64(*a)),
           itertools.chain(ag.k4_f32_faults(*a), ag.k4_faults(*a) if step else ()))


@pytest.mark.parametrize("N", [8, 40])
def test_f32_check_k8(N):
    """K8 at the fused path's shapes (D 1280, H 20, a 48-slot cache, pos
    19 with row pads; N 8 greedy, 40 the best_of 5 rung): self_out judged
    with its faults, k_new and v_new by the check alone."""
    g = torch.Generator().manual_seed(80 + N)
    L, D, Tc, pos = 2, 1280, 48, 19
    fw = ag.random_front(L, D, g, "cpu", dtype=F32)
    x = ag.randn(g, "cpu", N, 1, D, dtype=F32)
    kc, vc = (ag.randn(g, "cpu", L, N, D // 64, Tc, 64, dtype=F32) for _ in range(2))
    row_pad = torch.randint(0, pos + 1, (N,), generator=g)
    a = (1, pos, row_pad, x, fw)
    got = front.fused_front_layer_plain(*a, kc.clone(), vc.clone())
    ref = front.fused_front_layer_plain(*_f64(*a, kc, vc))
    _check(f"K8 N={N}", got[0], ref[0],
           itertools.chain(ag.k8_f32_faults(*a, kc, vc), ag.k8_faults(*a, kc, vc)))
    for name, i in (("k_new", 1), ("v_new", 2)):
        assert ag.compare(f"K8 N={N} {name}", got[i], ref[i], tol=ag.F32).ok


@pytest.mark.parametrize("single_pass", [True, False], ids=["one-pass", "two-pass"])
@pytest.mark.parametrize("ta", [1500, 1493])
def test_f32_check_k10(single_pass, ta):
    """K10 at the encoder's T 1500 (two heads of one stream), q and k at
    0.5 as the card's check draws them (36 padded keys move the softmax)."""
    g = torch.Generator().manual_seed(ta + int(single_pass))
    q, k, v = (ag.randn(g, "cpu", 1, 2, 1500, 64, scale=s, dtype=F32) for s in (0.5, 0.5, 1))
    a = (q, k, v, ta, single_pass)
    faults = ag.k10_f32_faults(*a)
    if ta == 1500:
        faults = itertools.chain(faults, ag.k10_faults(*a))
    _check(f"K10 ta={ta}", encoder_attn.encoder_self_attention_plain(*a),
           encoder_attn.encoder_self_attention_plain(*_f64(*a)), faults)


def test_k8_k10_wrappers_take_f32_on_the_cpu():
    """On CPU tensors K8's and K10's wrappers run their plain versions at
    f32 and launch nothing; K8's f32 split fits the card at every row count
    of the fused path."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (ag.randn(g, "cpu", 1, 2, 100, 64, dtype=F32) for _ in range(3))
    counts = (encoder_attn.encoder_self_attention.launches,
              encoder_attn.encoder_self_attention.launches_f32,
              front.fused_front_layer.launches, front.fused_front_layer.launches_f32)
    got = encoder_attn.encoder_self_attention(q, k, v, 90, False)
    assert got.dtype == F32
    assert torch.equal(got, encoder_attn.encoder_self_attention_plain(q, k, v, 90, False))
    fw = ag.random_front(1, 128, g, "cpu", dtype=F32)
    x = ag.randn(g, "cpu", 3, 1, 128, dtype=F32)
    kc = ag.randn(g, "cpu", 1, 3, 2, 16, 64, dtype=F32)
    out = front.fused_front_layer(0, 5, None, x, fw, kc.clone(), kc.clone())
    ref = front.fused_front_layer_plain(0, 5, torch.zeros(3, dtype=torch.long), x, fw,
                                        kc.clone(), kc.clone())
    assert all(torch.equal(a, b) and a.dtype == F32 for a, b in zip(out, ref))
    assert counts == (encoder_attn.encoder_self_attention.launches,
                      encoder_attn.encoder_self_attention.launches_f32,
                      front.fused_front_layer.launches, front.fused_front_layer.launches_f32)
    for N in (1, 8, 40, 80):
        args = front.front_int_args(0, N, 1280, 20, 48, 19, f32=True)
        plan = tail.SkinnyPlan(*args[6:])
        assert plan == tail.skinny_plan(N, 1280, 3 * 1280, ln=True, f32=True)
        assert tail.skinny_smem(min(N, 80), plan, False, True, True) <= tail.SKINNY_SMEM_MAX


def _int8_cache(seed, B, H, Ta, D=1280):
    g = torch.Generator().manual_seed(seed)
    blocks = ag.random_blocks(1, D, g, "cpu", dtype=F32)
    xa = ag.randn(g, "cpu", B, Ta, D, dtype=F32)
    k, v = attn.cross_kv_build_plain(xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    return g, blocks, attn.quantize_cross_kv(k, v)


@pytest.mark.parametrize("Q", [3, 15])
def test_f32_check_k5(Q):
    """K5's reference is its split model (the card's order: p * vs rounded
    to bf16 against each 64-key tile's running max)."""
    g, _, (k8, ks, v8, vs) = _int8_cache(Q, 2, 20, 1500)
    q = ag.randn(g, "cpu", 2, Q, 20, 64, scale=2.0, dtype=F32)
    a = (0, q, k8, ks, v8, vs, 1493)
    _check(f"K5 Q={Q}", ag.split_attend(0, q, k8, v8, 1493, ks, vs),
           ag.split_attend(*_f64(0, q, k8, v8, 1493, ks, vs)),
           itertools.chain(ag.k5_f32_faults(*a), ag.k5_faults(*a)), tol=ag.F32_Q8)


@pytest.mark.parametrize("form", ["kvq", "wq+kvq"])
def test_f32_check_k6_kvq(form):
    g, blocks, (k8, ks, v8, vs) = _int8_cache(7, 2, 20, 1500)
    N, beams, D = 10, 5, 1280
    w = tail.quantize_tail_weights(blocks) if form.startswith("wq") else blocks
    x = ag.randn(g, "cpu", N, 1, D, dtype=F32)
    so = ag.randn(g, "cpu", N, 20, 1, 64, scale=0.3, dtype=F32)
    a = (0, x, so, w, k8, v8, beams, 1500, ks, vs)
    _check(f"K6 {form}", tail.fused_tail_layer_plain(*a, attend=ag.split_attend),
           tail.fused_tail_layer_plain(*_f64(*a), attend=ag.split_attend),
           itertools.chain(ag.tail_f32_faults("K6", *a), ag.k6_faults(*a)),
           tol=ag.F32_Q8, base=x)


@pytest.mark.parametrize("B,Q,Ta,ta", [(2, 3, 700, 650), (1, 17, 1500, 1500), (2, 5, 200, 130)])
def test_split_model_matches_jax_k1_at_f32(B, Q, Ta, ta):
    """At f32 the split model rounds nowhere: it is the JAX kernel's f32
    function in another order of sums."""
    L, H = 2, 2
    rng = np.random.default_rng(B * 100 + Q)
    q = rng.standard_normal((B, Q, H, 64)).astype(np.float32) * 2
    k, v = (rng.standard_normal((L, B, H, Ta, 64)).astype(np.float32) for _ in range(2))
    k5, v5 = tile_cross_kv(jnp.asarray(k), jnp.asarray(v))
    for layer in range(L):
        ref = np.asarray(jax_cross_attn(layer, jnp.asarray(q), k5, v5, ta_total=ta,
                                        interpret=True))
        got = attn.cross_attn_split_plain(layer, *map(torch.from_numpy, (q, k, v)), ta)
        assert got.dtype == F32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("step", [0, 9, 31])
def test_k4_plain_matches_jax_at_f32(step):
    L, B, K, H, Tp, Td = 2, 2, 5, 4, 19, 32
    rng = np.random.default_rng(40 + step)
    q = rng.standard_normal((B, K, H, 64)).astype(np.float32) * 2
    pk, pv = (rng.standard_normal((L, B, H, Tp, 64)).astype(np.float32) for _ in range(2))
    dk, dv = (rng.standard_normal((L, B * K, H, Td, 64)).astype(np.float32) for _ in range(2))
    anc_j = rng.integers(0, K, (B, K, Td)).astype(np.int32)
    row_pad = np.array([4, 0], np.int32)
    for layer in range(L):
        ref = jax_split_self(layer, *map(jnp.asarray, (q, pk, pv, dk, dv, anc_j)), step,
                             jnp.asarray(row_pad), Tp, interpret=True)
        got = attn.split_self_attn_layer_plain(
            layer, *map(torch.from_numpy, (q, pk, pv, dk, dv, anc_j, )), step,
            torch.from_numpy(row_pad), Tp)
        ag.compare(f"K4 vs JAX step={step} layer={layer}", got,
                   torch.from_numpy(np.array(ref)), tol=ag.F32)


def test_wrappers_take_f32_on_the_cpu():
    """On CPU tensors every wrapper runs its plain version at f32 and
    launches nothing; the f32 plans differ from the bf16 ones only by the
    CTA target (K1) and the tile bytes (K3)."""
    g = torch.Generator().manual_seed(0)
    q = ag.randn(g, "cpu", 1, 3, 2, 64, dtype=F32)
    k, v = (ag.randn(g, "cpu", 1, 1, 2, 100, 64, dtype=F32) for _ in range(2))
    before = attn.cross_attn_layer.launches, attn.cross_attn_layer.launches_f32
    assert torch.equal(attn.cross_attn_layer(0, q, k, v),
                       attn.cross_attn_layer_plain(0, q, k, v))
    assert (attn.cross_attn_layer.launches, attn.cross_attn_layer.launches_f32) == before
    # B 8, Q <= 16 at large-v3: four spans of 384 keys at f32 (two in bf16)
    assert attn.cross_attn_plan(8, 20, 3, 1500, f32=True) == attn.CrossAttnPlan(4, 384)
    assert attn.cross_attn_plan(8, 20, 3, 1500) == attn.CrossAttnPlan(2, 768)
    for N in (1, 8, 40, 80):
        for int8 in (False, True):
            for plan, ln in zip(tail.tail_plans(N, 1280, int8, True),
                                (False, True, False, True, False)):
                assert tail.skinny_smem(min(N, 80), plan, int8, ln, True) <= tail.SKINNY_SMEM_MAX
