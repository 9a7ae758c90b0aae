"""K1 / K5's key split (`ops/attn.py::cross_attn_plan`) and its plain model
(`cross_attn_split_plain`: the spans of the plan, p rounded to bf16 against
the span's running max, the spans combined in order) on the CPU.

The plan must cover the keys [0, ta_total) once each, in spans of whole
64-key tiles, with at most a cluster's CTAs. The model must agree with the
JAX package's `cross_attn_layer` / `cross_attn_layer_q8` (Pallas, interpret
mode, bf16 inputs) under `kernels.agreement`'s check, at small widths; and
the check must refuse the split's planted faults (a span dropped, the
spans combined without their rescale), which is what the card's kernels
are held to in `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from whisper_diarize_tpu.ops.pallas_attn import cross_attn_layer as jax_cross_attn
from whisper_diarize_tpu.ops.pallas_attn import cross_attn_layer_q8 as jax_cross_attn_q8
from whisper_diarize_tpu.ops.pallas_attn import tile_cross_kv, tile_quantize_cross_kv
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn

torch.set_num_threads(2)


def _check_plan(B, H, Q, ta, int8=False):
    n_span, span_keys = attn.cross_attn_plan(B, H, Q, ta, int8)
    assert 1 <= n_span <= attn.CLUSTER_MAX
    assert span_keys > 0 and span_keys % attn.KEYS_PER_TILE == 0
    spans = [range(r * span_keys, min((r + 1) * span_keys, ta)) for r in range(n_span)]
    assert all(len(s) > 0 for s in spans), "every span holds an unmasked key"
    assert [t for s in spans for t in s] == list(range(ta)), "the keys, once each"
    return n_span, span_keys


@pytest.mark.parametrize("ta", [1, 63, 65, 1500])
@pytest.mark.parametrize("Q", [1, 3, 5, 15, 64])
@pytest.mark.parametrize("B", [1, 8, 16])
def test_plan_covers_the_keys(B, Q, ta):
    n_span, _ = _check_plan(B, 20, Q, ta)
    n8, _ = _check_plan(B, 20, Q, ta, int8=True)
    assert n8 >= n_span  # half the bytes a tile: at least as many CTAs
    if ta == 1500:
        # the served shapes (large-v3: 20 heads, 24 tiles): a full cluster
        # at B 1; at B 8 two spans of 768 keys (K1), three of 512 (K5)
        want = {1: (8, 8), 8: (2, 3), 16: (1, 2)}[B]
        assert (n_span, n8) == want


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 64), H=st.integers(1, 32), Q=st.integers(1, 300),
       ta=st.integers(1, 4096), int8=st.booleans())
def test_plan_covers_the_keys_at_any_shape(B, H, Q, ta, int8):
    _check_plan(B, H, Q, ta, int8)


def test_split_plans_are_plans():
    """`split_plans` (the tool's sweep) lists valid splits, the planner's
    among them."""
    for ta in (1, 65, 700, 1500):
        plans = attn.split_plans(ta)
        assert attn.cross_attn_plan(8, 20, 3, ta) in plans
        assert attn.cross_attn_plan(1, 20, 3, ta, int8=True) in plans
        for n, span in plans:
            assert n * span >= ta > (n - 1) * span and span % attn.KEYS_PER_TILE == 0


def test_plan_is_refused_for_empty_shapes():
    with pytest.raises(ValueError):
        attn.cross_attn_plan(8, 20, 3, 0)


def _inputs(seed, L, B, Q, H, Ta):
    g = torch.Generator().manual_seed(seed)
    q = ag.randn(g, "cpu", B, Q, H, 64, scale=2.0)
    k, v = (ag.randn(g, "cpu", L, B, H, Ta, 64) for _ in range(2))
    return q, k, v


def _bf16_jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)


def _from_jax(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("B,Q,Ta,ta", [(2, 3, 700, 650), (1, 17, 1500, 1500), (2, 5, 200, 130)])
def test_split_model_matches_jax_k1(B, Q, Ta, ta):
    """bf16 inputs to both: the model rounds where K1 on the card rounds; the
    JAX kernel against the row's running max of its 512-key tiles."""
    L, H = 2, 2
    q, k, v = _inputs(B * 100 + Q, L, B, Q, H, Ta)
    k5, v5 = tile_cross_kv(_bf16_jax(k), _bf16_jax(v))
    for layer in range(L):
        ref = _from_jax(jax_cross_attn(layer, _bf16_jax(q), k5, v5, ta_total=ta,
                                       interpret=True))
        got = attn.cross_attn_split_plain(layer, q, k, v, ta)
        ag.compare(f"K1 split model B={B} Q={Q} ta={ta} layer={layer}", got, ref)
        for name, bad in ag.k1_faults(layer, q, k, v, ta):
            ag.reject(name, got, bad)


@pytest.mark.parametrize("B,Q,Ta,ta", [(2, 3, 700, 650), (1, 15, 1500, 1500)])
def test_split_model_matches_jax_k5(B, Q, Ta, ta):
    L, H = 2, 2
    q, k, v = _inputs(B * 10 + Q, L, B, Q, H, Ta)
    k8, ks, v8, vs = attn.quantize_cross_kv(k.float(), v.float())
    jk8, jks, jv8, jvs = tile_quantize_cross_kv(jnp.asarray(k.float().numpy()),
                                                jnp.asarray(v.float().numpy()))
    for layer in range(L):
        ref = _from_jax(jax_cross_attn_q8(layer, _bf16_jax(q), jk8, jks, jv8, jvs,
                                          ta_total=ta, interpret=True))
        got = attn.cross_attn_split_plain(layer, q, k8, v8, ta, ks=ks, vs=vs)
        ag.compare(f"K5 split model B={B} Q={Q} ta={ta} layer={layer}", got, ref)
        names = [name for name, bad in ag.k5_faults(layer, q, k8, ks, v8, vs, ta)
                 if not ag.reject(name, got, bad).ok]
        assert "K5 a span dropped" in names


def test_split_faults_need_two_spans():
    """One span (a tile of keys) has nothing to drop or rescale."""
    q, k, v = _inputs(0, 1, 1, 3, 2, 60)
    assert attn.cross_attn_plan(1, 2, 3, 60).n_span == 1
    names = [name for name, _ in ag.k1_faults(0, q, k, v, 60)]
    assert names == ["K1 wrong layer", "K1 q not scaled by Dh^-0.5"]
    q, k, v = _inputs(0, 1, 1, 3, 2, 700)
    names = [name for name, _ in ag.k1_faults(0, q, k, v, 700)]
    assert names[2:] == ["K1 a span dropped", "K1 spans combined without their rescale"]


def test_split_model_is_the_combine_of_its_spans():
    """The model's pieces: one span reproduces the 64-key-tile flash
    recurrence over all keys; the combine of several equals it within bf16
    rounding of p."""
    q, k, v = _inputs(3, 1, 2, 4, 2, 500)
    one = attn.cross_attn_split_plain(0, q, k, v, 480, plan=attn.CrossAttnPlan(1, 512))
    many = attn.cross_attn_split_plain(0, q, k, v, 480, plan=attn.CrossAttnPlan(8, 64))
    ag.compare("one span vs eight", many, one)
    ag.compare("one span vs plain", one, attn.cross_attn_layer_plain(0, q, k, v, 480))
