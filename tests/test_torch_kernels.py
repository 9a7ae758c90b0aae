"""The PyTorch port's kernel modules against the JAX package's Pallas kernels.

K1 (`ops/attn.py::cross_attn_layer`), K2 (`cross_kv_build`) and K3
(`ops/tail.py::fused_tail_layer`) run their plain PyTorch versions here (CPU
tensors); the JAX side runs the Pallas kernels in interpret mode, as the JAX
package's own tests do. The JAX lane-tiled cross K/V is un-tiled to the
port's [L, B, H, Ta, Dh] before comparing. Same numpy inputs on both sides.

Tolerance (f32): atol 1e-5, rtol 1e-4 — the two sides sum in different
orders; nothing else differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import pallas_tail
from whisper_diarize_tpu.ops.pallas_attn import cross_attn_layer as jax_cross_attn
from whisper_diarize_tpu.ops.pallas_attn import tile_cross_kv

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import attn, tail

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
TA = 1500  # n_audio_ctx of every Whisper checkpoint
GEOMETRIES = [(64, 2), (128, 4)]  # (D, H): Dh 32 with 2 and 4 heads


def _cfg(D, H, L=2):
    return jwm.WhisperConfig(
        n_mels=80, n_vocab=512, n_audio_ctx=TA, n_audio_state=D,
        n_audio_head=H, n_audio_layer=1, n_text_ctx=64, n_text_state=D,
        n_text_head=H, n_text_layer=L)


def _untile(k5, ta):
    """JAX [L, B, NT, H, Dh, TT] -> [L, B, H, Ta, Dh]."""
    k5 = np.asarray(k5)
    L, B, NT, H, Dh, TT = k5.shape
    return k5.transpose(0, 1, 3, 2, 5, 4).reshape(L, B, H, NT * TT, Dh)[:, :, :, :ta]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("D,H", GEOMETRIES)
def test_k2_cross_kv_build_matches_pallas(D, H):
    cfg = _cfg(D, H)
    params = jwm.init_params(cfg, seed=1)
    rng = np.random.default_rng(0)
    xa = rng.standard_normal((2, TA, D)).astype(np.float32)
    ref = jwm.cross_kv_tiled(params, jnp.asarray(xa), cfg, use_kernel=True)
    blk = params["decoder"]["blocks"]
    k, v = attn.cross_kv_build(_t(xa), _t(blk["ck_w"]), _t(blk["cv_w"]),
                               _t(blk["cv_b"]), H)
    np.testing.assert_allclose(k.numpy(), _untile(ref["k5"], TA), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(v.numpy(), _untile(ref["v5"], TA), atol=ATOL, rtol=RTOL)
    # the plain XLA layout of the JAX package is the same array
    plain = jwm.cross_kv(params, jnp.asarray(xa), cfg)
    np.testing.assert_allclose(k.numpy(), np.asarray(plain["k"]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D,H", GEOMETRIES)
@pytest.mark.parametrize("Q,ta_total", [(1, TA), (7, TA), (3, 1100)])
def test_k1_cross_attn_matches_pallas(D, H, Q, ta_total):
    Dh, L, B = D // H, 2, 2
    rng = np.random.default_rng(Q)
    k = rng.standard_normal((L, B, H, TA, Dh)).astype(np.float32)
    v = rng.standard_normal((L, B, H, TA, Dh)).astype(np.float32)
    q = rng.standard_normal((B, Q, H, Dh)).astype(np.float32)
    k5, v5 = tile_cross_kv(jnp.asarray(k), jnp.asarray(v))
    for layer in range(L):
        ref = jax_cross_attn(layer, jnp.asarray(q), k5, v5, ta_total=ta_total,
                             interpret=True)
        got = attn.cross_attn_layer(layer, _t(q), _t(k), _t(v), ta_total)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D,H", GEOMETRIES)
@pytest.mark.parametrize("beams", [1, 3])
def test_k3_fused_tail_matches_pallas(D, H, beams):
    cfg = _cfg(D, H)
    params = jwm.init_params(cfg, seed=2)
    Dh, L, B = D // H, cfg.n_text_layer, 2
    N = B * beams
    rng = np.random.default_rng(beams)
    x = rng.standard_normal((N, 1, D)).astype(np.float32)
    so = (rng.standard_normal((N, H, 1, Dh)) * 0.3).astype(np.float32)
    k = rng.standard_normal((L, B, H, TA, Dh)).astype(np.float32)
    v = rng.standard_normal((L, B, H, TA, Dh)).astype(np.float32)
    k5, v5 = tile_cross_kv(jnp.asarray(k), jnp.asarray(v))
    pack = pallas_tail.pack_tail_weights(params, cfg)
    blocks = pwm.init_params(cfg, seed=2)["decoder"]["blocks"]
    for layer in range(L):
        ref = pallas_tail.fused_tail_layer(
            jnp.int32(layer), jnp.asarray(x), jnp.asarray(so), pack["w"],
            pack["b"], k5, v5, beams=beams, ta_total=TA, interpret=True)
        got = tail.fused_tail_layer(layer, _t(x), _t(so), blocks, _t(k), _t(v),
                                    beams, TA)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_wrappers_use_plain_version_only_on_cpu():
    """CPU tensors take the plain version and count no kernel launch; a
    tensor on any other device never reaches the plain version."""
    rng = np.random.default_rng(3)
    L, B, H, Ta, Dh, D = 2, 2, 2, 40, 32, 64
    k = _t(rng.standard_normal((L, B, H, Ta, Dh)))
    v = _t(rng.standard_normal((L, B, H, Ta, Dh)))
    q = _t(rng.standard_normal((B, 3, H, Dh)))
    before = (attn.cross_attn_layer.launches, attn.cross_kv_build.launches,
              tail.fused_tail_layer.launches)
    torch.testing.assert_close(attn.cross_attn_layer(1, q, k, v),
                               attn.cross_attn_layer_plain(1, q, k, v), rtol=0, atol=0)
    xa = _t(rng.standard_normal((B, Ta, D)))
    w = _t(rng.standard_normal((L, D, D)))
    b = _t(rng.standard_normal((L, D)))
    for got, ref in zip(attn.cross_kv_build(xa, w, w, b, H),
                        attn.cross_kv_build_plain(xa, w, w, b, H)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert (attn.cross_attn_layer.launches, attn.cross_kv_build.launches,
            tail.fused_tail_layer.launches) == before
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(RuntimeError, match="no kernel"):
        attn.cross_attn_layer(0, *meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        attn.cross_kv_build(xa.to("meta"), w.to("meta"), w.to("meta"), b.to("meta"), H)


def test_bf16_ulp():
    x = torch.tensor([1.0, 1.5, -3.0, 0.25, 0.0, 1000.0])
    torch.testing.assert_close(
        ag.bf16_ulp(x), torch.tensor([2 ** -7, 2 ** -7, 2 ** -6, 2 ** -9, 0.0, 4.0]))
    # the next bf16 number above y (one more in the bit pattern) is y + ulp(y)
    y = torch.tensor([1.0, 3.0, 0.3]).bfloat16()
    up = (y.view(torch.int16) + 1).view(torch.bfloat16)
    torch.testing.assert_close(up.float() - y.float(), ag.bf16_ulp(y))


@pytest.mark.parametrize("L,H,B,Ta,beams", [(2, 2, 2, 300, 1), (3, 4, 1, 200, 5)])
def test_kernel_check_takes_rounding_and_refuses_planted_faults(L, H, B, Ta, beams):
    """The card's kernel-vs-plain check (`kernels.agreement`, used by
    chip_smoke.py and test_torch_cuda.py), at Dh 64 in bf16 on the CPU. It
    must take a result that rounds to bf16 in another order: here the plain
    version run with f32 intermediates and rounded once at the end, which
    departs further from the bf16 plain version than the kernels do (they
    round where the plain version rounds). It must refuse every planted
    fault: a dropped bias, a wrong layer, an unscaled query, a span of the
    key split dropped or combined without its rescale."""
    D = 64 * H
    g = torch.Generator().manual_seed(L * 10 + H)
    bl = ag.random_blocks(L, D, g, "cpu")
    f32 = {key: w.float() for key, w in bl.items()}
    xa = ag.randn(g, "cpu", B, Ta, D)
    a2 = (xa, bl["ck_w"], bl["cv_w"], bl["cv_b"], H)
    k, v = attn.cross_kv_build_plain(*a2)
    k32, v32 = attn.cross_kv_build_plain(xa.float(), f32["ck_w"], f32["cv_w"], f32["cv_b"], H)
    assert ag.agreement(k32.bfloat16(), k).ok and ag.agreement(v32.bfloat16(), v).ok
    for name, i, bad in ag.k2_faults(*a2):
        assert not ag.agreement((k, v)[i], bad).ok, name

    layer = L - 1
    q = ag.randn(g, "cpu", B, 3 * beams, H, 64, scale=2.0)
    ref = attn.cross_attn_layer_plain(layer, q, k, v, Ta)
    loose = attn.cross_attn_layer_plain(layer, q.float(), k.float(), v.float(), Ta)
    assert ag.agreement(loose.bfloat16(), ref).ok
    faults = list(ag.k1_faults(layer, q, k, v, Ta))
    assert len(faults) == 4  # and the key split's two (its plan has >= 2 spans)
    for name, bad in faults:
        assert not ag.agreement(ref, bad).ok, name

    N = B * beams
    x = ag.randn(g, "cpu", N, 1, D)
    so = ag.randn(g, "cpu", N, H, 1, 64, scale=0.3)
    ref = tail.fused_tail_layer_plain(layer, x, so, bl, k, v, beams, Ta)
    loose = tail.fused_tail_layer_plain(
        layer, x.float(), so.float(), f32, k.float(), v.float(), beams, Ta)
    assert ag.agreement(loose.bfloat16(), ref, base=x).ok
    faults = list(ag.k3_faults(layer, x, so, bl, k, v, beams, Ta))
    assert len(faults) == 5
    for name, bad in faults:
        assert not ag.agreement(ref, bad, base=x).ok, name
    with pytest.raises(AssertionError, match="planted fault"):
        ag.reject("K3 unchanged", ref, ref, base=x)
    with pytest.raises(AssertionError, match="disagrees"):
        ag.compare("K3 vs a fault", ref, faults[0][1], base=x)
