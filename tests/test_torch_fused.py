"""The all-fused greedy path of the port against the JAX package on the CPU
(f32, the same numpy inputs and weights on both sides): K7 (`ops/mel.py::
log_mel_fused`, `frontend`), K10 (`ops/encoder_attn.py::
encoder_self_attention`, both forms, and `models/whisper.py::encode(...,
flash=True)`), K8 (`ops/front.py::fused_front_layer`, the weights carried by
`models/weights.py::front_from_jax`) and the greedy decode loops with the
front attached. The kernels' plain versions run here; the JAX side runs the
quarantined Pallas kernels of `tools/` in interpret mode, as the JAX
package's own tests do (`tests/test_pallas_mel.py`, `test_pallas_tail.py`).

`tools/bench_encoder_attn.py` does not import: a second `from __future__`
was pasted at its line 150. Its kernel half is loaded by executing the text
from that line on, and `make_encode` by executing the whole text without
that one line.

Tolerances:
- K7: atol 5e-5 on whisper's scaled log-mel (the JAX test's own bound);
- K10: atol 1e-5 (f32, sums in another order);
- `encode(flash=True)` (K10) against `make_encode(cfg, "flash-custom")`:
  atol 1e-4 on the layer-normed audio states (two layers);
- K8: rtol 1e-5 / atol 1e-6 on k_new and v_new, 2e-5 on self_out (the JAX
  test's bounds);
- greedy decoding with the front: JAX's tokens exactly, token
  probabilities within 1e-5; the best_of ladder with the front gives the
  tokens it gives without it, under the same `torch.Generator`.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.ops import pallas_tail
from whisper_diarize_tpu.tokenizer import DebugTokenizer

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.ops import encoder_attn, front, mel
from whisper_diarize_tpu_torch.ops.prng import Threefry

from tests.test_whisper_model import TINY_TEST_CFG

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))

import pallas_front  # noqa: E402 (quarantined kernels, tools/)
from pallas_mel import TILE_F, log_mel_pallas  # noqa: E402

torch.set_num_threads(2)

TK = DebugTokenizer()
SP = TK.specials


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _exec_tool(keep) -> dict:
    """Execute the lines of tools/bench_encoder_attn.py that `keep(i, line)`
    (1-based) selects, in a namespace of their own."""
    path = TOOLS / "bench_encoder_attn.py"
    lines = path.read_text().splitlines(keepends=True)
    src = "".join(ln if keep(i, ln) else "\n" for i, ln in enumerate(lines, 1))
    ns = {"__name__": "bench_encoder_attn_kernels"}
    exec(compile(src, str(path), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def enc_attn_tool():
    """(kernel half, whole file without its second `from __future__`)."""
    kernel = _exec_tool(lambda i, ln: i >= 150)
    whole = _exec_tool(lambda i, ln: not (i == 150 and ln.startswith("from __future__")))
    return kernel, whole


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_mels,T", [(80, 16000 * 5), (128, 16000 * 5),
                                      (80, 16000 * 3 + 4800)])
def test_k7_plain_matches_pallas(n_mels, T):
    """The raw log-mel of `log_mel_fused` (plain on the CPU), scaled as
    `frontend` scales it, and `frontend` itself, against the Pallas kernel;
    3 + 4800 / 16000 s is 337 frames, not a multiple of TILE_F."""
    rng = np.random.default_rng(n_mels + T)
    x = rng.standard_normal((2, T)).astype(np.float32) * 0.3
    ref = np.asarray(log_mel_pallas(jnp.asarray(x), n_mels=n_mels, interpret=True))
    raw = mel.log_mel_fused(_t(x), n_mels)
    assert tuple(raw.shape) == (2, T // 160, n_mels)
    np.testing.assert_allclose(mel._normalize(raw).numpy(), ref, atol=5e-5)
    np.testing.assert_allclose(mel.frontend(_t(x), n_mels).numpy(), ref, atol=5e-5)
    np.testing.assert_allclose(mel.frontend(_t(x[0]), n_mels).numpy(), ref[0], atol=5e-5)
    if T % 16000:
        assert ref.shape[-1] % TILE_F != 0


# --------------------------------------------------------------------------
# K10
# --------------------------------------------------------------------------

@pytest.mark.parametrize("single_pass", [True, False], ids=["one-pass", "two-pass"])
@pytest.mark.parametrize("T,ta_total", [(200, None), (600, None), (600, 550)])
def test_k10_plain_matches_pallas(enc_attn_tool, T, ta_total, single_pass):
    """T 200: one key block; T 600: two 512-key blocks, the second padded;
    ta_total 550 masks keys inside the last block as well."""
    kernel, _ = enc_attn_tool
    rng = np.random.default_rng(T + (ta_total or 0))
    q, k, v = (rng.standard_normal((2, 3, T, 64)).astype(np.float32) for _ in range(3))
    ref = kernel["encoder_self_attention"](
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ta_total=ta_total,
        interpret=True, single_pass=single_pass)
    got = encoder_attn.encoder_self_attention(_t(q), _t(k), _t(v), ta_total, single_pass)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_encode_with_k10_matches_flash_custom(enc_attn_tool, monkeypatch):
    """`encode(flash=True)` against the JAX tool's
    `make_encode(cfg, "flash-custom")` (the Pallas kernel in every layer):
    K10 in its single-pass form in every layer."""
    _, whole = enc_attn_tool
    cfg = TINY_TEST_CFG
    mel_np = np.random.default_rng(2).standard_normal((1, cfg.n_mels, 3000)).astype(np.float32)
    ref = whole["make_encode"](cfg, "flash-custom")(jwm.init_params(cfg, seed=5),
                                                   jnp.asarray(mel_np))
    calls = []
    real = encoder_attn.encoder_self_attention

    def counting(q, k, v, *rest, **kw):
        calls.append((tuple(q.shape), rest, kw))
        return real(q, k, v, *rest, **kw)

    monkeypatch.setattr(encoder_attn, "encoder_self_attention", counting)
    got = pwm.encode(pwm.init_params(cfg, seed=5), _t(mel_np), cfg, flash=True)
    assert calls == [((1, cfg.n_audio_head, 1500, cfg.head_dim), (), {})] * cfg.n_audio_layer
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# K8
# --------------------------------------------------------------------------

FRONT_CFG = jwm.WhisperConfig(
    n_mels=8, n_vocab=64, n_audio_ctx=32, n_audio_state=32, n_audio_head=4,
    n_audio_layer=1, n_text_ctx=64, n_text_state=32, n_text_head=4, n_text_layer=2)


@pytest.fixture(scope="module")
def front_params():
    """The JAX init of FRONT_CFG with random ln1 and q / v biases (the init
    leaves them trivial, which would hide a slip in the pack)."""
    params = jwm.init_params(FRONT_CFG, seed=7)
    rng = np.random.default_rng(11)
    blk = dict(params["decoder"]["blocks"])
    L, D = blk["q_b"].shape
    for key in ("q_b", "v_b", "ln1_b"):
        blk[key] = jnp.asarray(rng.standard_normal((L, D)) * 0.5, jnp.float32)
    blk["ln1_s"] = jnp.asarray(1 + rng.standard_normal((L, D)) * 0.5, jnp.float32)
    return {**params, "decoder": {**params["decoder"], "blocks": blk}}


def test_front_from_jax_is_the_ports_pack(front_params):
    pack = pallas_front.pack_front_weights(front_params, FRONT_CFG)
    carried = pweights.front_from_jax({key: np.asarray(a) for key, a in pack.items()})
    tree = jax.tree.map(np.asarray, front_params)
    own = front.pack_front_weights(pweights.params_from_jax(tree, "cpu", torch.float32),
                                   FRONT_CFG)
    assert set(carried) == set(own) == {"w", "b", "ln1_s", "ln1_b"}
    for key in own:
        torch.testing.assert_close(carried[key], own[key], rtol=0, atol=0, msg=key)
    D = FRONT_CFG.n_text_state
    assert not carried["b"][:, D:2 * D].any()  # k has no bias


@pytest.mark.parametrize("pos,rp", [(5, (0, 0)), (7, (2, 0))])
def test_k8_plain_matches_pallas(front_params, pos, rp):
    """`fused_front_layer` (plain) against the Pallas kernel, with the
    weights carried by `front_from_jax`; the cache after the step holds the
    new K/V at slot pos and is unchanged elsewhere."""
    cfg = FRONT_CFG
    B, Tc, H, Dh = 2, 16, cfg.n_text_head, cfg.head_dim
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 1, cfg.n_text_state)).astype(np.float32)
    kc, vc = (rng.standard_normal((cfg.n_text_layer, B, H, Tc, Dh)).astype(np.float32)
              for _ in range(2))
    pack = pallas_front.pack_front_weights(front_params, cfg)
    port_front = pweights.front_from_jax({key: np.asarray(a) for key, a in pack.items()})
    pkc, pvc = _t(kc), _t(vc)
    for layer in range(cfg.n_text_layer):
        so, kn, vn = pallas_front.fused_front_layer(
            jnp.int32(layer), jnp.int32(pos), jnp.asarray(rp, jnp.int32), jnp.asarray(x),
            pack["w"], pack["b"], jnp.asarray(kc), jnp.asarray(vc), interpret=True)
        before = front.fused_front_layer.launches
        got = front.fused_front_layer(layer, pos, torch.tensor(rp), _t(x), port_front,
                                      pkc, pvc)
        assert front.fused_front_layer.launches == before  # the plain version
        np.testing.assert_allclose(got[1].numpy(), np.asarray(kn), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(vn), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(so), rtol=2e-5, atol=2e-5)
        for cache, orig, new in ((pkc, kc, got[1]), (pvc, vc, got[2])):
            torch.testing.assert_close(cache[layer, :, :, pos], new[:, :, 0], rtol=0, atol=0)
            rest = np.delete(cache[layer].numpy(), pos, axis=2)
            np.testing.assert_array_equal(rest, np.delete(orig[layer], pos, axis=2))
    # every layer wrote only its own slot
    np.testing.assert_array_equal(np.delete(pkc.numpy(), pos, axis=3), np.delete(kc, pos, axis=3))


# --------------------------------------------------------------------------
# the slice: greedy decoding with the front attached
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny test model and its encoded audio; the port's
    same weights, and the same with the front attached."""
    jp = jwm.init_params(TINY_TEST_CFG, seed=3)
    mel_np = np.random.default_rng(4).standard_normal((2, 80, 3000))
    xa = np.asarray(jwm.encode(jp, jnp.asarray(mel_np, jnp.float32), TINY_TEST_CFG))
    pp = pwm.init_params(TINY_TEST_CFG, seed=3)
    pf = {**pp, "decoder": {**pp["decoder"],
                            "front": front.pack_front_weights(pp, TINY_TEST_CFG)}}
    return jp, pp, pf, xa


def test_greedy_decode_with_front_matches_jax(tiny):
    """`greedy_decode` with the front attached (K8 at every step, plain
    here) against JAX's `greedy_decode` with its fused tail and front
    attached (both Pallas kernels, interpret mode)."""
    jp, _, pf, xa = tiny
    cfg = TINY_TEST_CFG
    attached = {**jp, "decoder": {**jp["decoder"],
                                  "tail": pallas_tail.pack_tail_weights(jp, cfg),
                                  "front": pallas_front.pack_front_weights(jp, cfg)}}
    prompt = np.tile(np.array(TK.sot_sequence(language="en")), (2, 1))
    ref = jdec.greedy_decode(
        attached, cfg, jdec.DecodeConfig(max_tokens=10, blank_id=32, pallas_cross=True,
                                         unroll_layers=True),
        SP, jnp.asarray(xa), jnp.asarray(prompt, jnp.int32), prompt.shape[1])
    before = front.fused_front_layer.launches
    got = pdec.greedy_decode(pf, cfg, pdec.DecodeConfig(max_tokens=10, blank_id=32), SP,
                             _t(xa), torch.from_numpy(prompt), prompt.shape[1])
    assert front.fused_front_layer.launches == before
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.token_probs.numpy(), np.asarray(ref.token_probs),
                               atol=1e-5, rtol=0)


def test_front_runs_in_every_single_token_step(tiny, monkeypatch):
    """`decode_step` takes K8 for every layer of every S == 1 step while a
    front is attached (the prompt pass and beam steps never)."""
    _, pp, pf, xa = tiny
    calls = []
    real = pwm.fused_front_layer

    def counting(*a):
        calls.append(a[:2])
        return real(*a)

    monkeypatch.setattr(pwm, "fused_front_layer", counting)
    prompt = torch.tensor([TK.sot_sequence(language="en")] * 2)
    dc = pdec.DecodeConfig(max_tokens=4, blank_id=32, suppress_blank=False)
    pdec.greedy_decode(pf, TINY_TEST_CFG, dc, SP, _t(xa), prompt, prompt.shape[1])
    L, P = TINY_TEST_CFG.n_text_layer, prompt.shape[1]
    assert calls == [(l, P + t) for t in range(4) for l in range(L)]
    calls.clear()
    pdec.beam_decode(pf, TINY_TEST_CFG, dataclasses.replace(dc, beam_size=2), SP,
                     _t(xa), prompt, P)
    assert calls == []


def test_ladder_with_front_matches_without(tiny):
    """`sample_best_of` (best_of 5 folded as beams over one cross K/V; the
    port runs the front there as JAX runs it on its repeated rows) gives the
    same candidates with and without the front, under the same generator."""
    _, pp, pf, xa = tiny
    dc = pdec.DecodeConfig(max_tokens=8, blank_id=32, temperature=0.2)
    prompt = torch.tensor([TK.sot_sequence(language="en")] * 2)
    runs = [pdec.sample_best_of(p, TINY_TEST_CFG, dc, SP, _t(xa), prompt, prompt.shape[1],
                                best_of=5, generator=Threefry(9))
            for p in (pp, pf)]
    np.testing.assert_array_equal(runs[0].tokens.numpy(), runs[1].tokens.numpy())
    np.testing.assert_allclose(runs[0].token_probs.numpy(), runs[1].token_probs.numpy(),
                               atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# the card's check, its planted faults, and the wrappers' dispatch
# --------------------------------------------------------------------------

def test_fused_kernel_check_refuses_planted_faults():
    """The card's check (`kernels.agreement`) takes the plain versions in
    bf16 and refuses every planted fault of K7, K8 and K10; K7's f32 bound
    holds the f32 plain version to the float64 log-mel and refuses TF32."""
    g = torch.Generator().manual_seed(3)
    audio = torch.randn(2, 16000 * 2, generator=g) * 0.3
    ref = mel.log_mel_fused_plain(audio, 128)
    exact = mel.log_mel_fused_plain(audio.double(), 128)
    assert exact.dtype == torch.float64
    assert ag.agreement(ref, exact, atol=ag.F32_ATOL).ok
    faults = dict(ag.k7_faults(audio, 128))
    assert len(faults) == 4  # and the FFT's split twiddle conjugated
    for name, bad in faults.items():
        assert not ag.agreement(ref, bad, atol=ag.F32_ATOL).ok, name
    # TF32's products, not its sums, are what the bound refuses
    assert (faults["K7 DFT in TF32"] - exact).abs().max() > 10 * ag.F32_ATOL
    t = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -12)])
    torch.testing.assert_close(ag.tf32_round(t), torch.tensor(
        [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -1.0]), rtol=0, atol=0)

    L, H, N, Tc, pos = 2, 4, 6, 24, 9
    D = 64 * H
    fw = ag.random_front(L, D, g, "cpu")
    x = ag.randn(g, "cpu", N, 1, D)
    kc, vc = (ag.randn(g, "cpu", L, N, H, Tc, 64) for _ in range(2))
    row_pad = torch.tensor([0, 3, 0, 5, 1, 0])
    out, _, _ = front.fused_front_layer_plain(L - 1, pos, row_pad, x, fw, kc.clone(),
                                              vc.clone())
    faults = list(ag.k8_faults(L - 1, pos, row_pad, x, fw, kc, vc))
    assert len(faults) == 5
    for name, bad in faults:
        assert not ag.agreement(out, bad).ok, name

    # q, k at 0.5: scores of std 1/4, where 424 padded keys move the softmax
    q, k, v = (ag.randn(g, "cpu", 1, 2, 600, 64, scale=s) for s in (0.5, 0.5, 1.0))
    for single_pass in (True, False):
        ref = encoder_attn.encoder_self_attention_plain(q, k, v, 600, single_pass)
        faults = list(ag.k10_faults(q, k, v, 600, single_pass))
        assert len(faults) == 3  # and V read from the TMA ring's previous stage
        for name, bad in faults:
            assert not ag.agreement(ref, bad).ok, (single_pass, name)


def test_fused_wrappers_plain_only_on_cpu():
    """CPU tensors take the plain versions and count no launch; a tensor on
    any other device never reaches them."""
    before = (mel.log_mel_fused.launches, front.fused_front_layer.launches,
              encoder_attn.encoder_self_attention.launches)
    audio = torch.randn(1, 4000)
    torch.testing.assert_close(mel.log_mel_fused(audio, 80),
                               mel.log_mel_fused_plain(audio, 80), rtol=0, atol=0)
    q = torch.randn(1, 2, 70, 64)
    torch.testing.assert_close(encoder_attn.encoder_self_attention(q, q, q, 60, False),
                               encoder_attn.encoder_self_attention_plain(q, q, q, 60, False),
                               rtol=0, atol=0)
    assert (mel.log_mel_fused.launches, front.fused_front_layer.launches,
            encoder_attn.encoder_self_attention.launches) == before
    meta = torch.zeros(1, 2, 70, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        encoder_attn.encoder_self_attention(meta, meta, meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        mel.log_mel_fused(torch.zeros(1, 4000, device="meta"), 80)
    fw = ag.random_front(1, 128, torch.Generator().manual_seed(0), "cpu", torch.float32)
    with pytest.raises(RuntimeError, match="no kernel"):
        front.fused_front_layer(0, 0, None, torch.zeros(1, 1, 128, device="meta"),
                                {key: t.to("meta") for key, t in fw.items()},
                                *[torch.zeros(1, 1, 2, 4, 64, device="meta")] * 2)
