"""The port's training step (`whisper_diarize_tpu_torch/training.py`) against
the JAX package's on the CPU, at f32 on the tiny config (2 + 2 layers, d 64,
2 heads), same numpy inputs and the same random init on both sides; then
one TP + DP step on gloo ranks (`parallel/dryrun.py`, mesh (2, 2)) against
the single-device step.

Tolerances (f32):
- `decoder_forward_nocache` logits and `loss_fn`: atol 1e-5, rtol 1e-5;
- gradients, leaf by leaf: |g - g_jax| <= 1e-6 + 1e-4 max|g_jax| (sums
  in another order, relative to the leaf's scale);
- parameters after AdamW steps: each leaf's update p - p0 within 1e-2
  relative L2 of optax's, and every element within 1e-6 + 2 lr steps of it.
  Adam divides by sqrt(v): where a gradient is ~0 its update is the sign of
  rounding noise, so elementwise agreement is only up to a step's size, and
  the L2 measure carries the check;
- the (2, 2) step: loss 1e-5, gradient norm 1e-5 relative, parameters as
  above against the single-device step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_diarize_tpu import training as jtraining
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu_torch import training
from whisper_diarize_tpu_torch.models import whisper as wm
from whisper_diarize_tpu_torch.parallel import dryrun as dr
from whisper_diarize_tpu_torch.parallel import mesh as pm

torch.set_num_threads(2)

JCFG = jwm.WhisperConfig(
    n_mels=80, n_vocab=51865,
    n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
)
CFG = wm.WhisperConfig(**dataclasses.asdict(JCFG))
B, S = 2, 8
LR = 1e-4


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _np(path, t):
    """A port leaf in the JAX layout (the conv stem is torch's [out, in, k])."""
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.transpose(2, 1, 0) if path.endswith(("conv1_w", "conv2_w")) else a


@pytest.fixture(scope="module")
def inputs():
    inp = dr.job_inputs(CFG, B, seed=11, S=S)
    return inp["mel"], inp["tokens"], inp["mask"]


def _port(inputs):
    return tuple(torch.from_numpy(x) for x in inputs)


def _jax(inputs):
    mel, tokens, mask = inputs
    return jnp.asarray(mel), jnp.asarray(tokens.astype(np.int32)), jnp.asarray(mask)


def test_decoder_forward_nocache_matches_jax(inputs):
    xa = np.random.default_rng(3).standard_normal((B, 1500, 64)).astype(np.float32)
    tokens = inputs[1]
    ref = jwm.decoder_forward_nocache(jwm.init_params(JCFG, seed=0), JCFG,
                                      jnp.asarray(tokens.astype(np.int32)), jnp.asarray(xa))
    got = wm.decoder_forward_nocache(wm.init_params(CFG, seed=0), CFG,
                                     torch.from_numpy(tokens), torch.from_numpy(xa))
    assert got.shape == (B, S, CFG.n_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def grads(inputs):
    jp = jwm.init_params(JCFG, seed=0)
    jloss, jgrads = jax.value_and_grad(jtraining.loss_fn)(jp, JCFG, *_jax(inputs))
    params = wm.init_params(CFG, seed=0)
    for _, t in _flat(params):
        t.requires_grad_(True)
    loss = training.loss_fn(params, CFG, *_port(inputs))
    loss.backward()
    return float(jloss), dict(_flat(jgrads)), loss.item(), params


def test_loss_fn_matches_jax(grads):
    jloss, _, loss, _ = grads
    np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=1e-5)


def test_gradients_match_jax_grad(grads):
    _, jg, _, params = grads
    n = 0
    for path, t in _flat(params):
        ref = np.asarray(jg[path])
        got = _np(path, t.grad)
        tol = 1e-6 + 1e-4 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol, (path, np.abs(got - ref).max(), tol)
        n += 1
    assert n == len(jg)


def _check_updates(p0, got, ref, steps, what):
    """Each leaf's update p - p0 against the reference's (see the module
    docstring)."""
    for path in ref:
        d_ref, d_got = ref[path] - p0[path], got[path] - p0[path]
        rel = np.linalg.norm(d_got - d_ref) / max(np.linalg.norm(d_ref), 1e-30)
        assert rel <= 1e-2, (what, path, rel)
        assert np.abs(d_got - d_ref).max() <= 1e-6 + 2 * LR * steps, (what, path)


def test_adamw_three_steps_match_optax(inputs):
    """3 steps of `make_train_step` on one batch against the JAX step with
    `optax.adamw` (lr 1e-4, weight decay 0.01 on every leaf)."""
    jp = jwm.init_params(JCFG, seed=0)
    p0 = {k: np.asarray(v) for k, v in _flat(jp)}
    opt = jtraining.make_optimizer(lr=LR)
    jstate = opt.init(jp)
    jstep = jtraining.make_train_step(JCFG, opt)
    params = wm.init_params(CFG, seed=0)
    popt = training.make_optimizer(lr=LR)
    state = popt.init(params)
    step = training.make_train_step(CFG, popt)
    for i in range(3):
        jp, jstate, jloss = jstep(jp, jstate, *_jax(inputs))
        params, state, loss = step(params, state, *_port(inputs))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=1e-5,
                                   err_msg=f"step {i}")
    ref = {k: np.asarray(v) for k, v in _flat(jp)}
    got = {k: _np(k, v) for k, v in _flat(params)}
    _check_updates(p0, got, ref, 3, "optax")


def test_optimizer_is_optax_adamw_defaults():
    opt = training.make_optimizer()
    state = opt.init({"w": torch.zeros(3)})
    group = state.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["betas"], group["eps"]) == (
        1e-4, 0.01, (0.9, 0.999), 1e-8)
    assert group["params"][0].requires_grad


# --------------------------------------------------------------------------
# one TP + DP step on (2, 2) against the single-device step
# --------------------------------------------------------------------------

MESH_CFG = dr.dryrun_config()
MESH_JOB = dict(seed=4, B=4, steps=1)


@pytest.fixture(scope="module")
def mesh_step():
    outs = dr.run_ranks(dr.mesh_rank, 4, [("train", "train", (2, 2), MESH_JOB)])
    ref = dr.JOBS["train"](pm.Mesh(1, 1), MESH_CFG, **MESH_JOB)
    return [o["train"] for o in outs], ref


def test_tp_dp_step_matches_single_device(mesh_step):
    outs, ref = mesh_step
    got = outs[0]
    np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    p0 = {k: v.detach().numpy() for k, v in _flat(wm.init_params(MESH_CFG, seed=0))}
    _check_updates(p0, dict(_flat(got["params"])), dict(_flat(ref["params"])), 1, "(2, 2)")
    for r in range(1, 4):  # every rank holds the same loss
        assert outs[r]["losses"] == got["losses"], r


def test_global_loss_counts_every_rank_mask(mesh_step):
    """The data ranks carry different mask counts (9 and 8 targets); the
    step's loss is the whole batch's masked mean, which the mean of the
    ranks' own means is not."""
    outs, ref = mesh_step
    inp = dr.job_inputs(MESH_CFG, 4, 4)
    mask = inp["mask"]
    assert mask[:2].sum() != mask[2:].sum()
    params = wm.init_params(MESH_CFG, seed=0)
    with torch.no_grad():
        xa = wm.encode(params, torch.from_numpy(inp["mel"]), MESH_CFG)
        tokens = torch.from_numpy(inp["tokens"])
        logp = torch.log_softmax(wm.decoder_forward_nocache(params, MESH_CFG, tokens[:, :-1],
                                                            xa), -1)
        nll = (-logp.gather(-1, tokens[:, 1:, None])[..., 0] * torch.from_numpy(mask)).numpy()
    whole = nll.sum() / mask.sum()
    per_rank = 0.5 * (nll[:2].sum() / mask[:2].sum() + nll[2:].sum() / mask[2:].sum())
    np.testing.assert_allclose(outs[0]["losses"][0], whole, rtol=1e-5)
    assert abs(per_rank - whole) > 1e-3
