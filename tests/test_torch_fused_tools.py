"""The port's counterparts of the two JAX tools that launch K8 and K10
(`whisper_diarize_tpu_torch/tools/bench_encoder_attn.py`,
`.../tools/bench_megakernel.py`) against the JAX tools on the CPU, in f32.

- `make_encode` in its three JAX modes (full, no-attn, flash-custom) against
  the JAX tool's `make_encode` (loaded by executing its text, as
  `tests/test_torch_fused.py` does; flash-custom runs the Pallas kernel in
  interpret mode) on a tiny config with both packages' `init_params_fast`
  weights (equal by construction): atol 1e-5 on the layer-normed audio
  states (f32, sums in another order); the library mode (SDPA) against
  full, to the same bound.
- The megakernel worker in this process at its smoke budgets (4 and 8
  steps): its JSON row carries the JAX tool's keys; its greedy tokens with
  the front (K8's plain version) equal those without, and both equal the
  JAX package's `greedy_init` / `greedy_run` at `pallas_tail=False` (XLA,
  no interpret mode) on the same weights and audio. One worker also runs as
  the tool runs it, in a subprocess.
- The variant `off` is refused by name, and the tool's summary names it.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from whisper_diarize_tpu.tokenizer import DebugTokenizer as JaxTokenizer

from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.ops.mel import N_SAMPLES
from whisper_diarize_tpu_torch.tools import bench_encoder_attn, bench_megakernel

from tests.test_torch_fused import _exec_tool
from tests.test_whisper_model import TINY_TEST_CFG

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def encoders():
    """(the JAX tool's `make_encode`, JAX params, port params, mel)."""
    whole = _exec_tool(lambda i, ln: not (i == 150 and ln.startswith("from __future__")))
    cfg = TINY_TEST_CFG
    mel = (np.random.default_rng(0).standard_normal((2, cfg.n_mels, 3000)) * 0.3).astype(
        np.float32)
    return (whole["make_encode"], jwm.init_params_fast(cfg, dtype=jnp.float32),
            pweights.init_params_fast(cfg, "cpu", torch.float32), mel)


@pytest.mark.parametrize("mode", ["full", "no-attn", "flash-custom"])
def test_make_encode_matches_the_jax_tool(encoders, mode):
    jax_make, jparams, pparams, mel = encoders
    ref = np.asarray(jax_make(TINY_TEST_CFG, mode)(jparams, jnp.asarray(mel)))
    got = bench_encoder_attn.make_encode(TINY_TEST_CFG, mode)(pparams, torch.from_numpy(mel))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_library_mode_matches_full(encoders):
    """The JAX tool's `flash` mode calls the library's flash kernel; the
    port's calls `F.scaled_dot_product_attention` on the same q, k, v."""
    _, _, pparams, mel = encoders
    x = torch.from_numpy(mel)
    full = bench_encoder_attn.make_encode(TINY_TEST_CFG, "full")(pparams, x)
    lib = bench_encoder_attn.make_encode(TINY_TEST_CFG, "flash")(pparams, x)
    torch.testing.assert_close(lib, full, atol=1e-5, rtol=0)


def test_encoder_tool_main_on_the_cpu(capsys):
    rows = bench_encoder_attn.main("tiny", device="cpu", batch=1, repeat=1)
    assert [r["mode"] for r in rows] == list(bench_encoder_attn.MODES)
    assert all(r["ms"] > 0 for r in rows)
    assert rows[2]["max_rel_diff_vs_full"] < 1e-5
    out = capsys.readouterr().out
    assert "device cpu" in out.splitlines()[0]
    assert "flash-custom vs full: max rel diff" in out


def _jax_greedy_tokens(model: str, batch: int, steps: int) -> np.ndarray:
    """The JAX tool's worker at pallas_tail=False, on the CPU in f32."""
    cfg = jwm.PRESETS[model]
    params = jwm.init_params_fast(cfg, dtype=jnp.float32)
    sp = JaxTokenizer(num_languages=cfg.num_languages).specials
    dc = jdec.DecodeConfig(max_tokens=steps, with_timestamps=True, beam_size=None,
                           pallas_cross=False, pallas_tail=False)
    audio = jnp.asarray((np.random.default_rng(0).standard_normal(
        (batch, N_SAMPLES)) * 0.1).astype(np.float32))
    prompt = jnp.asarray(np.tile(np.array(
        JaxTokenizer(num_languages=cfg.num_languages).sot_sequence(language="en"),
        np.int32), (batch, 1)))
    suppress = jnp.asarray(jdec.build_suppress_mask(sp, cfg.n_vocab, extra_suppress=[sp.eot]))
    xa = jwm.encode(params, jax_log_mel(audio, n_mels=cfg.n_mels), cfg)
    P = prompt.shape[1]
    st = jdec.greedy_init(params, cfg, dc, sp, xa, prompt, P, suppress_mask=suppress)
    return np.asarray(jdec.greedy_run(params, cfg, dc, sp, st, suppress, P,
                                      jnp.int32(steps))["tokens"])


def test_megakernel_worker_matches_jax_greedy(capsys):
    """`tail` and `tail+front` at the smoke budgets (8 tokens), tiny
    preset, batch 2: the JAX tool's row keys, and the same tokens as each
    other and as the JAX decode without its fused tail."""
    rows, tokens = {}, {}
    for variant in ("tail", "tail+front"):
        rows[variant], tokens[variant] = bench_megakernel.worker(
            "tiny", 2, variant, "greedy", device="cpu", smoke=True)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == list(rows.values())
    for row in rows.values():
        assert set(row) == {"variant", "mode", "ms_per_step", "t64_ms"}
        assert row["mode"] == "greedy" and row["t64_ms"] > 0
    assert torch.equal(tokens["tail"], tokens["tail+front"])
    ref = _jax_greedy_tokens("tiny", 2, 8)
    np.testing.assert_array_equal(tokens["tail"].numpy(), ref)


def test_megakernel_refuses_off_by_name(capsys):
    """`off` (the JAX tool's un-fused step) has no counterpart: the worker
    refuses it by name, and the tool's summary names it untimed; the other
    variants run, in this process (`inline`) and as a subprocess worker."""
    with pytest.raises(ValueError, match="'off'.*pallas_tail=False"):
        bench_megakernel.measure("tiny", 1, "off", "greedy", device="cpu", smoke=True)
    with pytest.raises(ValueError, match="tail\\+front"):
        bench_megakernel.measure("tiny", 1, "tail+front", "beam", device="cpu", smoke=True)
    rows = bench_megakernel.main("tiny", 1, device="cpu", smoke=True, inline=True)
    assert [(r["mode"], r["variant"]) for r in rows] == [
        ("greedy", "tail"), ("greedy", "tail+front"), ("beam", "tail")]
    out = capsys.readouterr().out
    assert out.count("not timed") == 4 and "verdict:" in out
    assert "greedy off" in " ".join(out.split()) and "beam off" in " ".join(out.split())
    row = bench_megakernel._spawn("tiny", 1, "tail", "beam", "cpu", True)
    assert set(row) == {"variant", "mode", "ms_per_step", "t64_ms"} and row["mode"] == "beam"
