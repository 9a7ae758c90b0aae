"""The port's decode breakdown tools and converter CLI
(`whisper_diarize_tpu_torch/tools/bench_decode_breakdown.py`,
`bench_beam_breakdown.py`, `bench_layer_variants.py`, `bench_beam_variants.py`,
`bench_quant_kv.py`, `convert_models.py`) against the JAX package on the CPU,
in f32, at the weights of one `init_random_snapshot` loaded by both:

- the model_only loop's accumulated logits against a loop over the JAX
  `decode_step` (atol 1e-4, sums in another order);
- the beam `sample` loop's tokens after 8 steps against the JAX tool's body
  built from the JAX `_prepare_logits` / `_retire_eot_candidates` and
  `jax.lax.top_k` (candidates scored as the JAX `beam_run` scores them),
  from the same state (exact);
- the `topk` part's candidates against `jax.lax.top_k`'s two stages on
  logits full of ties (exact);
- the layer variants v0, v1b and v2 against the JAX `decode_step` (1e-4);
- `bench_quant_kv`'s `q8kv+tail` greedy tokens against the JAX greedy loop
  with `quantize_cross_kv` (its cross attention on K5 in interpret mode) on
  the same audio states (exact);
- `convert_models` against the JAX CLI's converters on the fixtures
  `tests/test_converters.py` writes (and the Silero GGML file): the same
  `.npz` keys and arrays;
- each tool's `main(device="cpu")` at the smoke budgets prints every phase
  or variant name of its JAX counterpart (those without a counterpart as
  such);
- the profiler sessions' split into windows (`timing.split_windows`)
  refuses a layout whose lost marker leaves the windows' places uncertain,
  and `chip_smoke._check_rows` refuses rows that break its checks.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.tokenizer import DebugTokenizer as JaxTokenizer

from whisper_diarize_tpu_torch.models import weights as pweights
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.tools import (bench_beam_breakdown, bench_beam_variants,
                                             bench_decode_breakdown, bench_layer_variants,
                                             bench_quant_kv, convert_models)

from tests.test_whisper_model import TINY_TEST_CFG

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CFG = TINY_TEST_CFG
CPU = torch.device("cpu")
ATOL = 1e-4


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params, port params) of one random snapshot."""
    d = tmp_path_factory.mktemp("snap")
    jweights.init_random_snapshot(d, cfg=CFG, seed=0)
    return jweights.load_model(d)[0], pweights.load_model(d, device="cpu")[0]


def _jax_model_only(jp, xa, P, cache_len, budget):
    """The JAX tool's model_only / layer loop body, eagerly: `decode_step` on
    token 100 at P + step from a zero cache."""
    B = xa.shape[0]
    cache = jwm.init_self_cache(CFG, B, jnp.float32, cache_len)
    cross = jwm.cross_kv(jp, jnp.asarray(xa), CFG)
    tok = jnp.full((B, 1), 100, jnp.int32)
    acc = jnp.zeros(B)
    for step in range(budget):
        logits, cache = jwm.decode_step(jp, CFG, tok, jnp.int32(P + step), cache, cross)
        acc = acc + logits[:, 0, 0]
    return np.asarray(acc), np.asarray(logits[:, 0])


def test_model_only_matches_jax_decode_step(weights):
    jp, pp = weights
    b = bench_decode_breakdown.setup(CFG, 2, CPU, 8, pp)
    xa = bench_decode_breakdown.random_xa(b)
    cache = pwm.init_self_cache(CFG, 2, torch.float32, CPU, 16)
    acc, last = bench_decode_breakdown.model_only(b, pp, cache, pwm.cross_kv(pp, xa, CFG), 6)
    ref_acc, ref_last = _jax_model_only(jp, xa.numpy(), b.P, 16, 6)
    np.testing.assert_allclose(acc.numpy(), ref_acc, atol=ATOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), ref_last, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["v0 baseline", "v1b unfused", "v2 fused-qkv"])
def test_layer_variants_match_jax_decode_step(weights, name):
    jp, pp = weights
    b = bench_layer_variants.layer_setup(CFG, 2, CPU, pp)
    cache = pwm.init_self_cache(CFG, 2, torch.float32, CPU, bench_layer_variants.CACHE_LEN)
    acc, last = bench_layer_variants.variant_loop(b, name, cache, b.cross, 4, fused=b.fused)
    ref_acc, ref_last = _jax_model_only(jp, bench_decode_breakdown.random_xa(b).numpy(),
                                        bench_layer_variants.P,
                                        bench_layer_variants.CACHE_LEN, 4)
    np.testing.assert_allclose(acc.numpy(), ref_acc, atol=ATOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), ref_last, atol=ATOL, rtol=0)


def _jax_sample_loop(s, sp, dc, suppress, K, budget):
    """The JAX tool's `sample` part body (`tools/bench_beam_breakdown.py`),
    eagerly, on a dict of jnp arrays, with the candidates scored as the JAX
    `beam_run` scores them (per-row top-2K of the raw logits, then `-
    logsumexp + score`): the tool's `score + log_softmax` rounds otherwise,
    and beams of one stream tie exactly under the tool's logit feedback."""
    N, V = s["logits"].shape
    B = N // K
    for _ in range(budget):
        logits = jdec._prepare_logits(s["logits"], suppress, sp, dc, s["step"],
                                      s["last_was_ts"], s["penult_was_ts"], s["max_ts_tok"],
                                      s["ts_seen"])
        v1, i1 = jax.lax.top_k(logits, 2 * K)
        v1 = v1 - jax.nn.logsumexp(logits, axis=-1)[:, None] + s["scores"][:, None]
        v1r = v1.reshape(B, K * 2 * K)
        i1r = (i1 + (jnp.arange(N) % K)[:, None] * V).reshape(B, K * 2 * K)
        topv, sel = jax.lax.top_k(v1r, 2 * K)
        topi = jnp.take_along_axis(i1r, sel, 1)
        tok_idx = (topi % V).astype(jnp.int32)
        src_flat = (jnp.arange(B)[:, None] * K + topi // V).astype(jnp.int32)
        ft, fp, fs, fl, fc = jdec._retire_eot_candidates(
            sp, K, topv, tok_idx, src_flat, s["tokens"], s["probs"], s["length"],
            s["fin_tokens"], s["fin_probs"], s["fin_scores"], s["fin_lengths"], s["fin_count"])
        active = jnp.where(tok_idx == sp.eot, jdec.NEG_INF, topv)
        keepv, keepi = jax.lax.top_k(active, K)
        new_tok = jnp.take_along_axis(tok_idx, keepi, 1).reshape(N)
        new_src = jnp.take_along_axis(src_flat, keepi, 1).reshape(N)
        new_scores = keepv.reshape(N)
        tok_logprob = new_scores - s["scores"][new_src]
        is_ts = new_tok >= sp.timestamp_begin
        s = dict(
            s, step=s["step"] + 1,
            logits=s["logits"].at[:, 0].add(new_tok.astype(jnp.float32) * 1e-9),
            tokens=s["tokens"][new_src].at[:, s["step"]].set(new_tok),
            probs=s["probs"][new_src].at[:, s["step"]].set(jnp.exp(tok_logprob)),
            scores=new_scores, length=s["length"][new_src] + 1, last_was_ts=is_ts,
            penult_was_ts=s["last_was_ts"][new_src],
            max_ts_tok=jnp.where(is_ts, jnp.maximum(s["max_ts_tok"][new_src], new_tok),
                                 s["max_ts_tok"][new_src]),
            ts_seen=s["ts_seen"][new_src] | is_ts,
            fin_tokens=ft, fin_probs=fp, fin_scores=fs, fin_lengths=fl, fin_count=fc)
    return np.asarray(s["tokens"])


def test_beam_sample_loop_matches_jax_body(weights):
    _, pp = weights
    K = bench_beam_breakdown.K
    b = bench_beam_breakdown.beam_setup(CFG, 2, CPU, 8, pp)
    state = pdec.beam_init(pp, CFG, b.dc, b.sp, b.xa, b.prompt, b.P)
    got = bench_beam_breakdown.sample_loop(b, state, 8)
    sp = JaxTokenizer(num_languages=CFG.num_languages).specials
    dc = jdec.DecodeConfig(max_tokens=8, with_timestamps=True, beam_size=K)
    suppress = jnp.asarray(jdec.build_suppress_mask(sp, CFG.n_vocab, extra_suppress=[sp.eot]))
    s0 = {k: jnp.asarray(state[k].numpy()) for k in bench_beam_breakdown.SAMPLE_KEYS
          if k != "step"}
    for k in ("tokens", "max_ts_tok", "length", "fin_tokens", "fin_lengths", "fin_count"):
        s0[k] = s0[k].astype(jnp.int32)
    ref = _jax_sample_loop(dict(s0, step=jnp.int32(0)), sp, dc, suppress, K, 8)
    assert (got[:, :8] != sp.eot).all()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_topk_matches_jax_top_k_with_ties():
    """Logits on a coarse grid tie everywhere: both stages must pick the
    lower index among equals, as `jax.lax.top_k` does."""
    K, B = bench_beam_breakdown.K, 3
    logits = (np.round(np.random.default_rng(0).standard_normal((B * K, 4099)) * 2) / 2
              ).astype(np.float32)
    logits[1] = 0.0  # a row of one value
    topv, topi = bench_beam_breakdown.topk_step(torch.from_numpy(logits), B)
    N, V = logits.shape
    v1, i1 = jax.lax.top_k(jnp.asarray(logits), 2 * K)
    i1r = (i1 + (jnp.arange(N) % K)[:, None] * V).reshape(B, K * 2 * K)
    rv, sel = jax.lax.top_k(v1.reshape(B, K * 2 * K), 2 * K)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jnp.take_along_axis(i1r, sel, 1)))
    np.testing.assert_array_equal(topv.numpy(), np.asarray(rv))


def test_quant_q8kv_tail_greedy_matches_jax(weights):
    jp, pp = weights
    b = bench_quant_kv.variant_setup(CFG, 2, "q8kv+tail", "greedy", CPU, 8, pp)
    assert "k8" in bench_quant_kv.init(b)["cross"]
    got = bench_quant_kv.run(b, bench_quant_kv.init(b), 8)["tokens"]
    sp = JaxTokenizer(num_languages=CFG.num_languages).specials
    dc = jdec.DecodeConfig(max_tokens=8, with_timestamps=True, quantize_cross_kv=True,
                           pallas_cross=True)
    suppress = jnp.asarray(jdec.build_suppress_mask(sp, CFG.n_vocab, extra_suppress=[sp.eot]))
    prompt = jnp.asarray(b.prompt.numpy(), jnp.int32)
    st = jdec.greedy_init(jp, CFG, dc, sp, jnp.asarray(b.xa.numpy()), prompt, b.P,
                          suppress_mask=suppress)
    ref = jdec.greedy_run(jp, CFG, dc, sp, st, suppress, b.P, jnp.int32(8))["tokens"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _fixtures(tmp_path):
    """(kind, source file) of each converter fixture: the synthetic Silero
    and pyannote state dicts of `tests/test_converters.py`, the upstream
    CAM++ topology's state dict (`evals/torch_refs.py`), and a Silero GGML
    file (the JAX package's writer)."""
    from whisper_diarize_tpu.models import convert as jcv
    from whisper_diarize_tpu.models import segmentation as seg

    rng = np.random.default_rng(0)
    sil = {}
    for i, (cin, cout) in enumerate([(129, 128), (128, 64), (64, 64), (64, 128)]):
        sil[f"_model.encoder.{i}.reparam_conv.weight"] = torch.tensor(
            rng.standard_normal((cout, cin, 3)).astype(np.float32))
        sil[f"_model.encoder.{i}.reparam_conv.bias"] = torch.zeros(cout)
    H = 128
    sil["_model.stft.forward_basis_buffer"] = torch.tensor(
        rng.standard_normal((258, 1, 256)).astype(np.float32))
    for k in ("weight_ih", "weight_hh"):
        sil[f"_model.decoder.rnn.{k}"] = torch.tensor(
            rng.standard_normal((4 * H, H)).astype(np.float32))
    for k in ("bias_ih", "bias_hh"):
        sil[f"_model.decoder.rnn.{k}"] = torch.zeros(4 * H)
    sil["_model.decoder.decoder.2.weight"] = torch.tensor(
        rng.standard_normal((1, H, 1)).astype(np.float32))
    sil["_model.decoder.decoder.2.bias"] = torch.zeros(1)
    sil["_model.extra.weight"] = torch.zeros(3)  # an unmapped tensor
    torch.save(sil, tmp_path / "silero.pt")
    jcv.write_silero_ggml(tmp_path / "silero.bin", {
        k.replace("_model.", ""): v.numpy() for k, v in sil.items() if "extra" not in k})

    pya = {"sincnet.conv1d.0.low_hz_": torch.tensor(np.linspace(
               30, 7000, seg.SINC_FILTERS).astype(np.float32).reshape(-1, 1)),
           "sincnet.conv1d.0.band_hz_": torch.full((seg.SINC_FILTERS, 1), 50.0)}
    for i in (1, 2):
        cin = seg.SINC_FILTERS if i == 1 else seg.CONV_FILTERS
        pya[f"sincnet.conv1d.{i}.weight"] = torch.tensor(rng.standard_normal(
            (seg.CONV_FILTERS, cin, seg.CONV_KERNEL)).astype(np.float32))
        pya[f"sincnet.conv1d.{i}.bias"] = torch.zeros(seg.CONV_FILTERS)
    for i, n in ((0, seg.SINC_FILTERS), (1, seg.CONV_FILTERS), (2, seg.CONV_FILTERS)):
        pya[f"sincnet.norm1d.{i}.weight"] = torch.ones(n)
        pya[f"sincnet.norm1d.{i}.bias"] = torch.zeros(n)
    Hl = seg.LSTM_HIDDEN
    for i in range(seg.LSTM_LAYERS):
        n_in = seg.CONV_FILTERS if i == 0 else 2 * Hl
        for sfx in ("", "_reverse"):
            pya[f"lstm.weight_ih_l{i}{sfx}"] = torch.tensor(
                rng.standard_normal((4 * Hl, n_in)).astype(np.float32))
            pya[f"lstm.weight_hh_l{i}{sfx}"] = torch.tensor(
                rng.standard_normal((4 * Hl, Hl)).astype(np.float32))
            pya[f"lstm.bias_ih_l{i}{sfx}"] = torch.zeros(4 * Hl)
            pya[f"lstm.bias_hh_l{i}{sfx}"] = torch.zeros(4 * Hl)
    for name, shape in (("linear.0", (seg.LINEAR_DIM, 2 * Hl)),
                        ("linear.1", (seg.LINEAR_DIM, seg.LINEAR_DIM)),
                        ("classifier", (seg.N_CLASSES, seg.LINEAR_DIM))):
        pya[f"{name}.weight"] = torch.tensor(rng.standard_normal(shape).astype(np.float32))
        pya[f"{name}.bias"] = torch.zeros(shape[0])
    torch.save({"state_dict": {f"model.{k}": v for k, v in pya.items()}},
               tmp_path / "pyannote.ckpt")

    refs = _load("torch_refs_for_breakdown", ROOT / "evals" / "torch_refs.py")
    torch.manual_seed(0)
    torch.save({f"module.{k}": v for k, v in
                refs._build_torch_campplus(torch).state_dict().items()},
               tmp_path / "campplus.pt")
    return [("silero", tmp_path / "silero.pt"), ("silero", tmp_path / "silero.bin"),
            ("pyannote", tmp_path / "pyannote.ckpt"), ("campplus", tmp_path / "campplus.pt")]


def test_convert_models_matches_the_jax_cli(tmp_path, capsys):
    jax_cli = _load("jax_convert_models", ROOT / "tools" / "convert_models.py")
    for i, (kind, src) in enumerate(_fixtures(tmp_path)):
        ref_path, got_path = tmp_path / f"ref{i}.npz", tmp_path / f"got{i}.npz"
        getattr(jax_cli, f"convert_{kind}")(str(src), str(ref_path))
        ref_out = capsys.readouterr().out
        assert convert_models.main([kind, str(src), str(got_path)]) == 0
        got_out = capsys.readouterr().out
        ref, got = np.load(ref_path), np.load(got_path)
        assert sorted(got.files) == sorted(ref.files) and got.files, (kind, src)
        for key in ref.files:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{kind} {key}")
        # the same report: unmapped / missing tensors named alike
        assert re.sub(r"\S*\.npz", "", got_out) == re.sub(r"\S*\.npz", "", ref_out)
        if src.suffix == ".pt" and kind == "silero":
            assert "1 unmapped tensors" in got_out and "_model.extra.weight" in got_out


EXPECTED = {
    "decode": ("mel", "mel slope", "encode", "prefill", "prefill slope", "cross_kv",
               "prompt_fwd", "residual", "greedy_run", "model_only", "sample_only",
               "sum(mel+enc+prefill+run"),
    "beam": ("beam_run", "model_N", "modelgather_N", "modelmul_N", "gather", "topk",
             "sample"),
    "layer": ("v0 baseline", "v1 no-cross", "v2 fused-qkv", "v3 fused+nocross", "v4 unrolled",
              "v5 unrolled-nocross"),
    "beamvar": bench_beam_variants.PARTS,
    "quant": ("greedy fp", "greedy tail", "greedy q8kv ", "greedy q8kv+tail",
              "greedy q8all+tail", "beam fp", "beam q8kv"),
}


@pytest.mark.parametrize("tool", list(EXPECTED))
def test_tool_main_on_the_cpu_prints_every_jax_phase(tool, capsys):
    kw = dict(device="cpu", smoke=True)
    run = {"decode": lambda: bench_decode_breakdown.main("tiny", 1, **kw),
           "beam": lambda: bench_beam_breakdown.main("tiny", 1, inline=True, **kw),
           "layer": lambda: bench_layer_variants.main("tiny", 1, **kw),
           "beamvar": lambda: bench_beam_variants.main("tiny", 1, inline=True, **kw),
           "quant": lambda: bench_quant_kv.main("tiny", 1, inline=True, **kw)}[tool]
    out = run()
    text = " ".join(capsys.readouterr().out.split())
    assert text.startswith("device cpu")
    for name in EXPECTED[tool]:
        assert name in text, (tool, name)
    rows = out if isinstance(out, list) else out.rows
    assert rows and all(r.get("device_ms", r.get("device_ms_per_step")) is None for r in rows)
    if tool in ("decode", "layer"):
        assert "no counterpart" in text
    if tool == "quant":
        assert text.count("not timed:") == 2


def _session(n, lost=None, tail_events=3):
    """A profiler session's device events (start us, name, us), in order:
    lead fills, a marker, n windows of 4 kernels each ended by a marker,
    `tail_events` tail fills and the tail's marker; `lost` names a marker
    the session lost ("lead", "window 2", "tail")."""
    ev, t = [], 0.0

    def add(name):
        nonlocal t
        ev.append((t, name, 1.0))
        t += 2.0

    for _ in range(5):
        add("fill")
    if lost != "lead":
        add("spin_kernel")
    for w in range(n):
        for k in range(4):
            add(f"w{w}k{k}")
        if lost != f"window {w}":
            add("spin_kernel")
    for _ in range(tail_events):
        add("fill")
    if lost != "tail":
        add("spin_kernel")
    return ev


@pytest.mark.parametrize("case", ["whole", "tail marker lost", "window marker lost",
                                  "last window's marker lost", "lead marker lost",
                                  "tail marker and fills lost"])
def test_split_windows_refuses_an_uncertain_layout(case):
    """A session whose markers leave the windows' places uncertain is
    refused (and profiled again by `_median_windows`); one that lost only
    the tail's marker, with events after its last, keeps its windows."""
    from whisper_diarize_tpu_torch.tools import timing

    n = 3
    ev = {"whole": lambda: _session(n),
          "tail marker lost": lambda: _session(n, "tail"),
          "window marker lost": lambda: _session(n, "window 1"),
          "last window's marker lost": lambda: _session(n, "window 2"),
          "lead marker lost": lambda: _session(n, "lead"),
          "tail marker and fills lost": lambda: _session(n, "tail", tail_events=0)}[case]()
    wins = timing.split_windows(ev, n)
    if case in ("whole", "tail marker lost"):
        assert [[name for name, _, _ in w] for w in wins] == [
            [f"w{w}k{k}" for k in range(4)] for w in range(n)]
    else:
        assert wins is None


def _row(**kw):
    row = dict(phase="model_only", wall_ms=10.0, device_ms=6.0, launches=915.0,
               wall_long_ms=700.0, device_long_ms=400.0)
    return dict(row, **kw)


@pytest.mark.parametrize("row, ok", [
    (_row(), True),
    (_row(wall_ms=-2.4), True),  # a wall slope the host's noise put below 0
    (_row(launches=-52.875), False),
    (_row(launches=915.5), False),
    (_row(device_ms=-0.1), False),
    (_row(device_long_ms=740.0), False),  # busier than 1.05 x the call's wall
    (_row(device_ms=float("nan")), False),
    (_row(phase="  residual", wall_ms=-23.6, device_ms=-0.01), True),
    (_row(phase="  residual", launches=10.5), False),
])
def test_chip_smoke_breakdown_row_checks(row, ok):
    """`chip_smoke._check_rows`, the card's checks of a breakdown row, on
    rows made up for it."""
    import chip_smoke

    if ok:
        chip_smoke._check_rows("decode-breakdown", [row])
    else:
        with pytest.raises(AssertionError, match="break the checks"):
            chip_smoke._check_rows("decode-breakdown", [row])
