"""The port's meshes (`whisper_diarize_tpu_torch/parallel/`) on the CPU:
gloo ranks spawned by `parallel/dryrun.py::run_ranks`, one thread each,
held against the JAX package's single-device functions and the port's own
single-device path (the counterpart of tests/test_parallel.py).

Spawns, each shared by the tests that read it (module fixtures): four ranks
that run the (2, 2), (4, 1) and (1, 4) jobs of `dryrun.mesh_rank`; two
ranks that run the Engine on (2, 1) and then on (1, 2), and decodes on
(1, 2) at 3 heads a rank; `dryrun_multigpu(2)` and `dryrun_multigpu(4)`.
The model is `dryrun.dryrun_config()` (2 + 2 layers, 4 heads of 64, vocab
51872): 2 heads a rank under a head split over 2, 1 over 4 (K2's 64-column
edge tile); `CFG6` (6 heads of 64, tiny.en's width) leaves 3 heads a rank
on (1, 2), as tiny.en on (1, 2) and small.en on (1, 4).

Tolerances (f32): encode on (2, 2) atol 2e-4 / rtol 1e-4 against JAX (the
head split sums o / fc2 in another order); data-parallel decodes: tokens and
lengths equal, sum_logprob 1e-4; the head split's greedy: tokens equal,
avg_logprob 1e-4; ranks of one run agree bit for bit.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu.ops import decode as jdec
from whisper_diarize_tpu.parallel.mesh import make_mesh as jmake_mesh
from whisper_diarize_tpu.parallel.mesh import param_sharding_spec as jspec
from whisper_diarize_tpu.parallel.mesh import shard_params as jshard
from whisper_diarize_tpu.tokenizer import DebugTokenizer
from whisper_diarize_tpu_torch.models import whisper as wm
from whisper_diarize_tpu_torch.parallel import distributed
from whisper_diarize_tpu_torch.parallel import dryrun as dr
from whisper_diarize_tpu_torch.parallel import mesh as pm

torch.set_num_threads(2)

CFG = dr.dryrun_config()
JCFG = jwm.WhisperConfig(**dataclasses.asdict(CFG))

JOBS = [
    ("encode", "encode", (2, 2), dict(seed=1, B=2)),
    ("greedy 4x1", "decode", (4, 1), dict(seed=2, B=8, strategy="greedy", max_tokens=12)),
    ("beam 4x1", "decode", (4, 1), dict(seed=2, B=8, strategy="beam", max_tokens=12)),
    ("greedy 2x2", "decode", (2, 2), dict(seed=6, B=4, strategy="greedy", max_tokens=10)),
    ("int8 2x2", "decode", (2, 2), dict(seed=6, B=4, strategy="greedy", max_tokens=10,
                                        quantize=True)),
    ("best_of 2x2", "decode", (2, 2), dict(seed=6, B=2, strategy="best_of", max_tokens=8,
                                           temperature=0.7)),
    ("beam 2x2", "decode", (2, 2), dict(seed=6, B=2, strategy="beam", max_tokens=8)),
    ("greedy 1x4", "decode", (1, 4), dict(seed=7, B=2, strategy="greedy", max_tokens=10)),
    ("beam 1x4", "decode", (1, 4), dict(seed=7, B=2, strategy="beam", max_tokens=8)),
]
# 6 heads: 3 a rank on (1, 2), an odd local head count (K2's edge tile)
CFG6 = dataclasses.replace(CFG, n_audio_state=384, n_audio_head=6, n_text_state=384,
                           n_text_head=6)
JOBS_3_HEADS = [
    (f"{strategy} 1x2 3 heads", "decode", (1, 2),
     dict(cfg=CFG6, seed=8, B=2, strategy=strategy, max_tokens=10 if strategy == "greedy" else 8))
    for strategy in ("greedy", "beam")]
BY_NAME = {j[0]: j for j in JOBS + JOBS_3_HEADS}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


@pytest.fixture(scope="module")
def ranks4():
    t0 = time.perf_counter()
    outs = dr.run_ranks(dr.mesh_rank, 4, JOBS)
    print(f"4 ranks: {time.perf_counter() - t0:.1f} s")
    return outs


@pytest.fixture(scope="module")
def jparams():
    return jwm.init_params(JCFG, seed=3)


def _jax_decode(jparams, job, n_model: int = 1):
    """The JAX package's decode of a job: on one device, or (`n_model` > 1)
    on its (1, n_model) mesh of virtual CPU devices, heads split over the
    model axis (`DecodeConfig.mesh`)."""
    kw = dict(job[3])
    cfg = kw.pop("cfg", CFG)
    jcfg = jwm.WhisperConfig(**dataclasses.asdict(cfg))
    inp = dr.job_inputs(cfg, kw["B"], kw["seed"])
    tk = DebugTokenizer(num_languages=cfg.num_languages)
    prompt = jnp.asarray(np.tile(np.array(tk.sot_sequence(language="en"), np.int32),
                                 (kw["B"], 1)))
    xa = jnp.asarray(inp["xa"])
    mesh = jmake_mesh(n_data=1, n_model=n_model) if n_model > 1 else None
    dc = jdec.DecodeConfig(max_tokens=kw["max_tokens"], beam_size=3, blank_id=32,
                           quantize_cross_kv=kw.get("quantize", False), mesh=mesh)
    if mesh is not None:
        jparams = jshard(jparams, mesh)
    fn = jdec.beam_decode if kw["strategy"] == "beam" else jdec.greedy_decode
    return fn(jparams, jcfg, dc, tk.specials, xa, prompt, prompt.shape[1])


def _port_decode(job):
    """The port's single-device result of a decode job."""
    kw = dict(job[3])
    return dr.JOBS[job[1]](pm.Mesh(1, 1), kw.pop("cfg", CFG), **kw)


# --------------------------------------------------------------------------
# sharding rules and shards (no ranks)
# --------------------------------------------------------------------------

def test_param_sharding_rules_match_jax():
    """Every leaf of the tree: the dimension the model axis splits equals
    the one JAX's PartitionSpec names."""
    shapes = dict(_flat(wm.param_shapes(CFG)))
    assert len(shapes) > 30
    for path, shape in shapes.items():
        spec = tuple(jspec(path, len(shape)))
        want = spec.index("model") if "model" in spec else None
        assert pm.param_sharding_spec(path, len(shape)) == want, path


def test_shards_equal_jax_addressable_shards():
    """On JAX's (4, 2) virtual mesh, every device's shard of every leaf is
    bit-equal to the port's shard for that device's (data, model) place."""
    mesh = jmake_mesh(n_data=4, n_model=2)
    jsh = dict(_flat(jshard(jwm.init_params(JCFG, seed=0), mesh)))
    full = wm.init_params(CFG, seed=0)
    ports = {(d, m): dict(_flat(pm.shard_params(full, pm.Mesh(4, 2, d, m))))
             for d in range(4) for m in range(2)}
    coords = {dev: (int(i), int(j)) for (i, j), dev in np.ndenumerate(mesh.devices)}
    checked = 0
    for path, arr in jsh.items():
        for shard in arr.addressable_shards:
            got = ports[coords[shard.device]][path].numpy()
            if path.endswith(("conv1_w", "conv2_w")):  # torch's [out, in, k]
                got = got.transpose(2, 1, 0)
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=path)
            checked += 1
    assert checked == 8 * len(jsh)


# --------------------------------------------------------------------------
# the (2, 2) and (4, 1) ranks
# --------------------------------------------------------------------------

def test_encode_2x2_matches_jax(ranks4):
    inp = dr.job_inputs(CFG, 2, 1)
    ref = np.asarray(jwm.encode(jwm.init_params(JCFG, seed=0), jnp.asarray(inp["mel"]), JCFG))
    np.testing.assert_allclose(ranks4[0]["encode"], ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["greedy 4x1", "beam 4x1"])
def test_data_parallel_decode_matches_jax(ranks4, jparams, name):
    """(4, 1): whole rows on each rank; tokens and lengths equal to the JAX
    single-device decode, scores within 1e-4."""
    ref = _jax_decode(jparams, BY_NAME[name])
    got = ranks4[0][name]
    np.testing.assert_array_equal(got["tokens"], np.asarray(ref.tokens))
    np.testing.assert_array_equal(got["lengths"], np.asarray(ref.lengths))
    np.testing.assert_allclose(got["sum_logprob"], np.asarray(ref.sum_logprob),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["greedy 2x2", "int8 2x2", "beam 2x2"])
def test_head_split_decode_matches_jax(ranks4, jparams, name):
    """(2, 2): heads split over the model axis, rows over the data axis, in
    greedy, over the int8 cross cache (K2, then K5 at every step) and in
    beam search (K4 on the local heads): tokens and lengths equal to the
    JAX single-device decode, avg_logprob within 1e-4."""
    ref = _jax_decode(jparams, BY_NAME[name])
    got = ranks4[0][name]
    np.testing.assert_array_equal(got["tokens"], np.asarray(ref.tokens))
    np.testing.assert_array_equal(got["lengths"], np.asarray(ref.lengths))
    np.testing.assert_allclose(got["avg_logprob"], np.asarray(ref.avg_logprob),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["best_of 2x2"])
def test_head_split_matches_port_single_device(ranks4, name):
    """(2, 2) best_of sampling (the whole batch's noise on every rank): its
    draws are the port's own (JAX's RNG differs), so the reference is the
    port on one device; tokens equal."""
    ref = _port_decode(BY_NAME[name])
    got = ranks4[0][name]
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    np.testing.assert_array_equal(got["lengths"], ref["lengths"])
    np.testing.assert_allclose(got["avg_logprob"], ref["avg_logprob"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["greedy 1x4", "beam 1x4"])
def test_one_head_a_rank_matches_jax_mesh_and_single_device(ranks4, jparams, name):
    """(1, 4): one decoder head a rank (K2's 64-column edge tile, K1 and K4
    on one head), in greedy and beam search: tokens and lengths equal to
    the JAX decode on its (1, 4) mesh and to the port's single-device
    decode, avg_logprob within 1e-4 of both."""
    got = ranks4[0][name]
    for ref in (_jax_decode(jparams, BY_NAME[name], n_model=4), _port_decode(BY_NAME[name])):
        ref = {k: np.asarray(getattr(ref, k) if not isinstance(ref, dict) else ref[k])
               for k in ("tokens", "lengths", "avg_logprob")}
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        np.testing.assert_array_equal(got["lengths"], ref["lengths"])
        np.testing.assert_allclose(got["avg_logprob"], ref["avg_logprob"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", [j[0] for j in JOBS])
def test_ranks_agree_bit_for_bit(ranks4, name):
    first = ranks4[0][name]
    for r in range(1, 4):
        got = ranks4[r][name]
        if isinstance(first, dict):
            for k in first:
                np.testing.assert_array_equal(got[k], first[k], err_msg=f"rank {r} {k}")
        else:
            np.testing.assert_array_equal(got, first, err_msg=f"rank {r}")


# --------------------------------------------------------------------------
# the Engine on (2, 1) and (1, 2)
# --------------------------------------------------------------------------

ENGINE_CFG = wm.WhisperConfig(**{**dataclasses.asdict(CFG), "n_vocab": 51866,
                                 "num_languages": 100})
ENGINE_CFG_1H = dataclasses.replace(ENGINE_CFG, n_audio_state=128, n_audio_head=2,
                                    n_text_state=128, n_text_head=2)


def _visible_bytes(tree):
    """Favour printable bytes for the byte-level tokenizer (in place)."""
    emb = tree["decoder"]["tok_emb"]
    emb[33:127] *= np.random.default_rng(0).uniform(2.0, 4.0, (94, 1)).astype(np.float32)
    emb[256:DebugTokenizer(num_languages=100).specials.eot] = 0.0
    return tree


@pytest.fixture(scope="module")
def engine_setup(tmp_path_factory):
    from whisper_diarize_tpu_torch.audio import write_wav
    from whisper_diarize_tpu_torch.models import weights

    d = tmp_path_factory.mktemp("mesh_engine")
    tree = _visible_bytes(wm.init_params_np(ENGINE_CFG, seed=0))
    weights.save_params(weights.params_from_jax(tree, "cpu", torch.float32), ENGINE_CFG,
                        d / "snap")
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(16000 * 40) * 4000).astype(np.int16)
    x[16000 * 12:16000 * 15] = 0
    write_wav(str(d / "in.wav"), x)
    kw = dict(snapshot=str(d / "snap"), wavs=[str(d / "in.wav")], cache=str(d / "cache"),
              enable_dtw=True, batch_size=2, max_decode_tokens=16)
    jobs = [(f"{shape} {strategy}", "engine", shape,
             dict(kw, greedy=strategy == "greedy", time_collectives=shape == (1, 2)))
            for shape in ((2, 1), (1, 2)) for strategy in ("greedy", "beam")]
    jobs.append(("all-reduces", "collectives", (1, 2), dict(n=5, rows=2)))
    resume = dict(kw, greedy=True, resume_dir=str(d / "resume"))
    jobs += [(f"resume {i}", "engine", (2, 1), resume) for i in range(2)]
    # one decoder head a rank: the Engine on (1, 2) over a 2-head snapshot
    weights.save_params(weights.params_from_jax(_visible_bytes(wm.init_params_np(
        ENGINE_CFG_1H, seed=0)), "cpu", torch.float32), ENGINE_CFG_1H, d / "snap1h")
    jobs.append(("(1, 2) one head", "engine", (1, 2),
                 dict(kw, snapshot=str(d / "snap1h"), greedy=True)))
    outs = dr.run_ranks(dr.mesh_rank, 2, jobs + JOBS_3_HEADS)
    return kw, outs, d / "resume"


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_engine_mesh_matches_single_device(engine_setup, shape, strategy):
    """Both ranks return the single-device Engine's cues (the fallback
    ladder on, DTW on), on a data split and on a head split."""
    kw, outs, _ = engine_setup
    ref = dr.mesh_rank(0, 1, [("ref", "engine", None, dict(kw, greedy=strategy == "greedy"))])
    ref = ref["ref"]["cues"]
    assert ref[0] and any(text.strip() for _, _, text in ref[0])
    for r in range(2):
        assert outs[r][f"{shape} {strategy}"]["cues"] == ref, f"rank {r}"


@pytest.mark.parametrize("name", [j[0] for j in JOBS_3_HEADS])
def test_three_heads_a_rank_match_jax_mesh_and_single_device(engine_setup, name):
    """(1, 2) at 6 heads, 3 a rank (tiny.en's split over 2; K2's edge tile
    on each rank), greedy and beam search: both ranks give the tokens and
    lengths of the JAX decode on its (1, 2) mesh and of the port's
    single-device decode, avg_logprob within 1e-4."""
    _, outs, _ = engine_setup
    jref = _jax_decode(jwm.init_params(jwm.WhisperConfig(**dataclasses.asdict(CFG6)), seed=3),
                       BY_NAME[name], n_model=2)
    for ref in ({k: np.asarray(getattr(jref, k)) for k in ("tokens", "lengths", "avg_logprob")},
                _port_decode(BY_NAME[name])):
        for r in range(2):
            got = outs[r][name]
            np.testing.assert_array_equal(got["tokens"], ref["tokens"], err_msg=f"rank {r}")
            np.testing.assert_array_equal(got["lengths"], ref["lengths"], err_msg=f"rank {r}")
            np.testing.assert_allclose(got["avg_logprob"], ref["avg_logprob"], atol=1e-4,
                                       rtol=1e-4, err_msg=f"rank {r}")


def test_engine_mesh_times_collectives(engine_setup):
    """`mesh.timed_collectives` on the (1, 2) requests: the two ranks of a
    model group make the same collectives (lockstep) and time them; the
    (2, 1) requests ran with the clock off. The "collectives" job times its
    all-reduces alone."""
    _, outs, _ = engine_setup
    for strategy in ("greedy", "beam"):
        clocks = [outs[r][f"(1, 2) {strategy}"]["collectives"] for r in range(2)]
        assert clocks[0]["calls"] == clocks[1]["calls"] > 0, clocks
        assert all(c["seconds"] > 0 and c["device_wait_s"] >= 0 for c in clocks)
        assert outs[0][f"(2, 1) {strategy}"]["collectives"] is None
    for r in range(2):
        assert outs[r]["all-reduces"]["calls"] == 5 and outs[r]["all-reduces"]["seconds"] > 0


def test_engine_mesh_resume_journal_written_once(engine_setup):
    """`resume_dir` on (2, 1): global rank 0 alone writes the journal (one
    record a window), and a second run replays it on both ranks without
    decoding, to the same cues."""
    _, outs, resume = engine_setup
    (journal,) = resume.glob("wdt-resume-*.jsonl")
    lines = journal.read_text().splitlines()
    keys = [tuple(json.loads(ln)[k] for k in ("si", "ci", "wi")) for ln in lines]
    assert keys and len(keys) == len(set(keys))
    for r in range(2):
        first, second = outs[r]["resume 0"], outs[r]["resume 1"]
        assert first["decodes"] and not second["decodes"], f"rank {r}"
        assert second["cues"] == first["cues"] == outs[0]["resume 0"]["cues"]


# --------------------------------------------------------------------------
# refusals and helpers
# --------------------------------------------------------------------------

def _refusal(kind):
    if kind == "batch rows":
        pm.data_slice(pm.Mesh(2, 1, 1, 0), 3)
    elif kind == "engine batch rows":
        from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

        Engine(EngineConfig(use_gpu=False, batch_size=3, mesh_shape=(2, 1)))
    elif kind == "odd vocab":
        pm.shard_params({"decoder": {"tok_emb": torch.zeros(51865, 8)}}, pm.Mesh(1, 2))
    elif kind == "odd vocab config":
        pm.check_model_split(wm.PRESETS["large-v2"], 2)
    elif kind == "heads":
        pm.check_model_split(wm.PRESETS["tiny"], 4)
    elif kind == "vocab rows of large-v3":
        pm.check_model_split(wm.PRESETS["large-v3"], 4)
    elif kind == "engine vocab rows":
        from whisper_diarize_tpu_torch.engine import Engine, EngineConfig

        Engine(EngineConfig(use_gpu=False, mesh_shape=(1, 4),
                            whisper_model_path="__random__:large-v3"))
    elif kind == "world":
        pm.make_mesh(2, 1, device_type="cpu")


@pytest.mark.parametrize("kind,match", [
    ("batch rows", "divisible by the mesh data axis"),
    ("engine batch rows", "divisible by the mesh data axis"),
    ("odd vocab", "not divisible by the mesh model axis"),
    ("odd vocab config", "vocab rows 51865"),
    ("heads", "heads 6 are not divisible"),
    ("vocab rows of large-v3", "vocab rows 51866"),
    ("engine vocab rows", "vocab rows 51866"),
    ("world", "initialized process group"),
])
def test_mesh_refusals(kind, match):
    """Shapes the mesh cannot take raise ValueError before any work: rows
    the data axis does not divide, a vocab or heads the model axis does not
    divide (large-v3 on (1, 4): 5 heads a rank run, its 51,866 vocab rows do
    not split), a world that is not the mesh."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match=match):
        _refusal(kind)


@pytest.mark.parametrize("kind", ["K2 local heads", "engine K2 local heads",
                                  "step K2 local heads"])
def test_mesh_takes_any_local_head_count(engine_setup, kind):
    """Head splits that leave a rank an odd number of decoder heads run, as
    in the JAX package (K2's 64-column edge tile; no einsum fallback):
    `check_model_split` takes tiny.en on (1, 2) and small.en on (1, 4) (3
    heads a rank) and base.en on (1, 8) (1); an Engine on (1, 2) over a
    2-head snapshot (1 head a rank) serves the single-device Engine's cues
    on both ranks; a `TranscribeStep` on a rank of (1, 2) keeps 1 head."""
    if kind == "K2 local heads":
        for preset, n_model, local in (("tiny.en", 2, 3), ("small.en", 4, 3), ("base.en", 8, 1)):
            cfg = wm.PRESETS[preset]
            pm.check_model_split(cfg, n_model)
            assert cfg.n_text_head // n_model == local
    elif kind == "engine K2 local heads":
        kw, outs, _ = engine_setup
        kw = dict(kw, snapshot=kw["snapshot"] + "1h", greedy=True)
        ref = dr.mesh_rank(0, 1, [("ref", "engine", None, kw)])["ref"]["cues"]
        assert ref[0] and any(text.strip() for _, _, text in ref[0])
        for r in range(2):
            assert outs[r]["(1, 2) one head"]["cues"] == ref, f"rank {r}"
    else:
        from whisper_diarize_tpu_torch.transcribe import TranscribeStep

        step = TranscribeStep(wm.init_params(ENGINE_CFG_1H), ENGINE_CFG_1H,
                              DebugTokenizer(num_languages=100), mesh=pm.Mesh(1, 2))
        assert wm.local_heads(step.params, ENGINE_CFG_1H) == 1


def test_initialize_explicit_bad_address_raises_within_seconds():
    """An explicit cluster that cannot be reached raises (no silent
    single-process fallback), within the rendezvous timeout it was given."""
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        distributed.initialize(f"tcp://127.0.0.1:{dr.free_port()}", world_size=2, rank=1,
                               backend="gloo", timeout_s=3)
    assert time.perf_counter() - t0 < 30
    assert not torch.distributed.is_initialized()


def test_rendezvous_timeout_bounds_only_the_rendezvous(tmp_path):
    """Two ranks initialize from torchrun's environment with a 2 s
    rendezvous timeout; global rank 0 then takes 6 s inside the Engine's
    rank-0-first block (a download or a conversion), and rank 1, waiting at
    the barrier, still completes: the short timeout bounds the rendezvous,
    not the group's barriers and collectives."""
    outs = dr.run_ranks(dr.rank0_first_rank, 2, 2.0, 6.0, str(tmp_path / "cache"),
                        backend=None, timeout=120)
    assert outs[1]["waited"] > 4.0
    assert [o["sum"] for o in outs] == [2.0, 2.0]


def test_distributed_helpers_single_process(monkeypatch):
    """No torchrun environment: `initialize` stays single-process and the
    process owns the whole batch."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert distributed.initialize() is False
    assert distributed.local_batch_slice(16) == slice(0, 16)
    assert pm.data_slice(None, 5) == slice(0, 5)
    assert pm.data_slice(pm.Mesh(4, 2, 3, 1), 8) == slice(6, 8)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multigpu(n):
    """The counterpart of `dryrun_multichip`: one TP + DP AdamW step, a
    greedy decode over the int8 cross cache and a beam-3 decode; the ranks
    agree bit for bit (checked inside), one row a data rank."""
    out = dr.dryrun_multigpu(n)
    assert out["mesh"] == {"data": n // 2, "model": 2}
    assert np.isfinite(out["loss"])
    assert out["tokens"].shape == (n // 2, 8) and out["beam_tokens"].shape == (n // 2, 6)
