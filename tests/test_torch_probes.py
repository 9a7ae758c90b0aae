"""The port's diagnostic kernels K9 and K11 against the JAX package's tools
on the CPU (f32, the same numpy inputs on both sides): K9a / K9c / K9d
(`ops/attn_probe.py`: `cross_attn_presliced`, `cross_attn_const_layer`,
`cross_attn_flat`) against `tools/bench_attn_kernel.py`'s `_attn_4d`,
`_attn_6d_const` and `_attn_6d_flat`; K9b (`ops/stream.py::kv_stream_sum`)
against `_sum_6d`; K11a / K11b (`stream_sum`, `stream_sum_pipelined`)
against `tools/bench_dma.py`'s `auto_sum` and `manual_sum`. The plain
versions run here; the JAX side runs the Pallas kernels in interpret mode.
Also: both tools' `main` on the CPU, the planted faults the card's check
must refuse, and what the wrappers take.

The tools' kernels take no `interpret=` argument: their module's `pl` is
replaced by a namespace whose `pallas_call` interprets, and the jitted
functions are called through `__wrapped__`, so each traces with it. They
also read their shapes from module globals (`B, NT, H, DH, TT`), which the
tests set to their own. `_attn_*` hard-code ta_total 1500 and
`_attn_6d_const` layer 1, so the caches keep NT x TT = 3 x 512 keys (36
masked) and two layers. The JAX tools lay K/V out as [L, B, NT, H, Dh, TT];
the port as [L, B, H, NT * TT, Dh].

Tolerances: the attention forms 1e-5 absolute (f32, sums in another
order); the sums 1e-5 of sum|terms|. The sums' inputs are multiples of 1/8
(`_eighths`) and s too, so that every partial sum of the JAX kernels' f32
reductions is exact and the comparison holds whatever their order: at
131,072 terms a slot, normal f32 values put the JAX side itself ~2e-5 of
sum|terms| from the float64 value the plain versions compute.
"""

import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, attn_probe, stream
from whisper_diarize_tpu_torch.tools import bench_attn_kernel, bench_dma

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))

import bench_attn_kernel as jattn  # noqa: E402 (the JAX package's tools)
import bench_dma as jdma  # noqa: E402

torch.set_num_threads(2)

L, B, NT, H, DH, TT = 2, 2, 3, 2, 64, 512
LAYER = 1
SUM_RTOL = 1e-5


@pytest.fixture
def jtools(monkeypatch):
    """The two JAX tool modules, interpreting, at the tests' shapes."""
    interp = types.SimpleNamespace(**{
        **vars(pl), "pallas_call": functools.partial(pl.pallas_call, interpret=True)})
    for mod in (jattn, jdma):
        monkeypatch.setattr(mod, "pl", interp)
    for name, val in (("B", B), ("NT", NT), ("H", H), ("DH", DH), ("TT", TT)):
        monkeypatch.setattr(jattn, name, val)
    for name, val in (("H", H), ("DH", DH), ("TT", TT)):
        monkeypatch.setattr(jdma, name, val)
    return jattn, jdma


def _eighths(a: np.ndarray) -> np.ndarray:
    return np.round(a * 8) / 8


def _caches(seed: int, grid=lambda a: a):
    """(k5, v5) in the JAX tools' layout and (k, v) in the port's."""
    rng = np.random.default_rng(seed)
    k5, v5 = (grid(rng.standard_normal((L, B, NT, H, DH, TT))).astype(np.float32)
              for _ in range(2))

    def port(a):
        return torch.from_numpy(a).permute(0, 1, 3, 2, 5, 4).reshape(L, B, H, NT * TT, DH)

    return k5, v5, port(k5).contiguous(), port(v5).contiguous()


def _q(seed: int, Q: int):
    q = np.random.default_rng(seed).standard_normal((B, Q, H, DH)).astype(np.float32)
    return q, torch.from_numpy(q)


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("form", ["presliced", "presliced-1-tile", "const-layer", "flat"])
def test_k9_attention_plain_matches_pallas(jtools, form, Q):
    """K9a (also at one 512-key tile, the tool's "1-tile compute" row, where
    nothing is masked), K9c and K9d against the TPU tool's kernels."""
    jt, _ = jtools
    k5, v5, k, v = _caches(10 + Q)
    qn, q = _q(20 + Q, Q)
    if form == "presliced":
        ref = jt._attn_4d.__wrapped__(jnp.asarray(qn), jnp.asarray(k5[LAYER]), jnp.asarray(v5[LAYER]))
        got = attn_probe.cross_attn_presliced(q, k[LAYER], v[LAYER])
    elif form == "presliced-1-tile":
        ref = jt._attn_4d.__wrapped__(jnp.asarray(qn), jnp.asarray(k5[LAYER, :, :1]),
                                      jnp.asarray(v5[LAYER, :, :1]))
        got = attn_probe.cross_attn_presliced(q, k[LAYER, :, :, :TT].contiguous(),
                                              v[LAYER, :, :, :TT].contiguous())
    elif form == "const-layer":
        ref = jt._attn_6d_const.__wrapped__(jnp.asarray(qn), jnp.asarray(k5), jnp.asarray(v5))
        got = attn_probe.cross_attn_const_layer(q, k, v)
    else:
        ref = jt._attn_6d_flat.__wrapped__(LAYER, jnp.asarray(qn), jnp.asarray(k5), jnp.asarray(v5))
        got = attn_probe.cross_attn_flat(LAYER, q, k, v)
    assert tuple(got.shape) == (B, Q, H, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_k9_attention_forms_are_k1s_function():
    """On the same inputs the three forms equal K1's plain version with
    ta_total 1500 (f32: the flat form's 512-key running max moves the
    result by rounding only)."""
    _, _, k, v = _caches(3)
    _, q = _q(4, 3)
    ref = attn.cross_attn_layer_plain(LAYER, q, k, v, attn_probe.TA_TOTAL)
    for got in (attn_probe.cross_attn_presliced(q, k[LAYER], v[LAYER]),
                attn_probe.cross_attn_const_layer(q, k, v),
                attn_probe.cross_attn_flat(LAYER, q, k, v)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def _sum_close(got, ref, terms: torch.Tensor):
    tol = SUM_RTOL * float(terms.abs().sum())
    assert abs(float(got) - float(np.asarray(ref).reshape(()))) <= tol


@pytest.mark.parametrize("s", [0.0, 0.25])
def test_k9b_plain_matches_pallas(jtools, s):
    jt, _ = jtools
    k5, v5, k, v = _caches(30, _eighths)
    ref = jt._sum_6d.__wrapped__(jnp.int32(LAYER), jnp.asarray(k5), jnp.asarray(v5),
                                 jnp.float32(s))
    got = stream.kv_stream_sum(LAYER, k, v, s)
    assert got.dtype == torch.float32 and got.dim() == 0
    _sum_close(got, ref, torch.cat([k[LAYER].double().clamp_min(s).flatten(),
                                    v[LAYER].double().flatten()]))


def _tiles(seed: int, n: int = 6):
    x = _eighths(np.random.default_rng(seed).standard_normal((n, H, DH, TT))).astype(np.float32)
    return x, torch.from_numpy(x)


def test_k11a_plain_matches_pallas(jtools):
    _, jd = jtools
    xn, x = _tiles(40)
    s = 0.25
    ref = jd.auto_sum(jnp.asarray(xn), jnp.float32(s))
    _sum_close(stream.stream_sum(x, s), ref, x.double().clamp_min(s))


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("nbuf", [2, 3])
def test_k11b_plain_matches_pallas(jtools, nbuf, chunk):
    """The TPU tool's ring copies `chunk` tiles a slot; the port's a stage of
    bytes (16 KB a chunk here); both sum every element once."""
    _, jd = jtools
    xn, x = _tiles(50 + nbuf)
    s = -0.125
    ref = jd.manual_sum(jnp.asarray(xn), jnp.float32(s), nbuf, chunk)
    got = stream.stream_sum_pipelined(x, s, nbuf, chunk * 16384)
    _sum_close(got, ref, x.double().clamp_min(s))


def test_ring_shape_is_checked():
    x = torch.zeros(64, dtype=torch.bfloat16)
    for nbuf, stage in ((1, 16384), (9, 16384), (2, 1000), (2, 512), (8, 32768)):
        with pytest.raises(ValueError):
            stream.stream_sum_pipelined(x, 0.0, nbuf, stage)


def test_wrappers_run_their_plain_versions_on_the_cpu():
    """CPU tensors take the plain versions and launch nothing."""
    wrappers = (stream.stream_sum, stream.stream_sum_pipelined, stream.kv_stream_sum,
                attn_probe.cross_attn_presliced, attn_probe.cross_attn_const_layer,
                attn_probe.cross_attn_flat)
    before = [w.launches for w in wrappers]
    _, _, k, v = _caches(5)
    _, q = _q(6, 1)
    x = k.flatten()[:1003]  # a length that is no multiple of 8
    assert float(stream.stream_sum(x, 0.0)) == float(stream.stream_sum_plain(x, 0.0))
    stream.stream_sum_pipelined(x, 0.0, 2, 16384)
    stream.kv_stream_sum(LAYER, k, v, 0.0)
    attn_probe.cross_attn_presliced(q, k[LAYER], v[LAYER])
    attn_probe.cross_attn_const_layer(q, k, v)
    attn_probe.cross_attn_flat(LAYER, q, k, v)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("family", ["K11", "K9b", "K9-attention"])
def test_planted_faults_are_refused(family):
    """The card's checks (`agreement.compare_sum` / `compare`) pass the
    plain result and refuse every planted fault, here on the CPU at small
    shapes (132 CTAs, the H100's SM count, for K11's splits)."""
    g = torch.Generator().manual_seed(7)
    if family == "K11":
        x = ag.stream_input(g, "cpu", 48, H, DH, TT)
        ref, mass = ag.stream_terms(x, 0.0)
        got = stream.stream_sum(x, 0.0)
        ag.compare_sum("K11", got, ref, mass)
        faults = [*ag.k11a_faults(x, 0.0, 4 * 132), *ag.k11b_faults(x, 0.0, 4, 16384, 132)]
        assert len(faults) == 5
        for name, bad in faults:
            assert ag.reject_sum(name, got, bad, mass) > 10
    elif family == "K9b":
        k, v = (ag.stream_input(g, "cpu", L, B, H, NT * TT, DH) for _ in range(2))
        ref, mass = ag.kv_terms(LAYER, k, v, 0.0)
        got = stream.kv_stream_sum(LAYER, k, v, 0.0)
        ag.compare_sum("K9b", got, ref, mass)
        for name, bad in ag.k9b_faults(LAYER, k, v, 0.0):
            assert ag.reject_sum(name, got, bad, mass) > 10
    else:
        q = ag.randn(g, "cpu", B, 3, H, DH, scale=2.0)
        k, v = (ag.randn(g, "cpu", L, B, H, NT * TT, DH) for _ in range(2))
        for flat, got in ((False, attn_probe.cross_attn_const_layer(q, k, v)),
                          (True, attn_probe.cross_attn_flat(LAYER, q, k, v))):
            ag.compare("K9", got, attn.cross_attn_layer_plain(LAYER, q, k, v, 1500))
            faults = list(ag.k9_faults(LAYER, q, k, v, 1500, flat))
            assert len(faults) == (3 if flat else 2)
            for name, bad in faults:
                ag.reject(name, got, bad)


def test_stage_shares_cover_the_array_once():
    for numel, stage, ctas in ((48 * H * DH * TT, 16384, 132), (1003, 1024, 4), (8, 1024, 3)):
        shares = stream.stage_shares(numel, stage, ctas)
        assert len(shares) == ctas
        flat = [j for r in shares for j in r]
        assert flat == list(range(-(-(numel // 8 * 16) // stage)))


SASS = """
        Function : _ZN12_GLOBAL__N_118ldg_staging_kernelEPK13__nv_bfloat16
        /*0010*/  LDG.E.CONSTANT R1, desc[UR8][R2.64] ;
        /*0020*/  LDG.E.CONSTANT R3, desc[UR8][R4.64] ;
        /*0030*/  IADD3 R5, R5, 0x80, RZ ;
        /*0040*/  LDG.E.CONSTANT R6, desc[UR8][R8.64] ;
        /*0050*/  LDG.E.CONSTANT R7, desc[UR8][R10.64] ;
        /*0060*/  STS [R12], R1 ;
        /*0070*/  LDS R13, [R12] ;
        /*0080*/  STS [R14], R3 ;
        Function : _ZN12_GLOBAL__N_117cross_attn_kernelI13__nv_bfloat16Lin1ELb0EEEvPKS1_
        /*0010*/  LDGSTS.E.BYPASS.128 [R1], desc[UR8][R2.64] ;
        /*0020*/  LDGSTS.E.BYPASS.128 [R1+0x2400], desc[UR8][R2.64] ;
        /*0030*/  LDGDEPBAR ;
        /*0040*/  LDGSTS.E.BYPASS.128 [R3], desc[UR8][R4.64] ;
        /*0050*/  LDGSTS.E.BYPASS.128 [R3+0x2400], desc[UR8][R4.64] ;
        /*0060*/  LDGDEPBAR ;
        /*0070*/  DEPBAR.LE SB0, 0x1 ;
        /*0080*/  BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/  LDGSTS.E.BYPASS.128 [R5], desc[UR8][R6.64] ;
        /*00a0*/  LDGDEPBAR ;
        /*00b0*/  DEPBAR.LE SB0, 0x1 ;
        Function : _ZN12_GLOBAL__N_120kv_stream_sum_kernelEPK13__nv_bfloat16
        /*0010*/  LDGSTS.E.BYPASS.128 [R1], desc[UR8][R2.64] ;
        /*0020*/  LDGSTS.E.BYPASS.128 [R1+0x2400], desc[UR8][R2.64] ;
        /*0030*/  LDGDEPBAR ;
        /*0040*/  DEPBAR.LE SB0, 0x1 ;
        /*0050*/  LDG.E.CONSTANT R1, desc[UR8][R2.64] ;
        /*0060*/  STS [R12], R1 ;
"""


@pytest.mark.parametrize("frag,want", [
    ("ldg_staging_kernel", 4),  # loads into registers: LDG runs up to an STS
    (bench_attn_kernel.STAGING[0][1], 4),  # K1: cp.async runs across commits, up to a wait
    (bench_attn_kernel.STAGING[1][1], 2),  # K9b
])
def test_sass_loads_before_a_store(frag, want):
    """The tool's SASS reading: the longest run of global loads (LDG up to a
    shared store, cp.async LDGSTS up to a wait) in one function's SASS."""
    assert bench_attn_kernel.loads_before_store(SASS, frag) == want
    with pytest.raises(RuntimeError):
        bench_attn_kernel.loads_before_store(SASS, "no_such_kernel")


def test_timing_helpers():
    from whisper_diarize_tpu_torch.tools import timing

    assert timing.kernel_name(
        "void (anonymous namespace)::cross_attn_kernel<__nv_bfloat16, -1>"
        "(__nv_bfloat16 const*, int)") == "cross_attn_kernel<__nv_bfloat16, -1>"
    assert timing.kernel_name("sum_partials_kernel(float const*, int, float*)") == \
        "sum_partials_kernel"
    assert timing.host_bound(0.05, 0.023) and not timing.host_bound(0.024, 0.023)
    assert timing.gb_per_s(62.9e6, 0.0232) == pytest.approx(2711.2, rel=1e-3)
    assert timing.sum_bound(62914560)["bound_by"] == "bytes"


@pytest.mark.parametrize("tool", ["bench_dma", "bench_attn_kernel"])
def test_tools_run_on_the_cpu(tool, capsys):
    """Each tool's `main` on the CPU at tiny shapes prints a row for every
    variant or form, with the device time "not measured"."""
    if tool == "bench_dma":
        rows = bench_dma.main(device="cpu", tiles=(1,))
        names = [name for name, _ in bench_dma.variants()]
    else:
        rows = bench_attn_kernel.main(device="cpu", layers=2, batch=1, queries=3)
        names = ["cross_attn_layer", "presliced", "stream", "stream+sum", "1-tile compute",
                 "const layer", "flat", "sdpa"]
    assert [r["name"] for r in rows] == names
    assert all(r["device_ms"] is None and r["bound_ms"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("device cpu")
    for name in names:
        assert any(line.startswith(name) and "not measured" in line for line in out.splitlines())
