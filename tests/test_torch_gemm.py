"""The split of K3's skinny GEMM (`ops/tail.py::skinny_plan`, also K6's
and K8's product) and K2's tile walk (`ops/attn.py::cross_kv_tile`), on the
CPU: both are pure functions of the shape that the wrappers pass to (or
mirror in) the CUDA kernels, so their cover of the work is checked here,
with no card. Also: the wrappers pass the split through unchanged (a fake
library records the C call's arguments), and the planted faults of the
split (`kernels.agreement.tail_split_faults`) are refused by the card's
check while the split itself, summed span by span, is not."""

import contextlib

import pytest
import torch

from whisper_diarize_tpu_torch import kernels
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import whisper as wm
from whisper_diarize_tpu_torch.ops import attn, front, tail

PRESETS = ("tiny", "base", "small", "medium", "large-v3", "large-v3-turbo")


def _products(D: int):
    """(name, Din, Dout, layer norm) of the five tail products and K8's q/k/v
    product."""
    return [("o", D, D, False), ("cq", D, D, True), ("co", D, D, False),
            ("fc1", D, 4 * D, True), ("fc2", 4 * D, D, False), ("qkv", D, 3 * D, True)]


def _check_cover(plan: tail.SkinnyPlan, N: int, Din: int, Dout: int, int8: bool,
                 ln: bool) -> None:
    assert plan.bn in (32, 64) and Dout % plan.bn == 0
    assert 1 <= plan.n_split <= tail.SKINNY_CLUSTER_MAX
    assert plan.span_k > 0 and plan.span_k % tail.SKINNY_K_TILE == 0
    cols = [c for s in range(Dout // plan.bn) for c in range(s * plan.bn, (s + 1) * plan.bn)]
    assert cols == list(range(Dout))  # every output column once
    rows = []
    for r in range(plan.n_split):
        span = range(r * plan.span_k, min((r + 1) * plan.span_k, Din))
        assert len(span) > 0 and len(span) % tail.SKINNY_K_TILE == 0
        rows.extend(span)
    assert rows == list(range(Din))  # every input row once, spans in order
    assert tail.skinny_smem(min(N, tail.SKINNY_MAX_ROWS), plan, int8, ln) <= tail.SKINNY_SMEM_MAX


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("N", [1, 5, 8, 15, 40, 80])
@pytest.mark.parametrize("preset", PRESETS)
def test_skinny_plan_covers_every_column_and_input_row_once(preset, N, int8):
    D = wm.PRESETS[preset].n_text_state
    for _, din, dout, ln in _products(D):
        _check_cover(tail.skinny_plan(N, din, dout, int8, ln), N, din, dout, int8, ln)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("N", [8, 40])
def test_skinny_plan_fills_the_card_at_large_v3(N, int8):
    """At least two CTAs an SM (264) for each of the five products and K8's,
    all of them resident at once at the CTAs an SM their shared memory
    allows."""
    D = wm.PRESETS["large-v3"].n_text_state
    for name, din, dout, ln in _products(D):
        plan = tail.skinny_plan(N, din, dout, int8, ln)
        ctas = dout // plan.bn * plan.n_split
        per_sm = tail.SM_SHARED // (tail.skinny_smem(N, plan, int8, ln)
                                    + tail.SKINNY_CTA_RESERVE)
        assert ctas >= tail.SKINNY_CTA_TARGET, (name, plan, ctas)
        assert ctas <= tail.SKINNY_SMS * per_sm, (name, plan, ctas, per_sm)


@pytest.mark.parametrize("Din,Dout", [(64, 32), (192, 96), (640, 4096), (5120, 1280), (8192, 64)])
def test_skinny_plan_respects_its_cluster_limit(Din, Dout):
    """Whatever the shape, no strip takes more spans than the portable
    cluster (8), and a shape the kernel does not take is refused."""
    for N in (1, 33, 80, 200):
        for ln in (False, True):
            plan = tail.skinny_plan(N, Din, Dout, ln=ln)
            assert plan.n_split <= tail.SKINNY_CLUSTER_MAX
            _check_cover(plan, N, Din, Dout, False, ln)
    with pytest.raises(ValueError):
        tail.skinny_plan(8, Din + 32, Dout)
    with pytest.raises(ValueError):
        tail.skinny_plan(8, Din, Dout + 16)


class _FakeLib:
    """Records the C calls a wrapper makes; every call returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' kernel path on meta tensors (data_ptr 0): device checks,
    the library and the stream replaced, so the C call's arguments show."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for mod in (tail, front):
        monkeypatch.setattr(mod, "_require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(front, "_int32_on", lambda name, device, t: t)
    return lib


@pytest.mark.parametrize("wq,kvq", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("N,beams", [(8, 1), (40, 5)])
def test_fused_tail_passes_the_plans_unchanged(fake_card, N, beams, wq, kvq):
    L, D, H, Ta = 2, 1280, 20, 1500
    meta = torch.device("meta")
    mat = torch.int8 if wq else torch.bfloat16
    blocks = {key: torch.empty(shape, dtype=mat if key.endswith("_w") else torch.bfloat16,
                               device=meta)
              for key, shape in (("o_w", (L, D, D)), ("cq_w", (L, D, D)), ("co_w", (L, D, D)),
                                 ("fc1_w", (L, D, 4 * D)), ("fc2_w", (L, 4 * D, D)),
                                 ("fc1_b", (L, 4 * D)))}
    for key in ("o_b", "ln2_s", "ln2_b", "cq_b", "co_b", "ln3_s", "ln3_b", "fc2_b"):
        blocks[key] = torch.empty((L, D), dtype=torch.bfloat16, device=meta)
    if wq:
        for m, n in (("o", D), ("cq", D), ("co", D), ("fc1", 4 * D), ("fc2", 4 * D)):
            blocks[f"{m}_ws"] = torch.empty((L, n), device=meta)
    cache = torch.int8 if kvq else torch.bfloat16
    k = torch.empty((L, N // beams, H, Ta, 64), dtype=cache, device=meta)
    ks = torch.empty((L, N // beams, H, Ta), device=meta) if kvq else None
    x = torch.empty((N, 1, D), dtype=torch.bfloat16, device=meta)
    so = torch.empty((N, H, 1, 64), dtype=torch.bfloat16, device=meta)
    before = tail.fused_tail_layer.launches + tail.fused_tail_layer.launches_int8
    tail.fused_tail_layer(1, x, so, blocks, k, k, beams, 1493, ks, ks)
    assert tail.fused_tail_layer.launches + tail.fused_tail_layer.launches_int8 == before + 1
    (name, args), = fake_card.calls
    sig = kernels._SIGNATURES[name]
    assert name == "wdt_fused_tail" and len(args) == len(sig)
    ints = args[31:-1]
    assert all(t is kernels._I for t in sig[31:-1])
    assert ints == tail.fused_tail_int_args(1, N, D, H, N // beams, beams, Ta, 1493, wq, kvq)
    assert ints[8:10] == tuple(attn.cross_attn_plan(N // beams, H, beams, 1493, int8=kvq))
    assert ints[10:] == tuple(x for p in tail.tail_plans(N, D, wq) for x in p)


@pytest.mark.parametrize("N", [8, 40])
def test_fused_front_passes_its_plan_unchanged(fake_card, N):
    L, D, H, Tc = 2, 1280, 20, 48
    meta = torch.device("meta")
    fw = {"w": torch.empty((L, D, 3 * D), dtype=torch.bfloat16, device=meta),
          "b": torch.empty((L, 3 * D), dtype=torch.bfloat16, device=meta),
          "ln1_s": torch.empty((L, D), dtype=torch.bfloat16, device=meta),
          "ln1_b": torch.empty((L, D), dtype=torch.bfloat16, device=meta)}
    kc = torch.empty((L, N, H, Tc, 64), dtype=torch.bfloat16, device=meta)
    x = torch.empty((N, 1, D), dtype=torch.bfloat16, device=meta)
    rp = torch.zeros((N,), dtype=torch.int32, device=meta)
    front.fused_front_layer(1, 19, rp, x, fw, kc, kc)
    (name, args), = fake_card.calls
    assert name == "wdt_fused_front" and len(args) == len(kernels._SIGNATURES[name])
    assert args[10:-1] == (1, N, D, H, Tc, 19, *tail.skinny_plan(N, D, 3 * D, ln=True))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("Ta", [1500, 1493])
def test_cross_kv_tiles_cover_every_output_once(preset, Ta):
    """K2's walk covers [L, B * Ta, 2 * H * Dh] once: every tile's rows lie
    in one stream, its columns wholly in K's or V's half, and its rows past
    Ta (zero fill, not stored) are the only ones outside."""
    L, B = 2, 3
    HD = wm.PRESETS[preset].n_text_state
    n = attn.cross_kv_tiles(L, B, Ta, HD)
    seen = torch.zeros((L, B, Ta, 2 * HD // attn.CROSS_KV_COLS), dtype=torch.int32)
    for i in range(n):
        t = attn.cross_kv_tile(i, L, B, Ta, HD)
        assert t.n0 % attn.CROSS_KV_COLS == 0 and (t.n0 < HD) == (t.n0 + attn.CROSS_KV_COLS <= HD)
        assert t.t0 < Ta and t.t0 % attn.CROSS_KV_ROWS == 0
        seen[t.layer, t.stream, t.t0:t.t0 + attn.CROSS_KV_ROWS, t.n0 // attn.CROSS_KV_COLS] += 1
    assert bool((seen == 1).all())
    assert [attn.cross_kv_tile(i, L, B, Ta, HD).layer for i in range(n)] == sorted(
        attn.cross_kv_tile(i, L, B, Ta, HD).layer for i in range(n))  # the layer outermost


# The f32 plans that held one CTA an SM before the f32 products moved to the
# tensor cores (f32 activation rows of 68 floats then, 72 now): (product,
# int8 weights) -> the row counts N.
_ONE_CTA_AN_SM_BEFORE = {("qkv", False): range(38, 52), ("qkv", True): range(61, 63),
                         ("cq", False): range(72, 81)}


@pytest.mark.parametrize("preset", ["large-v3", "large-v3-turbo"])
def test_f32_skinny_plans_fit_and_keep_two_ctas_an_sm(preset):
    """Every f32 plan of the five tail products and K8's (`skinny_plan(...,
    f32=True)`, both weight types) at N 1 - 80: it covers the product, its
    shared memory (`skinny_smem`, the mirror of `csrc/tail.cu::smem_bytes`,
    with the 3xTF32 products' padded activation rows) fits SKINNY_SMEM_MAX
    and the CTA's partial fits the ring, and it keeps two CTAs an SM
    wherever the plans did before."""
    D = wm.PRESETS[preset].n_text_state
    for N in range(1, tail.SKINNY_MAX_ROWS + 1):
        for name, din, dout, ln in _products(D):
            for int8 in (False, True):
                plan = tail.skinny_plan(N, din, dout, int8, ln, f32=True)
                _check_cover(plan, N, din, dout, int8, ln)
                smem = tail.skinny_smem(N, plan, int8, ln, f32=True)
                assert smem <= tail.SKINNY_SMEM_MAX, (N, name, int8, plan)
                assert plan.stages * tail._ring_tile(N, plan.bn, int8, ln, True) >= N * plan.bn * 4
                per_sm = tail.SM_SHARED // (smem + tail.SKINNY_CTA_RESERVE)
                if N not in _ONE_CTA_AN_SM_BEFORE.get((name, int8), ()):
                    assert per_sm >= 2, (N, name, int8, plan, smem)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("Ta", [1500, 1493])
def test_cross_kv_tiles_cover_every_output_once_at_f32(preset, Ta):
    """K2-f32's walk (tiles of `CROSS_KV_ROWS_F32` rows) covers
    [L, B * Ta, 2 * H * Dh] once, the layer outermost, as the bf16 walk."""
    L, B = 2, 3
    HD = wm.PRESETS[preset].n_text_state
    rows = attn.CROSS_KV_ROWS_F32
    n = attn.cross_kv_tiles(L, B, Ta, HD, f32=True)
    assert n == L * B * -(-Ta // rows) * (2 * HD // attn.CROSS_KV_COLS)
    seen = torch.zeros((L, B, Ta, 2 * HD // attn.CROSS_KV_COLS), dtype=torch.int32)
    tiles = [attn.cross_kv_tile(i, L, B, Ta, HD, f32=True) for i in range(n)]
    for t in tiles:
        assert t.t0 < Ta and t.t0 % rows == 0 and t.n0 % attn.CROSS_KV_COLS == 0
        seen[t.layer, t.stream, t.t0:t.t0 + rows, t.n0 // attn.CROSS_KV_COLS] += 1
    assert bool((seen == 1).all())
    assert [t.layer for t in tiles] == sorted(t.layer for t in tiles)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_split_faults_refused_and_split_sum_taken(int8):
    """Summed span by span on the plans' spans, the plain tail stays within
    the card's check of itself; each planted slip of the split (a span
    dropped, a span combined twice, the layer-norm statistics over one span)
    is refused."""
    g = torch.Generator().manual_seed(3)
    L, H, B, Ta, beams = 2, 4, 2, 150, 5
    D = 64 * H
    blocks = ag.random_blocks(L, D, g, "cpu")
    if int8:
        blocks = tail.quantize_tail_weights(blocks)
    k, v = (ag.randn(g, "cpu", L, B, H, Ta, 64) for _ in range(2))
    N = B * beams
    x = ag.randn(g, "cpu", N, 1, D)
    so = ag.randn(g, "cpu", N, H, 1, 64, scale=0.3)
    a = (1, x, so, blocks, k, v, beams, Ta)
    ref = tail.fused_tail_layer_plain(*a)
    plans = dict(zip(("o", "cq", "co", "fc1", "fc2"), tail.tail_plans(N, D, int8)))

    def by_span(name, h, w, b, col_scale):
        parts = ag._span_products(h, w, plans[name].span_k)
        y = parts[0]
        for p in parts[1:]:
            y = y + p
        return (y if col_scale is None else y * col_scale.float()) + b.float()

    assert ag.agreement(tail.fused_tail_layer_plain(*a, proj=by_span), ref, base=x).ok
    faults = list(ag.tail_split_faults("K6" if int8 else "K3", *a))
    assert len(faults) == 3
    for name, bad in faults:
        assert not ag.agreement(ref, bad, base=x).ok, name
