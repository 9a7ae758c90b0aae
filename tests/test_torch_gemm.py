"""The split of K3's skinny GEMM (`ops/tail.py::skinny_plan`, also K6's
and K8's product), K2's tile walk (`ops/attn.py::cross_kv_tile`) and K4's
staging plan (`ops/attn.py::split_self_plan`), on the CPU: each is a pure
function of the shape that the wrappers pass to (or mirror in) the CUDA
kernels, so their cover of the work is checked here, with no card; K4's
walk through its plan is also run in plain PyTorch against its plain
version. Also: the wrappers pass the split through unchanged (a fake
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


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("HD", [64, 192, 320, 384])
def test_cross_kv_tiles_cover_every_column_once_at_any_head_count(HD, f32):
    """K2's walk at 1, 3, 5 and 6 local heads (a head split of base.en over
    8, tiny.en over 2, large-v3 over 4, tiny.en whole): every output column
    of K and of V covered exactly once, each half's tiles of 128 columns and,
    at an odd head count, one 64-column edge tile of its last head; no tile
    crosses HD; the walk's order kept (layer outermost, then the stream and
    its row tile, the column innermost, K's tiles before V's)."""
    L, B, Ta = 2, 3, 1493
    rows = attn.cross_kv_rows(f32)
    n = attn.cross_kv_tiles(L, B, Ta, HD, f32=f32)
    per_half = HD // attn.CROSS_KV_COLS + HD % attn.CROSS_KV_COLS // 64
    assert n == L * B * -(-Ta // rows) * 2 * per_half
    seen = torch.zeros((L, B, -(-Ta // rows), 2 * HD), dtype=torch.int32)
    tiles = [attn.cross_kv_tile(i, L, B, Ta, HD, f32=f32) for i in range(n)]
    for t in tiles:
        edge = t.cols == attn.CROSS_KV_EDGE_COLS
        assert t.cols in (attn.CROSS_KV_COLS, attn.CROSS_KV_EDGE_COLS)
        assert (t.n0 < HD) == (t.n0 + t.cols <= HD)  # wholly in K's half or in V's
        assert t.n0 + t.cols <= 2 * HD and t.n0 % 64 == 0
        assert edge == (HD % 128 == 64 and (t.n0 + t.cols) % HD == 0)  # a half's last head
        assert t.t0 < Ta and t.t0 % rows == 0
        seen[t.layer, t.stream, t.t0 // rows, t.n0:t.n0 + t.cols] += 1
    assert bool((seen == 1).all())
    order = [(t.layer, t.stream, t.t0, t.n0) for t in tiles]
    assert order == sorted(order)


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


# --------------------------------------------------------------------------
# K4's staging plan (`ops/attn.py::split_self_plan`, the mirror of
# `csrc/split_self.cu::make_plan`) and the kernel's walk through it
# --------------------------------------------------------------------------

def _k4_chunks(plan, K, prompt_len, step):
    return [attn.split_self_chunk(c, plan.cap, K, prompt_len, step) for c in range(plan.chunks)]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("Td", [64, 224])
@pytest.mark.parametrize("Tp", [3, 19, 227])
@pytest.mark.parametrize("B", [1, 8])
def test_split_self_plan_covers_every_slot_once_and_fits(B, Tp, Td, f32):
    """Every plan at K 1 - 8 and every step of a Td-slot decode half: it
    fits 113 KB, so the B x 20 CTAs of large-v3 run two an SM in one wave;
    its chunks cover the prompt's rows and the decode slots once each, in
    order, each within a stage; every bulk copy (the prompt's span, each
    physical row's span) is a multiple of 16 bytes and lands 16-byte
    aligned; one chunk is one load phase (K's stage and V's)."""
    rb = 256 if f32 else 128
    for K in range(1, 9):
        for step in range(Td):
            plan = attn.split_self_plan(K, Tp, Tp, step, f32)
            key = (K, step, plan)
            assert plan.smem <= attn.SPLIT_SELF_SMEM_TWO, key
            assert B * 20 <= 132 * (tail.SM_SHARED // (plan.smem + 1024)), key
            assert plan.stages == attn.SPLIT_SELF_STAGES == 2 and plan.cap >= K, key
            assert (plan.chunks == 1) == (plan.cap == Tp + K * (step + 1)), key
            prompt, decode = [], []
            for ch in _k4_chunks(plan, K, Tp, step):
                assert ch.np + ch.nd > 0 and ch.np + K * ch.nd <= plan.cap, (key, ch)
                prompt.extend(range(ch.p0, ch.p0 + ch.np))
                decode.extend(range(ch.d0, ch.d0 + ch.nd))
                starts = ([0] * (ch.np > 0)
                          + [(ch.np + j * ch.nd) * rb for j in range(K)] * (ch.nd > 0))
                sizes = [ch.np * rb] * (ch.np > 0) + [ch.nd * rb] * K * (ch.nd > 0)
                assert all(n % 16 == 0 and n > 0 for n in sizes), (key, ch)
                assert all((128 + s * plan.cap * rb + o) % 16 == 0
                           for s in range(plan.stages) for o in starts), (key, ch)
            assert prompt == list(range(Tp)), key
            assert decode == list(range(step + 1)), key


def _k4_beam_by_beam_smem(K: int, t_all: int, f32: bool) -> int:
    """Dynamic shared memory of the beam-by-beam K4 this design replaced
    (q, scores and row offsets [K][t_all], a P.V reduction of 16 or 32 rows
    of 64 floats): it launched wherever this fit 227 KB."""
    a4 = lambda n: (n + 3) & ~3  # noqa: E731
    return 4 * (a4(K * 64) + 2 * a4(K * t_all) + (16 if f32 else 32) * 64 + a4(K))


def test_split_self_plan_shrinks_the_chunk_never_k():
    """Past 113 KB the plan takes one CTA an SM (227 KB); it plans every K
    the beam-by-beam kernel before it launched; where even a stage of one
    decode slot of all K rows does not fit it raises, and so does a shape
    the kernel does not take."""
    big = attn.split_self_plan(40, 227, 227, 223)
    assert attn.SPLIT_SELF_SMEM_TWO < big.smem <= attn.SPLIT_SELF_SMEM_ONE and big.cap >= 40
    for f32 in (False, True):
        for Tp in (3, 19, 227):
            for step in (0, 63, 223):
                for K in range(1, 80):
                    if _k4_beam_by_beam_smem(K, Tp + step + 1, f32) <= attn.SPLIT_SELF_SMEM_ONE:
                        plan = attn.split_self_plan(K, Tp, Tp, step, f32)
                        assert plan.cap >= K and plan.smem <= attn.SPLIT_SELF_SMEM_ONE
    with pytest.raises(ValueError, match="do not fit"):
        attn.split_self_plan(200, 227, 227, 223)
    for bad in ((0, 3, 3, 0), (5, 3, 4, 0), (5, 3, 0, 0), (5, 3, 3, -1)):
        with pytest.raises(ValueError):
            attn.split_self_plan(*bad)


def _k4_staged(layer, q, pk, pv, dk, dv, anc_j, step, row_pad, prompt_len, plan=None):
    """K4's walk in plain PyTorch (f32): per (stream, head) each chunk of the
    plan staged as the bulk copies land it (its prompt rows, then K spans of
    its decode slots, one for each physical row); scores read through the
    staged rows, each (beam, slot) written once; the softmax over the joint
    row of staged slots (its max over the scores that are not NaN, as
    fmaxf); P.V over each chunk's slots in lane groups (4 of a beam's warp,
    2 at f32), group g the slots s = g mod the groups, the groups added at
    the chunk's end, the chunks summed in order. The plan is the kernel's
    (`split_self_plan_at`: its launch's, planned for the whole caches, re-cut
    for prompt_len and step), unless `plan` gives another."""
    B, K, H, _ = q.shape
    Tp, Td = pk.shape[3], dk.shape[3]
    f32 = q.dtype == torch.float32
    if plan is None:
        plan = attn.split_self_plan_at(K, Tp, Td, prompt_len, step, f32)
    chunks = _k4_chunks(plan, K, prompt_len, step)
    P, S = prompt_len, step + 1
    qs = (q.float() * 0.125).to(q.dtype).float()
    out = torch.empty(B, K, H, 64)
    for b in range(B):
        rp = int(row_pad[b])
        for h in range(H):
            def stage(ch, pc, dc):
                return torch.cat([pc[layer, b, h, ch.p0:ch.p0 + ch.np]] + [
                    dc[layer, b * K + j, h, ch.d0:ch.d0 + ch.nd] for j in range(K)]).float()

            def rows_of(ch):  # (beam, staged row or code, joint slot) of the chunk's pairs
                for k in range(K):
                    for s in range(ch.np + ch.nd):
                        if s < ch.np:
                            t = ch.p0 + s
                            yield k, (s if t >= rp else -1), t
                        else:
                            d = ch.d0 + s - ch.np
                            a = int(anc_j[b, k, d])
                            yield k, (ch.np + a * ch.nd + s - ch.np if 0 <= a < K else -2), P + d

            sc = torch.zeros(K, P + S)
            seen = torch.zeros(K, P + S, dtype=torch.int32)
            for ch in chunks:
                rows = stage(ch, pk, dk)
                for k, row, slot in rows_of(ch):
                    seen[k, slot] += 1
                    sc[k, slot] = (rows[row] @ qs[b, k, h] if row >= 0
                                   else float("-inf") if row == -1 else float("nan"))
            assert bool((seen == 1).all())
            m = torch.where(sc.isnan(), float("-inf"), sc).amax(dim=1, keepdim=True)
            p = torch.exp(sc - m)
            lsum = p.sum(dim=1)
            p = p.to(q.dtype).float()
            total = torch.zeros(K, 64)
            groups = 2 if f32 else 4
            for ch in chunks:
                rows = stage(ch, pv, dv)
                part = torch.zeros(K, groups, 64)
                for i, (k, row, slot) in enumerate(rows_of(ch)):
                    s = i - k * (ch.np + ch.nd)
                    if row >= 0:
                        part[k, s % groups] += p[k, slot] * rows[row]
                total += part.sum(dim=1)
            out[b, :, h] = total / lsum[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K,Tp,Td,step", [(5, 3, 64, 31), (5, 19, 224, 111), (8, 19, 224, 223),
                                          (1, 227, 224, 223), (3, 227, 64, 0)])
def test_k4_staged_walk_matches_plain(dtype, K, Tp, Td, step):
    """The kernel's walk through its plan (`_k4_staged`: one load phase, or
    the ring where the rows do not fit 113 KB) equals the plain version
    within the card's check, row pads and a random ancestry included; an
    ancestor outside [0, K) makes that beam's output NaN and no other."""
    g = torch.Generator().manual_seed(K * 1000 + step)
    L, B, H = 2, 2, 2
    q = ag.randn(g, "cpu", B, K, H, 64, scale=2.0, dtype=dtype)
    pk, pv = (ag.randn(g, "cpu", L, B, H, Tp, 64, dtype=dtype) for _ in range(2))
    dk, dv = (ag.randn(g, "cpu", L, B * K, H, Td, 64, dtype=dtype) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, dtype=torch.int32)
    row_pad = torch.tensor([0, min(16, Tp - 2)], dtype=torch.int32)
    a = (1, q, pk, pv, dk, dv, anc_j, step, row_pad, Tp - 1)
    ref = attn.split_self_attn_layer_plain(*a)
    tol = ag.F32 if dtype == torch.float32 else ag.BF16
    assert ag.agreement(_k4_staged(*a), ref, tol=tol).ok
    bad = anc_j.clone()
    bad[1, K - 1, step // 2] = K
    got = _k4_staged(1, q, pk, pv, dk, dv, bad, step, row_pad, Tp - 1)
    assert bool(got[1, K - 1].isnan().all()) and not bool(got[:1].isnan().any())
    assert bool((got[1, :K - 1] == _k4_staged(*a)[1, :K - 1]).all())


def test_split_self_wrapper_checks_its_plan(fake_card, monkeypatch):
    """The wrapper asks `split_self_plan` for the launch's plan (the whole
    caches) before the C call: a shape with no plan raises ValueError and
    launches nothing; a shape with one is passed to the C entry point
    unchanged (the C side plans it again), an int step and prompt length
    as device scalars."""
    monkeypatch.setattr(attn, "_require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(attn, "_int32_on", lambda name, device, t: t)
    meta = torch.device("meta")

    def call(K, Tp, Td, step):
        L, B, H = 2, 8, 20
        q = torch.empty((B, K, H, 64), dtype=torch.bfloat16, device=meta)
        pk = torch.empty((L, B, H, Tp, 64), dtype=torch.bfloat16, device=meta)
        dk = torch.empty((L, B * K, H, Td, 64), dtype=torch.bfloat16, device=meta)
        anc = torch.empty((B, K, Td), dtype=torch.int32, device=meta)
        rp = torch.empty((B,), dtype=torch.int32, device=meta)
        return attn.split_self_attn_layer(1, q, pk, pk, dk, dk, anc, step, rp, Tp)

    before = attn.split_self_attn_layer.launches
    with pytest.raises(ValueError, match="do not fit"):
        call(200, 227, 224, 223)
    assert fake_card.calls == [] and attn.split_self_attn_layer.launches == before
    call(5, 3, 64, 31)
    (name, args), = fake_card.calls
    assert name == "wdt_split_self_attn" and len(args) == len(kernels._SIGNATURES[name])
    assert args[10:-1] == (8, 5, 20, 3, 64, 1)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("Td", [64, 224])
@pytest.mark.parametrize("Tp", [3, 19, 227])
def test_split_self_plan_at_a_device_step_covers_every_slot_once(Tp, Td, f32):
    """The plan a CTA runs (its launch planned for the whole caches, the
    chunks re-cut for the prompt_len and step it reads): the launch's
    stages and shared memory at every prompt length and step; its chunks
    cover the prompt's rows and the decode slots once each, each within a
    stage; one chunk wherever the rows fit that stage, as at the plan of
    the values themselves."""
    for K in (1, 5, 8):
        top = attn.split_self_plan(K, Tp, Tp, Td - 1, f32)
        for P in sorted({1, 3, Tp // 2 or 1, Tp}):
            for step in range(Td):
                plan = attn.split_self_plan_at(K, Tp, Td, P, step, f32)
                key = (K, P, step, plan)
                assert (plan.cap, plan.stages, plan.smem) == (top.cap, top.stages, top.smem), key
                rows = P + K * (step + 1)
                assert (plan.chunks == 1) == (rows <= plan.cap), key
                if rows <= plan.cap:
                    assert attn.split_self_plan(K, Tp, P, step, f32).chunks == 1, key
                prompt, decode = [], []
                for ch in _k4_chunks(plan, K, P, step):
                    assert ch.np + ch.nd > 0 and ch.np + K * ch.nd <= plan.cap, (key, ch)
                    prompt.extend(range(ch.p0, ch.p0 + ch.np))
                    decode.extend(range(ch.d0, ch.d0 + ch.nd))
                assert prompt == list(range(P)) and decode == list(range(step + 1)), key
        assert attn.split_self_plan_at(K, Tp, Td, Tp, Td - 1, f32) == top
    for P, step in ((Tp, -1), (Tp, Td), (0, 0), (Tp + 1, 0)):
        with pytest.raises(ValueError):
            attn.split_self_plan_at(5, Tp, Td, P, step, f32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K,Tp,Td,step", [(5, 3, 64, 0), (5, 3, 64, 31), (5, 3, 64, 63),
                                          (5, 19, 224, 40), (8, 19, 224, 111)])
def test_k4_staged_walk_at_a_device_step_matches_plain(dtype, K, Tp, Td, step):
    """K4's walk through the plan a CTA runs equals the plain version
    within the card's check, and the walk of the values' own plan bit for
    bit where the two plans cut the same chunks; so does a prompt shorter
    than the cache (a graph's prompt buffer)."""
    g = torch.Generator().manual_seed(K * 1000 + step + 7)
    L, B, H = 2, 2, 2
    q = ag.randn(g, "cpu", B, K, H, 64, scale=2.0, dtype=dtype)
    pk, pv = (ag.randn(g, "cpu", L, B, H, Tp, 64, dtype=dtype) for _ in range(2))
    dk, dv = (ag.randn(g, "cpu", L, B * K, H, Td, 64, dtype=dtype) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, Td), generator=g, dtype=torch.int32)
    row_pad = torch.tensor([0, min(16, Tp - 2)], dtype=torch.int32)
    tol = ag.F32 if dtype == torch.float32 else ag.BF16
    f32 = dtype == torch.float32
    for P in (Tp - 1, Tp):
        a = (1, q, pk, pv, dk, dv, anc_j, step, row_pad, P)
        got = _k4_staged(*a)
        assert ag.agreement(got, attn.split_self_attn_layer_plain(*a), tol=tol).ok, P
        own = attn.split_self_plan(K, Tp, P, step, f32)
        at = attn.split_self_plan_at(K, Tp, Td, P, step, f32)
        if _k4_chunks(own, K, P, step) == _k4_chunks(at, K, P, step):
            assert torch.equal(got, _k4_staged(*a, plan=own)), P


def test_split_self_wrapper_launches_a_device_step_at_the_last_slots_plan(fake_card,
                                                                          monkeypatch):
    """A tensor step and prompt length go to `wdt_split_self_attn` as
    their pointers, the launch planned for the whole caches before the C
    call; a step of more than one value, or caches with no plan, are
    refused with nothing launched."""
    monkeypatch.setattr(attn, "_require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(attn, "_int32_on", lambda name, device, t: t)
    meta = torch.device("meta")

    def one(n=1):
        return torch.empty((n,), dtype=torch.int32, device=meta)

    def call(K, Tp, Td, step, prompt_len):
        L, B, H = 2, 8, 20
        q = torch.empty((B, K, H, 64), dtype=torch.bfloat16, device=meta)
        pk = torch.empty((L, B, H, Tp, 64), dtype=torch.bfloat16, device=meta)
        dk = torch.empty((L, B * K, H, Td, 64), dtype=torch.bfloat16, device=meta)
        anc = torch.empty((B, K, Td), dtype=torch.int32, device=meta)
        rp = torch.empty((B,), dtype=torch.int32, device=meta)
        return attn.split_self_attn_layer(1, q, pk, pk, dk, dk, anc, step, rp, prompt_len)

    before = attn.split_self_attn_layer.launches
    with pytest.raises(ValueError, match="do not fit"):
        call(200, 227, 224, one(), one())
    with pytest.raises(ValueError, match="one value"):
        call(5, 3, 64, one(2), one())
    assert fake_card.calls == [] and attn.split_self_attn_layer.launches == before
    call(5, 3, 64, one(), one())
    (name, args), = fake_card.calls
    assert name == "wdt_split_self_attn" and len(args) == len(kernels._SIGNATURES[name])
    assert args[10:-1] == (8, 5, 20, 3, 64, 1)
    assert attn.split_self_attn_layer.launches == before + 1
