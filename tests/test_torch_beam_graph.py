"""The beam step's device step and its CUDA graph, on the CPU: the parts
that need no card.

- `decode_step_split` with the step and the prompt's length as
  one-element int32 tensors (how the captured graph runs it,
  `ops/beam_graph.py`) gives the ints' logits and caches bit for bit
  through the plain kernels, at steps 0, 1, 31 and Td - 1, beam 5, over
  the f32 and the int8 cross cache, with and without per-row prompt pads;
  so does a prompt in the first slots of a longer prompt buffer (the
  graph's), within the f32 check; the plain K4 takes tensors the same way.
- Where the graph engages (`beam_graph.engages`): a CUDA device without a
  head split; `beam_decode` on the CPU and under a mesh runs eagerly and
  counts no replay and no capture.
- The graph's buffers and bookkeeping on the CPU, with the capture and the
  replay stood in for (a stand-in replay reruns the captured forward into
  the captured output): `beam_decode` gives the eager path's tokens, one
  capture a batch shape whatever the prompt's length, every step a
  replay; a cross K/V built into the graph's buffers is not copied; the
  buffers are held for one scope: a second hold, in another thread or in
  the same one, gets none and runs eagerly, and an error releases them.
- `benchmark/metrics/decode_graph_share.py` on known request summaries.
"""

import contextlib
import dataclasses
import importlib.util
import threading

import pytest
import torch

from benchmark import hostspans, spec
from whisper_diarize_tpu_torch import tracing
from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.models import whisper as pwm
from whisper_diarize_tpu_torch.ops import attn, beam_graph
from whisper_diarize_tpu_torch.ops import decode as pdec
from whisper_diarize_tpu_torch.parallel.mesh import Mesh
from whisper_diarize_tpu_torch.tokenizer import DebugTokenizer

from tests.test_whisper_model import TINY_TEST_CFG

TK = DebugTokenizer()
SP = TK.specials
L, B, K, H, DH, TP, TD, V = 2, 2, 5, 2, 8, 5, 64, 64
N, D = B * K, H * DH
STEPS = (0, 1, 31, TD - 1)


def _cfg():
    return pwm.WhisperConfig(
        n_mels=8, n_vocab=V, n_audio_ctx=16, n_audio_state=D, n_audio_head=H,
        n_audio_layer=L, n_text_ctx=128, n_text_state=D, n_text_head=H, n_text_layer=L)


def _ancestry(g, step):
    """Identity for the slots from `step` on, random rows of each stream's
    beams for the decoded ones (what `beam_run` keeps)."""
    anc = torch.arange(N)[:, None].repeat(1, TD)
    anc[:, :step] = (torch.arange(N)[:, None] // K) * K + torch.randint(0, K, (N, step),
                                                                        generator=g)
    return anc


@pytest.mark.parametrize("padded", [False, True], ids=["no-pad", "row-pad"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32-cross", "int8-cross"])
def test_decode_step_split_device_step_equals_int_step(int8, padded):
    cfg = _cfg()
    params = pwm.init_params(cfg, seed=0)
    g = torch.Generator().manual_seed(int8 * 2 + padded)
    xa = torch.randn(B, 16, D, generator=g)
    cross = pwm.cross_kv(params, xa, cfg, quantize=int8)
    prompt = {k: torch.randn(L, B, H, TP, DH, generator=g) for k in ("k", "v")}
    # the graph's layout: the prompt in the first slots of a longer buffer
    wide = {k: torch.cat([t, torch.randn(L, B, H, 3, DH, generator=g)], dim=3)
            for k, t in prompt.items()}
    decode = {k: torch.randn(L, N, H, TD, DH, generator=g) for k in ("k", "v")}
    row_pad = (torch.randint(0, TP - 1, (B,), generator=g).repeat_interleave(K)
               if padded else None)
    on_dev = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    for step in STEPS:
        anc = _ancestry(g, step)
        anc[:, step] = torch.arange(N)
        tokens = torch.randint(0, V, (N, 1), generator=g)
        caches = [{k: t.clone() for k, t in decode.items()} for _ in range(3)]
        ref = pwm.decode_step_split(params, cfg, tokens, step, prompt, caches[0], cross, TP, K,
                                    row_pad, anc)
        got = pwm.decode_step_split(params, cfg, tokens, on_dev(step), prompt, caches[1], cross,
                                    on_dev(TP), K, row_pad, anc)
        assert torch.equal(got, ref), step
        in_wide = pwm.decode_step_split(params, cfg, tokens, on_dev(step), wide, caches[2],
                                        cross, on_dev(TP), K, row_pad, anc)
        assert ag.agreement(in_wide, ref, tol=ag.F32).ok, step
        for k in ("k", "v"):
            assert torch.equal(caches[1][k], caches[0][k]), (step, k)
            assert ag.agreement(caches[2][k], caches[0][k], tol=ag.F32).ok, (step, k)
            assert not torch.equal(caches[0][k][:, :, :, step], decode[k][:, :, :, step]), step


@pytest.mark.parametrize("step", STEPS)
def test_plain_k4_takes_a_tensor_step(step):
    """int32 and int64 one-element steps and prompt lengths give the ints'
    bits; the planted faults stay refused against the tensors' output."""
    g = torch.Generator().manual_seed(step)
    q = ag.randn(g, "cpu", B, K, H, 64, scale=2.0)
    pk, pv = (ag.randn(g, "cpu", L, B, H, TP, 64) for _ in range(2))
    dk, dv = (ag.randn(g, "cpu", L, N, H, TD, 64) for _ in range(2))
    anc_j = torch.randint(0, K, (B, K, TD), generator=g, dtype=torch.int32)
    row_pad = torch.tensor([0, 2], dtype=torch.int32)
    a = (1, q, pk, pv, dk, dv, anc_j)
    for P in (TP - 1, TP):
        ref = attn.split_self_attn_layer_plain(*a, step, row_pad, P)
        for dtype in (torch.int32, torch.int64):
            got = attn.split_self_attn_layer(*a, torch.tensor([step], dtype=dtype), row_pad,
                                             torch.tensor([P], dtype=dtype))
            assert torch.equal(got, ref), (P, dtype)
        if step:
            for name, bad in ag.k4_faults(*a, torch.tensor([step]), row_pad, torch.tensor([P])):
                assert not ag.agreement(ref, bad).ok, (P, name)


def test_graph_engages_on_a_card_without_a_head_split():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert beam_graph.engages(cuda, None)
    assert beam_graph.engages(cuda, Mesh(n_data=2, n_model=1))
    assert beam_graph.engages(cuda, Mesh(n_data=1, n_model=1))
    assert not beam_graph.engages(cuda, Mesh(n_data=1, n_model=2))
    assert not beam_graph.engages(cuda, Mesh(n_data=2, n_model=2))
    assert not beam_graph.engages(cpu, None)


@pytest.mark.parametrize("mesh", [None, Mesh(n_data=1, n_model=1)], ids=["no-mesh", "mesh-1x1"])
def test_beam_decode_on_the_cpu_counts_no_replay(mesh):
    params = pwm.init_params(TINY_TEST_CFG, seed=3)
    xa = torch.randn(2, TINY_TEST_CFG.n_audio_ctx, TINY_TEST_CFG.n_audio_state,
                     generator=torch.Generator().manual_seed(4))
    prompt = torch.tensor([TK.sot_sequence(task="transcribe", language="en")] * 2)
    dc = pdec.DecodeConfig(max_tokens=6, beam_size=5, mesh=mesh)
    state = pdec.beam_init(params, TINY_TEST_CFG, dc, SP, xa, prompt, prompt.shape[1])
    assert state["graph"] is None
    with tracing.request() as req:
        res = pdec.beam_decode(params, TINY_TEST_CFG, dc, SP, xa, prompt, prompt.shape[1])
        counters = req.summary()["counters"]
    assert res.tokens.shape == (2, 6)
    assert counters["decode.steps"] == 6
    assert "decode.graph_replays" not in counters and "decode.graph_captures" not in counters


class _StandInGraph:
    """A CUDA graph's stand-in: its capture runs the forward once (a real
    capture only records it), and a replay reruns it into the output the
    capture returned, reading the buffers as they are then."""

    capturing = None

    def replay(self):
        self.out.copy_(self.forward(*self.args))


@contextlib.contextmanager
def _stand_in_capture(graph, capture_error_mode="global"):
    _StandInGraph.capturing = graph
    try:
        yield
    finally:
        _StandInGraph.capturing = None


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: `engages` holds, CUDA's graph calls
    stood in for, each capture's forward kept for its replays."""
    forward = beam_graph.BeamStepGraph._forward

    def recorded(self, params):
        out = forward(self, params)
        g = _StandInGraph.capturing
        if g is not None:
            g.forward, g.args, g.out = forward, (self, params), out
        return out

    monkeypatch.setattr(beam_graph, "engages", lambda device, mesh: True)
    monkeypatch.setattr(beam_graph.BeamStepGraph, "_forward", recorded)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)


def _tiny_beam(prefix=0, **kw):
    params = pwm.init_params(TINY_TEST_CFG, seed=3)
    xa = torch.randn(2, TINY_TEST_CFG.n_audio_ctx, TINY_TEST_CFG.n_audio_state,
                     generator=torch.Generator().manual_seed(4))
    seq = TK.sot_sequence(task="transcribe", language="en")
    prompt = torch.tensor([[SP.sot_prev] * prefix + seq] * 2)
    return params, xa, prompt, pdec.DecodeConfig(max_tokens=8, beam_size=5, **kw)


def _decode(params, xa, prompt, dc):
    with tracing.request() as req:
        res = pdec.beam_decode(params, TINY_TEST_CFG, dc, SP, xa, prompt, prompt.shape[1],
                               row_pad=torch.tensor([1, 0]), sot_pos=prompt.shape[1] - 3)
        return res, dict(req.summary()["counters"])


def _equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(pdec.DecodeResult))


def _same_tokens(a, b, tol=ag.F32):
    """The eager path's tokens and lengths, its scores and probabilities
    within the f32 check (the graph's prompt buffer is longer than the
    prompt: its masked slots sum in another order)."""
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
    for name in ("sum_logprob", "avg_logprob", "token_probs", "no_speech_prob"):
        assert ag.agreement(getattr(a, name), getattr(b, name), tol=tol).ok, name
    return True


def _shapes(params):
    ptr = params["decoder"]["tok_emb"].data_ptr()
    return [g for key, g in beam_graph._graphs.items() if key[-1][0] == ptr]


@pytest.mark.parametrize("int8", [False, True], ids=["f32-cross", "int8-cross"])
def test_graph_path_equals_eager_with_the_capture_stood_in(stand_in, monkeypatch, int8):
    params, xa, prompt, dc = _tiny_beam(quantize_cross_kv=int8)
    longer = torch.cat([torch.full((2, 2), SP.sot_prev), prompt], dim=1)
    got, counted = _decode(params, xa, prompt, dc)
    again, counted2 = _decode(params, xa, prompt, dc)
    other, counted3 = _decode(params, xa, longer, dc)
    assert (counted["decode.graph_captures"], counted["decode.graph_replays"]) == (1, 8)
    for later in (counted2, counted3):  # one capture serves every prompt length
        assert "decode.graph_captures" not in later and later["decode.graph_replays"] == 8
    graph, = _shapes(params)
    assert graph.prompt_slots == beam_graph.prompt_slots(TINY_TEST_CFG) >= longer.shape[1]
    assert not graph.held
    monkeypatch.setattr(beam_graph, "engages", lambda device, mesh: False)
    ref, eager = _decode(params, xa, prompt, dc)
    ref_other, _ = _decode(params, xa, longer, dc)
    assert "decode.graph_replays" not in eager
    assert _same_tokens(got, ref) and _same_tokens(other, ref_other)
    assert all(torch.equal(getattr(again, f.name), getattr(got, f.name))
               for f in dataclasses.fields(pdec.DecodeResult))


def test_a_prompt_longer_than_the_graphs_buffer_runs_eagerly(stand_in):
    params, xa, prompt, dc = _tiny_beam()
    slots = beam_graph.prompt_slots(TINY_TEST_CFG)
    long = torch.cat([torch.full((2, slots - 2), SP.sot_prev), prompt], dim=1)
    _, counted = _decode(params, xa, long, dc)
    assert "decode.graph_replays" not in counted and counted["decode.steps"] == 8


@pytest.mark.parametrize("int8", [False, True], ids=["f32-cross", "int8-cross"])
def test_a_cross_built_into_the_graphs_buffers_is_not_copied(stand_in, monkeypatch, int8):
    """The hold first, then the cross K/V built into its buffers (bf16 by
    K2, as the Engine builds it; int8 by the quantizer, as `beam_init`
    builds it where no cache is given), the decode on them with no copy;
    the same result as a cross built elsewhere and copied in."""
    params, xa, prompt, dc = _tiny_beam(quantize_cross_kv=int8)
    P = prompt.shape[1]
    copies = []
    load = beam_graph.BeamStepGraph.load

    def counted_load(self, cross, row_pad):
        copies.append(not self.owns(cross))
        return load(self, cross, row_pad)

    monkeypatch.setattr(beam_graph.BeamStepGraph, "load", counted_load)
    with pdec.beam_hold(params, TINY_TEST_CFG, dc, xa) as graph:
        assert graph is not None and graph.held
        exact = pwm.cross_kv(params, xa, TINY_TEST_CFG, out=None if int8 else graph.cross)
        cross = (pwm.quantize_cross_cache(exact, out=graph.cross) if int8 else exact)
        assert graph.owns(cross)
        got = pdec.beam_decode(params, TINY_TEST_CFG, dc, SP, xa, prompt, P, cross=cross,
                               graph=graph)
    ref = pdec.beam_decode(params, TINY_TEST_CFG, dc, SP, xa, prompt, P,
                           cross=pdec.build_cross_cache(params, TINY_TEST_CFG, dc, xa))
    assert copies == [False, True]
    assert all(torch.equal(getattr(got, f.name), getattr(ref, f.name))
               for f in dataclasses.fields(pdec.DecodeResult))


def test_a_loop_on_another_thread_runs_eagerly_while_the_buffers_are_held(stand_in):
    """A second hold, another thread's or this one's, gets no graph and runs
    eagerly; an error inside the decode releases the hold."""
    params, xa, prompt, dc = _tiny_beam()
    seen = {}
    with pdec.beam_hold(params, TINY_TEST_CFG, dc, xa) as graph:
        assert graph is not None and graph.held
        worker = threading.Thread(target=lambda: seen.update(counters=_decode(
            params, xa, prompt, dc)[1]))
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
        # the same thread: a second live state gets no graph, not the held buffers
        with pdec.beam_hold(params, TINY_TEST_CFG, dc, xa) as second:
            assert second is None
            _, same_thread = _decode(params, xa, prompt, dc)
    for counters in (seen["counters"], same_thread):
        assert "decode.graph_replays" not in counters and counters["decode.steps"] == 8
    assert not graph.held

    def cancelled():
        raise RuntimeError("cancelled")

    with pytest.raises(RuntimeError, match="cancelled"):
        pdec.beam_decode(params, TINY_TEST_CFG, dc, SP, xa, prompt, prompt.shape[1],
                         is_cancelled=cancelled, poll_tokens=2)
    assert not graph.held
    _, counted = _decode(params, xa, prompt, dc)
    assert counted["decode.graph_replays"] == 8 and not graph.held


def _reader(name):
    return spec.metric_reader(name)


@pytest.mark.parametrize("replays,steps,want", [(128, 128, 100.0), (64, 128, 50.0),
                                                (None, 128, 0.0), (None, 0, None)])
def test_decode_graph_share_reads_replays_over_steps(monkeypatch, replays, steps, want):
    """Replays over the window's counted steps, the warm call left out."""
    def summary(counters):
        return {"id": 1, "counters": counters, "spans": {}}

    counted = {"decode.steps": steps} if steps else {}
    if replays is not None:
        counted["decode.graph_replays"] = replays
    reqs = [summary({"decode.steps": 64, "decode.graph_captures": 1}),  # the warm call
            summary(dict(counted)), summary(dict(counted))]
    monkeypatch.setattr(hostspans, "requests", lambda: reqs)
    assert _reader("decode_graph_share")({"window": {"calls": 2}}) == want


def test_decode_graph_share_is_silent_without_the_graph(monkeypatch):
    """A program without `ops/beam_graph.py` (the parent of this metric)
    reports nothing, whatever its step counters."""
    reqs = [{"id": 1, "counters": {"decode.steps": 64}, "spans": {}}]
    monkeypatch.setattr(hostspans, "requests", lambda: reqs)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("beam_graph") else real(name, *a))
    assert _reader("decode_graph_share")({"window": {"calls": 1}}) is None
