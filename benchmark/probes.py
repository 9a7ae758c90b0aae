"""Spans, counters and captures, recorded from the benchmark's own files
around the program's calls into each layer (the program is not edited):

- `parallel/batching.pack_batch`: a decode batch begins; its rows;
- `TranscribeStep.mel`, `.encode`, `.exact_cross_cache`, `.decode`,
  `.start_alignment` (and the thunk it returns): the frontend, encoder,
  cross K/V, prompt pass and decode loop, and word alignment;
- `ops/decode.beam_sample` / `greedy_sample`: one decode step each;
- `TranscribeStep.decode_cache`: the cross K/V in the form the decode
  reads it (captured for the check);
- `diarize.get_segments_batch` and `models/campplus.embed_from_audio`: the
  segmentation pass and the embedding dispatch;
- `Engine._run_pipeline_multi`: the segments of each stream, so that each
  segment the callback sees maps to its file by identity.

While a stretch is traced, each span launches a marker kernel at its start
and end (`devtrace.Tracer`), and the decode, segmentation and embedding
spans synchronize around themselves so that their walls are the card's.
Outside the traced stretch a span costs a few Python calls.

The random-weight handling of the traffic is installed here too: the
suppressions (`ops/decode.build_suppress_mask`, as the port's long-form
tool does it), the whole window as each window's seek
(`TranscribeStep.build_chunk_results`' `end_ts`), and, in a diarized
cell, one speaker turn a file.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from . import traffic as traffic_mod
from .devtrace import Tracer

SYNCED = ("decode", "segment", "embed")


class Probes:
    """The spans, counters and captures of one run, over the patched
    program (`install`, `uninstall`)."""

    def __init__(self, tr: Dict, device: torch.device, trace_batches: int):
        self.tr, self.device = tr, device
        self.kv_layers: List[int] = []  # the decoder layers whose cross K/V is captured
        self.trace_batches = trace_batches
        self.call = -1
        self.batch = -1
        self.rows: List[Tuple[int, float, int]] = []
        self.decodes: List[Dict] = []  # one a decode batch
        self.steps = 0
        # the sampled batches: those holding a (stream, window) of a call;
        # the sampled segmentation forward: the one holding a call's 10 s
        # window of this global index
        self.targets: Dict[int, Set[Tuple[int, int]]] = {}
        self.seg_targets: Dict[int, int] = {}
        self.cur_sampled = False
        self.captures: Dict[Tuple[int, int], Dict] = {}
        self.seg_captures: Dict[Tuple[int, int], Dict] = {}
        self.forward = -1
        self.forward_rows: Dict[int, List[int]] = defaultdict(list)
        self.seg_lists = None
        self.tracer: Optional[Tracer] = None
        self.trace: Optional[Dict] = None
        self.span_walls: Dict[str, List[float]] = defaultdict(list)
        self.traced_windows = 0
        self.traced_audio_s = 0.0
        self._undo: List[Callable[[], None]] = []

    # -- bookkeeping ----------------------------------------------------------
    def begin_call(self, call: int, trace: bool) -> None:
        self.call, self.batch, self.forward = call, -1, -1
        if trace:
            self.tracer = Tracer()
            self.span_walls = defaultdict(list)
            self.traced_windows = 0
            self.traced_audio_s = traffic_mod.audio_seconds(self.tr)
            self.tracer.start()

    def end_call(self) -> None:
        self._stop_trace()

    def _stop_trace(self) -> None:
        if self.tracer is not None and self.tracer.active:
            self.trace = self.tracer.stop()
        self.tracer = None

    @property
    def tracing(self) -> bool:
        return self.tracer is not None and self.tracer.active

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str, fn: Callable, *args, **kwargs):
        if not self.tracing:
            return fn(*args, **kwargs)
        synced = name in SYNCED
        if synced:
            self._sync()
        self.tracer.mark(name + ">")
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if synced:
            self._sync()
            self.span_walls[name].append(time.perf_counter() - t0)
        self.tracer.mark(name + "<")
        return out

    def sampled(self) -> bool:
        return self.cur_sampled

    def _cap(self) -> Dict:
        return self.captures.setdefault((self.call, self.batch), {})

    # -- installation ----------------------------------------------------------
    def _patch(self, owner: Any, name: str, new: Callable) -> None:
        old = getattr(owner, name)
        setattr(owner, name, new)
        self._undo.append(lambda: setattr(owner, name, old))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def install(self) -> None:
        from whisper_diarize_tpu_torch import diarize
        from whisper_diarize_tpu_torch.engine import Engine
        from whisper_diarize_tpu_torch.models import campplus, segmentation
        from whisper_diarize_tpu_torch.ops import decode as dec
        from whisper_diarize_tpu_torch.parallel import batching
        from whisper_diarize_tpu_torch.transcribe import TranscribeStep
        from whisper_diarize_tpu_torch.types import SpeechSegment

        P, tr = self, self.tr

        suppress_orig = dec.build_suppress_mask

        def build_suppress_mask(sp, n_vocab, extra_suppress=None):
            extra = list(extra_suppress or []) + traffic_mod.suppressed_ids(
                tr, sp.eot, sp.timestamp_begin)
            return suppress_orig(sp, n_vocab, extra)

        self._patch(dec, "build_suppress_mask", build_suppress_mask)

        if tr["handling"].get("full_window_seek"):
            results_orig = TranscribeStep.build_chunk_results

            def build_chunk_results(step, *args, **kwargs):
                return [dataclasses.replace(cr, end_ts=None)
                        for cr in results_orig(step, *args, **kwargs)]

            self._patch(TranscribeStep, "build_chunk_results", build_chunk_results)

        pack_orig = batching.pack_batch

        def pack_batch(group, batch_size):
            P.batch += 1
            if P.tracing and P.batch >= P.trace_batches:
                P._stop_trace()
            P.rows = [(w.stream_idx, w.start, len(w.samples)) for w in group]
            want = P.targets.get(P.call, ())
            P.cur_sampled = any((w.stream_idx, w.window_idx) in want for w in group)
            if P.tracing:
                P.traced_windows += len(group)
            return pack_orig(group, batch_size)

        self._patch(batching, "pack_batch", pack_batch)

        def spanned(name: str, orig: Callable, capture: Optional[Callable] = None):
            def method(step, *args, **kwargs):
                out = P.span(name, orig, step, *args, **kwargs)
                if capture is not None and P.sampled():
                    capture(out)
                return out
            return method

        def cap_mel(out):
            P._cap()["mel"] = out.detach().float().clone()
            P._cap()["rows"] = list(P.rows)

        def cap_xa(out):
            P._cap()["xa"] = out.detach().clone()

        def cap_cache(out):
            kv = {}
            for l in P.kv_layers:
                if "k8" in out:
                    kv[l] = (out["k8"][l].float() * out["ks"][l][..., None],
                             out["v8"][l].float() * out["vs"][l][..., None])
                else:
                    kv[l] = (out["k"][l].detach().clone(), out["v"][l].detach().clone())
            P._cap()["kv"] = kv

        self._patch(TranscribeStep, "mel", spanned("mel", TranscribeStep.mel, cap_mel))
        self._patch(TranscribeStep, "encode", spanned("encode", TranscribeStep.encode, cap_xa))
        self._patch(TranscribeStep, "exact_cross_cache",
                    spanned("cross_kv", TranscribeStep.exact_cross_cache))
        cache_orig = TranscribeStep.decode_cache

        def decode_cache(step, cross):
            out = cache_orig(step, cross)
            if P.sampled():
                cap_cache(out)
            return out

        self._patch(TranscribeStep, "decode_cache", decode_cache)
        decode_orig = TranscribeStep.decode

        def decode(step, *args, **kwargs):
            s0 = P.steps
            res = P.span("decode", decode_orig, step, *args, **kwargs)
            P.decodes.append({"call": P.call, "batch": P.batch, "rows": len(P.rows),
                              "steps": P.steps - s0, "traced": P.tracing})
            if P.sampled():
                P._cap()["tokens"] = res.tokens.detach().clone()
                P._cap()["lengths"] = res.lengths.detach().clone()
                P._cap()["probs"] = res.token_probs.detach().clone()
            return res

        self._patch(TranscribeStep, "decode", decode)
        for name in ("beam_sample", "greedy_sample"):
            orig = getattr(dec, name)

            def counted(*args, _orig=orig, **kwargs):
                P.steps += 1
                return _orig(*args, **kwargs)

            self._patch(dec, name, counted)
        align_orig = TranscribeStep.start_alignment

        def start_alignment(step, *args, **kwargs):
            thunk = P.span("align", align_orig, step, *args, **kwargs)
            if thunk is None:
                return None
            key = (P.call, P.batch) if P.sampled() else None

            def wrapped():
                t0 = time.perf_counter()
                anchors = thunk()
                P.span_walls["align_thunk"].append(time.perf_counter() - t0)
                if key is not None:
                    P.captures[key]["anchors"] = anchors
                return anchors
            return wrapped

        self._patch(TranscribeStep, "start_alignment", start_alignment)

        run_orig = Engine._run_pipeline_multi

        def run_pipeline(eng, *args, **kwargs):
            out = run_orig(eng, *args, **kwargs)
            P.seg_lists = out[0]
            return out

        self._patch(Engine, "_run_pipeline_multi", run_pipeline)

        if tr["diarize"]:
            seg_orig = diarize.get_segments_batch

            def get_segments_batch(streams, sample_rate=16000, *args, **kwargs):
                P.span("segment", seg_orig, streams, sample_rate, *args, **kwargs)
                if tr["handling"].get("one_turn_per_file"):
                    return [[SpeechSegment(start=0.0, end=len(x) / sample_rate, samples=x)]
                            for x in streams]
                raise ValueError("a diarized traffic states its segmentation handling")

            self._patch(diarize, "get_segments_batch", get_segments_batch)
            fwd_orig = segmentation.forward

            def forward(params, audio, *args, **kwargs):
                P.forward += 1
                out = fwd_orig(params, audio, *args, **kwargs)
                offset, rows = sum(P.forward_rows[P.call]), int(out.shape[0])
                P.forward_rows[P.call].append(rows)
                if offset <= P.seg_targets.get(P.call, -1) < offset + rows:
                    P.seg_captures[(P.call, P.forward)] = {
                        "out": out.detach().clone(), "offset": offset, "rows": rows}
                return out

            self._patch(segmentation, "forward", forward)
            emb_orig = campplus.embed_from_audio

            def embed_from_audio(params, audio, n_valid):
                out = P.span("embed", emb_orig, params, audio, n_valid)
                if P.sampled():
                    P._cap()["emb"] = out.detach().clone()
                return out

            self._patch(campplus, "embed_from_audio", embed_from_audio)
