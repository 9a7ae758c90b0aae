"""Engine: the end-to-end transcription orchestrator of the PyTorch port
(counterpart of `whisper_diarize_tpu/engine.py`).

  audio.wav -> read_wav -> [VAD | whole-file] speech segments
  -> batched whisper decode (beam search by default, or greedy; +
     temperature fallback, + DTW word timestamps) -> optional translate
     post-pass -> language preset + overrides -> process_segments cues.

The same `EngineConfig` / `TranscribeOptions` / `Callbacks` surface, model
and step cache, resume journal, callbacks, chunk scheduler, one-deep DTW
pipeline and formatting as the JAX Engine, on the port's own copies of the
host modules (the port imports nothing of the JAX package).
`EngineConfig(use_gpu=True)` (the default) runs on a CUDA card in bf16 and
raises without one; `use_gpu=False` runs on the CPU in f32 through the
kernels' plain versions. `quantize_kv_cache=True` decodes over an int8
cross K/V cache (K5, K6) on both devices; language detection reads the
exact bf16 cache.

Not ported yet, and refused with NotImplementedError (never run some other
way): diarization, device meshes, speculative decoding and GGML / OpenAI
`.pt` checkpoint files — see ROADMAP.md.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import audio as audio_io
from . import translate as translate_mod
from .formatting import (
    FormattingOverrides,
    PostProcessConfig,
    VadMaskOracle,
    apply_overrides,
    process_segments,
)
from .model_manager import ModelManager
from .types import (
    Callbacks,
    ProgressType,
    Segment,
    SpeechSegment,
    TranscribeOptions,
    WordTimestamp,
)

from .ops import decode as dec
from .parallel.batching import SAMPLE_RATE

logger = logging.getLogger(__name__)


class _AsyncResult:
    """Run a host thunk on a daemon thread; `.result()` joins and re-raises.
    Overlaps batch i's DTW backtrack with batch i+1's decode.
    `WDT_SERIAL_DTW=1` runs the thunk inline."""

    def __init__(self, thunk):
        self._value = None
        self._error: Optional[BaseException] = None
        if os.environ.get("WDT_SERIAL_DTW") == "1":
            self._thread = None
            self._run(thunk)
        else:
            self._thread = threading.Thread(
                target=self._run, args=(thunk,), daemon=True,
                name="wdt-dtw-backtrack")
            self._thread.start()

    def _run(self, thunk) -> None:
        try:
            self._value = thunk()
        except BaseException as e:  # re-raised on the main thread
            self._error = e

    def result(self):
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self._value


class _ResumeJournal:
    """Append-only JSONL store of per-window results; each record carries the
    (possibly None) Segment plus `adv`, the sample stride the window
    consumed, so a resumed run replays seek-based windowing exactly."""

    def __init__(self, path: Path):
        self.path = path
        self._done: Dict[Tuple[int, int, int], Tuple[Optional[Segment], int]] = {}
        if path.exists():
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("skip"):
                        seg = None
                    else:
                        words = rec.get("words")
                        seg = Segment(
                            start=rec["start"], end=rec["end"], text=rec["text"],
                            words=[WordTimestamp(**w) for w in words] if words else None,
                            speaker_id=rec.get("speaker_id"),
                        )
                    self._done[(rec["ci"], rec["wi"], rec.get("si", 0))] = (
                        seg, int(rec.get("adv", 0)))
        self._fh = open(path, "a")

    def has(self, ci: int, wi: int, si: int = 0) -> bool:
        return (ci, wi, si) in self._done

    def get(self, ci: int, wi: int, si: int = 0) -> Tuple[Optional[Segment], int]:
        return self._done[(ci, wi, si)]

    def put(self, ci: int, wi: int, seg: Optional[Segment], si: int = 0,
            adv: int = 0) -> None:
        rec = {"ci": ci, "wi": wi, "si": si, "adv": int(adv)}
        if seg is None:
            rec["skip"] = True
        else:
            rec.update(seg.to_dict())
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self._done[(ci, wi, si)] = (seg, int(adv))

    def close(self) -> None:
        self._fh.close()


@dataclass
class EngineConfig:
    """The JAX Engine's knobs (`engine.rs:9-33` plus extensions)."""

    cache_dir: str = "./cache"
    enable_dtw: Optional[bool] = True
    enable_flash_attn: Optional[bool] = False  # only False: K1 always runs
    use_gpu: Optional[bool] = True  # CUDA (required) vs CPU plain path
    gpu_device: Optional[int] = None  # CUDA device ordinal
    vad_model_path: Optional[str] = None
    diarize_segment_model_path: Optional[str] = None
    diarize_embedding_model_path: Optional[str] = None
    whisper_model_path: Optional[str] = None  # snapshot dir or "__random__[:preset]"
    batch_size: int = 8
    dtype: Optional[str] = None  # "bfloat16" | "float32" (auto by device)
    sequential_prompt: bool = False
    max_decode_tokens: int = 224
    resume_dir: Optional[str] = None
    temperature_fallback: bool = True
    no_speech_threshold: float = 0.6
    mesh_shape: Optional[Tuple[int, int]] = None  # not ported
    long_form_seek: bool = True
    draft_model_path: Optional[str] = None  # not ported
    speculative_gamma: int = 4  # not ported (only the default)
    # int8 cross-K/V decode cache (K5, K6) on either device; language
    # detection reads the exact bf16 cache
    quantize_kv_cache: bool = False
    allow_random_weights: bool = False


class Engine:
    """Public orchestrator (`engine.rs:52-217`)."""

    def __init__(self, cfg: Optional[EngineConfig] = None):
        self.cfg = cfg or EngineConfig()
        if self.cfg.mesh_shape is not None:
            raise NotImplementedError(
                "mesh_shape: multi-GPU inference is not ported yet "
                "(ROADMAP Queue 1: Multi-GPU and training)")
        if self.cfg.draft_model_path:
            raise NotImplementedError(
                "draft_model_path: speculative decoding is not ported yet "
                "(ROADMAP Queue 1: Speculative decoding)")
        if self.cfg.speculative_gamma != EngineConfig.speculative_gamma:
            raise NotImplementedError(
                "speculative_gamma: speculative decoding is not ported yet "
                "(ROADMAP Queue 1: Speculative decoding)")
        if self.cfg.dtype == "float32" and self.cfg.use_gpu is not False:
            raise NotImplementedError(
                "dtype='float32' on the card: the CUDA kernels take bfloat16 "
                "only (ROADMAP Queue 1: f32 forms of the kernels); leave dtype "
                "unset or 'bfloat16', or pass use_gpu=False for the f32 CPU path")
        if self.cfg.use_gpu is False:
            self.device = torch.device("cpu")
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "EngineConfig(use_gpu=True) needs a CUDA device and none is "
                    "available; pass use_gpu=False for the CPU path")
            self.device = torch.device("cuda", self.cfg.gpu_device or 0)
        if self.cfg.enable_flash_attn:
            raise ValueError(
                "enable_flash_attn selects nothing in the port: the decoder's "
                "cross attention always runs on its flash kernel (K1) on CUDA "
                "and on its plain version on the CPU; leave it False")
        self.models = ModelManager(self.cfg.cache_dir)
        self._whisper_cache: dict = {}
        self._step_cache: dict = {}
        self.last_run: Dict[str, Any] = {}  # windows decoded, stage seconds

    # ------------------------------------------------------------------
    def _resolve_dtype(self) -> torch.dtype:
        if self.cfg.dtype == "bfloat16":
            return torch.bfloat16
        if self.cfg.dtype == "float32":
            return torch.float32
        return torch.bfloat16 if self.device.type == "cuda" else torch.float32

    def _whisper_key(self, options: TranscribeOptions) -> tuple:
        return (self.cfg.whisper_model_path or "", options.model,
                str(self._resolve_dtype()))

    def _load_whisper(self, options: TranscribeOptions, progress, is_cancelled):
        """Load the checkpoint once per Engine (single-entry cache: another
        model or dtype evicts it and the step cache)."""
        key = self._whisper_key(options)
        hit = self._whisper_cache.get(key)
        if hit is not None:
            return hit
        out = self._load_whisper_uncached(options, progress, is_cancelled)
        self._whisper_cache.clear()
        self._step_cache.clear()
        self._whisper_cache[key] = out
        return out

    def _load_whisper_uncached(self, options: TranscribeOptions, progress,
                               is_cancelled):
        from .models import weights as weights_mod
        from .models import whisper as wm
        from .tokenizer import DebugTokenizer, load_tokenizer

        dtype = self._resolve_dtype()
        path = self.cfg.whisper_model_path
        if path and path.startswith("__random__"):
            # benchmark-grade pattern weights at a preset's geometry, filled
            # on the device, with the byte-level DebugTokenizer
            name = path.split(":", 1)[1] if ":" in path else options.model
            cfg = wm.PRESETS[name]
            params = weights_mod.init_params_fast(cfg, self.device, dtype)
            return params, cfg, DebugTokenizer(num_languages=cfg.num_languages)
        snap = Path(path) if path else self.models.ensure_whisper_model(
            options.model, progress, is_cancelled)
        if snap.is_file():
            raise NotImplementedError(
                f"{snap}: GGML / OpenAI .pt checkpoint files are not ported yet "
                "(ROADMAP Queue 1: Checkpoint files, CLI and tools); pass a "
                "snapshot directory (config.json + model.safetensors)")
        params, cfg = weights_mod.load_model(snap, self.device, dtype)
        tokenizer = load_tokenizer(str(snap), multilingual=cfg.multilingual,
                                   num_languages=cfg.num_languages)
        return params, cfg, tokenizer

    def _make_step(self, params, cfg, tokenizer, options: TranscribeOptions):
        """Build (or reuse) the TranscribeStep for these options."""
        from .tokenizer import DebugTokenizer
        from .transcribe import TranscribeStep

        adv = options.advanced
        step_key = self._whisper_key(options) + (
            adv.best_of_or_beam_size if adv else None,
            adv.sampling_strategy if adv else None,
            adv.temperature if adv else None,
            adv.max_text_ctx if adv else None,
        )
        hit = self._step_cache.get(step_key)
        if hit is not None:
            return hit
        # `advanced=None` and any strategy but "greedy" run beam search
        # (beam 5 by default, temperature 0), as in the JAX Engine
        greedy = bool(adv and adv.sampling_strategy == "greedy")
        dc = dec.DecodeConfig(
            beam_size=max((adv.best_of_or_beam_size if adv else None) or 5, 1),
            temperature=float(adv.temperature) if greedy and adv.temperature else 0.0,
            max_tokens=self.cfg.max_decode_tokens,
            blank_id=32 if isinstance(tokenizer, DebugTokenizer) else 220,
            quantize_cross_kv=bool(self.cfg.quantize_kv_cache),
        )
        step = TranscribeStep(
            params, cfg, tokenizer, model_name=options.model,
            enable_dtw=bool(self.cfg.enable_dtw), decode_config=dc,
            strategy="greedy" if greedy else "beam_search",
            max_text_ctx=adv.max_text_ctx if adv else None,
        )
        self._step_cache[step_key] = step
        return step

    # ------------------------------------------------------------------
    def transcribe_audio(
        self,
        audio_path: str,
        options: Optional[TranscribeOptions] = None,
        formatting_overrides: Optional[FormattingOverrides] = None,
        callbacks: Optional[Callbacks] = None,
    ) -> List[Segment]:
        """The primary entry point (`engine.rs:65-200`)."""
        return self._transcribe_paths(
            [audio_path], options, formatting_overrides, callbacks)[0]

    async def transcribe_audio_async(self, *args, **kwargs) -> List[Segment]:
        import asyncio

        return await asyncio.to_thread(self.transcribe_audio, *args, **kwargs)

    def transcribe_audio_batch(
        self,
        audio_paths: List[str],
        options: Optional[TranscribeOptions] = None,
        formatting_overrides: Optional[FormattingOverrides] = None,
        callbacks: Optional[Callbacks] = None,
    ) -> List[List[Segment]]:
        """Many files at once, filling decode batches across streams."""
        return self._transcribe_paths(
            audio_paths, options, formatting_overrides, callbacks)

    def _resolve_vad_model(self, cb: Callbacks):
        vad_model = self.cfg.vad_model_path
        if vad_model is None:
            try:
                vad_model = str(self.models.ensure_vad_model(cb.progress, cb.is_cancelled))
            except Exception as e:
                if not self.cfg.allow_random_weights:
                    raise RuntimeError(
                        "VAD weights unavailable (download of "
                        "ggml-silero-v5.1.2.bin failed) and "
                        "allow_random_weights is off") from e
                logger.warning("VAD weights unavailable (%s); using RANDOM weights", e)
                vad_model = "__random__"
        return vad_model

    def _transcribe_paths(self, audio_paths, options, formatting_overrides,
                          callbacks) -> List[List[Segment]]:
        options = options or TranscribeOptions()
        cb = callbacks or Callbacks()
        for p in audio_paths:
            if not os.path.exists(p):
                raise FileNotFoundError("audio file doesn't exist")
        if options.enable_diarize:
            raise NotImplementedError(
                "enable_diarize: diarization is not ported yet "
                "(ROADMAP Queue 1: Diarization)")

        with torch.inference_mode():
            params, model_cfg, tokenizer = self._load_whisper(
                options, cb.progress, cb.is_cancelled)
            step = self._make_step(params, model_cfg, tokenizer, options)
            all_samples = [audio_io.read_wav(p) for p in audio_paths]
            per_stream_segments: List[List[SpeechSegment]] = []
            vad_masks: List[Optional[VadMaskOracle]] = []
            if options.enable_vad:
                from . import vad as vad_mod

                vad_model = self._resolve_vad_model(cb)
                for mask, segs in vad_mod.get_segments_batch(
                        vad_model, all_samples, device=self.device):
                    per_stream_segments.append(segs)
                    vad_masks.append(VadMaskOracle(mask))
            else:
                for samples in all_samples:
                    per_stream_segments.append([SpeechSegment(
                        start=0.0, end=len(samples) / SAMPLE_RATE, samples=samples)])
                    vad_masks.append(None)
            seg_lists, langs = self._run_pipeline_multi(
                step, per_stream_segments, options, cb)

        whisper_to_en = bool(options.whisper_to_english)
        out: List[List[Segment]] = []
        for si, segments in enumerate(seg_lists):
            effective_lang = langs[si] or (options.lang or "auto")
            if not whisper_to_en and options.translate_target:
                translate_mod.translate_segments(
                    segments, effective_lang, options.translate_target, cb.progress)
            pp_cfg = PostProcessConfig.for_language(effective_lang)
            if formatting_overrides is not None:
                apply_overrides(pp_cfg, formatting_overrides)
            out.append(process_segments(segments, pp_cfg, vad_masks[si]))
        return out

    # ------------------------------------------------------------------
    def _run_pipeline_multi(
        self, step, per_stream_segments: List[List[SpeechSegment]],
        options: TranscribeOptions, cb: Callbacks,
    ) -> Tuple[List[List[Segment]], List[Optional[str]]]:
        """Batched multi-stream pipeline: windows of all streams fill the
        same decode batches; language latches per stream; overlap clamping
        and prompt carry are per stream; segments are emitted in order."""
        from .parallel.batching import WindowScheduler, pack_batch

        S = len(per_stream_segments)
        user_offset = options.offset or 0.0
        translated = bool(options.whisper_to_english)
        task = "translate" if translated else "transcribe"
        preset_lang = options.lang if options.lang and options.lang != "auto" else None
        detected_langs: List[Optional[str]] = [preset_lang] * S

        seg_lists: List[List[Segment]] = [[] for _ in range(S)]
        previous_texts: List[Optional[str]] = [None] * S
        adv = options.advanced
        init_prompt = adv.init_prompt if adv else None
        init_tokens = step.tk.encode(" " + init_prompt.strip()) if init_prompt else None
        if init_tokens is not None and self.cfg.sequential_prompt:
            previous_texts = [init_prompt] * S

        sched = WindowScheduler(per_stream_segments,
                                one_per_stream=self.cfg.sequential_prompt,
                                seek=self.cfg.long_form_seek)
        batch_size = self.cfg.batch_size
        if self.cfg.sequential_prompt:
            batch_size = max(1, min(batch_size, S))

        done = 0
        windows = 0
        empty_segments = 0
        total_chars = 0
        stage_s = {"mel": 0.0, "encode": 0.0, "decode": 0.0}
        journal = self._open_resume_journal(options, per_stream_segments)

        def tick_progress():
            if cb.progress:
                total = max(sched.estimated_windows(), 1)
                cb.progress(int(done / total * 100), ProgressType.TRANSCRIBE,
                            "Transcribing audio")

        results: Dict[Tuple[int, int, int], Optional[Segment]] = {}
        emit_ptr: List[List[int]] = [[0, 0] for _ in range(S)]

        def try_emit(si: int) -> None:
            nonlocal done
            row = sched.stream_chunks(si)
            segments = seg_lists[si]
            while emit_ptr[si][0] < len(row):
                cur = row[emit_ptr[si][0]]
                key = (si, cur.chunk_idx, emit_ptr[si][1])
                if key in results:
                    segment = results.pop(key)
                    done += 1
                    if segment is not None:
                        if segments:  # clamp this stream's previous segment
                            last = segments[-1]
                            if last.end > segment.start:
                                last.end = segment.start
                            if last.words and last.words[-1].end > last.end:
                                last.words[-1].end = last.end
                        if cb.new_segment_callback:
                            cb.new_segment_callback(segment)
                        segments.append(segment)
                    tick_progress()
                    emit_ptr[si][1] += 1
                    continue
                if cur.done and emit_ptr[si][1] >= cur.window_idx:
                    emit_ptr[si] = [emit_ptr[si][0] + 1, 0]
                    continue
                break

        pending: List[Optional[Any]] = [None]

        def flush_pending() -> None:
            fin, pending[0] = pending[0], None
            if fin is not None:
                fin()

        def make_finalize(decode_group, adv_steps, ns_flags, anchors_async,
                          res, xa, n_valid, crs_a):
            def finalize() -> None:
                nonlocal empty_segments, total_chars
                anchors = anchors_async.result() if anchors_async is not None else None
                crs = crs_a if anchors is None else step.build_chunk_results(
                    res, xa, n_valid, translated, anchors_all=anchors)
                for j, w in enumerate(decode_group):
                    cr = crs[j]
                    si = w.stream_idx
                    base_offset = w.start + user_offset
                    key = (si, w.chunk_idx, w.window_idx)
                    if ns_flags[j]:
                        results[key] = None
                        if journal is not None:
                            journal.put(w.chunk_idx, w.window_idx, None, si, adv=adv_steps[j])
                        continue
                    text = cr.text.lstrip()
                    approx_start = base_offset + cr.seg_start
                    approx_end = base_offset + cr.seg_end
                    if translated:
                        from .transcribe import interpolate_word_timestamps

                        word_timestamps = interpolate_word_timestamps(
                            text, approx_start, approx_end)
                    else:
                        word_timestamps = [
                            WordTimestamp(text=wt.text, start=wt.start + base_offset,
                                          end=wt.end + base_offset,
                                          probability=wt.probability)
                            for wt in cr.words]
                    if not text.strip():
                        empty_segments += 1
                        logger.warning("empty segment in [%.2f-%.2f]",
                                       approx_start, approx_end)
                    total_chars += len(text)
                    segment = Segment(
                        start=word_timestamps[0].start if word_timestamps else approx_start,
                        end=word_timestamps[-1].end if word_timestamps else approx_end,
                        text=text, words=word_timestamps or None)
                    results[key] = segment
                    if journal is not None:
                        journal.put(w.chunk_idx, w.window_idx, segment, si, adv=adv_steps[j])
            return finalize

        while True:
            if cb.is_cancelled and cb.is_cancelled():
                break
            group = sched.next_batch(batch_size)
            if not group:
                break
            decode_group = []
            for w in group:
                if journal is not None and journal.has(w.chunk_idx, w.window_idx, w.stream_idx):
                    seg, adv_step = journal.get(w.chunk_idx, w.window_idx, w.stream_idx)
                    sched.replay(w, adv_step or len(w.samples))
                    results[(w.stream_idx, w.chunk_idx, w.window_idx)] = seg
                    if self.cfg.sequential_prompt and seg is not None:
                        previous_texts[w.stream_idx] = seg.text
                else:
                    decode_group.append(w)

            if decode_group:
                windows += len(decode_group)
                audio_batch, n_valid = pack_batch(decode_group, batch_size)
                t0 = time.perf_counter()
                mel = step.mel(step.place_audio(audio_batch))
                stage_s["mel"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                xa = step.encode(mel)
                stage_s["encode"] += time.perf_counter() - t0

                # built once, shared by language detection (on the bf16 cache)
                # and the decode (on its int8 form with quantize_kv_cache; the
                # bf16 copy is dropped before the loop); the decode stage's
                # time includes both
                t0 = time.perf_counter()
                cross = step.exact_cross_cache(xa)
                if any(detected_langs[w.stream_idx] is None for w in decode_group):
                    langs = step.detect_language(xa, cross)
                    for j, w in enumerate(decode_group):
                        if detected_langs[w.stream_idx] is None:
                            detected_langs[w.stream_idx] = langs[j] if langs else "en"
                cross = step.decode_cache(cross)
                row_langs = [detected_langs[w.stream_idx] or "en" for w in decode_group
                             ] + ["en"] * (batch_size - len(decode_group))

                if self.cfg.sequential_prompt:
                    row_prev = [
                        step.tk.encode(" " + previous_texts[w.stream_idx].strip())
                        if previous_texts[w.stream_idx] else None
                        for w in decode_group
                    ] + [None] * (batch_size - len(decode_group))
                    if all(p is None for p in row_prev):
                        row_prev = None
                else:
                    row_prev = init_tokens
                if self.cfg.temperature_fallback:
                    res, row_temps = step.decode_with_fallback(
                        xa, row_langs, task, prev_tokens=row_prev,
                        n_valid_rows=len(decode_group), is_cancelled=cb.is_cancelled,
                        cross=cross)
                else:
                    res = step.decode(xa, row_langs, task, prev_tokens=row_prev,
                                      is_cancelled=cb.is_cancelled, cross=cross)
                    row_temps = np.zeros((batch_size,), np.float32)
                del cross  # not held across the alignment pass and the next encode
                if cb.is_cancelled and cb.is_cancelled():
                    break
                align_thunk = step.start_alignment(res, xa, n_valid, translated)
                anchors_async = _AsyncResult(align_thunk) if align_thunk is not None else None
                crs_a = step.build_chunk_results(
                    res, xa, n_valid, translated, anchors_all=[None] * len(n_valid))
                stage_s["decode"] += time.perf_counter() - t0

                adv_steps: List[int] = []
                ns_flags: List[bool] = []
                for j, w in enumerate(decode_group):
                    cr = crs_a[j]
                    si = w.stream_idx
                    seek_samples = int(cr.end_ts * SAMPLE_RATE) if cr.end_ts is not None else None
                    adv_steps.append(sched.advance(w, seek_samples))
                    ns = cr.no_speech_prob > self.cfg.no_speech_threshold and cr.avg_logprob < -1.0
                    ns_flags.append(ns)
                    if ns:
                        continue
                    text = cr.text.lstrip()
                    if not text.strip() or float(row_temps[j]) > 0.5:
                        previous_texts[si] = None
                    else:
                        previous_texts[si] = text

                flush_pending()
                fin = make_finalize(decode_group, adv_steps, ns_flags,
                                    anchors_async, res, xa, n_valid, crs_a)
                if anchors_async is None:
                    fin()
                else:
                    pending[0] = fin
            else:
                flush_pending()
            for si in range(S):
                try_emit(si)

        flush_pending()
        for si in range(S):
            try_emit(si)
        if journal is not None:
            journal.close()
        self.last_run = {"windows": windows, "stage_s": dict(stage_s),
                         "empty_segments": empty_segments,
                         "total_chars": total_chars}
        logger.info("stage seconds: mel=%.3f encode=%.3f decode=%.3f "
                    "(%d windows, %d streams)", stage_s["mel"], stage_s["encode"],
                    stage_s["decode"], windows, S)
        return seg_lists, detected_langs

    # ------------------------------------------------------------------
    def _open_resume_journal(self, options: TranscribeOptions, per_stream_segments):
        """Per-window resume journal keyed by the option / chunk-plan
        fingerprint (same file format as the JAX Engine's)."""
        if not self.cfg.resume_dir:
            return None
        import hashlib

        fingerprint = hashlib.sha1(json.dumps({
            "options": asdict(options),
            "chunks": [(si, ci, seg.start, len(seg.samples))
                       for si, segs in enumerate(per_stream_segments)
                       for ci, seg in enumerate(segs)],
            "dtw": bool(self.cfg.enable_dtw),
            "seek": bool(self.cfg.long_form_seek),
            "seq": bool(self.cfg.sequential_prompt),
        }, sort_keys=True, default=str).encode()).hexdigest()[:16]
        path = Path(self.cfg.resume_dir) / f"wdt-resume-{fingerprint}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        return _ResumeJournal(path)

    # model-cache passthroughs (`engine.rs:202-216`)
    def delete_whisper_model(self, model_name: str) -> None:
        self.models.delete_whisper_model(model_name)

    def list_cached_models(self) -> List[str]:
        return self.models.list_cached_models()

    def delete_cached_model(self, model_name: str) -> bool:
        return self.models.delete_cached_model(model_name)
