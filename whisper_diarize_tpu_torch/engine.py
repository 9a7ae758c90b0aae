"""Engine: the end-to-end transcription orchestrator of the PyTorch port
(counterpart of `whisper_diarize_tpu/engine.py`).

  audio.wav -> read_wav -> [diarization | VAD | whole-file] speech segments
  -> batched whisper decode (beam search by default, or greedy; +
     temperature fallback, + DTW word timestamps; + a CAM++ speaker
     embedding of each chunk's first window when diarizing) -> optional
     translate post-pass -> language preset + overrides -> process_segments
     cues.

The same `EngineConfig` / `TranscribeOptions` / `Callbacks` surface, model
and step cache, resume journal, callbacks, chunk scheduler, one-deep DTW
pipeline and formatting as the JAX Engine, on the port's own copies of the
host modules (the port imports nothing of the JAX package).
`EngineConfig(use_gpu=True)` (the default) runs on a CUDA card in bf16, or
in f32 with `dtype="float32"` (the kernels' f32 forms, every torch product
in f32: `utils.exact_f32`), and raises without one; `use_gpu=False` runs
on the CPU in f32 through the kernels' plain versions. `quantize_kv_cache=True` decodes over an int8
cross K/V cache (K5, K6) on both devices; language detection reads the
exact bf16 cache. `TranscribeOptions(enable_diarize=True)` cuts each
stream by the segmentation net and gives every segment the `speaker_id` of
its chunk (per-stream online clustering of CAM++ embeddings); both nets run
in f32 on the Engine's device. `draft_model_path` runs greedy windows by
speculative decoding (`ops/speculative.py`, `speculative_gamma` proposals a
verify pass; the output is the target's own), and `whisper_model_path` may
also name a checkpoint file: a whisper.cpp GGML file (its embedded
vocabulary builds the tokenizer) or an OpenAI `.pt` file.

`mesh_shape=(n_data, n_model)` runs the Engine as one rank of a mesh, one
process per GPU (`torchrun --nproc-per-node N`, NCCL; gloo on the CPU): the
process group comes from torchrun's environment (`parallel/distributed.py`),
or a 1 x 1 mesh makes its own. Every rank calls the same entry point with the
same arguments, decodes its rows of each batch over its slice of the heads
(`TranscribeStep(mesh=...)`), and returns the same segments. Files the
Engine writes (downloads, converted weights, the resume journal) are
written by global rank 0 alone, the other ranks behind a barrier. A draft
model is ignored under a mesh, with a warning.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import struct
import threading
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import audio as audio_io
from . import tracing
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
    DiarizeOptions,
    ProgressType,
    Segment,
    SpeechSegment,
    TranscribeOptions,
    WordTimestamp,
)

from .ops import decode as dec
from .parallel.batching import SAMPLE_RATE
from .utils import exact_f32

logger = logging.getLogger(__name__)

UNBOUNDED_SPEAKERS = 2**62  # usize::MAX analogue (`engine.rs:108-111`)


class _AsyncResult:
    """Run a host thunk on a daemon thread; `.result()` joins and re-raises.
    Overlaps batch i's DTW backtrack with batch i+1's decode. The thread's
    spans belong to the request and span that started it (`tracing.carry`).
    `WDT_SERIAL_DTW=1` runs the thunk inline."""

    def __init__(self, thunk):
        self._value = None
        self._error: Optional[BaseException] = None
        thunk = tracing.carry(thunk)
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
    consumed, so a resumed run replays seek-based windowing exactly. Only
    the `writer` (global rank 0 of a mesh) appends to the file; every rank
    keeps the records in memory."""

    def __init__(self, path: Path, writer: bool = True):
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
        self._fh = open(path, "a") if writer else None

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
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        self._done[(ci, wi, si)] = (seg, int(adv))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()


def _random_spec(path: str, model: str) -> Tuple[str, Optional[int]]:
    """(preset, seed or None) of a "__random__[:preset[:seed]]" model path;
    the preset defaults to `model`."""
    parts = path.split(":")
    return (parts[1] if len(parts) > 1 and parts[1] else model,
            int(parts[2]) if len(parts) > 2 else None)


@dataclass
class EngineConfig:
    """The JAX Engine's knobs (`engine.rs:9-33` plus extensions)."""

    cache_dir: str = "./cache"
    enable_dtw: Optional[bool] = True
    enable_flash_attn: Optional[bool] = False  # accepted, changes nothing: K1 always runs
    use_gpu: Optional[bool] = True  # CUDA (required) vs CPU plain path
    gpu_device: Optional[int] = None  # CUDA device ordinal
    vad_model_path: Optional[str] = None
    diarize_segment_model_path: Optional[str] = None
    diarize_embedding_model_path: Optional[str] = None
    # snapshot dir, GGML or OpenAI .pt file, or "__random__[:preset[:seed]]"
    # (random weights: the benchmark's pattern, or with a seed the JAX
    # init's distribution, whose logits do not tie)
    whisper_model_path: Optional[str] = None
    batch_size: int = 8
    dtype: Optional[str] = None  # "bfloat16" | "float32" (auto by device)
    sequential_prompt: bool = False
    max_decode_tokens: int = 224
    resume_dir: Optional[str] = None
    temperature_fallback: bool = True
    no_speech_threshold: float = 0.6
    # (n_data, n_model): one rank of a mesh; batch_size divisible by n_data
    mesh_shape: Optional[Tuple[int, int]] = None
    long_form_seek: bool = True
    # speculative greedy decoding: a snapshot dir of a smaller model sharing
    # the vocabulary proposes speculative_gamma tokens a verify pass
    draft_model_path: Optional[str] = None
    speculative_gamma: int = 4
    # int8 cross-K/V decode cache (K5, K6) on either device; language
    # detection reads the exact bf16 cache
    quantize_kv_cache: bool = False
    allow_random_weights: bool = False


class Engine:
    """Public orchestrator (`engine.rs:52-217`)."""

    def __init__(self, cfg: Optional[EngineConfig] = None):
        self.cfg = cfg or EngineConfig()
        if self.cfg.use_gpu is False:
            self.device = torch.device("cpu")
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "EngineConfig(use_gpu=True) needs a CUDA device and none is "
                    "available; pass use_gpu=False for the CPU path")
            # under torchrun each process takes its own card (ranks beyond
            # the node's cards share them); an explicit gpu_device wins
            ordinal = self.cfg.gpu_device
            if ordinal is None:
                ordinal = int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count()
            self.device = torch.device("cuda", ordinal)
        self.mesh = self._make_mesh() if self.cfg.mesh_shape is not None else None
        if self.cfg.enable_flash_attn:
            # as the JAX Engine: accepted for API parity, changes nothing
            logger.warning(
                "enable_flash_attn=True has no effect: the decoder's cross "
                "attention always runs on its flash kernel (K1) on CUDA and on "
                "its plain version on the CPU")
        self.models = ModelManager(self.cfg.cache_dir)
        self._whisper_cache: dict = {}
        self._step_cache: dict = {}
        self._draft_cache: Optional[Tuple[str, Any]] = None  # (path, (params, cfg))
        # the last request's view of its tracing summary (`_view`)
        self.last_run: Dict[str, Any] = {}

    def _make_mesh(self):
        """The rank's mesh of `mesh_shape`, refusing before any work a batch
        the data axis does not divide and a preset the model axis cannot
        split."""
        from .models import whisper as wm
        from .parallel import distributed, mesh as mesh_mod

        n_data, n_model = self.cfg.mesh_shape
        if n_data < 1 or n_model < 1 or self.cfg.batch_size % n_data:
            raise ValueError(f"batch_size {self.cfg.batch_size} must be divisible by "
                             f"the mesh data axis {n_data} (mesh {n_data}x{n_model})")
        path = self.cfg.whisper_model_path or ""
        if path.startswith("__random__:"):
            mesh_mod.check_model_split(wm.PRESETS[_random_spec(path, "")[0]], n_model)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        distributed.initialize(backend=mesh_mod.default_backend(self.device.type))
        return mesh_mod.make_mesh(n_data, n_model, self.device.type, self.device)

    @contextlib.contextmanager
    def _rank0_first(self):
        """Global rank 0 runs the block first (downloads, conversions and
        files it writes), the other ranks after it, behind a barrier."""
        if self._rank() != 0:
            self._barrier()
        try:
            yield
        finally:
            if self._rank() == 0:
                self._barrier()

    def _rank(self) -> int:
        return dist.get_rank() if self.mesh is not None else 0

    def _barrier(self) -> None:
        if self.mesh is not None and dist.get_world_size() > 1:
            dist.barrier()

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
        model or dtype evicts it and the step cache); under a mesh the
        rank's slice of it."""
        key = self._whisper_key(options)
        hit = self._whisper_cache.get(key)
        if hit is not None:
            return hit
        with self._rank0_first():
            out = self._load_whisper_uncached(options, progress, is_cancelled)
        if self.mesh is not None:  # keep only the rank's slice
            from .parallel import mesh as mesh_mod

            mesh_mod.check_model_split(out[1], self.mesh.n_model)
            out = (mesh_mod.shard_params(out[0], self.mesh),) + out[1:]
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
            # random weights at a preset's geometry, filled on the device,
            # with the byte-level DebugTokenizer: the benchmark's pattern, or
            # with a seed draws of the JAX init's distribution
            name, seed = _random_spec(path, options.model)
            cfg = wm.PRESETS[name]
            params = (weights_mod.init_params_fast(cfg, self.device, dtype) if seed is None
                      else weights_mod.init_params_normal(cfg, self.device, dtype, seed))
            return params, cfg, DebugTokenizer(num_languages=cfg.num_languages)
        snap = Path(path) if path else self.models.ensure_whisper_model(
            options.model, progress, is_cancelled)
        if snap.is_file():
            from .models import ggml
            from .tokenizer import VocabTokenizer

            with open(snap, "rb") as f:
                magic = f.read(4)
            if magic == struct.pack("<i", ggml.GGML_MAGIC):
                # the reference's own format; its vocabulary builds the tokenizer
                params, cfg, vocab = ggml.load_ggml(snap, self.device, dtype)
                return params, cfg, VocabTokenizer(vocab, multilingual=cfg.multilingual,
                                                   num_languages=cfg.num_languages)
            params, cfg = weights_mod.load_openai_pt(snap, self.device, dtype)
            return params, cfg, load_tokenizer(None, multilingual=cfg.multilingual,
                                               num_languages=cfg.num_languages)
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
            self.cfg.draft_model_path, self.cfg.speculative_gamma, self.cfg.mesh_shape,
        )
        hit = self._step_cache.get(step_key)
        if hit is not None:
            return hit
        # `advanced=None` and any strategy but "greedy" run beam search
        # (beam 5 by default, temperature 0), as in the JAX Engine
        greedy = bool(adv and adv.sampling_strategy == "greedy")
        temperature = float(adv.temperature) if greedy and adv.temperature else 0.0
        dc = dec.DecodeConfig(
            beam_size=max((adv.best_of_or_beam_size if adv else None) or 5, 1),
            temperature=temperature,
            max_tokens=self.cfg.max_decode_tokens,
            blank_id=32 if isinstance(tokenizer, DebugTokenizer) else 220,
            quantize_cross_kv=bool(self.cfg.quantize_kv_cache),
        )
        draft = None
        if self.cfg.draft_model_path:
            if greedy and temperature == 0.0 and self.mesh is None:
                draft = self._load_draft(cfg)
            else:
                logger.warning(
                    "draft_model_path set but speculative decoding needs greedy strategy, "
                    "temperature 0 and no mesh (strategy=%s, temperature=%s, mesh=%s) — "
                    "ignoring", "greedy" if greedy else "beam_search", temperature,
                    self.cfg.mesh_shape)
        step = TranscribeStep(
            params, cfg, tokenizer, model_name=options.model,
            enable_dtw=bool(self.cfg.enable_dtw), decode_config=dc,
            strategy="greedy" if greedy else "beam_search",
            max_text_ctx=adv.max_text_ctx if adv else None,
            draft=draft, spec_gamma=self.cfg.speculative_gamma, mesh=self.mesh,
        )
        self._step_cache[step_key] = step
        return step

    def _load_draft(self, target_cfg):
        """The speculative draft (params, cfg) on the Engine's device and
        dtype, loaded once per path; None, with a warning, when its
        vocabulary differs from the target's."""
        from .models import weights as weights_mod

        path = str(self.cfg.draft_model_path)
        if self._draft_cache is None or self._draft_cache[0] != path:
            self._draft_cache = (path, weights_mod.load_model(
                Path(path), self.device, self._resolve_dtype()))
        entry = self._draft_cache[1]
        if entry[1].n_vocab != target_cfg.n_vocab:
            logger.warning("draft model vocab %d != target %d; speculative decoding disabled",
                           entry[1].n_vocab, target_cfg.n_vocab)
            return None
        return entry

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

    def _resolve_diarization(self, options: TranscribeOptions, cb: Callbacks
                             ) -> Tuple[DiarizeOptions, Any]:
        """The diarization options and the segmentation weights on the
        Engine's device. Both model paths given: used as they are (.npz,
        the reference's .onnx, or "__random__"); else downloaded by the
        ModelManager (`engine.rs:94-100`). Unloadable weights raise
        WeightIngestError unless `allow_random_weights`."""
        from .models import convert as convert_mod

        if self.cfg.diarize_segment_model_path and self.cfg.diarize_embedding_model_path:
            seg_path = self.cfg.diarize_segment_model_path
            emb_path = self.cfg.diarize_embedding_model_path
        else:
            seg_p, emb_p = self.models.ensure_diarize_models(
                progress=cb.progress, is_cancelled=cb.is_cancelled)
            seg_path, emb_path = str(seg_p), str(emb_p)
        adv = options.advanced
        diarize_options = DiarizeOptions(
            segment_model_path=seg_path, embedding_model_path=emb_path,
            threshold=(adv.diarize_threshold if adv else None) or 0.5,
            max_speakers=options.max_speakers or UNBOUNDED_SPEAKERS)
        seg_params = convert_mod.load_segmentation_params(
            seg_path, allow_random=self.cfg.allow_random_weights, device=self.device)
        return diarize_options, seg_params

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

        with tracing.request(files=len(audio_paths)) as req:
            out = self._transcribe_request(audio_paths, options, formatting_overrides, cb)
        self.last_run = self._view(req.summary())
        logger.info("stage host seconds: %s (%d windows, %d streams)",
                    " ".join(f"{k}={v:.3f}" for k, v in self.last_run["stage_s"].items()),
                    self.last_run["windows"], len(audio_paths))
        return out

    # `last_run["stage_s"]`: host seconds of each stage, summed over the
    # request's spans of these names (`tracing`)
    STAGE_SPANS = {
        "segment": ("segment",), "vad": ("vad",), "mel": ("mel",), "encode": ("encode",),
        "cross_kv": ("cross_kv",), "lang": ("lang",), "decode": ("decode",),
        "align": ("align.launch", "align.wait"),
        "chunk_results": ("engine.chunk_results",),
        "embed": ("embed.dispatch", "embed.assign"),
        "format": ("engine.format",),
    }

    @classmethod
    def _view(cls, summary: Dict[str, Any]) -> Dict[str, Any]:
        """`last_run`: the request's windows decoded (the rows of its decode
        batches), `stage_s` (host seconds a stage: each span's enqueue and
        host work, and the device time only where the host waits on the
        device inside it; 0.0 for a stage that did not run), its counters
        and the request's id (its summary in `tracing.requests()`, its
        recorded events in `tracing.events()`)."""
        spans, counters = summary["spans"], summary["counters"]
        return {
            "windows": counters.get("batch.rows", 0),
            "stage_s": {k: sum((spans[n]["seconds"] for n in names if n in spans), 0.0)
                        for k, names in cls.STAGE_SPANS.items()},
            "counters": dict(counters),
            "request": summary["id"],
        }

    def _transcribe_request(self, audio_paths, options, formatting_overrides,
                            cb: Callbacks) -> List[List[Segment]]:
        # an f32 Engine's torch products in f32 on the card: cuDNN's
        # convolutions (the encoder's conv1d) would take TF32 by default
        f32 = self._resolve_dtype() == torch.float32
        with torch.inference_mode(), (exact_f32() if f32 else contextlib.nullcontext()):
            with tracing.span("engine.load"):
                params, model_cfg, tokenizer = self._load_whisper(
                    options, cb.progress, cb.is_cancelled)
                step = self._make_step(params, model_cfg, tokenizer, options)
            with tracing.span("engine.read_wav"):
                all_samples = [audio_io.read_wav(p) for p in audio_paths]
            per_stream_segments: List[List[SpeechSegment]] = []
            vad_masks: List[Optional[VadMaskOracle]] = []
            diarize_options: Optional[DiarizeOptions] = None
            if options.enable_diarize:
                # every stream's windows through the segmentation net at once
                from . import diarize as diarize_mod

                with tracing.span("engine.load"), self._rank0_first():
                    diarize_options, seg_params = self._resolve_diarization(options, cb)
                with tracing.span("segment"):
                    per_stream_segments = diarize_mod.get_segments_batch(
                        all_samples, SAMPLE_RATE, seg_params, device=self.device)
                vad_masks = [None] * len(audio_paths)
            elif options.enable_vad:
                from . import vad as vad_mod

                with tracing.span("engine.load"), self._rank0_first():
                    vad_model = vad_mod.load_vad_params(self._resolve_vad_model(cb),
                                                        self.device)
                with tracing.span("vad"):
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
                step, per_stream_segments, options, diarize_options, cb)

        whisper_to_en = bool(options.whisper_to_english)
        out: List[List[Segment]] = []
        with tracing.span("engine.format"):
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
        options: TranscribeOptions, diarize_options: Optional[DiarizeOptions],
        cb: Callbacks,
    ) -> Tuple[List[List[Segment]], List[Optional[str]]]:
        """Batched multi-stream pipeline: windows of all streams fill the
        same decode batches; language latches per stream; speakers cluster
        per stream; overlap clamping and prompt carry are per stream;
        segments are emitted in order."""
        from .parallel.batching import WindowScheduler, pack_batch

        S = len(per_stream_segments)
        user_offset = options.offset or 0.0
        translated = bool(options.whisper_to_english)
        task = "translate" if translated else "transcribe"
        preset_lang = options.lang if options.lang and options.lang != "auto" else None
        detected_langs: List[Optional[str]] = [preset_lang] * S

        # diarization: one CAM++ net, speaker clusters per stream
        emb_params, emb_managers = None, []
        chunk_speakers: Dict[Tuple[int, int], str] = {}  # (stream, chunk) -> id
        if diarize_options is not None:
            from .diarize import EmbeddingManager
            from .models import convert as convert_mod

            with tracing.span("engine.load"), self._rank0_first():
                emb_params = convert_mod.load_campplus_params(
                    diarize_options.embedding_model_path,
                    allow_random=self.cfg.allow_random_weights, device=self.device)
            emb_managers = [EmbeddingManager(diarize_options.max_speakers) for _ in range(S)]

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

        def assign(key, emb) -> None:
            manager = emb_managers[key[0]]
            if len(manager.get_all_speakers()) == diarize_options.max_speakers:
                sid = manager.get_best_speaker_match(emb)
            else:
                sid = manager.search_speaker(emb, diarize_options.threshold)
            chunk_speakers[key] = str(sid) if sid is not None else "?"

        def plan_embeddings(group):
            """The (stream, chunk) keys that need an embedding this batch:
            `fresh` ones ride the batch's device audio (the chunk's first
            window), `late` ones (a resumed chunk whose first window was
            replayed) take the chunk's own samples."""
            fresh: List[Tuple[int, Tuple[int, int]]] = []
            late: List[Tuple[int, int]] = []
            seen = set()
            for j, w in enumerate(group):
                key = (w.stream_idx, w.chunk_idx)
                if key in chunk_speakers or key in seen:
                    continue
                seen.add(key)
                if w.window_idx == 0:
                    fresh.append((j, key))
                else:
                    late.append(key)
            return fresh, late

        def dispatch_embeddings(fresh, audio_dev, n_valid):
            """Enqueue the CAM++ pass over the decode batch's own device audio:
            one embedding per chunk, from its first window (the net's context
            is capped at ~20 s). Enqueued before the host alignment pass, so
            the card computes while the host backtracks."""
            from .models import campplus

            if not fresh:
                return None
            return campplus.embed_from_audio(emb_params, audio_dev, n_valid)

        def assign_speakers(fresh, late, embs_dev) -> None:
            from .models import campplus

            if fresh:
                embs = tracing.to_host(embs_dev, "embed")
                for j, key in fresh:
                    assign(key, embs[j])
            if late:
                embs = campplus.compute_embeddings_batch(
                    emb_params, [np.asarray(per_stream_segments[si][ci].samples, np.int16)
                                 for si, ci in late], device=self.device)
                for key, emb in zip(late, embs):
                    assign(key, emb)

        pending: List[Optional[Any]] = [None]

        def flush_pending() -> None:
            fin, pending[0] = pending[0], None
            if fin is not None:
                fin()

        def make_finalize(decode_group, adv_steps, ns_flags, anchors_async,
                          res, xa, n_valid, crs_a):
            def finalize() -> None:
                anchors = None
                if anchors_async is not None:
                    with tracing.span("align.wait"):
                        anchors = anchors_async.result()
                crs = crs_a
                if anchors is not None:
                    with tracing.span("engine.chunk_results"):
                        crs = step.build_chunk_results(
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
                        logger.warning("empty segment in [%.2f-%.2f]",
                                       approx_start, approx_end)
                    segment = Segment(
                        start=word_timestamps[0].start if word_timestamps else approx_start,
                        end=word_timestamps[-1].end if word_timestamps else approx_end,
                        text=text, words=word_timestamps or None,
                        speaker_id=(chunk_speakers.get((si, w.chunk_idx))
                                    if diarize_options is not None else None))
                    results[key] = segment
                    if journal is not None:
                        journal.put(w.chunk_idx, w.window_idx, segment, si, adv=adv_steps[j])
            return finalize

        while True:
            if cb.is_cancelled and cb.is_cancelled():
                break
            with tracing.span("engine.schedule"):
                group = sched.next_batch(batch_size)
                decode_group = []
                for w in group:
                    if journal is not None and journal.has(w.chunk_idx, w.window_idx,
                                                           w.stream_idx):
                        seg, adv_step = journal.get(w.chunk_idx, w.window_idx, w.stream_idx)
                        sched.replay(w, adv_step or len(w.samples))
                        results[(w.stream_idx, w.chunk_idx, w.window_idx)] = seg
                        if self.cfg.sequential_prompt and seg is not None:
                            previous_texts[w.stream_idx] = seg.text
                    else:
                        decode_group.append(w)
                if decode_group:
                    audio_batch, n_valid = pack_batch(decode_group, batch_size)
            if not group:
                break

            if decode_group:
                with tracing.span("batch", rows=len(decode_group)):
                    tracing.count("batch.rows", len(decode_group))
                    tracing.count("batch.slots", batch_size)
                    with tracing.span("mel"):
                        audio_dev = step.place_audio(audio_batch)
                        mel = step.mel(audio_dev)
                    with tracing.span("encode"):
                        xa = step.encode(mel)
                    # lazy: a batch that falls back to plain greedy (per-row
                    # prompts) never pays a draft encode
                    xa_d = ((lambda a=audio_dev: step.encode_draft(a))
                            if step.draft is not None else None)

                    # the beam step's graph (or None) held through the decode:
                    # its cross K/V buffers take this batch's cache
                    with step.beam_hold(xa) as graph:
                        # built once, shared by language detection (on the bf16
                        # cache) and the decode (on its int8 form with
                        # quantize_kv_cache; the bf16 copy is dropped before the loop)
                        with tracing.span("cross_kv"):
                            cross = step.exact_cross_cache(xa, graph)
                        if any(detected_langs[w.stream_idx] is None for w in decode_group):
                            with tracing.span("lang"):
                                langs = step.detect_language(xa, cross)
                            for j, w in enumerate(decode_group):
                                if detected_langs[w.stream_idx] is None:
                                    detected_langs[w.stream_idx] = langs[j] if langs else "en"
                        with tracing.span("cross_kv"):
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
                        with tracing.span("decode"):
                            if self.cfg.temperature_fallback:
                                res, row_temps = step.decode_with_fallback(
                                    xa, row_langs, task, prev_tokens=row_prev,
                                    n_valid_rows=len(decode_group),
                                    is_cancelled=cb.is_cancelled, cross=cross, xa_d=xa_d,
                                    graph=graph)
                            else:
                                res = step.decode(xa, row_langs, task, prev_tokens=row_prev,
                                                  is_cancelled=cb.is_cancelled, cross=cross,
                                                  xa_d=xa_d, graph=graph)
                                row_temps = np.zeros((batch_size,), np.float32)
                        del cross  # not held across the alignment pass and the next encode
                    if cb.is_cancelled and cb.is_cancelled():
                        break
                    emb_plan = emb_dev = None
                    if diarize_options is not None:
                        # the embedding pass first: it overlaps the host token pass
                        with tracing.span("embed.dispatch"):
                            emb_plan = plan_embeddings(decode_group)
                            emb_dev = dispatch_embeddings(emb_plan[0], audio_dev, n_valid)
                    with tracing.span("align.launch"):
                        align_thunk = step.start_alignment(res, xa, n_valid, translated)
                        anchors_async = (_AsyncResult(align_thunk)
                                         if align_thunk is not None else None)
                    with tracing.span("engine.chunk_results"):
                        crs_a = step.build_chunk_results(
                            res, xa, n_valid, translated, anchors_all=[None] * len(n_valid))
                    if diarize_options is not None:
                        with tracing.span("embed.assign"):
                            assign_speakers(emb_plan[0], emb_plan[1], emb_dev)

                    adv_steps: List[int] = []
                    ns_flags: List[bool] = []
                    with tracing.span("engine.schedule"):
                        for j, w in enumerate(decode_group):
                            cr = crs_a[j]
                            si = w.stream_idx
                            seek_samples = (int(cr.end_ts * SAMPLE_RATE)
                                            if cr.end_ts is not None else None)
                            adv_steps.append(sched.advance(w, seek_samples))
                            ns = (cr.no_speech_prob > self.cfg.no_speech_threshold
                                  and cr.avg_logprob < -1.0)
                            ns_flags.append(ns)
                            if ns:
                                continue
                            text = cr.text.lstrip()
                            if not text.strip() or float(row_temps[j]) > 0.5:
                                previous_texts[si] = None
                            else:
                                previous_texts[si] = text

                    with tracing.span("engine.finalize"):
                        flush_pending()
                        fin = make_finalize(decode_group, adv_steps, ns_flags,
                                            anchors_async, res, xa, n_valid, crs_a)
                        if anchors_async is None:
                            fin()
                        else:
                            pending[0] = fin
            else:
                with tracing.span("engine.finalize"):
                    flush_pending()
            with tracing.span("engine.emit"):
                for si in range(S):
                    try_emit(si)

        with tracing.span("engine.finalize"):
            flush_pending()
        with tracing.span("engine.emit"):
            for si in range(S):
                try_emit(si)
        if journal is not None:
            journal.close()
            self._barrier()  # the journal is whole before any rank reads it again
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
        journal = _ResumeJournal(path, writer=self._rank() == 0)
        self._barrier()  # every rank has read it before rank 0 appends
        return journal

    # model-cache passthroughs (`engine.rs:202-216`)
    def delete_whisper_model(self, model_name: str) -> None:
        self.models.delete_whisper_model(model_name)

    def list_cached_models(self) -> List[str]:
        return self.models.list_cached_models()

    def delete_cached_model(self, model_name: str) -> bool:
        return self.models.delete_cached_model(model_name)
