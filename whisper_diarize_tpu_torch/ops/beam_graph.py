"""The beam step's decoder forward as one CUDA graph.

`models/whisper.py::decode_step_split` enqueues about 24 launches a layer
(the layer norm, three products with their biases, two slot writes, K4,
K3 with K1 inside), ~800 a large-v3 step, and the host takes longer to
enqueue them than the card takes to run them. Here the forward is captured
once for each batch shape and replayed at every step: one launch from the
host, the same hand-written kernels on the card.

One capture serves every step of every batch of its shape, whatever the
prompt, because nothing the graph launches depends on the step or on the
prompt's length: both live in device memory (`step`, `prompt_len`: one
int32 each, filled by the host before each replay and before each loop),
where the slot writes, the position and K4 read them (K4's launch is
planned for the whole caches, `ops/attn.py::split_self_attn_layer`).
Every tensor the graph reads has one address across replays, the graph's
own buffers:
- the cross K/V (`cross`), which K2 writes in place where the caller
  builds a batch's bf16 cache into it (the Engine, `transcribe.py::
  TranscribeStep.beam_hold`), else copied in once a batch (`load`; the
  Engine's int8 cache, quantized by `TranscribeStep.decode_cache`);
- the prompt half of the split self-cache, `prompt_slots(cfg)` slots: the
  longest prompt the transcriber builds (a longer one runs eagerly); each
  batch's prompt is prefilled as on the eager path and copied into its
  first slots (`set_prompt`);
- the decode half: a batch's slot t is written at its step t before any
  step reads it, so nothing is cleared between batches;
- the row pads (one copy a batch), the tokens and the ancestry map (one
  copy each a step), and the output logits.

A batch shape is (B, beams, Td, the cross cache's form, the dtype and the
device) on one set of weights, and its buffers and graph live as long as
the weights. At its first step the forward runs eagerly on the buffers, so
the kernel library is loaded and every kernel's attributes are set before
the capture; then it is captured and replayed, which writes the step's
cache slots again with the same values. So every step of a loop on the
buffers is a replay. No capture happens while a torch profiler records
(those steps run eagerly, and the capture comes later).

The graph engages wherever `engages` holds: a CUDA device and no head
split (whose all-reduces stay eager). A shape's buffers serve one beam
loop at a time, held for the caller's scope (`hold`): a second hold while
they are held, another thread's or a second state in the same one, gets
none and runs eagerly.

Counters (`tracing`): `decode.graph_replays` a step whose model ran as a
replay, `decode.graph_captures` a capture. The kernel wrappers' Python
launch counters (`<wrapper>.launches`) count a replay's launches as the
eager step counts them.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, Iterator, Optional, Tuple

import torch

from .. import tracing
from ..models import whisper as wm
from ..parallel.mesh import model_parallel
from . import attn, tail

# the kernel wrappers of the captured forward (K4; K3 / K6 with K1 / K5
# inside), whose launch counters a replay adds to
_COUNTED = (attn.split_self_attn_layer, tail.fused_tail_layer)

_lock = threading.Lock()
_graphs: Dict[Tuple, "BeamStepGraph"] = {}


def engages(device: torch.device, mesh) -> bool:
    """Whether a beam loop on `device` under `mesh` replays its forward as
    a graph: on a CUDA device, unless the rank holds a head slice."""
    return device.type == "cuda" and not model_parallel(mesh)


def prompt_slots(cfg: wm.WhisperConfig) -> int:
    """The prompt slots a graph holds: the transcriber's longest prompt,
    the previous text (sot_prev and its last n_text_ctx // 2 - 1 tokens)
    padded to a multiple of 8, then the start sequence (at most 4 tokens:
    sot, language, task, no-timestamps)."""
    return min(cfg.n_text_ctx, -(-(cfg.n_text_ctx // 2) // 8) * 8 + 4)


def _launch_counts() -> Dict[Tuple[int, str], int]:
    return {(i, name): n for i, fn in enumerate(_COUNTED) for name, n in vars(fn).items()
            if "launches" in name and isinstance(n, int)}


def _weights(params) -> Tuple[torch.Tensor, ...]:
    """The decoder tensors a step reads from `params`."""
    dec = params["decoder"]
    return (dec["tok_emb"], dec["pos_emb"], dec["ln_s"], dec["ln_b"],
            *(dec["blocks"][k] for k in sorted(dec["blocks"])))


def _forget(key: Tuple) -> None:
    with _lock:
        _graphs.pop(key, None)


class BeamStepGraph:
    """The static buffers of one batch shape and its captured forward."""

    def __init__(self, params, cfg: wm.WhisperConfig, B: int, beams: int, td: int,
                 int8_cross: bool):
        dec = params["decoder"]
        dev, dtype = dec["tok_emb"].device, dec["tok_emb"].dtype
        N, L, H, Dh = B * beams, cfg.n_text_layer, wm.local_heads(params, cfg), cfg.head_dim
        self.cfg, self.beams, self.td = cfg, beams, td
        self.prompt_slots = prompt_slots(cfg)
        cross = (L, B, H, cfg.n_audio_ctx, Dh)
        # plain tensors, written in place in and out of inference mode
        with torch.inference_mode(False):
            def zeros(shape, dt=dtype):
                return torch.zeros(shape, dtype=dt, device=dev)

            self.tokens = zeros((N, 1), torch.long)
            self.step = zeros((1,), torch.int32)
            self.prompt_len = zeros((1,), torch.int32)
            self.anc = zeros((N, td), torch.long)
            self.row_pad = zeros((N,), torch.long)
            self.prompt_cache = {k: zeros((L, B, H, self.prompt_slots, Dh)) for k in ("k", "v")}
            self.decode_cache = {k: zeros((L, N, H, td, Dh)) for k in ("k", "v")}
            self.cross = ({"k8": zeros(cross, torch.int8), "ks": zeros(cross[:-1], torch.float32),
                           "v8": zeros(cross, torch.int8), "vs": zeros(cross[:-1], torch.float32)}
                          if int8_cross else {"k": zeros(cross), "v": zeros(cross)})
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: Dict[Tuple[int, str], int] = {}  # a replay's launches by counter
        self.held = False

    def owns(self, cross: Dict[str, torch.Tensor]) -> bool:
        """Whether `cross` is this graph's cross K/V."""
        return cross.keys() == self.cross.keys() and all(
            t.data_ptr() == self.cross[k].data_ptr() for k, t in cross.items())

    def takes(self, cross: Dict[str, torch.Tensor], prompt_len: int) -> bool:
        """Whether a batch of this cross K/V and prompt length fits the
        buffers (else the loop runs eagerly)."""
        return (prompt_len <= self.prompt_slots and cross.keys() == self.cross.keys()
                and all(t.shape == self.cross[k].shape and t.dtype == self.cross[k].dtype
                        for k, t in cross.items()))

    def load(self, cross: Dict[str, torch.Tensor], row_pad: torch.Tensor) -> None:
        """A batch's cross K/V (unless K2 wrote it here) and row pads [N]
        into the buffers."""
        if not self.owns(cross):
            for k, t in cross.items():
                self.cross[k].copy_(t)
        self.row_pad.copy_(row_pad)

    def set_prompt(self, cache: Dict[str, torch.Tensor], prompt_len: int) -> None:
        """A batch's prefilled prompt cache {"k", "v"} [L, B, H, prompt_len,
        Dh] into the first slots of the buffer, and its length."""
        for k, t in cache.items():
            self.prompt_cache[k][:, :, :, :prompt_len].copy_(t)
        self.prompt_len.fill_(prompt_len)

    def _forward(self, params) -> torch.Tensor:
        return wm.decode_step_split(params, self.cfg, self.tokens, self.step,
                                    self.prompt_cache, self.decode_cache, self.cross,
                                    self.prompt_len, self.beams, self.row_pad, self.anc)

    def _capture(self, params) -> None:
        self._forward(params)  # eagerly first: nothing loads or sets up under capture
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread-local: the alignment's thread may read the card meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.logits = self._forward(params)
        after = _launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        for (i, name), n in self.launches.items():  # the capture launched nothing
            setattr(_COUNTED[i], name, getattr(_COUNTED[i], name) - n)
        self.graph = graph
        tracing.count("decode.graph_captures")

    def run(self, params, tokens: torch.Tensor, anc: torch.Tensor, step: int) -> torch.Tensor:
        """The forward of beam step `step` on the new beams' tokens [N] and
        the ancestry map [N, Td] -> f32 logits [N, 1, V], the graph's output
        buffer (valid until the next replay)."""
        self.tokens.copy_(tokens[:, None])
        self.anc.copy_(anc)
        self.step.fill_(step)
        if self.graph is None:
            if tracing.profiling():
                return self._forward(params)
            self._capture(params)
        self.graph.replay()
        for (i, name), n in self.launches.items():
            setattr(_COUNTED[i], name, getattr(_COUNTED[i], name) + n)
        tracing.count("decode.graph_replays")
        return self.logits


def _acquire(params, cfg: wm.WhisperConfig, B: int, beams: int, td: int,
             int8_cross: bool) -> Optional[BeamStepGraph]:
    weights = _weights(params)
    key = (B, beams, td, int8_cross, weights[0].dtype, weights[0].device,
           tuple(w.data_ptr() for w in weights))
    with _lock:
        graph = _graphs.get(key)
        if graph is None:
            graph = _graphs[key] = BeamStepGraph(params, cfg, B, beams, td, int8_cross)
            # the graph reads these weights' memory: it goes with them
            weakref.finalize(weights[0], _forget, key)
        if graph.held:
            return None
        graph.held = True
        return graph


@contextlib.contextmanager
def hold(params, cfg: wm.WhisperConfig, B: int, beams: int, td: int, int8_cross: bool,
         device: torch.device, mesh=None) -> Iterator[Optional[BeamStepGraph]]:
    """The graph of this batch shape on `params` (made on first use),
    held until the scope ends; None where it does not engage or is held."""
    graph = _acquire(params, cfg, B, beams, td, int8_cross) if engages(device, mesh) else None
    try:
        yield graph
    finally:
        if graph is not None:
            with _lock:
                graph.held = False
