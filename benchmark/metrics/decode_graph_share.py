"""decode_graph_share (%): the share of the window's decode steps whose
decoder forward ran as one replay of a captured CUDA graph.

Layer: prefill and decode loop (`ops/decode.py::beam_run`,
`ops/beam_graph.py`). Source: program counter, the program's
`decode.graph_replays` (a step whose model ran as a replay) over its
`decode.steps` (every step of a decode loop: in the beam cells, every one a
beam step), summed over the window's requests (`hostspans.window_requests`;
the profiler changes no count, the warm call, which captures, is left
out). A program without the graph (no `ops/beam_graph.py`) gives none.
Moves xrt: a replay is one launch from the host where the eager forward
makes ~800, so the card no longer waits on the host's enqueue.
"""

import importlib.util

from benchmark import hostspans


def read(ctx):
    if importlib.util.find_spec("whisper_diarize_tpu_torch.ops.beam_graph") is None:
        return None
    reqs = hostspans.window_requests(ctx)
    steps = sum(r["counters"].get("decode.steps", 0) for r in reqs)
    if not steps:
        return None
    return 100.0 * sum(r["counters"].get("decode.graph_replays", 0) for r in reqs) / steps
