"""host_syncs_per_batch (syncs): the device-to-host reads the program
makes per decode batch.

Layer: Engine and scheduler (`engine.py`, `transcribe.py`, `ops/decode.py`,
`diarize.py`). Source: program counter, the program's `host_sync` counter
(the decode polls, the chunk results', alignment's, language detection's,
the fallback ladder's, the embeddings' and the segmentation forwards'
reads) over its `batch` spans, summed over the window's requests
(`hostspans.window_requests`; the profiler changes no count). Moves xrt:
each read waits for the device's queue to drain, and the card idles
until the host launches again.
"""

from benchmark import hostspans


def read(ctx):
    return hostspans.host_syncs_per_batch(ctx)
