"""engine_idle_ms_per_batch (ms): device idle while the Engine does host
work, per traced decode batch.

Layer: Engine and scheduler (`engine.py`). Source: device trace, the gaps
between the traced stretch's device operations, set against the program's
own spans on the profiler's clock: the idle during which the main
thread's innermost open span was `engine.load`, `engine.read_wav`,
`engine.schedule`, `engine.chunk_results`, `engine.finalize` or
`engine.emit` (`hostspans.ENGINE_HOST`), over the traced decode batches.
Moves xrt: the card waits through that host work.
"""

from benchmark import hostspans


def read(ctx):
    return hostspans.engine_idle_ms_per_batch(ctx)
