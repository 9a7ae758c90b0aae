"""step_host_ms (ms): host seconds of one decode step, from the program's
own spans in the window's calls, less the steps the profiler recorded.

Layer: prefill and decode loop (`ops/decode.py`: `greedy_run` /
`beam_run`). Source: program span, `decode.step` (the sampling call, the
ancestry map and the model's enqueue, including any wait inside a launch
for room in the launch queue; no host read inside), its seconds over its
count summed over the window's requests, less the steps recorded under the
profiler (`hostspans.step_host_ms`); the warm call is left out. The
window's calls all follow the traced call, and the host's speed drifts
between calls: PERF.md §6 (the tracing findings) gives the early against
the late steps of a loop and the calls before and after a profiled one. Compare two
versions within one chip call. Moves xrt: a step's host cost paces the
card wherever it exceeds the step's device time.
"""

from benchmark import hostspans


def read(ctx):
    return hostspans.step_host_ms(ctx)
