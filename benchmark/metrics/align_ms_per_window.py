"""align_ms_per_window (ms): device time of word alignment per window.

Layer: word alignment (`transcribe.py::start_alignment`, `ops/dtw.py`).
Source: device trace, the union of the device operations inside the
`start_alignment` spans of the traced decode batches (the teacher-forced
pass, the cost reduction and the DTW kernel; its thunk only copies the
anchors back), over the windows those batches decoded. Moves xrt.
"""

from benchmark.counts import union_s


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["traced_windows"] or "align" not in tr["spans"]:
        return None
    return 1e3 * union_s((s, e) for s, e, _ in tr["spans"]["align"]) / ctx["traced_windows"]
