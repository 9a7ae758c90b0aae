"""encode_ms_per_window (ms): device time of the frontend and the encoder
per window.

Layer: frontend and encoder (`ops/mel.py`, `models/whisper.py::encode`).
Source: device trace, the union of the device operations inside the
`mel` and `encode` spans (`TranscribeStep.mel`, `.encode`) of the traced
decode batches, over the windows those batches decoded. Moves xrt.
"""

from benchmark.counts import union_s


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["traced_windows"]:
        return None
    ev = tr["spans"].get("mel", []) + tr["spans"].get("encode", [])
    if not ev:
        return None
    return 1e3 * union_s((s, e) for s, e, _ in ev) / ctx["traced_windows"]
