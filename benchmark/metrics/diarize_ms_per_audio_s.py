"""diarize_ms_per_audio_s (ms/s): wall of the segmentation pass and the
embedding dispatches per second of audio.

Layer: diarization (`diarize.py`, `models/segmentation.py`,
`models/campplus.py`). Source: program span, `diarize.get_segments_batch`
and `models/campplus.embed_from_audio`, each synchronized before and
after, in the traced call (whose first decode batches hold every file's
first window, so every embedding), over the call's audio seconds. Moves
xrt in diarized cells.
"""


def read(ctx):
    walls = ctx["span_walls"]
    if not walls.get("segment") or not ctx["traced_audio_s"]:
        return None
    return 1e3 * (sum(walls["segment"]) + sum(walls.get("embed", []))) / ctx["traced_audio_s"]
