"""launches_per_step (launches): kernels the card ran inside the decode
spans per decode step.

Layer: prefill and decode loop (`ops/decode.py`, `models/whisper.py`).
Source: device trace, the kernels (copies and fills left out) inside the
traced `TranscribeStep.decode` spans, over their steps. Moves xrt: the
host issues each launch, and between launches the card waits.
"""


def read(ctx):
    tr = ctx["trace"]
    steps = sum(d["steps"] for d in ctx["decodes"] if d["traced"])
    if not tr or not steps or "decode" not in tr["spans"]:
        return None
    kernels = [n for _, _, n in tr["spans"]["decode"] if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels) / steps
