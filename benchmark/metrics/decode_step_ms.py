"""decode_step_ms (ms): wall of the synchronized decode span per decode
step.

Layer: prefill and decode loop (`ops/attn.py` K2, `ops/decode.py`,
`transcribe.py`). Source: program span, `TranscribeStep.decode` with a
synchronization before and after it in the traced decode batches (its
prompt pass included), over the steps it ran (`ops/decode.beam_sample` /
`greedy_sample` calls). Moves xrt.
"""


def read(ctx):
    walls = ctx["span_walls"].get("decode", [])
    steps = sum(d["steps"] for d in ctx["decodes"] if d["traced"])
    if not walls or not steps:
        return None
    return 1e3 * sum(walls) / steps
