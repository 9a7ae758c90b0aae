"""cross_attn_roofline (%): the least time of the decode's cross attention
over the device time of the kernels that serve it.

Layer: kernels (`csrc/cross_attn.cu`, K1, also launched inside K3). Source:
device trace, the union of the `cross_attn` kernels inside the traced
decode spans; the work is counted from the shapes
(`counts.cross_attn_work`: every layer's cross K and V of the batch read
once a pass, q read and the output written once): one pass for the prompt
(its tokens as queries) and one a step (the beams as queries), whatever
kernel serves it. Moves xrt.
"""

from benchmark.counts import cross_attn_work, least_s, union_s

PATTERN = "cross_attn"
PROMPT_TOKENS = 3  # <|startoftranscript|> <|en|> <|transcribe|>


def read(ctx):
    tr = ctx["trace"]
    if not tr or "decode" not in tr["spans"]:
        return None
    busy = union_s((s, e) for s, e, n in tr["spans"]["decode"] if PATTERN in n)
    traced = [d for d in ctx["decodes"] if d["traced"]]
    if busy <= 0 or not traced:
        return None
    t, c = ctx["traffic"], ctx["config"]
    B, K = int(t["batch_size"]), int(t["beam_size"])
    least = 0.0
    for d in traced:
        least += least_s(*cross_attn_work(c, B, PROMPT_TOKENS))
        least += d["steps"] * least_s(*cross_attn_work(c, B, K))
    return 100.0 * least / busy
