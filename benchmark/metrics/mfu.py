"""mfu (%): the whole step's share of the card's peak, the counted model
operations of the window's completed work over the window's wall at the
H100's dense bf16 rate (989 TFLOP/s, at its 700 W limit; the card's
`power.limit` is printed with every run).

Layer: the whole step. Source: host clock for the window's wall (the
same as xrt's); the operations counted from the shapes
(`counts.window_flops`) for every decoded window: encoder, cross K/V,
prompt pass, the decode steps of its beams and the alignment pass, padded
rows not counted. Moves xrt; a later change that takes a kernel off the
path leaves that kernel's roofline silent, and this share still bounds it.
"""

from benchmark.counts import BF16_FLOPS, window_flops

PROMPT_TOKENS = 3  # <|startoftranscript|> <|en|> <|transcribe|>
PROMPT_LOGITS = 2  # the no-speech position and the prompt's last


def read(ctx):
    wall = ctx["window"]["wall_s"]
    if not ctx["decodes"] or not wall or wall != wall:
        return None
    t, c = ctx["traffic"], ctx["config"]
    K = int(t["beam_size"]) if t["strategy"] != "greedy" else 1
    flops = 0.0
    for d in ctx["decodes"]:
        align = PROMPT_TOKENS + d["steps"] + 1 if t["dtw"] else 0
        flops += d["rows"] * window_flops(c, PROMPT_TOKENS, PROMPT_LOGITS, d["steps"], K, align)
    return 100.0 * flops / (wall * BF16_FLOPS)
