"""batch_fill (%): windows decoded over the decode batches' rows.

Layer: Engine and scheduler (`engine.py`, `parallel/batching.py`). Source:
program counter, the rows of each decode batch the program packs
(`pack_batch`, counted by the probes) over the window's decode batches
times the traffic's `batch_size`. Moves xrt: the padded rows of a thin
batch cost the card as much as real ones.
"""


def read(ctx):
    decodes = ctx["decodes"]
    if not decodes:
        return None
    rows = sum(d["rows"] for d in decodes)
    return 100.0 * rows / (len(decodes) * int(ctx["traffic"]["batch_size"]))
