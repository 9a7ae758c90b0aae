"""tail_gemm_roofline (%): the least time of the decoder tail's products
over the device time of the kernels that serve them.

Layer: kernels (`csrc/tail.cu`, K3's skinny GEMM). Source: device trace,
the union of the `skinny_gemm` kernels inside the traced decode spans;
the work is counted from the shapes (`counts.tail_gemm_work`: every
decoder layer's five tail weights streamed once a step, each product's
input read and output written once) at the batch's rows (streams times
beams), whatever kernel serves it. Moves xrt.
"""

from benchmark.counts import least_s, tail_gemm_work, union_s

PATTERN = "skinny_gemm"


def read(ctx):
    tr = ctx["trace"]
    if not tr or "decode" not in tr["spans"]:
        return None
    busy = union_s((s, e) for s, e, n in tr["spans"]["decode"] if PATTERN in n)
    t = ctx["traffic"]
    rows = int(t["batch_size"]) * int(t["beam_size"])
    steps = sum(d["steps"] for d in ctx["decodes"] if d["traced"])
    if busy <= 0 or not steps:
        return None
    nbytes, flops = tail_gemm_work(ctx["config"], rows)
    return 100.0 * steps * least_s(nbytes, flops) / busy
