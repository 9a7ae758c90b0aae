"""The card's stream rate over a bf16 array of cross-K/V tiles, three ways:

  torch_sum   one PyTorch reduction, torch.sum(torch.clamp_min(x.float(), s));
  stream_sum  K11a: a grid-stride kernel over the whole card, 16-byte loads,
              several in flight a thread (`ops/stream.py`);
  pipelined   K11b: one CTA an SM streams its share through an nbuf-deep
              ring of shared-memory stages filled by TMA bulk copies, for
              nbuf in NBUFS and each stage size in STAGES.

Counterpart of `tools/bench_dma.py`. Its array, TILES tiles of [20, 64, 512]
bf16 (62.9 MB), is barely larger than the H100's 50 MB L2 cache, so
back-to-back passes may partly hit L2; the tool also runs 4x as many tiles
(252 MB), whose passes come from device memory.

    python -m whisper_diarize_tpu_torch.tools.bench_dma [--tiles 48 192]

Runs on CUDA device 0 and raises without a card; `--device cpu` runs the
plain versions at the sizes given (for the tests), timed by the host clock.
Each row: ms a pass (the slope of CUDA-event times over 8 and 40 passes,
best of 3; marked host-bound where it exceeds the device time by more than
a fifth, the host issuing calls slower than the card runs them), GB/s of
the array's bytes over the profiled device time of a pass
(`timing.device_ms`; over the slope on the CPU), that device time and the
bound (the array's bytes over the data sheet's 3.35 TB/s). The first line
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import functools
from typing import List, Optional, Sequence

import torch

from ..ops import stream
from ..utils import default_device
from . import timing

H, DH, TT = 20, 64, 512  # one cross-K/V tile, large-v3 / turbo geometry
TILES = 48  # 16 streams x 3 tiles
SIZES = (TILES, 4 * TILES)  # the arrays a run measures: 62.9 and 252 MB
NBUFS = (2, 3, 4, 6, 8)
STAGES = (16 * 1024, 24 * 1024)  # bytes a ring stage; 8 x 24 KB fits in 227 KB


def variants():
    """(row name, fn(x, s) -> f32 scalar) in the order the rows print."""
    rows = [("torch_sum", lambda x, s: torch.sum(torch.clamp_min(x.float(), s))),
            ("stream_sum", stream.stream_sum)]
    for nbuf in NBUFS:
        for stage in STAGES:
            rows.append((f"pipelined_nbuf{nbuf}_{stage // 1024}k", functools.partial(
                stream.stream_sum_pipelined, nbuf=nbuf, stage_bytes=stage)))
    return rows


def main(device: Optional[str] = None,
         tiles: Sequence[int] = SIZES) -> List[dict]:
    """Print and return one row a variant and array size."""
    dev = default_device(device, "bench_dma")
    cuda = dev.type == "cuda"
    print(timing.card_line(dev), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for n in tiles:
        x = torch.randn((n, H, DH, TT), generator=g, device=dev, dtype=torch.bfloat16)
        nbytes = x.numel() * x.element_size()
        print(f"array: {tuple(x.shape)} bf16 = {nbytes / 1e6:.1f} MB", flush=True)
        b = timing.sum_bound(nbytes)
        for name, fn in variants():
            call = functools.partial(fn, x, 0.0)
            ms = timing.slope_ms(call, dev)
            dms = timing.device_ms(call, iters=5) if cuda else None
            host = cuda and timing.host_bound(ms, dms)
            row = dict(name=name, tiles=n, bytes=nbytes, ms=ms, host_bound=host,
                       gbps=timing.gb_per_s(nbytes, ms if dms is None else dms),
                       device_ms=dms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            out.append(row)
            print(f"{name:24s} {n:4d} tiles {ms:8.4f} ms/pass"
                  f"{' (host-bound)' if host else '             '} {row['gbps']:8.1f} GB/s  "
                  f"device {'not measured' if dms is None else f'{dms:.4f} ms'}  "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
                  + ("" if cuda else "  [cpu, host clock]"), flush=True)
        del x
    return out


def _args(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cpu for the plain versions (tests)")
    p.add_argument("--tiles", type=int, nargs="+", default=list(SIZES))
    return vars(p.parse_args(argv))


if __name__ == "__main__":
    main(**_args())
