"""Take K1, the decoder's flash cross-attention of one layer, apart on the
card: its stream, its access pattern, the latency of a CTA's compute, its
layer indexing and its grid.

  cross_attn_layer   K1 itself (`ops/attn.py`);
  presliced          K9a: K1 over the layer's K/V sliced out on the host;
  stream             K11a over the layer's K and V: what the card's stream
                     takes for the same bytes;
  stream+sum         K9b: the layer's K/V bytes walked as K1 walks them (one
                     CTA per (b, h), 64-key tiles), summed, no attention;
  1-tile compute     K9a over the first 512 keys only: the latency floor of a
                     CTA, not a stream;
  const layer        K9c: K1 with the layer a compile-time constant;
  flat               K9d: the audio axis split, one CTA per 512-key span,
                     then a combine;
  sdpa               F.scaled_dot_product_attention over the same layer
                     (the library yardstick; the port never calls it).

Counterpart of `tools/bench_attn_kernel.py`, at its shapes by default: L 4,
B 16, Q 1, H 20, Dh 64, 1536 keys of which 1500 are unmasked, layer 1
(125.8 MB of K/V a call). `--batch 8 --queries 3 --layers 32 --keys 1500`
is K1's shape on the served paths (large-v3, 8 streams, a 3-token prompt).

    python -m whisper_diarize_tpu_torch.tools.bench_attn_kernel [--batch 8 ...]

Runs on CUDA device 0 and raises without a card; `--device cpu` runs the
plain versions (for the tests), timed by the host clock. Each row: ms a call
(the slope of CUDA-event times over 8 and 40 calls, best of 3; marked
host-bound where it exceeds the device time by more than a fifth), GB/s of
the layer's K/V bytes over the profiled device time of a call
(`timing.device_ms_by_kernel`; over the slope on the CPU), that device time
(split by kernel where a row launches more than one) and the bound
(`timing.attn_bound` / `sum_bound`). The first line names the card and its
power limit, the next how many global loads K1's and K9b's tile-staging
loops issue before a shared-memory store (the loads a thread keeps in
flight), read from `cuobjdump -sass` of the built kernels.
"""

from __future__ import annotations

import argparse
import functools
import re
import subprocess
import types
from pathlib import Path
from typing import List, Optional

import torch
import torch.nn.functional as F

from .. import kernels
from ..ops import attn, attn_probe, stream
from ..utils import default_device
from . import timing

L, B, Q, H, DH = 4, 16, 1, 20, 64
KEYS, VALID = 1536, attn_probe.TA_TOTAL  # padded keys, unmasked keys
LAYER = attn_probe.CONST_LAYER  # every row reads the layer K9c fixes
SERVED = dict(batch=8, queries=3, layers=32, keys=VALID)  # K1 on the served paths
# (label, mangled-name fragment) of the kernels whose staging `staging_loads` reads
STAGING = (("K1 cross_attn_kernel<bf16>", "cross_attn_kernelI13__nv_bfloat16Lin1ELb0E"),
           ("K9b kv_stream_sum_kernel", "kv_stream_sum_kernel"))


def setup(device: torch.device, layers: int = L, batch: int = B, queries: int = Q,
          keys: int = KEYS) -> types.SimpleNamespace:
    """The tool's inputs at one shape (random bf16, seed 0): q [batch,
    queries, H, DH], the cache k, v [layers, batch, H, keys, DH], the layer
    read (kl, vl), its first KEY_TILE keys (k1, v1) and the unmasked count."""
    if layers <= LAYER or keys < attn.KEY_TILE:
        raise ValueError(f"bench_attn_kernel: needs layers > {LAYER} and keys >= "
                         f"{attn.KEY_TILE}, got {layers} and {keys}")
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)

    k, v = randn(layers, batch, H, keys, DH), randn(layers, batch, H, keys, DH)
    q = randn(batch, queries, H, DH)
    kl, vl = k[LAYER], v[LAYER]
    k1, v1 = (t[:, :, :attn.KEY_TILE].contiguous() for t in (kl, vl))
    return types.SimpleNamespace(q=q, k=k, v=v, kl=kl, vl=vl, k1=k1, v1=v1,
                                 ta=min(keys, VALID), layers=layers, batch=batch,
                                 queries=queries, keys=keys)


def forms(t: types.SimpleNamespace) -> list:
    """(row name, call, plain version or None, bound) in the order the rows
    print; each call and plain version takes no argument."""
    q, k, v, kl, vl, k1, v1 = t.q, t.k, t.v, t.kl, t.vl, t.k1, t.v1
    qt, ks, vs = q.transpose(1, 2), kl[:, :, :t.ta], vl[:, :, :t.ta]
    layer_bytes = 2 * kl.numel() * kl.element_size()
    att = timing.attn_bound(t.batch, t.queries, H, t.ta, 128)
    return [
        ("cross_attn_layer", lambda: attn.cross_attn_layer(LAYER, q, k, v, VALID),
         lambda: attn.cross_attn_layer_plain(LAYER, q, k, v, t.ta), att),
        ("presliced", lambda: attn_probe.cross_attn_presliced(q, kl, vl, VALID),
         lambda: attn_probe.cross_attn_presliced_plain(q, kl, vl, VALID), att),
        ("stream", lambda: (stream.stream_sum(kl, 0.0), stream.stream_sum(vl, 0.0)),
         lambda: (stream.stream_sum_plain(kl, 0.0), stream.stream_sum_plain(vl, 0.0)),
         timing.sum_bound(layer_bytes)),
        ("stream+sum", lambda: stream.kv_stream_sum(LAYER, k, v, 0.0),
         lambda: stream.kv_stream_sum_plain(LAYER, k, v, 0.0), timing.sum_bound(layer_bytes)),
        ("1-tile compute", lambda: attn_probe.cross_attn_presliced(q, k1, v1, VALID),
         lambda: attn_probe.cross_attn_presliced_plain(q, k1, v1, VALID),
         timing.attn_bound(t.batch, t.queries, H, attn.KEY_TILE, 128)),
        ("const layer", lambda: attn_probe.cross_attn_const_layer(q, k, v, VALID),
         lambda: attn_probe.cross_attn_const_layer_plain(q, k, v, VALID), att),
        ("flat", lambda: attn_probe.cross_attn_flat(LAYER, q, k, v, VALID),
         lambda: attn_probe.cross_attn_flat_plain(LAYER, q, k, v, VALID), att),
        ("sdpa", lambda: F.scaled_dot_product_attention(qt, ks, vs), None, att),
    ]


def loads_before_store(sass: str, frag: str) -> int:
    """The longest run of global loads (LDG) between two shared-memory
    stores (STS) in the SASS of the kernel whose mangled name holds `frag`."""
    body = re.search(r"Function : \S*" + re.escape(frag) + r"\S*\n(.*?)(?=Function : |\Z)",
                     sass, re.S)
    if body is None:
        raise RuntimeError(f"bench_attn_kernel: no kernel {frag} in the SASS")
    run = best = 0
    for op in re.findall(r"\b(LDG|STS)\b", body.group(1)):
        run = run + 1 if op == "LDG" else 0
        best = max(best, run)
    return best


@functools.lru_cache(maxsize=1)
def staging_loads() -> dict:
    """Label -> `loads_before_store` of each kernel of `STAGING`, from
    `cuobjdump -sass` of the built library."""
    lib = Path(kernels.library()._name)
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {label: loads_before_store(sass, frag) for label, frag in STAGING}


def main(device: Optional[str] = None, layers: int = L, batch: int = B,
         queries: int = Q, keys: int = KEYS) -> List[dict]:
    """Print and return one row a form (see the module's docstring)."""
    dev = default_device(device, "bench_attn_kernel")
    cuda = dev.type == "cuda"
    print(timing.card_line(dev), flush=True)
    t = setup(dev, layers, batch, queries, keys)
    if cuda:
        for label, n in staging_loads().items():
            print(f"sass: {label}: up to {n} global loads issued before a shared store",
                  flush=True)
    layer_bytes = 2 * t.kl.numel() * t.kl.element_size()
    print(f"L {layers} B {batch} Q {queries} H {H} Dh {DH}, {keys} keys ({t.ta} "
          f"unmasked), layer {LAYER}: {layer_bytes / 1e6:.1f} MB of K/V a call", flush=True)
    out = []
    for name, call, _, b in forms(t):
        ms = timing.slope_ms(call, dev)
        split = timing.device_ms_by_kernel(call, iters=5) if cuda else {}
        dms = sum(split.values()) if cuda else None
        host = cuda and timing.host_bound(ms, dms)
        stream_gbps = name != "1-tile compute"  # a latency floor, not a stream
        row = dict(name=name, ms=ms, host_bound=host, device_ms=dms, device_split=split,
                   gbps=timing.gb_per_s(layer_bytes, ms if dms is None else dms)
                   if stream_gbps else None, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   batch=batch, queries=queries, layers=layers, keys=keys)
        out.append(row)
        rate = f"{row['gbps']:8.1f} GB/s" if stream_gbps else "  (latency floor)"
        parts = ("  [" + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + "]"
                 if len(split) > 1 else "")
        print(f"{name:18s} {ms:8.4f} ms{' (host-bound)' if host else '             '} "
              f"{rate}  device {'not measured' if dms is None else f'{dms:.4f} ms'}  bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}){parts}"
              + ("" if cuda else "  [cpu, host clock]"), flush=True)
    return out


def _args(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cpu for the plain versions (tests)")
    for flag, default in (("layers", L), ("batch", B), ("queries", Q), ("keys", KEYS)):
        p.add_argument(f"--{flag}", type=int, default=default)
    return vars(p.parse_args(argv))


if __name__ == "__main__":
    main(**_args())
