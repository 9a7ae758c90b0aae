"""The comparison that decides `correct`: what the timed path produced on
the sampled batches, against the plain reference, each number beside its
limit (`limits/<cell>.json`).

The numbers (each the widest over the sampled rows, tokens or layers):

- `mel_err`: the log-mel's largest absolute gap;
- `enc_err`: the encoder output's relative L2 gap, a row at a time;
- `kv_err`: the cross K or V the decode read (dequantized where int8),
  relative L2, on three sampled decoder layers, against the reference's
  projection of the program's own encoder output (the stage alone: the
  encoder's part is `enc_err`'s);
- `logp_rms`: the root mean square over the emitted tokens of the gap
  between the log-probability the decode gave each token and the
  reference's, teacher-forced on the program's encoder output along the
  emitted tokens under the decode's logit rules (`logp_max`: the widest
  such gap);
- `rank_gap` (greedy cells): the widest gap by which an emitted token's
  logit lies below the reference's best at its position;
- `anchor_off`: the share of DTW anchor frames more than two frames (40 ms)
  from the reference's, whose alignment pass also reads the program's
  encoder output;
- `anchor_cost`: the mean over the sampled windows of how far the cheapest
  path through the reference's DTW cost that enters each text row at the
  program's anchor frames lies above the reference's optimum, per path
  step in units of the cost's standard deviation
  (`whisper_ref.anchored_excess`; `anchor_cost_max`: the widest window):
  random weights leave the alignment maps nearly flat, where many paths
  cost about the same and rounding moves the anchors far without making
  them wrong;
- `seg_err` (diarized cells): the segmentation net's largest absolute
  log-probability gap, on a sampled forward of 10 s windows;
- `emb_err` (diarized cells): the CAM++ embeddings' relative L2 gap, a row
  at a time.

`lowp=True` computes the control instead: the reference in the program's
place one step of precision lower (TF32 for the f32 stages: the log-mel and
the nets; for the stages the configuration serves in `served_dtype`,
encoder, cross K/V, decoder and alignment pass, the step below it:
`CONTROL`, or the configuration's `control_precision`), read against the
f32 reference in the same way; for `rank_gap` the gap of the token the
lower precision puts first.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import traffic as traffic_mod
from .reference import campplus as cam_ref
from .reference import segmentation as seg_ref
from .reference import whisper_ref as wr
from .reference.precision import f32_products

ANCHOR_TOLERANCE = 2  # frames (40 ms): whisper's word times are read on a 20 ms grid
SEG_WINDOW = 160_000  # the segmentation net's 10 s windows
MEANS = {"logp_sq": "logp_rms", "anchor_cost": "anchor_cost"}  # read as a mean, not the widest
# the control's precision for the served stages: fp8 e4m3 operands below
# bf16 (the H100's next tensor-core type), TF32 below f32 (IEEE f32 on the
# card's 3xTF32 kernels)
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def lower(c: Dict):
    """fn(*args, **kwargs) of the reference in the control's precision."""
    kind = c.get("control_precision", CONTROL[c["served_dtype"]])
    if kind not in ("fp8", "tf32"):
        raise ValueError(f"unknown control_precision {kind!r}")

    def run(fn, *args, **kwargs):
        if kind == "fp8":
            return fn(*args, lowp=True, **kwargs)
        with f32_products(tf32=True):
            return fn(*args, **kwargs)
    return run


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest relative L2 gap over the leading axis (rows)."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max())


def _rows_audio(rows, order: Sequence[int], audio: List[np.ndarray], device) -> Tuple:
    """The sampled batch's valid rows as the reference cuts them again from
    the run's files: (audio [n, 30 s] f32 in [-1, 1], samples a row)."""
    out = torch.zeros((len(rows), wr.N_SAMPLES), dtype=torch.float32)
    ns = []
    for j, (stream, start_s, n) in enumerate(rows):
        x = audio[order[stream]]
        s0 = int(round(start_s * wr.SAMPLE_RATE))
        part = x[s0:s0 + n]
        out[j, :len(part)] = torch.from_numpy(part.astype(np.float32) / 32768.0)
        ns.append(n)
    return out.to(device), ns


def _heads_merged(t: torch.Tensor) -> torch.Tensor:
    """[B, H, T, Dh] -> [B, T, H Dh]."""
    B, H, T, Dh = t.shape
    return t.transpose(1, 2).reshape(B, T, H * Dh)


def compute(sp: Dict, seed: int, captures: Dict, seg_captures: Dict,
            audio: List[np.ndarray], device, lowp: bool = False) -> Dict[str, float]:
    """The numbers of the sampled batches (see the module docstring)."""
    c, tr = sp["config"], sp["traffic"]
    specials = wr.Specials(c)
    greedy = tr["strategy"] == "greedy"
    heads = [tuple(h) for h in c["alignment_heads"]]
    width = int(c["median_filter_width"])
    blank = int(c["blank_id"])
    got: Dict[str, List[float]] = defaultdict(list)
    low = lower(c)
    with torch.inference_mode(), f32_products():
        W = wr.init_weights(c, seed, device)
        suppress = specials.suppress_mask(
            traffic_mod.suppressed_ids(tr, specials.eot, specials.timestamp_begin), device)
        sot = specials.sot_sequence()
        P = len(sot)
        for (call, _), cap in sorted(captures.items()):
            order = traffic_mod.call_order(tr)
            a, ns = _rows_audio(cap["rows"], order, audio, device)
            nv = len(ns)
            mel_ref = wr.log_mel(a, int(c["num_mel_bins"]))
            if lowp:
                with f32_products(tf32=True):
                    mel = wr.log_mel(a, int(c["num_mel_bins"]))
            else:
                mel = cap["mel"][:nv]
            got["mel_err"].append(float((mel.float() - mel_ref).abs().max()))
            xa_ref = wr.encode(W, c, mel_ref)
            xa = low(wr.encode, W, c, mel_ref) if lowp else cap["xa"][:nv]
            got["enc_err"].append(_rel(xa, xa_ref))
            del xa_ref
            # the later stages read the program's encoder output, as the decode did
            xa_in = cap["xa"][:nv].float()
            for layer, (k, v) in cap["kv"].items():
                k_ref, v_ref = wr.cross_kv(W, xa_in, layer)
                if lowp:
                    k, v = low(wr.cross_kv, W, xa_in, layer)
                else:
                    k, v = _heads_merged(k[:nv]), _heads_merged(v[:nv])
                got["kv_err"].append(max(_rel(k, k_ref), _rel(v, v_ref)))
            lengths = cap["lengths"][:nv].tolist()
            T = min(lengths)
            tokens = cap["tokens"][:nv, :T].to(device)
            seq = torch.cat([torch.tensor(sot, device=device).expand(nv, P), tokens], dim=1)
            raw = wr.decoder(W, c, seq, xa_in)[:, P - 1:P - 1 + T]
            masked = wr.masked_logits(raw, tokens, specials, suppress, blank)
            del raw
            logp_ref = torch.log_softmax(masked, dim=-1).gather(2, tokens[..., None])[..., 0]
            if lowp:
                raw_c = low(wr.decoder, W, c, seq, xa_in)[:, P - 1:P - 1 + T]
                masked_c = wr.masked_logits(raw_c, tokens, specials, suppress, blank)
                del raw_c
                logp = torch.log_softmax(masked_c, dim=-1).gather(2, tokens[..., None])[..., 0]
                first = masked_c.argmax(dim=-1)
                del masked_c
            else:
                logp = torch.log(cap["probs"][:nv, :T].float().to(device).clamp_min(1e-30))
                first = tokens
            gap = (logp - logp_ref).float()
            got["logp_max"].append(float(gap.abs().max()))
            got["logp_sq"].extend(gap.square().flatten().tolist())
            if greedy:
                gap = masked.amax(dim=-1) - masked.gather(2, first[..., None])[..., 0]
                got["rank_gap"].append(float(gap.max()))
            del masked
            seq_a = torch.cat([seq, torch.full((nv, 1), specials.eot, device=device)], dim=1)
            qk = wr.decoder(W, c, seq_a, xa_in, heads=heads).cpu().numpy()
            if lowp:
                qk_c = low(wr.decoder, W, c, seq_a, xa_in, heads=heads).cpu().numpy()
            off = total = 0
            for b in range(nv):
                nf = wr.n_align_frames(ns[b], int(c["max_source_positions"]))
                rows_b = P + T + 1
                cost = wr.alignment_matrix(qk[b], nf, rows_b, width)[P:P + T]
                ref = wr.dtw_anchor_frames(cost)
                if lowp:
                    prog = wr.dtw_anchor_frames(
                        wr.alignment_matrix(qk_c[b], nf, rows_b, width)[P:P + T])
                else:
                    prog = np.rint(np.asarray(cap["anchors"][b][:T]) / wr.FRAME_SECONDS)
                off += int((np.abs(prog - ref) > ANCHOR_TOLERANCE).sum())
                total += T
                got["anchor_cost"].append(wr.anchored_excess(cost, prog))
            got["anchor_off"].append(off / max(total, 1))
            if tr["diarize"] and "emb" in cap:  # a batch with a file's first window
                pc = cam_ref.params_from_jax(cam_ref.init_params_np(0), device)
                with f32_products(tf32=lowp):
                    emb = cam_ref.embed_from_audio(pc, a, ns)
                with f32_products():
                    emb_ref = cam_ref.embed_from_audio(pc, a, ns)
                if not lowp:
                    emb = cap["emb"][:nv]
                got["emb_err"].append(_rel(emb, emb_ref))
        if tr["diarize"]:
            ps = seg_ref.params_from_jax(seg_ref.init_params_np(0), device)
            for (call, _), cap in sorted(seg_captures.items()):
                order = traffic_mod.call_order(tr)
                windows = _seg_windows([audio[i] for i in order], cap["offset"], cap["rows"])
                x = torch.from_numpy(windows).to(device)
                ref = seg_ref.forward(ps, x)
                if lowp:
                    with f32_products(tf32=True):
                        out = seg_ref.forward(ps, x)
                else:
                    out = cap["out"]
                got["seg_err"].append(float((out - ref).abs().max()))
    out = {k: max(v) for k, v in got.items() if k not in MEANS}
    for k, name in MEANS.items():
        if got.get(k):
            mean = float(np.mean(got[k]))
            out[name] = float(np.sqrt(mean)) if k == "logp_sq" else mean
    if got.get("anchor_cost"):
        out["anchor_cost_max"] = max(got["anchor_cost"])
    return out


def _seg_windows(streams: List[np.ndarray], first: int, n: int) -> np.ndarray:
    """Windows first .. first + n of every stream's 10 s windows in order
    (each stream's last zero-padded), f32 in [-1, 1]."""
    out = np.zeros((n, SEG_WINDOW), np.float32)
    k = 0
    for x in streams:
        for w0 in range(0, len(x), SEG_WINDOW):
            if first <= k < first + n:
                part = x[w0:w0 + SEG_WINDOW]
                out[k - first, :len(part)] = part.astype(np.float32) / 32768.0
            k += 1
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): every limited number present
    and within its limit. A number without a limit is not compared."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = numbers.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
