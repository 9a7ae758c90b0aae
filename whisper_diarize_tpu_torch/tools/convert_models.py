"""Convert upstream checkpoints into the `.npz` files the port's nets load
(counterpart of `tools/convert_models.py`).

The Engine converts and caches the reference's artifacts at first use
(`models/convert.py::_cached_convert`); this CLI writes the same files ahead
of time, from either the reference's artifacts (ONNX, the Silero GGML
binary) or the original torch checkpoints:

    python -m whisper_diarize_tpu_torch.tools.convert_models KIND SRC DST

  KIND      SRC                                  DST
  silero    silero_vad.jit                       out/silero_v5.npz
  silero    ggml-silero-v5.1.2.bin               out/silero_v5.npz
  pyannote  pytorch_model.bin                    out/segmentation3.npz
  pyannote  segmentation-3.0.onnx                out/segmentation3.npz
  campplus  campplus.pt                          out/campplus.npz
  campplus  wespeaker_en_voxceleb_CAM++.onnx     out/campplus.npz

The source kind (ONNX, GGML, torch) is detected per file. Upstream layouts
drift between releases, so every unmapped or missing tensor is printed:
inspect the output before trusting a converted file. The mapping is
`models/convert.py`'s (the Engine's own); no kernel runs here.
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..models import convert as cv


def _load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A TorchScript module's or a pickled checkpoint's tensors as numpy,
    on the CPU."""
    import torch

    try:
        obj = torch.jit.load(path, map_location="cpu")
        return {k: v.detach().numpy() for k, v in obj.state_dict().items()}
    except RuntimeError:  # not a TorchScript archive
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: np.asarray(v) for k, v in obj.items() if hasattr(v, "shape")}


def _detect(path: str) -> str:
    if str(path).endswith(".onnx"):
        return "onnx"
    with open(path, "rb") as f:
        if f.read(4) == struct.pack("<i", cv.GGML_MAGIC):
            return "ggml"
    return "torch"


def convert_silero(src: str, dst: str) -> List[str]:
    """Silero VAD v5 (torch jit, or whisper.cpp's `ggml-silero-v5.1.2.bin`)
    -> `models/silero_vad.load_params`'s layout. Returns the unmapped
    tensors' names."""
    if _detect(src) == "ggml":
        out, unmapped = cv.silero_npz_from_ggml(src), []
    else:
        out, unmapped = cv.map_silero_state(_load_torch_state(src))
    if unmapped:
        print(f"[silero] {len(unmapped)} unmapped tensors (first 10): {unmapped[:10]}")
    np.savez(dst, **out)
    print(f"[silero] wrote {dst} with keys: {sorted(out)}")
    return unmapped


def convert_pyannote(src: str, dst: str) -> Tuple[List[str], List[str]]:
    """pyannote segmentation-3.0 (a torch checkpoint: the raw PyanNet state
    dict, a pytorch-lightning checkpoint {"state_dict": {"model.…"}}, either
    asteroid filterbank spelling; or the reference's ONNX artifact) ->
    `models/segmentation.load_params`'s layout (dotted keys). Returns
    (missing, unmapped) tensor names."""
    missing: List[str] = []
    unmapped: List[str] = []
    if _detect(src) == "onnx":
        out = cv.segmentation_npz_from_onnx(src)
    else:
        sd = _load_torch_state(src)
        for prefix in ("model.", "_model."):
            if any(k.startswith(prefix + "sincnet.") for k in sd):
                sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
                break
        out, missing, mapped = cv.map_pyannote_state(sd)
        unmapped = sorted(set(sd) - set(mapped))
        if unmapped:
            print(f"[pyannote] {len(unmapped)} unmapped tensors (first 10): {unmapped[:10]}")
    for name in missing:
        print(f"[pyannote] missing: {name}")
    np.savez(dst, **out)
    print(f"[pyannote] wrote {dst} ({len(out)} tensors)")
    return missing, unmapped


def convert_campplus(src: str, dst: str) -> Tuple[List[str], List[str]]:
    """wespeaker / modelscope CAM++ (a torch checkpoint, or the reference's
    ONNX artifact) -> `models/campplus.load_params`'s layout. Returns
    (missing, unmapped) tensor names; both empty on a clean conversion."""
    if _detect(src) == "onnx":
        out, missing, unmapped = cv.campplus_npz_from_onnx(src), [], []
    else:
        sd = _load_torch_state(src)
        for prefix in ("", "module.", "speaker_extractor.", "embedding_model.", "_model.",
                       "model."):
            if prefix + "head.conv1.weight" in sd:
                if prefix:
                    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
                break
        out, missing, unmapped = cv.map_campplus_state(sd)
    if missing:
        print(f"[campplus] MISSING upstream tensors ({len(missing)}): "
              f"{missing[:10]}{'...' if len(missing) > 10 else ''}")
    if unmapped:
        print(f"[campplus] {len(unmapped)} unmapped tensors (first 10): {unmapped[:10]}")
    np.savez(dst, **out)
    print(f"[campplus] wrote {dst} ({len(out)} tensors, {len(missing)} missing, "
          f"{len(unmapped)} unmapped)")
    return missing, unmapped


CONVERTERS = {"silero": convert_silero, "pyannote": convert_pyannote,
              "campplus": convert_campplus}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", choices=sorted(CONVERTERS))
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    Path(args.dst).parent.mkdir(parents=True, exist_ok=True)
    CONVERTERS[args.kind](args.src, args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
