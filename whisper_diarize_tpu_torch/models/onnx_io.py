"""Minimal ONNX file reader/writer (protobuf wire format, no deps): the
port's own copy of `whisper_diarize_tpu/models/onnx_io.py`.

The reference pipeline downloads two ONNX models — `segmentation-3.0.onnx`
and `wespeaker_en_voxceleb_CAM++.onnx` (`engine.rs:90-91` of the reference)
— and executes them through ONNX Runtime. The port runs its own PyTorch
nets instead, so it only needs the *weights* out of those files. This module
parses the ONNX protobuf wire format directly (field numbers from the public
`onnx.proto` schema) and extracts:

* every graph initializer as a named numpy array,
* the node list (op_type, inputs, outputs, int/ints attributes) — enough to
  locate LSTM weight tensors and to structurally match layers when the
  exporter renamed initializers (constant folding does this).

A tiny writer (`write_onnx`) exists so tests can synthesize valid ONNX
files and round-trip them through the converters without network access.

Wire-format facts used (protobuf encoding spec):
  key = (field_number << 3) | wire_type; varint
  wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit
Schema subset (onnx.proto3):
  ModelProto:  graph = 7
  GraphProto:  node = 1, initializer = 5
  NodeProto:   input = 1, output = 2, name = 3, op_type = 4, attribute = 5
  AttributeProto: name = 1, f = 2, i = 3, s = 4, t = 5, floats = 7, ints = 8
  TensorProto: dims = 1, data_type = 2, float_data = 4, int32_data = 5,
               int64_data = 7, name = 8, raw_data = 9, double_data = 10
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# onnx.TensorProto.DataType -> numpy dtype (little-endian on disk)
_DTYPES = {
    1: np.dtype("<f4"),   # FLOAT
    2: np.dtype("u1"),    # UINT8
    3: np.dtype("i1"),    # INT8
    4: np.dtype("<u2"),   # UINT16
    5: np.dtype("<i2"),   # INT16
    6: np.dtype("<i4"),   # INT32
    7: np.dtype("<i8"),   # INT64
    9: np.dtype("?"),     # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
    12: np.dtype("<u4"),  # UINT32
    13: np.dtype("<u8"),  # UINT64
}
_DTYPE_IDS = {v: k for k, v in _DTYPES.items()}


class OnnxFormatError(ValueError):
    pass


@dataclass
class OnnxNode:
    op_type: str
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnnxModel:
    initializers: Dict[str, np.ndarray]
    nodes: List[OnnxNode]

    def producer_of(self, tensor_name: str) -> Optional[OnnxNode]:
        for n in self.nodes:
            if tensor_name in n.outputs:
                return n
        return None


# ---------------------------------------------------------------------------
# wire-level decoding
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise OnnxFormatError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise OnnxFormatError("varint too long")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.

    Length-delimited values come back as memoryview slices; varints as ints;
    fixed32/64 as raw bytes."""
    pos = 0
    mv = memoryview(buf)
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise OnnxFormatError("truncated length-delimited field")
            val = mv[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = mv[pos:pos + 4]
            pos += 4
        elif wtype == 1:
            val = mv[pos:pos + 8]
            pos += 8
        else:
            raise OnnxFormatError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _zigzag_free_i64(v: int) -> int:
    """Protobuf int64 varints are two's-complement (not zigzag)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(data) -> List[int]:
    buf = bytes(data)
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_zigzag_free_i64(v))
    return out


def _parse_tensor(buf) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    name = ""
    raw = None
    data_location = 0
    typed: List[Tuple[str, Any]] = []
    for fnum, wtype, val in _iter_fields(bytes(buf)):
        if fnum == 1:  # dims
            if wtype == 0:
                dims.append(_zigzag_free_i64(val))
            else:
                dims.extend(_packed_varints(val))
        elif fnum == 2 and wtype == 0:
            data_type = val
        elif fnum == 8:
            name = bytes(val).decode("utf-8")
        elif fnum == 9:
            raw = bytes(val)
        elif fnum == 14 and wtype == 0:  # data_location
            data_location = val
        elif fnum == 4:  # float_data
            typed.append(("<f4", val if wtype == 2 else bytes(val)))
        elif fnum == 5:  # int32_data
            typed.append(("i32v", val))
        elif fnum == 7:  # int64_data
            typed.append(("i64v", val))
        elif fnum == 10:  # double_data
            typed.append(("<f8", val if wtype == 2 else bytes(val)))
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise OnnxFormatError(f"tensor {name!r}: unsupported data_type {data_type}")
    if data_location == 1:  # EXTERNAL: payload lives in a sidecar file
        raise OnnxFormatError(
            f"tensor {name!r} uses external data storage; pass the model "
            "through `onnx.save(..., save_as_external_data=False)` first")
    shape = tuple(int(d) for d in dims)
    count = int(np.prod(shape)) if shape else 1
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype, count=count)
    elif typed:
        parts: List[np.ndarray] = []
        for kind, val in typed:
            if kind in ("<f4", "<f8"):
                parts.append(np.frombuffer(bytes(val), dtype=kind))
            else:  # packed varint ints
                vals = _packed_varints(val)
                parts.append(np.asarray(vals, dtype.base))
        arr = np.concatenate(parts) if len(parts) > 1 else parts[0]
    elif count == 0:
        arr = np.zeros((0,), dtype)
    else:
        # no raw_data and no typed payload: refuse to fabricate zeros
        raise OnnxFormatError(
            f"tensor {name!r}: no payload for {count} elements")
    if arr.size != count:
        raise OnnxFormatError(
            f"tensor {name!r}: payload {arr.size} elements, shape {shape}"
        )
    return name, np.ascontiguousarray(arr.reshape(shape))


def _parse_attr(buf) -> Tuple[str, Any]:
    name = ""
    value: Any = None
    for fnum, wtype, val in _iter_fields(bytes(buf)):
        if fnum == 1:
            name = bytes(val).decode("utf-8")
        elif fnum == 2:  # f
            value = struct.unpack("<f", bytes(val))[0]
        elif fnum == 3:  # i
            value = _zigzag_free_i64(val)
        elif fnum == 4:  # s
            value = bytes(val)
        elif fnum == 5:  # t (tensor)
            value = _parse_tensor(val)[1]
        elif fnum == 7:  # floats
            value = list(np.frombuffer(bytes(val), "<f4")) if wtype == 2 else value
        elif fnum == 8:  # ints
            if wtype == 0:
                value = (value or []) + [_zigzag_free_i64(val)]
            else:
                value = _packed_varints(val)
    return name, value


def _parse_node(buf) -> OnnxNode:
    node = OnnxNode(op_type="")
    for fnum, _wtype, val in _iter_fields(bytes(buf)):
        if fnum == 1:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif fnum == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif fnum == 3:
            node.name = bytes(val).decode("utf-8")
        elif fnum == 4:
            node.op_type = bytes(val).decode("utf-8")
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _parse_graph(buf) -> OnnxModel:
    inits: Dict[str, np.ndarray] = {}
    nodes: List[OnnxNode] = []
    for fnum, _wtype, val in _iter_fields(bytes(buf)):
        if fnum == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fnum == 1:
            nodes.append(_parse_node(val))
    return OnnxModel(initializers=inits, nodes=nodes)


def read_onnx(path) -> OnnxModel:
    """Parse an .onnx file into (initializers, nodes)."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 7 and wtype == 2:  # ModelProto.graph
            graph = val
    if graph is None:
        raise OnnxFormatError(f"{path}: no GraphProto found (not an ONNX file?)")
    model = _parse_graph(graph)
    # Constant nodes are initializers in disguise (exporters use both forms)
    for n in model.nodes:
        if n.op_type == "Constant" and n.outputs and "value" in n.attrs:
            v = n.attrs["value"]
            if isinstance(v, np.ndarray):
                model.initializers.setdefault(n.outputs[0], v)
    return model


# ---------------------------------------------------------------------------
# wire-level encoding (tests only: synthesize files for converter round-trips)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    key = _varint((fnum << 3) | wtype)
    if wtype == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = _DTYPE_IDS.get(arr.dtype.newbyteorder("<"))
    if dt is None:
        arr = arr.astype(np.float32)
        dt = 1
    out = b""
    for d in arr.shape:
        out += _field(1, 0, _varint(int(d)))
    out += _field(2, 0, _varint(dt))
    out += _field(8, 2, name.encode("utf-8"))
    out += _field(9, 2, np.ascontiguousarray(arr).tobytes())
    return out


def _enc_node(node: OnnxNode) -> bytes:
    out = b""
    for i in node.inputs:
        out += _field(1, 2, i.encode())
    for o in node.outputs:
        out += _field(2, 2, o.encode())
    if node.name:
        out += _field(3, 2, node.name.encode())
    out += _field(4, 2, node.op_type.encode())
    for k, v in node.attrs.items():
        a = _field(1, 2, k.encode())
        if isinstance(v, int):
            a += _field(3, 0, _varint(v))
        elif isinstance(v, float):
            a += _field(2, 5, struct.pack("<f", v))
        elif isinstance(v, bytes):
            a += _field(4, 2, v)
        elif isinstance(v, np.ndarray):
            a += _field(5, 2, _enc_tensor("", v))
        elif isinstance(v, (list, tuple)):
            a += _field(8, 2, b"".join(_varint(int(x)) for x in v))
        out += _field(5, 2, a)
    return out


def write_onnx(path, initializers: Dict[str, np.ndarray],
               nodes: Optional[List[OnnxNode]] = None) -> None:
    graph = b""
    for n in nodes or []:
        graph += _field(1, 2, _enc_node(n))
    for name, arr in initializers.items():
        graph += _field(5, 2, _enc_tensor(name, arr))
    model = _field(1, 0, _varint(8))  # ir_version
    model += _field(7, 2, graph)
    with open(path, "wb") as f:
        f.write(model)
