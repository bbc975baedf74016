"""Minimal pure-Python ONNX protobuf codec (no `onnx` package needed): the
port's copy of flexflow_tpu/onnx/wire.py, numpy only, writing the same
bytes for the same arguments.

The ONNX importer (onnx/model.py) needs only a thin slice of the ONNX
proto surface: ModelProto.graph, nodes (op_type/input/output/name/
attribute), initializers (numpy), and graph input/output names. This
module decodes that slice straight from the protobuf wire format, plus a
small encoder so tests and scripts can author .onnx files; the onnx
package stays the preferred backend where it is installed.

ONNX is proto3: repeated scalars are packed (wire type 2); both packed and
unpacked encodings are accepted on read.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

# TensorProto.DataType values (onnx.proto)
FLOAT, UINT8, INT8, INT32, INT64 = 1, 2, 3, 6, 7
BOOL, FLOAT16, DOUBLE, BFLOAT16 = 9, 10, 11, 16

_NP_OF = {
    FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8, INT32: np.int32,
    INT64: np.int64, BOOL: np.bool_, FLOAT16: np.float16, DOUBLE: np.float64,
}
_DT_OF = {np.dtype(v): k for k, v in _NP_OF.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR = 1, 2, 3, 4
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------
def _rv(b: bytes, i: int):
    """Read a varint; returns (value, next_index)."""
    out = shift = 0
    while True:
        x = b[i]
        i += 1
        out |= (x & 0x7F) << shift
        if not x & 0x80:
            return out, i
        shift += 7


def _fields(b: bytes):
    """Yield (field_no, wire_type, value) over a serialized message; value is
    int (wt 0), bytes (wt 2), or raw 4/8 bytes (wt 5/1)."""
    i = 0
    while i < len(b):
        key, i = _rv(b, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _rv(b, i)
        elif wt == 2:
            ln, i = _rv(b, i)
            v = b[i:i + ln]
            i += ln
        elif wt == 5:
            v = b[i:i + 4]
            i += 4
        elif wt == 1:
            v = b[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


def _ints(wt, v) -> List[int]:
    """A repeated-int field occurrence: packed (wt 2) or single (wt 0)."""
    if wt == 0:
        return [v]
    out, i = [], 0
    while i < len(v):
        x, i = _rv(v, i)
        out.append(x)
    return out


def _signed(v: int) -> int:
    """int64 fields store negatives as 10-byte varints (2^64 complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _floats(wt, v) -> List[float]:
    if wt == 5:
        return [struct.unpack("<f", v)[0]]
    return list(struct.unpack(f"<{len(v) // 4}f", v))


def _vi(fno: int, val: int) -> bytes:
    """Encode a varint field."""
    key = (fno << 3)
    out = bytearray()
    for x in (key, val & ((1 << 64) - 1)):
        while True:
            b7 = x & 0x7F
            x >>= 7
            out.append(b7 | (0x80 if x else 0))
            if not x:
                break
    return bytes(out)


def _ld(fno: int, payload: bytes) -> bytes:
    """Encode a length-delimited field."""
    key = bytearray()
    x = (fno << 3) | 2
    while True:
        b7 = x & 0x7F
        x >>= 7
        key.append(b7 | (0x80 if x else 0))
        if not x:
            break
    ln = bytearray()
    x = len(payload)
    while True:
        b7 = x & 0x7F
        x >>= 7
        ln.append(b7 | (0x80 if x else 0))
        if not x:
            break
    return bytes(key) + bytes(ln) + payload


def _packed(fno: int, vals) -> bytes:
    body = bytearray()
    for v in vals:
        x = int(v) & ((1 << 64) - 1)
        while True:
            b7 = x & 0x7F
            x >>= 7
            body.append(b7 | (0x80 if x else 0))
            if not x:
                break
    return _ld(fno, bytes(body))


# ---------------------------------------------------------------------------
# decoded message objects (attribute names mirror the onnx package)
# ---------------------------------------------------------------------------
class TensorP:
    def __init__(self):
        self.dims: List[int] = []
        self.data_type = FLOAT
        self.name = ""
        self.raw_data = b""
        self.float_data: List[float] = []
        self.int32_data: List[int] = []
        self.int64_data: List[int] = []
        self.double_data: List[float] = []


class Attribute:
    def __init__(self):
        self.name = ""
        self.type = 0
        self.f = 0.0
        self.i = 0
        self.s = b""
        self.t: Optional[TensorP] = None
        self.floats: List[float] = []
        self.ints: List[int] = []
        self.strings: List[bytes] = []


class Node:
    def __init__(self):
        self.input: List[str] = []
        self.output: List[str] = []
        self.name = ""
        self.op_type = ""
        self.attribute: List[Attribute] = []


class ValueInfo:
    def __init__(self, name=""):
        self.name = name
        self.dims: List[int] = []       # flattened convenience
        self.elem_type = FLOAT


class GraphP:
    def __init__(self):
        self.node: List[Node] = []
        self.name = ""
        self.initializer: List[TensorP] = []
        self.input: List[ValueInfo] = []
        self.output: List[ValueInfo] = []


class ModelP:
    def __init__(self):
        self.ir_version = 8
        self.opset_version = 13
        self.graph = GraphP()


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------
def _dec_tensor(b: bytes) -> TensorP:
    t = TensorP()
    for fno, wt, v in _fields(b):
        if fno == 1:
            t.dims += [_signed(x) for x in _ints(wt, v)]
        elif fno == 2:
            t.data_type = v
        elif fno == 4:
            t.float_data += _floats(wt, v)
        elif fno == 5:
            t.int32_data += [_signed(x) for x in _ints(wt, v)]
        elif fno == 7:
            t.int64_data += [_signed(x) for x in _ints(wt, v)]
        elif fno == 8:
            t.name = v.decode()
        elif fno == 9:
            t.raw_data = v
        elif fno == 10:
            t.double_data += (list(struct.unpack("<d", v)) if wt == 1
                              else list(struct.unpack(f"<{len(v) // 8}d", v)))
    return t


def _dec_attr(b: bytes) -> Attribute:
    a = Attribute()
    for fno, wt, v in _fields(b):
        if fno == 1:
            a.name = v.decode()
        elif fno == 2:
            a.f = struct.unpack("<f", v)[0]
        elif fno == 3:
            a.i = _signed(v)
        elif fno == 4:
            a.s = v
        elif fno == 5:
            a.t = _dec_tensor(v)
        elif fno == 7:
            a.floats += _floats(wt, v)
        elif fno == 8:
            a.ints += [_signed(x) for x in _ints(wt, v)]
        elif fno == 9:
            a.strings.append(v)
        elif fno == 20:
            a.type = v
    return a


def _dec_node(b: bytes) -> Node:
    n = Node()
    for fno, wt, v in _fields(b):
        if fno == 1:
            n.input.append(v.decode())
        elif fno == 2:
            n.output.append(v.decode())
        elif fno == 3:
            n.name = v.decode()
        elif fno == 4:
            n.op_type = v.decode()
        elif fno == 5:
            n.attribute.append(_dec_attr(v))
    return n


def _dec_value_info(b: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fno, _, v in _fields(b):
        if fno == 1:
            vi.name = v.decode()
        elif fno == 2:  # TypeProto -> tensor_type -> shape
            for f2, _, v2 in _fields(v):
                if f2 != 1:
                    continue
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        vi.elem_type = v3
                    elif f3 == 2:
                        for f4, _, v4 in _fields(v3):
                            if f4 == 1:  # Dimension
                                for f5, w5, v5 in _fields(v4):
                                    if f5 == 1:
                                        vi.dims.append(_signed(v5))
    return vi


def _dec_graph(b: bytes) -> GraphP:
    g = GraphP()
    for fno, _, v in _fields(b):
        if fno == 1:
            g.node.append(_dec_node(v))
        elif fno == 2:
            g.name = v.decode()
        elif fno == 5:
            g.initializer.append(_dec_tensor(v))
        elif fno == 11:
            g.input.append(_dec_value_info(v))
        elif fno == 12:
            g.output.append(_dec_value_info(v))
    return g


def load(path_or_bytes) -> ModelP:
    """Decode a serialized ModelProto (path or bytes)."""
    if isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    m = ModelP()
    for fno, wt, v in _fields(data):
        if fno == 1:
            m.ir_version = v
        elif fno == 7:
            m.graph = _dec_graph(v)
        elif fno == 8:  # opset_import
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    m.opset_version = v2
    return m


def to_array(t: TensorP) -> np.ndarray:
    """numpy_helper.to_array for the decoded TensorProto. Raises on
    encodings this codec does not model rather than returning zeros."""
    import math

    if t.data_type == BFLOAT16:
        # bf16 payloads arrive as uint16 bit patterns, in raw_data or (per
        # the spec) packed into int32_data
        if t.raw_data:
            raw = np.frombuffer(t.raw_data, dtype=np.uint16)
        elif t.int32_data:
            raw = np.asarray(t.int32_data, dtype=np.uint16)
        else:
            raise ValueError(
                f"ONNX initializer {t.name!r}: BFLOAT16 without raw_data/"
                "int32_data payload")
        return (raw.astype(np.uint32) << 16).view(np.float32).reshape(t.dims)
    if t.data_type not in _NP_OF:
        raise ValueError(
            f"ONNX initializer {t.name!r}: data_type={t.data_type} not "
            "modeled by this codec — install the onnx package")
    dt = np.dtype(_NP_OF[t.data_type])
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=dt).reshape(t.dims).copy()
    if t.float_data:
        return np.asarray(t.float_data, dtype=dt).reshape(t.dims)
    if t.double_data:
        return np.asarray(t.double_data, dtype=dt).reshape(t.dims)
    if t.int64_data:
        return np.asarray(t.int64_data, dtype=dt).reshape(t.dims)
    if t.int32_data:
        if t.data_type == FLOAT16:
            # the ONNX spec stores fp16 payloads as uint16 bit patterns
            # inside int32_data
            raw = np.asarray(t.int32_data, dtype=np.uint16)
            return raw.view(np.float16).reshape(t.dims)
        return np.asarray(t.int32_data, dtype=dt).reshape(t.dims)
    if math.prod(t.dims or [1]) == 0:
        return np.zeros(t.dims, dtype=dt)
    raise ValueError(
        f"ONNX initializer {t.name!r}: no payload this codec decodes "
        f"(data_type={t.data_type}) — install the onnx package for full "
        "TensorProto coverage")


def get_attribute_value(a: Attribute):
    """onnx.helper.get_attribute_value for the decoded AttributeProto."""
    if a.type == AT_FLOAT:
        return a.f
    if a.type == AT_INT:
        return a.i
    if a.type == AT_STRING:
        return a.s
    if a.type == AT_TENSOR:
        return a.t
    if a.type == AT_FLOATS:
        return list(a.floats)
    if a.type == AT_INTS:
        return list(a.ints)
    if a.type == AT_STRINGS:
        return list(a.strings)
    # untyped (hand-built): best effort by which field is set
    for v in (a.ints, a.floats, a.strings):
        if v:
            return list(v)
    if a.s:
        return a.s
    if a.f:
        return a.f
    return a.i


# ---------------------------------------------------------------------------
# encoder (test and script authoring without the onnx package)
# ---------------------------------------------------------------------------
def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DT_OF:
        arr = arr.astype(np.float32)
    out = _packed(1, arr.shape)
    out += _vi(2, _DT_OF[arr.dtype])
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def _enc_attr(name: str, val) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(val, float):
        out += struct.pack("<B", (2 << 3) | 5) + struct.pack("<f", val)
        out += _vi(20, AT_FLOAT)
    elif isinstance(val, bool) or isinstance(val, int):
        out += _vi(3, int(val))
        out += _vi(20, AT_INT)
    elif isinstance(val, (bytes, str)):
        out += _ld(4, val.encode() if isinstance(val, str) else val)
        out += _vi(20, AT_STRING)
    elif isinstance(val, np.ndarray):
        out += _ld(5, _enc_tensor(name, val))
        out += _vi(20, AT_TENSOR)
    elif isinstance(val, (list, tuple)) and val and isinstance(val[0], float):
        out += _ld(7, struct.pack(f"<{len(val)}f", *val))
        out += _vi(20, AT_FLOATS)
    else:  # int list (possibly empty)
        out += _packed(8, [int(v) for v in val])
        out += _vi(20, AT_INTS)
    return out


def make_node(op_type: str, inputs, outputs, name: str = "",
              **attrs) -> bytes:
    out = b""
    for s in inputs:
        out += _ld(1, s.encode())
    for s in outputs:
        out += _ld(2, s.encode())
    out += _ld(3, (name or outputs[0]).encode())
    out += _ld(4, op_type.encode())
    for k, v in attrs.items():
        out += _ld(5, _enc_attr(k, v))
    return out


def _enc_value_info(name: str, dims, elem_type=FLOAT) -> bytes:
    shape = b"".join(_ld(1, _vi(1, int(d))) for d in dims)
    tensor_type = _vi(1, elem_type) + _ld(2, shape)
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def make_model(nodes: List[bytes],
               inputs: Dict[str, tuple],
               outputs: Dict[str, tuple],
               initializers: Dict[str, np.ndarray],
               name: str = "g", opset: int = 13) -> bytes:
    """Serialize a ModelProto. inputs/outputs: name -> dims;
    initializers: name -> numpy array (also declared as graph inputs, the
    pre-IR4 convention both onnx and this decoder accept)."""
    g = b""
    for n in nodes:
        g += _ld(1, n)
    g += _ld(2, name.encode())
    for nm, arr in initializers.items():
        g += _ld(5, _enc_tensor(nm, arr))
    for nm, dims in inputs.items():
        g += _ld(11, _enc_value_info(nm, dims))
    for nm, arr in initializers.items():
        g += _ld(11, _enc_value_info(nm, arr.shape, _DT_OF.get(arr.dtype,
                                                               FLOAT)))
    for nm, dims in outputs.items():
        g += _ld(12, _enc_value_info(nm, dims))
    m = _vi(1, 8)                       # ir_version
    m += _ld(8, _ld(1, b"") + _vi(2, opset))   # opset_import
    m += _ld(7, g)
    return m


def save(model_bytes: bytes, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model_bytes)
