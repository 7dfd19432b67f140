"""Dependency-free ONNX protobuf codec (writer + reader).

A copy of `bert_vits2_tpu/compat/onnx_pb.py` (a test holds the two to equal
bytes). Neither the `onnx` package nor `onnxruntime` is installed where the
port runs, but the MoeVS-style ecosystem the reference feeds
(onnx_modules/V230/models_onnx.py:896-1080) consumes plain `.onnx` files. ONNX models are
protobuf messages with a stable, published schema, and protobuf's wire
format is simple (varints + length-delimited fields), so we serialize
ModelProto directly.

Field numbers follow onnx/onnx.proto (IR version 8 / opset 17):

  ModelProto:    ir_version=1, producer_name=2, producer_version=3,
                 domain=4, model_version=5, doc_string=6, graph=7,
                 opset_import=8
  OperatorSetId: domain=1, version=2
  GraphProto:    node=1, name=2, initializer=5, doc_string=10,
                 input=11, output=12, value_info=13
  NodeProto:     input=1, output=2, name=3, op_type=4, attribute=5,
                 doc_string=6, domain=7
  AttributeProto name=1, f=2, i=3, s=4, t=5, g=6, floats=7, ints=8,
                 strings=9, tensors=10, graphs=11, type=20
  TensorProto:   dims=1, data_type=2, name=8, raw_data=9
  ValueInfo:     name=1, type=2
  TypeProto:     tensor_type=1 {elem_type=1, shape=2}
  TensorShape:   dim=1 {dim_value=1, dim_param=2}

Only the subset needed for inference graphs is implemented; everything is
round-trip tested (tests/test_torch_onnx.py) via the numpy evaluator.
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# TensorProto.DataType
# ---------------------------------------------------------------------------

FLOAT = 1
UINT8 = 2
INT8 = 3
UINT16 = 4
INT16 = 5
INT32 = 6
INT64 = 7
STRING = 8
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
UINT32 = 12
UINT64 = 13
BFLOAT16 = 16

_NP_TO_DT = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.int8): INT8,
    np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.uint16): UINT16,
    np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
    np.dtype(np.bool_): BOOL,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}


def np_to_onnx_dtype(dtype) -> int:
    d = np.dtype(dtype)
    if d.name == "bfloat16":  # ml_dtypes — keep as bf16 raw bits
        return BFLOAT16
    return _NP_TO_DT[d]


def onnx_to_np_dtype(dt: int):
    if dt == BFLOAT16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return _DT_TO_NP[dt]


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # two's-complement 64-bit, per proto int64 encoding
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def f_fixed32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def f_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def f_string(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode("utf-8"))


# ---------------------------------------------------------------------------
# message builders
# ---------------------------------------------------------------------------


def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto with raw_data (little-endian)."""
    arr = np.ascontiguousarray(arr)
    out = bytearray()
    for d in arr.shape:
        out += f_varint(1, int(d))
    out += f_varint(2, np_to_onnx_dtype(arr.dtype))
    out += f_string(8, name)
    data = arr.tobytes()
    if arr.dtype == np.bool_:
        data = arr.astype(np.uint8).tobytes()
    out += f_bytes(9, data)
    return bytes(out)


def tensor_type(elem_type: int, dims) -> bytes:
    """TypeProto{tensor_type{elem_type, shape}}. dims entries: int, str
    (dim_param, i.e. symbolic/dynamic), or None (anonymous dynamic)."""
    shape = bytearray()
    for d in dims:
        if isinstance(d, str):
            dim = f_string(2, d)
        elif d is None:
            dim = f_string(2, "?")
        else:
            dim = f_varint(1, int(d))
        shape += f_bytes(1, dim)
    tt = f_varint(1, elem_type) + f_bytes(2, bytes(shape))
    return f_bytes(1, tt)


def value_info(name: str, elem_type: int, dims) -> bytes:
    return f_string(1, name) + f_bytes(2, tensor_type(elem_type, dims))


# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS, _AT_STRINGS = 6, 7, 8


def attribute(name: str, value) -> bytes:
    out = bytearray(f_string(1, name))
    if isinstance(value, bool):
        out += f_varint(3, int(value)) + f_varint(20, _AT_INT)
    elif isinstance(value, (int, np.integer)):
        out += f_varint(3, int(value)) + f_varint(20, _AT_INT)
    elif isinstance(value, (float, np.floating)):
        out += f_fixed32(2, float(value)) + f_varint(20, _AT_FLOAT)
    elif isinstance(value, str):
        out += f_bytes(4, value.encode("utf-8")) + f_varint(20, _AT_STRING)
    elif isinstance(value, np.ndarray):
        out += f_bytes(5, tensor("", value)) + f_varint(20, _AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], (float, np.floating)):
            for v in value:
                out += f_fixed32(7, float(v))
            out += f_varint(20, _AT_FLOATS)
        elif value and isinstance(value[0], str):
            for v in value:
                out += f_bytes(9, v.encode("utf-8"))
            out += f_varint(20, _AT_STRINGS)
        else:
            for v in value:
                out += f_varint(8, int(v))
            out += f_varint(20, _AT_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return bytes(out)


def node(
    op_type: str,
    inputs,
    outputs,
    name: str = "",
    domain: str = "",
    **attrs,
) -> bytes:
    out = bytearray()
    for i in inputs:
        out += f_string(1, i)
    for o in outputs:
        out += f_string(2, o)
    if name:
        out += f_string(3, name)
    out += f_string(4, op_type)
    for k in sorted(attrs):
        out += f_bytes(5, attribute(k, attrs[k]))
    if domain:
        out += f_string(7, domain)
    return bytes(out)


def graph(
    nodes,
    name: str,
    inputs,
    outputs,
    initializers=(),
    doc_string: str = "",
) -> bytes:
    out = bytearray()
    for n in nodes:
        out += f_bytes(1, n)
    out += f_string(2, name)
    for t in initializers:
        out += f_bytes(5, t)
    if doc_string:
        out += f_string(10, doc_string)
    for vi in inputs:
        out += f_bytes(11, vi)
    for vi in outputs:
        out += f_bytes(12, vi)
    return bytes(out)


def model(
    graph_bytes: bytes,
    opset: int = 17,
    ir_version: int = 8,
    producer_name: str = "bert_vits2_tpu",
    producer_version: str = "0.2",
    doc_string: str = "",
) -> bytes:
    out = bytearray()
    out += f_varint(1, ir_version)
    out += f_string(2, producer_name)
    out += f_string(3, producer_version)
    if doc_string:
        out += f_string(6, doc_string)
    out += f_bytes(7, graph_bytes)
    out += f_bytes(8, f_string(1, "") + f_varint(2, opset))
    return bytes(out)


# ---------------------------------------------------------------------------
# reader (generic wire decoder + typed views) — used by the numpy evaluator
# and by tests; also handy for inspecting third-party .onnx files.
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_fields(buf: bytes) -> dict[int, list]:
    """-> {field_number: [raw values]} (varints as int, len-delim as bytes,
    fixed32 as 4 raw bytes)."""
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            v = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(v)
    return fields


def _sint64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    f = parse_fields(buf)
    dims = [_sint64(d) for d in f.get(1, [])]
    dt = f[2][0]
    name = f.get(8, [b""])[0].decode("utf-8")
    np_dt = onnx_to_np_dtype(dt)
    if 9 in f:  # raw_data
        raw = f[9][0]
        if dt == BOOL:
            arr = np.frombuffer(raw, np.uint8).astype(np.bool_)
        else:
            arr = np.frombuffer(raw, np_dt)
    elif 4 in f and dt == FLOAT:  # packed float_data (we never emit, torch may)
        raw = b"".join(f[4])
        arr = np.frombuffer(raw, np.float32)
    elif 7 in f and dt == INT64:
        arr = np.array([_sint64(v) for v in f[7]], np.int64)
    else:
        arr = np.zeros(0, np_dt)
    return name, arr.reshape(dims).copy()


def parse_attribute(buf: bytes):
    f = parse_fields(buf)
    name = f[1][0].decode("utf-8")
    at = f.get(20, [0])[0]
    if at == _AT_FLOAT:
        return name, struct.unpack("<f", f[2][0])[0]
    if at == _AT_INT:
        return name, _sint64(f[3][0])
    if at == _AT_STRING:
        return name, f[4][0].decode("utf-8")
    if at == _AT_TENSOR:
        return name, parse_tensor(f[5][0])[1]
    if at == _AT_FLOATS:
        return name, [struct.unpack("<f", v)[0] for v in f.get(7, [])]
    if at == _AT_INTS:
        return name, [_sint64(v) for v in f.get(8, [])]
    if at == _AT_STRINGS:
        return name, [v.decode("utf-8") for v in f.get(9, [])]
    raise ValueError(f"unsupported attribute type {at} for {name}")


def parse_node(buf: bytes) -> dict:
    f = parse_fields(buf)
    return {
        "inputs": [v.decode("utf-8") for v in f.get(1, [])],
        "outputs": [v.decode("utf-8") for v in f.get(2, [])],
        "name": f.get(3, [b""])[0].decode("utf-8"),
        "op_type": f[4][0].decode("utf-8"),
        "attrs": dict(parse_attribute(a) for a in f.get(5, [])),
    }


def parse_value_info(buf: bytes) -> dict:
    f = parse_fields(buf)
    name = f[1][0].decode("utf-8")
    elem_type, dims = None, []
    if 2 in f:
        tp = parse_fields(f[2][0])
        if 1 in tp:  # tensor_type
            tt = parse_fields(tp[1][0])
            elem_type = tt.get(1, [None])[0]
            if 2 in tt:
                for d in parse_fields(tt[2][0]).get(1, []):
                    df = parse_fields(d)
                    if 1 in df:
                        dims.append(_sint64(df[1][0]))
                    else:
                        dims.append(df.get(2, [b"?"])[0].decode("utf-8"))
    return {"name": name, "elem_type": elem_type, "dims": dims}


def parse_graph(buf: bytes) -> dict:
    f = parse_fields(buf)
    return {
        "name": f.get(2, [b""])[0].decode("utf-8"),
        "nodes": [parse_node(n) for n in f.get(1, [])],
        "initializers": dict(parse_tensor(t) for t in f.get(5, [])),
        "inputs": [parse_value_info(v) for v in f.get(11, [])],
        "outputs": [parse_value_info(v) for v in f.get(12, [])],
    }


def parse_model(buf: bytes) -> dict:
    f = parse_fields(buf)
    opsets = []
    for o in f.get(8, []):
        of = parse_fields(o)
        opsets.append(
            (
                of.get(1, [b""])[0].decode("utf-8"),
                _sint64(of.get(2, [0])[0]),
            )
        )
    return {
        "ir_version": _sint64(f.get(1, [0])[0]),
        "producer_name": f.get(2, [b""])[0].decode("utf-8"),
        "opsets": opsets,
        "graph": parse_graph(f[7][0]),
    }
