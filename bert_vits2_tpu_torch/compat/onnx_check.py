"""Independent ONNX conformance checker.

A copy of `bert_vits2_tpu/compat/onnx_check.py` (a test holds the two to
equal verdicts). This module is DELIBERATELY written against the public
ONNX specification (onnx/onnx.proto field numbers + per-operator schemas,
opset 17) and shares NO code, tables, or helpers with the exporter
(`onnx_pb.py` / `torch2onnx.py`) or the numpy evaluator (`onnx_eval.py`).
Its purpose is to catch a bug that the writer and evaluator share: the
reference's artifacts are consumed by external ONNX runtimes (the
reference's onnx_modules/V230_OnnxInference/__init__.py loads them with
onnxruntime), so the bytes must conform to the spec, not merely round-trip
through our own tools.

check_model(data: bytes) -> list[str]   empty list == conformant
decode_model(data: bytes) -> Model      independent structural decode

Covered: protobuf wire-format well-formedness, required model/graph fields,
opset declaration, SSA (every node input is produced before use; unique
output names), per-op input/output arity and attribute names/types for every
op the exporter can emit (see OP_SPECS — the "known-validated ops" table),
tensor payload sizes vs dims/dtype, and value-info element types.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire format (from scratch; google protobuf encoding spec)
# ---------------------------------------------------------------------------

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _uvarint(b: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(b):
            raise ValueError("truncated varint")
        byte = b[i]
        out |= (byte & 0x7F) << shift
        i += 1
        if not byte & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _iter_fields(b: bytes):
    """Yield (field_number, wire_type, value). value is int for varint/fixed,
    bytes for length-delimited."""
    i = 0
    while i < len(b):
        key, i = _uvarint(b, i)
        fno, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, i = _uvarint(b, i)
        elif wire == _WIRE_I64:
            if i + 8 > len(b):
                raise ValueError("truncated fixed64")
            val = int.from_bytes(b[i:i + 8], "little")
            i += 8
        elif wire == _WIRE_LEN:
            n, i = _uvarint(b, i)
            if i + n > len(b):
                raise ValueError("truncated length-delimited field")
            val = b[i:i + n]
            i += n
        elif wire == _WIRE_I32:
            if i + 4 > len(b):
                raise ValueError("truncated fixed32")
            val = int.from_bytes(b[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield fno, wire, val


def _packed_varints(val, wire) -> list[int]:
    """Repeated int field: packed (len-delimited) or single varint."""
    if wire == _WIRE_VARINT:
        return [val]
    out, i = [], 0
    while i < len(val):
        v, i = _uvarint(val, i)
        out.append(v)
    return out


def _zigzagless_i64(v: int) -> int:
    """onnx int64 fields use plain (two's-complement) varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# onnx.proto message decode (field numbers from the public onnx.proto)
# ---------------------------------------------------------------------------

# TensorProto.DataType
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}

_ATTR_TYPE_NAMES = {1: "FLOAT", 2: "INT", 3: "STRING", 4: "TENSOR",
                    5: "GRAPH", 6: "FLOATS", 7: "INTS", 8: "STRINGS"}


@dataclass
class Tensor:
    name: str = ""
    dims: list = field(default_factory=list)
    data_type: int = 0
    raw: bytes | None = None
    typed: list = field(default_factory=list)

    def to_numpy(self) -> np.ndarray:
        dt = _DTYPES.get(self.data_type)
        if dt is None:
            raise ValueError(f"tensor {self.name}: dtype {self.data_type}")
        if self.raw is not None:
            return np.frombuffer(self.raw, dtype=dt).reshape(self.dims)
        return np.asarray(self.typed, dtype=dt).reshape(self.dims)


@dataclass
class Attr:
    name: str = ""
    type: int = 0
    i: int = 0
    f: float = 0.0
    s: bytes = b""
    ints: list = field(default_factory=list)
    floats: list = field(default_factory=list)
    strings: list = field(default_factory=list)
    t: Tensor | None = None


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    dims: list = field(default_factory=list)  # int, str (dim_param), or None


@dataclass
class Graph:
    name: str = ""
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 0
    opsets: dict = field(default_factory=dict)  # domain -> version
    graph: Graph | None = None
    producer: str = ""


def _decode_tensor(b: bytes) -> Tensor:
    t = Tensor()
    for fno, wire, val in _iter_fields(b):
        if fno == 1:
            t.dims += [_zigzagless_i64(v) for v in _packed_varints(val, wire)]
        elif fno == 2:
            t.data_type = val
        elif fno == 4:  # float_data (packed fixed32)
            t.typed += list(np.frombuffer(val, np.float32)) \
                if wire == _WIRE_LEN else [struct.unpack(
                    "<f", struct.pack("<I", val))[0]]
        elif fno == 5:  # int32_data
            t.typed += _packed_varints(val, wire)
        elif fno == 7:  # int64_data
            t.typed += [_zigzagless_i64(v)
                        for v in _packed_varints(val, wire)]
        elif fno == 8:
            t.name = val.decode()
        elif fno == 9:
            t.raw = val
        elif fno == 10:  # double_data
            t.typed += list(np.frombuffer(val, np.float64))
    return t


def _decode_attr(b: bytes) -> Attr:
    a = Attr()
    for fno, wire, val in _iter_fields(b):
        if fno == 1:
            a.name = val.decode()
        elif fno == 2:
            a.f = struct.unpack("<f", struct.pack("<I", val))[0]
        elif fno == 3:
            a.i = _zigzagless_i64(val)
        elif fno == 4:
            a.s = val
        elif fno == 5:
            a.t = _decode_tensor(val)
        elif fno == 7:
            a.floats += list(np.frombuffer(val, np.float32)) \
                if wire == _WIRE_LEN else [struct.unpack(
                    "<f", struct.pack("<I", val))[0]]
        elif fno == 8:
            a.ints += [_zigzagless_i64(v)
                       for v in _packed_varints(val, wire)]
        elif fno == 9:
            a.strings.append(val)
        elif fno == 20:
            a.type = val
    return a


def _decode_node(b: bytes) -> Node:
    n = Node()
    for fno, _, val in _iter_fields(b):
        if fno == 1:
            n.inputs.append(val.decode())
        elif fno == 2:
            n.outputs.append(val.decode())
        elif fno == 3:
            n.name = val.decode()
        elif fno == 4:
            n.op_type = val.decode()
        elif fno == 5:
            a = _decode_attr(val)
            n.attrs[a.name] = a
        elif fno == 7:
            n.domain = val.decode()
    return n


def _decode_value_info(b: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fno, _, val in _iter_fields(b):
        if fno == 1:
            vi.name = val.decode()
        elif fno == 2:  # TypeProto
            for f2, _, v2 in _iter_fields(val):
                if f2 != 1:  # tensor_type
                    continue
                for f3, _, v3 in _iter_fields(v2):
                    if f3 == 1:
                        vi.elem_type = v3
                    elif f3 == 2:  # TensorShapeProto
                        for f4, _, v4 in _iter_fields(v3):
                            if f4 != 1:
                                continue
                            dim = None
                            for f5, _, v5 in _iter_fields(v4):
                                if f5 == 1:
                                    dim = _zigzagless_i64(v5)
                                elif f5 == 2:
                                    dim = v5.decode()
                            vi.dims.append(dim)
    return vi


def _decode_graph(b: bytes) -> Graph:
    g = Graph()
    for fno, _, val in _iter_fields(b):
        if fno == 1:
            g.nodes.append(_decode_node(val))
        elif fno == 2:
            g.name = val.decode()
        elif fno == 5:
            t = _decode_tensor(val)
            g.initializers[t.name] = t
        elif fno == 11:
            g.inputs.append(_decode_value_info(val))
        elif fno == 12:
            g.outputs.append(_decode_value_info(val))
    return g


def decode_model(data: bytes) -> Model:
    m = Model()
    for fno, _, val in _iter_fields(data):
        if fno == 1:
            m.ir_version = val
        elif fno == 2:
            m.producer = val.decode()
        elif fno == 7:
            m.graph = _decode_graph(val)
        elif fno == 8:
            domain, version = "", 0
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    domain = v2.decode()
                elif f2 == 2:
                    version = v2
            m.opsets[domain] = version
    return m


# ---------------------------------------------------------------------------
# per-operator schemas (opset 17, default domain) — known-validated ops
# ---------------------------------------------------------------------------

def _spec(min_in, max_in, n_out=1, req=(), opt=()):
    return {"in": (min_in, max_in), "out": n_out,
            "req": dict(req), "opt": dict(opt)}


_UNARY = _spec(1, 1)
_BINARY = _spec(2, 2)
_CONV_ATTRS = (("auto_pad", "STRING"), ("dilations", "INTS"),
               ("group", "INT"), ("kernel_shape", "INTS"),
               ("pads", "INTS"), ("strides", "INTS"))

OP_SPECS: dict[str, dict] = {
    # elementwise
    "Add": _BINARY, "Sub": _BINARY, "Mul": _BINARY, "Div": _BINARY,
    "Pow": _BINARY, "Mod": _spec(2, 2, opt=(("fmod", "INT"),)),
    "And": _BINARY, "Or": _BINARY, "Xor": _BINARY,
    "Equal": _BINARY, "Less": _BINARY, "Greater": _BINARY,
    "LessOrEqual": _BINARY, "GreaterOrEqual": _BINARY,
    "Min": _spec(1, 64), "Max": _spec(1, 64),
    "Abs": _UNARY, "Neg": _UNARY, "Sign": _UNARY, "Sqrt": _UNARY,
    "Exp": _UNARY, "Log": _UNARY, "Sigmoid": _UNARY, "Tanh": _UNARY,
    "Erf": _UNARY, "Floor": _UNARY, "Ceil": _UNARY, "Round": _UNARY,
    "Sin": _UNARY, "Cos": _UNARY, "Not": _UNARY, "Reciprocal": _UNARY,
    "Identity": _UNARY,
    "Cast": _spec(1, 1, req=(("to", "INT"),)),
    "Clip": _spec(1, 3),
    # shape / data movement
    "Reshape": _spec(2, 2, opt=(("allowzero", "INT"),)),
    "Transpose": _spec(1, 1, opt=(("perm", "INTS"),)),
    "Concat": _spec(1, 64, req=(("axis", "INT"),)),
    "Slice": _spec(3, 5),
    "Expand": _spec(2, 2),
    "Gather": _spec(2, 2, opt=(("axis", "INT"),)),
    "GatherND": _spec(2, 2, opt=(("batch_dims", "INT"),)),
    "ScatterND": _spec(3, 3, opt=(("reduction", "STRING"),)),
    "Pad": _spec(2, 4, opt=(("mode", "STRING"),)),
    "Where": _spec(3, 3),
    "CumSum": _spec(2, 2, opt=(("exclusive", "INT"), ("reverse", "INT"))),
    # contraction / conv
    "Einsum": _spec(1, 64, req=(("equation", "STRING"),)),
    "MatMul": _BINARY,
    "Conv": _spec(2, 3, opt=_CONV_ATTRS),
    "ConvTranspose": _spec(2, 3, opt=_CONV_ATTRS + (
        ("output_padding", "INTS"), ("output_shape", "INTS"))),
    # reductions (opset 13-17: ReduceSum takes axes as INPUT, the others as
    # an ATTRIBUTE — they move to inputs only at opset 18)
    "ReduceSum": _spec(1, 2, opt=(("keepdims", "INT"),
                                  ("noop_with_empty_axes", "INT"))),
    "ReduceMax": _spec(1, 1, opt=(("axes", "INTS"), ("keepdims", "INT"))),
    "ReduceMin": _spec(1, 1, opt=(("axes", "INTS"), ("keepdims", "INT"))),
    "ReduceProd": _spec(1, 1, opt=(("axes", "INTS"), ("keepdims", "INT"))),
    "ArgMax": _spec(1, 1, opt=(("axis", "INT"), ("keepdims", "INT"),
                               ("select_last_index", "INT"))),
    "ArgMin": _spec(1, 1, opt=(("axis", "INT"), ("keepdims", "INT"),
                               ("select_last_index", "INT"))),
}


def check_model(data: bytes, max_issues: int = 50) -> list[str]:
    """Spec-conformance check. Returns a list of human-readable issues;
    empty means the model passed every check this module implements."""
    issues: list[str] = []

    def bad(msg):
        if len(issues) < max_issues:
            issues.append(msg)

    try:
        m = decode_model(data)
    except ValueError as e:
        return [f"wire format: {e}"]

    if not (1 <= m.ir_version <= 10):
        bad(f"ir_version {m.ir_version} out of supported range")
    ai_version = m.opsets.get("") or m.opsets.get("ai.onnx")
    if ai_version is None:
        bad("no default-domain opset_import")
    elif not (13 <= ai_version <= 19):
        bad(f"default opset {ai_version} outside validated range 13..19")
    g = m.graph
    if g is None:
        bad("model has no graph")
        return issues

    # SSA + name resolution
    known = set(g.initializers)
    for vi in g.inputs:
        known.add(vi.name)
        if vi.name not in g.initializers and vi.elem_type not in _DTYPES:
            bad(f"graph input {vi.name}: elem_type {vi.elem_type} invalid")
    for n in g.nodes:
        spec = OP_SPECS.get(n.op_type) if n.domain in ("", "ai.onnx") else None
        if spec is None:
            bad(f"node {n.name}: op {n.domain or 'ai.onnx'}.{n.op_type} "
                "not in validated set")
        else:
            lo, hi = spec["in"]
            n_in = len([i for i in n.inputs if i])
            if not (lo <= n_in <= hi):
                bad(f"{n.op_type} {n.name}: {n_in} inputs, spec {lo}..{hi}")
            if len(n.outputs) != spec["out"]:
                bad(f"{n.op_type} {n.name}: {len(n.outputs)} outputs, "
                    f"spec {spec['out']}")
            allowed = {**spec["req"], **spec["opt"]}
            for a in n.attrs.values():
                want = allowed.get(a.name)
                if want is None:
                    bad(f"{n.op_type} {n.name}: unknown attribute {a.name}")
                elif _ATTR_TYPE_NAMES.get(a.type) != want:
                    bad(f"{n.op_type} {n.name}: attr {a.name} type "
                        f"{_ATTR_TYPE_NAMES.get(a.type, a.type)} != {want}")
            for req_name in spec["req"]:
                if req_name not in n.attrs:
                    bad(f"{n.op_type} {n.name}: missing required attr "
                        f"{req_name}")
        for i in n.inputs:
            if i and i not in known:
                bad(f"{n.op_type} {n.name}: input {i} not defined before "
                    "use (SSA violation)")
        for o in n.outputs:
            if o in known:
                bad(f"{n.op_type} {n.name}: output {o} redefined")
            known.add(o)
    for vi in g.outputs:
        if vi.name not in known:
            bad(f"graph output {vi.name} never produced")

    # tensor payloads
    for t in g.initializers.values():
        dt = _DTYPES.get(t.data_type)
        if dt is None:
            bad(f"initializer {t.name}: dtype {t.data_type} invalid")
            continue
        n_elem = int(np.prod(t.dims)) if t.dims else 1
        if t.raw is not None:
            want = n_elem * np.dtype(dt).itemsize
            if len(t.raw) != want:
                bad(f"initializer {t.name}: raw_data {len(t.raw)} bytes, "
                    f"dims {t.dims} x {np.dtype(dt)} needs {want}")
        elif len(t.typed) != n_elem:
            bad(f"initializer {t.name}: {len(t.typed)} typed values for "
                f"dims {t.dims}")
    return issues
