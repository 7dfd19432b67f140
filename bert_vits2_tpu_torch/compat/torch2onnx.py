"""torch.export -> ONNX graph converter for inference-stage export.

Counterpart of `bert_vits2_tpu/compat/jax2onnx.py`. PyTorch's own exporter
needs the `onnx` package (and `onnxscript`), which the port does not depend
on, so this module writes the `.onnx` artifacts the
MoeVS-style deployment ecosystem consumes (reference: onnx_modules/V230/
models_onnx.py:896-1080) itself, through the dependency-free codec
`compat/onnx_pb.py`.

Design:
- trace with `torch.export.export(..., strict=False)` on the CPU inside
  `ops.library.plain_functions()`, where the kernel wrappers call their
  plain versions, so the graph holds no `torch.ops.bv2.*` custom op; then
  decompose to core ATen (`run_decompositions()`);
- static shapes only (one (t_x, max_frames) bucket);
- lifted parameters, buffers and constants are known values, and every node
  whose tensor inputs are all known is evaluated with torch at export time:
  this folds the weight-norm products g * v / ||v||, index tables and
  constant masks into plain initializers, as jax2onnx folds with JAX;
- each remaining ATen op maps onto opset-17 ops that the evaluator
  (`compat/onnx_eval.py`) and the checker (`compat/onnx_check.py`) cover.

An ATen op without a mapping raises `UnsupportedOp` with its name, so
coverage gaps are loud; a custom op (any namespace but aten) is one, so no
node is ever emitted outside the default domain.
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch
from torch.export.graph_signature import InputKind, OutputKind

from bert_vits2_tpu_torch.compat import onnx_pb as pb
from bert_vits2_tpu_torch.ops.library import plain_functions

aten = torch.ops.aten
_I64_MIN = -(2**63)


class UnsupportedOp(NotImplementedError):
    pass


class _Builder:
    def __init__(self):
        self.nodes: list[bytes] = []
        self.initializers: dict[str, bytes] = {}
        self._n = 0
        self._const_cache: dict[tuple, str] = {}

    def fresh(self, hint: str) -> str:
        self._n += 1
        hint = "".join(c if c.isalnum() or c in "._" else "_" for c in hint)
        return f"{hint}_{self._n}"

    def add(self, op: str, inputs, **attrs) -> str:
        """One node with one output -> the output's name."""
        out = self.fresh(op.lower())
        self.nodes.append(pb.node(op, inputs, [out], name=self.fresh(op.lower()),
                                  **attrs))
        return out

    def const(self, arr: np.ndarray, hint: str = "const") -> str:
        arr = np.asarray(arr)
        # key on the actual (shape, dtype, bytes) tuple: two distinct
        # constants never alias
        key = (arr.shape, str(arr.dtype), arr.tobytes())
        if key in self._const_cache:
            return self._const_cache[key]
        name = self.fresh(hint)
        self.initializers[name] = pb.tensor(name, arr)
        self._const_cache[key] = name
        return name

    def i64(self, values, hint: str = "i64") -> str:
        return self.const(np.asarray(values, np.int64), hint)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _onnx_dtype(dtype: torch.dtype) -> int:
    return pb.np_to_onnx_dtype(_np_dtype(dtype))


class _Val:
    """A graph value during conversion: its ONNX name and/or its known
    value (a tensor), with its dtype and shape."""

    __slots__ = ("name", "const", "dtype", "shape")

    def __init__(self, name, dtype, shape, const=None):
        self.name, self.dtype, self.shape, self.const = name, dtype, tuple(shape), const

    @classmethod
    def of(cls, t: torch.Tensor) -> "_Val":
        return cls(None, t.dtype, t.shape, t.detach())


def _tree_map(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, a) for a in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [a for b in x for a in _leaves(b)]
    if isinstance(x, dict):
        return [a for b in x.values() for a in _leaves(b)]
    return [x]


# ops that carry no value: the tracer's dtype assertions
_SKIP = {aten._assert_tensor_metadata.default}


class Converter:
    def __init__(self):
        self.b = _Builder()
        self.env: dict = {}

    # -- values ------------------------------------------------------------

    def arg(self, a):
        """An FX argument -> _Val (for graph values) or the Python value."""
        return _tree_map(lambda x: self.env[x] if isinstance(x, torch.fx.Node) else x, a)

    def name_of(self, v: _Val, hint: str = "c") -> str:
        """Materialize: give a constant an initializer name."""
        if v.name is None:
            v.name = self.b.const(v.const.cpu().numpy(), hint)
        return v.name

    def tensor(self, x, dtype: torch.dtype) -> str:
        """A _Val or a Python number as an ONNX tensor of `dtype` (cast when
        it is another)."""
        if not isinstance(x, _Val):
            return self.b.const(np.asarray(x, _np_dtype(dtype)), "scalar")
        if x.const is not None and x.name is None:
            return self.b.const(x.const.to(dtype).cpu().numpy(), "c")
        if x.dtype == dtype:
            return self.name_of(x)
        return self.b.add("Cast", [self.name_of(x)], to=_onnx_dtype(dtype))

    # -- main loop -----------------------------------------------------------

    def call(self, node: torch.fx.Node):
        op = node.target
        if op is operator.getitem:
            self.env[node] = self.env[node.args[0]][node.args[1]]
            return
        if op in _SKIP:
            return
        if not isinstance(op, torch._ops.OpOverload) or op.namespace != "aten":
            raise UnsupportedOp(f"no ONNX mapping for op '{op}' (only ATen ops "
                                "map onto the default domain)")
        if torch.Tag.nondeterministic_seeded in op.tags:
            raise UnsupportedOp(f"no ONNX mapping for the random op '{op}'")
        args, kwargs = self.arg(node.args), self.arg(node.kwargs)
        vals = [v for v in _leaves((args, kwargs)) if isinstance(v, _Val)]
        meta = node.meta["val"]
        # constant folding: execute with torch when every input is known
        if all(v.const is not None for v in vals):
            out = op(*_tree_map(_concrete, args), **_tree_map(_concrete, kwargs))
            self.env[node] = _tree_map(_Val.of, out)
            return
        if op == aten.full_like.default:  # a value of its input's shape only
            self.env[node] = _Val.of(torch.full(meta.shape, args[1], dtype=meta.dtype))
            return
        handler = _HANDLERS.get(op)
        if handler is None:
            raise UnsupportedOp(f"no ONNX mapping for ATen op '{op}' "
                                f"(inputs {[(str(v.dtype), v.shape) for v in vals]})")
        out = handler(self, node, *args, **kwargs)
        if isinstance(meta, (list, tuple)):
            self.env[node] = [o if isinstance(o, _Val) else _Val(o, m.dtype, m.shape)
                              for o, m in zip(out, meta)]
        else:
            self.env[node] = out if isinstance(out, _Val) else _Val(
                out, meta.dtype, meta.shape)


def _concrete(x):
    return x.const if isinstance(x, _Val) else x


# ---------------------------------------------------------------------------
# handlers: (converter, fx node, *args, **kwargs) -> output name(s) or _Val
# ---------------------------------------------------------------------------

_HANDLERS: dict = {}


def _on(*ops):
    def deco(fn):
        for op in ops:
            _HANDLERS[op] = fn
        return fn

    return deco


def _out(node):
    return node.meta["val"]


def _axis(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _result_dtype(a, b) -> torch.dtype:
    """torch's type promotion of two operands (_Val or Python numbers)."""
    def probe(x):
        if isinstance(x, _Val):
            return torch.empty((1,) * min(len(x.shape), 1), dtype=x.dtype)
        return x

    return torch.result_type(probe(a), probe(b))


def _binary(onnx_op):
    def h(cv, node, a, b, alpha=1):
        dt = _out(node).dtype
        b_name = cv.tensor(b, dt)
        if alpha != 1:
            b_name = cv.b.add("Mul", [b_name, cv.tensor(alpha, dt)])
        return cv.b.add(onnx_op, [cv.tensor(a, dt), b_name])

    return h


_on(aten.add.Tensor)(_binary("Add"))
_on(aten.sub.Tensor)(_binary("Sub"))
_on(aten.mul.Tensor)(_binary("Mul"))
_on(aten.div.Tensor)(_binary("Div"))


@_on(aten.pow.Tensor_Scalar)
def _pow(cv, node, x, e):
    dt = _out(node).dtype
    xn = cv.tensor(x, dt)
    if e == 2:  # torch squares by one multiply
        return cv.b.add("Mul", [xn, xn])
    return cv.b.add("Pow", [xn, cv.tensor(e, dt)])


def _compare(onnx_op):
    def h(cv, node, a, b):
        dt = _result_dtype(a, b)
        return cv.b.add(onnx_op, [cv.tensor(a, dt), cv.tensor(b, dt)])

    return h


# the overloads the stages' graphs hold
_on(aten.eq.Tensor, aten.eq.Scalar)(_compare("Equal"))
_on(aten.lt.Tensor)(_compare("Less"))
_on(aten.le.Scalar)(_compare("LessOrEqual"))
_on(aten.gt.Scalar)(_compare("Greater"))
_on(aten.ge.Tensor, aten.ge.Scalar)(_compare("GreaterOrEqual"))


@_on(aten.bitwise_and.Tensor)
def _and(cv, node, a, b):
    if not (a.dtype == b.dtype == torch.bool):
        raise UnsupportedOp(f"no ONNX mapping for integer '{node.target}'")
    return cv.b.add("And", [cv.name_of(a), cv.name_of(b)])


def _unary(onnx_op):
    def h(cv, node, x):
        return cv.b.add(onnx_op, [cv.tensor(x, _out(node).dtype)])

    return h


for _op, _onnx in ((aten.neg, "Neg"), (aten.exp, "Exp"), (aten.sqrt, "Sqrt"),
                   (aten.tanh, "Tanh"), (aten.sigmoid, "Sigmoid")):
    _on(_op.default)(_unary(_onnx))


@_on(aten.log1p.default)
def _log1p(cv, node, x):
    dt = _out(node).dtype
    return cv.b.add("Log", [cv.b.add("Add", [cv.tensor(x, dt), cv.tensor(1.0, dt)])])


@_on(aten.relu.default)
def _relu(cv, node, x):
    dt = _out(node).dtype
    return cv.b.add("Max", [cv.tensor(x, dt), cv.tensor(0, dt)])


@_on(aten.leaky_relu.default)
def _leaky_relu(cv, node, x, slope=0.01):
    dt = _out(node).dtype
    xn = cv.tensor(x, dt)
    pos = cv.b.add("Greater", [xn, cv.tensor(0, dt)])
    return cv.b.add("Where", [pos, xn, cv.b.add("Mul", [xn, cv.tensor(slope, dt)])])


@_on(aten.gelu.default)
def _gelu(cv, node, x, approximate="none"):
    """0.5 x (1 + erf(x / sqrt(2)))."""
    if approximate != "none":
        raise UnsupportedOp(f"no ONNX mapping for '{node.target}' with approximate="
                            f"{approximate!r}")
    dt = _out(node).dtype
    xn = cv.tensor(x, dt)
    t = cv.b.add("Erf", [cv.b.add("Mul", [xn, cv.tensor(math.sqrt(0.5), dt)])])
    half = cv.b.add("Mul", [xn, cv.tensor(0.5, dt)])
    return cv.b.add("Mul", [half, cv.b.add("Add", [t, cv.tensor(1.0, dt)])])


@_on(aten.where.self)
def _where(cv, node, c, a, b):
    dt = _out(node).dtype
    return cv.b.add("Where", [cv.tensor(c, torch.bool), cv.tensor(a, dt),
                              cv.tensor(b, dt)])


@_on(aten.clamp.default)
def _clamp(cv, node, x, lo=None, hi=None):
    dt = _out(node).dtype
    return cv.b.add("Clip", [cv.tensor(x, dt), "" if lo is None else cv.tensor(lo, dt),
                             "" if hi is None else cv.tensor(hi, dt)])


@_on(aten._to_copy.default)
def _to_copy(cv, node, x, **_):
    return cv.tensor(x, _out(node).dtype)


@_on(aten.clone.default, aten.alias.default)
def _identity(cv, node, x, **_):
    return _Val(cv.name_of(x), x.dtype, x.shape)


@_on(aten.view.default, aten.unsqueeze.default)
def _reshape(cv, node, x, *_):
    return cv.b.add("Reshape", [cv.name_of(x), cv.b.i64(list(_out(node).shape))])


@_on(aten.permute.default)
def _permute(cv, node, x, dims):
    return cv.b.add("Transpose", [cv.name_of(x)],
                    perm=[_axis(d, len(x.shape)) for d in dims])


@_on(aten.expand.default)
def _expand(cv, node, x, *_):
    return cv.b.add("Expand", [cv.name_of(x), cv.b.i64(list(_out(node).shape))])


@_on(aten.slice.Tensor)
def _slice(cv, node, x, dim=0, start=None, end=None, step=1):
    dim = _axis(dim, len(x.shape))
    s, e, st = slice(start, end, step).indices(x.shape[dim])
    return cv.b.add("Slice", [cv.name_of(x), cv.b.i64([s]), cv.b.i64([e]),
                              cv.b.i64([dim]), cv.b.i64([st])])


@_on(aten.select.int)
def _select(cv, node, x, dim, index):
    """A Gather of one index, then a Reshape that drops the axis: the codec
    writes a 0-d initializer with dims [1] (np.ascontiguousarray), so a
    scalar index would keep the axis."""
    dim = _axis(dim, len(x.shape))
    taken = cv.b.add("Gather", [cv.name_of(x), cv.b.i64([_axis(index, x.shape[dim])])],
                     axis=dim)
    return cv.b.add("Reshape", [taken, cv.b.i64(list(_out(node).shape))])


@_on(aten.split_with_sizes.default)
def _split(cv, node, x, sizes, dim=0):
    dim = _axis(dim, len(x.shape))
    outs, start = [], 0
    for n in sizes:
        outs.append(cv.b.add("Slice", [cv.name_of(x), cv.b.i64([start]),
                                       cv.b.i64([start + n]), cv.b.i64([dim])]))
        start += n
    return outs


@_on(aten.cat.default)
def _cat(cv, node, xs, dim=0):
    out = _out(node)
    return cv.b.add("Concat", [cv.tensor(x, out.dtype) for x in xs],
                    axis=_axis(dim, len(out.shape)))


@_on(aten.flip.default)
def _flip(cv, node, x, dims):
    dims = [_axis(d, len(x.shape)) for d in dims]
    return cv.b.add("Slice", [cv.name_of(x), cv.b.i64([-1] * len(dims)),
                              cv.b.i64([_I64_MIN] * len(dims)), cv.b.i64(dims),
                              cv.b.i64([-1] * len(dims))])


@_on(aten.constant_pad_nd.default)
def _pad(cv, node, x, pad, value=0):
    rank = len(x.shape)
    begin, end = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):  # torch pads the last axis first
        begin[rank - 1 - i], end[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    name = cv.name_of(x)
    if any(p > 0 for p in begin + end):
        name = cv.b.add("Pad", [name, cv.b.i64([max(p, 0) for p in begin + end]),
                                cv.tensor(value, x.dtype)])
    crop = [a for a in range(rank) if begin[a] < 0 or end[a] < 0]
    if crop:  # negative pads remove entries
        size = [x.shape[a] + max(begin[a], 0) + max(end[a], 0) for a in crop]
        name = cv.b.add("Slice", [name, cv.b.i64([-min(begin[a], 0) for a in crop]),
                                  cv.b.i64([n + min(end[a], 0)
                                            for a, n in zip(crop, size)]),
                                  cv.b.i64(crop)])
    return name


@_on(aten.embedding.default)
def _embedding(cv, node, weight, indices, *_):
    return cv.b.add("Gather", [cv.name_of(weight), cv.tensor(indices, torch.int64)],
                    axis=0)


@_on(aten.index.Tensor)
def _index(cv, node, x, indices):
    """x[..., i0, i1, ...] with index tensors on adjacent axes (after full
    slices): those axes flattened, the index tensors combined into flat
    positions (broadcast together), and one Gather."""
    used = [i for i, t in enumerate(indices) if t is not None]
    k, m = used[0], len(used)
    if used != list(range(k, k + m)):
        raise UnsupportedOp(f"no ONNX mapping for '{node.target}' on axes {used}")
    sizes = x.shape[k:k + m]
    flat = None
    for a, t in zip(range(m), indices[k:k + m]):
        pos = cv.tensor(t, torch.int64)
        stride = int(np.prod(sizes[a + 1:]))
        if stride != 1:
            pos = cv.b.add("Mul", [pos, cv.b.i64(stride)])
        flat = pos if flat is None else cv.b.add("Add", [flat, pos])
    name = cv.name_of(x)
    if m > 1:
        name = cv.b.add("Reshape", [name, cv.b.i64(list(x.shape[:k]) + [
            int(np.prod(sizes))] + list(x.shape[k + m:]))])
    return cv.b.add("Gather", [name, flat], axis=k)


@_on(aten.gather.default)
def _gather(cv, node, x, dim, index, sparse_grad=False):
    """torch.gather with a known index: the leading axes over which the
    index does not vary (and matches x) stay, the rest of x is flattened,
    and one Gather takes the flat positions."""
    if index.const is None:
        raise UnsupportedOp(f"no ONNX mapping for '{node.target}' with a computed index")
    idx = index.const.to(torch.int64)
    rank = len(x.shape)
    dim = _axis(dim, rank)
    k = 0
    while (k < dim and idx.shape[k] == x.shape[k]
           and bool((idx == idx.narrow(k, 0, 1)).all())):
        k += 1
    idx = idx[(0,) * k]
    strides = [int(np.prod(x.shape[a + 1:])) for a in range(k, rank)]
    flat = torch.zeros(idx.shape, dtype=torch.int64)
    for a, stride in zip(range(k, rank), strides):
        coord = idx if a == dim else torch.arange(idx.shape[a - k]).reshape(
            [-1 if j == a - k else 1 for j in range(idx.dim())])
        flat = flat + coord * stride
    xf = cv.b.add("Reshape", [cv.name_of(x), cv.b.i64(list(x.shape[:k])
                                                       + [int(np.prod(x.shape[k:]))])])
    return cv.b.add("Gather", [xf, cv.b.i64(flat.numpy())], axis=k)


@_on(aten.cumsum.default)
def _cumsum(cv, node, x, dim, dtype=None):
    out = _out(node)
    return cv.b.add("CumSum", [cv.tensor(x, out.dtype),
                               cv.b.i64(_axis(dim, len(out.shape)))])


def _axes(x, dims):
    rank = len(x.shape)
    if dims is None or len(dims) == 0:
        return list(range(rank))
    return sorted(_axis(d, rank) for d in dims)


@_on(aten.sum.dim_IntList)
def _sum(cv, node, x, dims=None, keepdim=False, dtype=None):
    return cv.b.add("ReduceSum", [cv.tensor(x, _out(node).dtype),
                                  cv.b.i64(_axes(x, dims))], keepdims=int(keepdim))


@_on(aten.argmin.default)
def _argmin(cv, node, x, dim, keepdim=False):
    return cv.b.add("ArgMin", [cv.name_of(x)], axis=_axis(dim, len(x.shape)),
                    keepdims=int(keepdim))


@_on(aten._softmax.default)
def _softmax(cv, node, x, dim, half_to_float=False):
    dim = _axis(dim, len(x.shape))
    xn = cv.tensor(x, _out(node).dtype)
    m = cv.b.add("ReduceMax", [xn], axes=[dim], keepdims=1)
    e = cv.b.add("Exp", [cv.b.add("Sub", [xn, m])])
    return cv.b.add("Div", [e, cv.b.add("ReduceSum", [e, cv.b.i64([dim])], keepdims=1)])


@_on(aten.native_layer_norm.default)
def _layer_norm(cv, node, x, shape, weight, bias, eps):
    """-> (out, mean, rstd), the statistics kept over the normalized axes."""
    dt = _out(node)[0].dtype
    rank = len(x.shape)
    axes = cv.b.i64(list(range(rank - len(shape), rank)))
    n = cv.tensor(int(np.prod(shape)), dt)
    xn = cv.tensor(x, dt)
    mean = cv.b.add("Div", [cv.b.add("ReduceSum", [xn, axes], keepdims=1), n])
    d = cv.b.add("Sub", [xn, mean])
    var = cv.b.add("Div", [cv.b.add("ReduceSum", [cv.b.add("Mul", [d, d]), axes],
                                    keepdims=1), n])
    rstd = cv.b.add("Reciprocal", [cv.b.add("Sqrt", [cv.b.add("Add", [
        var, cv.tensor(eps, dt)])])])
    out = cv.b.add("Mul", [d, rstd])
    if weight is not None:
        out = cv.b.add("Mul", [out, cv.tensor(weight, dt)])
    if bias is not None:
        out = cv.b.add("Add", [out, cv.tensor(bias, dt)])
    return [out, mean, rstd]


@_on(aten.mm.default, aten.bmm.default)
def _matmul(cv, node, a, b):
    dt = _out(node).dtype
    return cv.b.add("MatMul", [cv.tensor(a, dt), cv.tensor(b, dt)])


@_on(aten.addmm.default)
def _addmm(cv, node, bias, a, b, beta=1, alpha=1):
    dt = _out(node).dtype
    prod = cv.b.add("MatMul", [cv.tensor(a, dt), cv.tensor(b, dt)])
    if alpha != 1:
        prod = cv.b.add("Mul", [prod, cv.tensor(alpha, dt)])
    bias = cv.tensor(bias, dt)
    if beta != 1:
        bias = cv.b.add("Mul", [bias, cv.tensor(beta, dt)])
    return cv.b.add("Add", [prod, bias])


@_on(aten.convolution.default)
def _convolution(cv, node, x, w, bias, stride, padding, dilation, transposed,
                 output_padding, groups):
    dt = _out(node).dtype
    n_sp = len(x.shape) - 2
    attrs = dict(strides=list(stride), pads=list(padding) * 2,
                 dilations=list(dilation), group=int(groups))
    inputs = [cv.tensor(x, dt), cv.tensor(w, dt)]
    if not transposed:
        if bias is not None:
            inputs.append(cv.tensor(bias, dt))
        return cv.b.add("Conv", inputs, **attrs)
    if any(o for o in output_padding) or any(d != 1 for d in dilation):
        raise UnsupportedOp(f"no ONNX mapping for a transposed '{node.target}' with "
                            "output padding or dilation")
    y = cv.b.add("ConvTranspose", inputs, **attrs)
    if bias is not None:  # added apart: the evaluator's ConvTranspose takes none
        b = cv.b.add("Reshape", [cv.tensor(bias, dt), cv.b.i64([1, -1] + [1] * n_sp)])
        y = cv.b.add("Add", [y, b])
    return y


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def trace(fn, example_args) -> torch.export.ExportedProgram:
    """`fn` (a module or a function of tensors) traced on the CPU inside
    `plain_functions()` and decomposed to core ATen."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    args = tuple(torch.as_tensor(a) for a in example_args)
    with plain_functions(), torch.no_grad():
        prog = torch.export.export(mod, args, strict=False)
        return prog.run_decompositions()


def export_model(
    fn,
    example_args,
    input_names: list[str],
    output_names: list[str],
    graph_name: str = "graph",
    doc_string: str = "",
) -> bytes:
    """Trace `fn(*example_args)` and serialize an ONNX ModelProto (opset 17).

    Parameters, buffers and closed-over tensors become initializers. Shapes
    are static (taken from example_args)."""
    prog = trace(fn, example_args)
    sig = prog.graph_signature
    cv = Converter()
    user = []
    known = {}
    for spec in sig.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            user.append(spec.arg.name)
        elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER,
                           InputKind.CONSTANT_TENSOR):
            t = prog.state_dict.get(spec.target)
            known[spec.arg.name] = t if t is not None else prog.constants[spec.target]
        else:
            raise UnsupportedOp(f"no ONNX mapping for the input kind {spec.kind}")
    if len(input_names) != len(user):
        raise ValueError(f"{len(input_names)} input names for {len(user)} inputs")
    names = dict(zip(user, input_names))
    graph_inputs = []
    out_node = None
    for node in prog.graph.nodes:
        if node.op == "placeholder":
            if node.name in known:
                cv.env[node] = _Val.of(known[node.name])
            else:
                meta = node.meta["val"]
                cv.env[node] = _Val(names[node.name], meta.dtype, meta.shape)
                graph_inputs.append(pb.value_info(names[node.name],
                                                  _onnx_dtype(meta.dtype),
                                                  list(meta.shape)))
        elif node.op == "call_function":
            cv.call(node)
        elif node.op == "output":
            out_node = node
    outs = [a for a, spec in zip(out_node.args[0], sig.output_specs)
            if spec.kind == OutputKind.USER_OUTPUT]
    if len(output_names) != len(outs):
        raise ValueError(f"{len(output_names)} output names for {len(outs)} outputs")

    graph_outputs = []
    for name, o in zip(output_names, outs):
        v = cv.env[o]
        cv.b.nodes.append(pb.node("Identity", [cv.name_of(v, "out_const")], [name],
                                  name=cv.b.fresh("out")))
        graph_outputs.append(pb.value_info(name, _onnx_dtype(v.dtype), list(v.shape)))

    g = pb.graph(cv.b.nodes, graph_name, graph_inputs, graph_outputs,
                 initializers=list(cv.b.initializers.values()),
                 doc_string=doc_string)
    return pb.model(g, producer_name="bert_vits2_tpu_torch", doc_string=doc_string)


def count_ops(model_bytes: bytes) -> dict[str, int]:
    g = pb.parse_model(model_bytes)["graph"]
    out: dict[str, int] = {}
    for n in g["nodes"]:
        out[n["op_type"]] = out.get(n["op_type"], 0) + 1
    return out
