"""Minimal numpy evaluator for the ONNX graphs this framework emits.

A copy of `bert_vits2_tpu/compat/onnx_eval.py` (a test holds the two to
equal outputs). Neither `onnx` nor `onnxruntime` is installed where the
port runs, so round-trip verification of exported artifacts
(tests/test_torch_onnx.py) runs on this evaluator: parse the ModelProto
back (compat/onnx_pb.py), execute the node list with numpy, compare against
the torch stage. Ops are implemented from the ONNX operator spec (opset 17
semantics), independently of the exporter's ATen->ONNX mapping
(compat/torch2onnx.py), so a wrong mapping shows up as a numeric mismatch
instead of cancelling out.

Covers the op set the JAX package's exporter can emit, which holds every op
`compat/torch2onnx.py` emits. Reference analog:
onnx_modules/*_OnnxInference/__init__.py runs the exported graphs with
onnxruntime; deployments with onnxruntime available should prefer it — this
module is for verification and air-gapped smoke tests.
"""

from __future__ import annotations

import numpy as np

from bert_vits2_tpu_torch.compat import onnx_pb as pb

try:  # scipy where installed; else a vectorized math.erf
    from scipy.special import erf as _erf
except Exception:  # pragma: no cover
    import math

    _erf = np.vectorize(math.erf)


def _slice(x, starts, ends, axes=None, steps=None):
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        st, en, ax, sp = int(st), int(en), int(ax), int(sp)
        dim = x.shape[ax]
        if sp > 0:
            if st < 0:
                st += dim
            if en < 0:
                en += dim
            sl[ax] = slice(max(min(st, dim), 0), max(min(en, dim), 0), sp)
        else:
            if st < 0:
                st += dim
            st = max(min(st, dim - 1), 0)
            if en < 0:
                en += dim
            sl[ax] = slice(st, en if en >= 0 else None, sp)
    return x[tuple(sl)]


def _conv_nd(x, w, strides, pads, dilations, group):
    """ONNX Conv: x [N, C, *sp], w [M, C/g, *k] -> [N, M, *out]."""
    n_sp = x.ndim - 2
    pb_, pe = pads[:n_sp], pads[n_sp:]
    pad_width = [(0, 0), (0, 0)] + [(int(b), int(e)) for b, e in zip(pb_, pe)]
    xp = np.pad(x, pad_width)
    n, c = x.shape[:2]
    m = w.shape[0]
    k = w.shape[2:]
    out_sp = [
        (xp.shape[2 + i] - (dilations[i] * (k[i] - 1) + 1)) // strides[i] + 1
        for i in range(n_sp)
    ]
    y = np.zeros((n, m, *out_sp), np.result_type(x, w))
    cg = c // group
    mg = m // group
    for g_i in range(group):
        xg = xp[:, g_i * cg : (g_i + 1) * cg]
        wg = w[g_i * mg : (g_i + 1) * mg]
        if n_sp == 1:
            for t in range(out_sp[0]):
                base = t * strides[0]
                taps = xg[:, :, base : base + dilations[0] * k[0] : dilations[0]]
                y[:, g_i * mg : (g_i + 1) * mg, t] = np.einsum(
                    "nck,mck->nm", taps, wg
                )
        elif n_sp == 2:
            for t0 in range(out_sp[0]):
                for t1 in range(out_sp[1]):
                    b0, b1 = t0 * strides[0], t1 * strides[1]
                    taps = xg[
                        :,
                        :,
                        b0 : b0 + dilations[0] * k[0] : dilations[0],
                        b1 : b1 + dilations[1] * k[1] : dilations[1],
                    ]
                    y[:, g_i * mg : (g_i + 1) * mg, t0, t1] = np.einsum(
                        "nchw,mchw->nm", taps, wg
                    )
        else:
            raise NotImplementedError(f"Conv with {n_sp} spatial dims")
    return y


def _conv_transpose_nd(x, w, strides, pads, group):
    """ONNX ConvTranspose: x [N, C, *sp], w [C, M/g, *k] -> [N, M, *out].

    out[i*stride + k] += x[i] * w[k]  (then crop pads)."""
    n_sp = x.ndim - 2
    n, c = x.shape[:2]
    mg = w.shape[1]
    m = mg * group
    k = w.shape[2:]
    full_sp = [
        (x.shape[2 + i] - 1) * strides[i] + k[i] for i in range(n_sp)
    ]
    y = np.zeros((n, m, *full_sp), np.result_type(x, w))
    cg = c // group
    for g_i in range(group):
        xg = x[:, g_i * cg : (g_i + 1) * cg]
        wg = w[g_i * cg : (g_i + 1) * cg]  # [C/g, M/g, *k]
        if n_sp == 1:
            for i in range(x.shape[2]):
                contrib = np.einsum("nc,cmk->nmk", xg[:, :, i], wg)
                base = i * strides[0]
                y[:, g_i * mg : (g_i + 1) * mg, base : base + k[0]] += contrib
        else:
            raise NotImplementedError(
                f"ConvTranspose with {n_sp} spatial dims"
            )
    pb_, pe = pads[:n_sp], pads[n_sp:]
    sl = [slice(None), slice(None)] + [
        slice(int(b), full_sp[i] - int(e))
        for i, (b, e) in enumerate(zip(pb_, pe))
    ]
    return y[tuple(sl)]


class OnnxEvaluator:
    def __init__(self, model_bytes: bytes):
        m = pb.parse_model(model_bytes)
        self.graph = m["graph"]
        self.opset = dict(m["opsets"]).get("", 17)
        self.input_names = [
            vi["name"]
            for vi in self.graph["inputs"]
            if vi["name"] not in self.graph["initializers"]
        ]
        self.output_names = [vi["name"] for vi in self.graph["outputs"]]

    def __call__(self, *args, **kwargs) -> list[np.ndarray]:
        env: dict[str, np.ndarray] = dict(self.graph["initializers"])
        names = list(self.input_names)
        for name, v in zip(names, args):
            env[name] = np.asarray(v)
        for name, v in kwargs.items():
            env[name] = np.asarray(v)
        for node in self.graph["nodes"]:
            outs = self._exec(node, env)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, v in zip(node["outputs"], outs):
                env[name] = v
        return [env[n] for n in self.output_names]

    def _exec(self, node, env):
        op = node["op_type"]
        a = node["attrs"]
        x = [env[i] if i else None for i in node["inputs"]]
        if op == "Add":
            return x[0] + x[1]
        if op == "Sub":
            return x[0] - x[1]
        if op == "Mul":
            return x[0] * x[1]
        if op == "Div":
            if np.issubdtype(x[0].dtype, np.floating):
                return x[0] / x[1]
            # ONNX integer Div truncates toward zero; numpy // floors.
            # Exact correction (no float round-trip): bump the floored
            # quotient when there is a remainder and the signs differ.
            q = x[0] // x[1]
            r = x[0] - q * x[1]
            return q + ((r != 0) & ((x[0] < 0) != (x[1] < 0)))
        if op == "Pow":
            return np.power(x[0], x[1].astype(x[0].dtype))
        if op == "Mod":
            return np.fmod(x[0], x[1]) if a.get("fmod") else np.mod(x[0], x[1])
        if op == "Neg":
            return -x[0]
        if op == "Abs":
            return np.abs(x[0])
        if op == "Sign":
            return np.sign(x[0])
        if op == "Sqrt":
            return np.sqrt(x[0])
        if op == "Reciprocal":
            return 1.0 / x[0]
        if op == "Exp":
            return np.exp(x[0])
        if op == "Log":
            return np.log(x[0])
        if op == "Tanh":
            return np.tanh(x[0])
        if op == "Sigmoid":
            return 1.0 / (1.0 + np.exp(-x[0]))
        if op == "Erf":
            return _erf(x[0]).astype(x[0].dtype)
        if op == "Sin":
            return np.sin(x[0])
        if op == "Cos":
            return np.cos(x[0])
        if op == "Floor":
            return np.floor(x[0])
        if op == "Ceil":
            return np.ceil(x[0])
        if op == "Round":
            return np.round(x[0])
        if op == "Max":
            out = x[0]
            for v in x[1:]:
                out = np.maximum(out, v)
            return out
        if op == "Min":
            out = x[0]
            for v in x[1:]:
                out = np.minimum(out, v)
            return out
        if op == "Where":
            return np.where(x[0], x[1], x[2])
        if op == "Clip":
            lo = x[1] if len(x) > 1 and x[1] is not None else None
            hi = x[2] if len(x) > 2 and x[2] is not None else None
            return np.clip(x[0], lo, hi)
        if op == "Equal":
            return x[0] == x[1]
        if op == "Less":
            return x[0] < x[1]
        if op == "LessOrEqual":
            return x[0] <= x[1]
        if op == "Greater":
            return x[0] > x[1]
        if op == "GreaterOrEqual":
            return x[0] >= x[1]
        if op == "And":
            return np.logical_and(x[0], x[1])
        if op == "Or":
            return np.logical_or(x[0], x[1])
        if op == "Xor":
            return np.logical_xor(x[0], x[1])
        if op == "Not":
            return np.logical_not(x[0])
        if op == "Cast":
            dt = pb.onnx_to_np_dtype(a["to"])
            if dt == np.bool_:
                return x[0] != 0
            return x[0].astype(dt)
        if op == "Identity":
            return x[0]
        if op == "Reshape":
            return x[0].reshape([int(d) for d in x[1]])
        if op == "Transpose":
            return np.transpose(x[0], a.get("perm"))
        if op == "Expand":
            target = [int(d) for d in x[1]]
            shape = np.broadcast_shapes(x[0].shape, tuple(target))
            return np.broadcast_to(x[0], shape)
        if op == "Concat":
            return np.concatenate(x, axis=a["axis"])
        if op == "Pad":
            pads = [int(p) for p in x[1]]
            n = len(pads) // 2
            cval = x[2] if len(x) > 2 and x[2] is not None else 0
            return np.pad(
                x[0],
                list(zip(pads[:n], pads[n:])),
                constant_values=np.asarray(cval).item() if np.ndim(cval) == 0
                else cval,
            )
        if op == "Slice":
            return _slice(
                x[0],
                x[1],
                x[2],
                x[3] if len(x) > 3 else None,
                x[4] if len(x) > 4 else None,
            )
        if op == "Gather":
            return np.take(x[0], x[1].astype(np.int64), axis=a.get("axis", 0))
        if op == "GatherND":
            if a.get("batch_dims", 0):
                raise NotImplementedError("GatherND batch_dims > 0")
            data, idx = x[0], x[1].astype(np.int64)
            m = idx.shape[-1]
            flat = idx.reshape(-1, m)
            rows = data[tuple(flat[:, i] for i in range(m))]
            return rows.reshape(idx.shape[:-1] + data.shape[m:])
        if op == "ReduceSum":
            axes = (
                tuple(int(v) for v in x[1])
                if len(x) > 1 and x[1] is not None
                else None
            )
            return np.sum(x[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))
        if op == "ReduceMax":
            return np.max(
                x[0],
                axis=tuple(a["axes"]) if "axes" in a else None,
                keepdims=bool(a.get("keepdims", 1)),
            )
        if op == "ReduceMin":
            return np.min(
                x[0],
                axis=tuple(a["axes"]) if "axes" in a else None,
                keepdims=bool(a.get("keepdims", 1)),
            )
        if op == "ReduceProd":
            return np.prod(
                x[0],
                axis=tuple(a["axes"]) if "axes" in a else None,
                keepdims=bool(a.get("keepdims", 1)),
            )
        if op in ("ArgMax", "ArgMin"):
            f = np.argmax if op == "ArgMax" else np.argmin
            r = f(x[0], axis=a.get("axis", 0))
            if a.get("keepdims", 1):
                r = np.expand_dims(r, a.get("axis", 0))
            return r.astype(np.int64)
        if op == "CumSum":
            axis = int(np.asarray(x[1]).item())
            v = x[0]
            if a.get("reverse"):
                v = np.flip(v, axis)
            out = np.cumsum(v, axis=axis, dtype=v.dtype)
            if a.get("exclusive"):
                out = np.roll(out, 1, axis)
                sl = [slice(None)] * out.ndim
                sl[axis] = slice(0, 1)
                out[tuple(sl)] = 0
            if a.get("reverse"):
                out = np.flip(out, axis)
            return out
        if op == "Einsum":
            return np.einsum(a["equation"], *x)
        if op == "MatMul":
            return np.matmul(x[0], x[1])
        if op == "Conv":
            n_sp = x[0].ndim - 2
            return _conv_nd(
                x[0],
                x[1],
                a.get("strides", [1] * n_sp),
                a.get("pads", [0] * 2 * n_sp),
                a.get("dilations", [1] * n_sp),
                a.get("group", 1),
            ) + (
                x[2].reshape(1, -1, *([1] * n_sp)) if len(x) > 2 else 0
            )
        if op == "ConvTranspose":
            n_sp = x[0].ndim - 2
            if any(d != 1 for d in a.get("dilations", [1] * n_sp)):
                raise NotImplementedError("ConvTranspose dilations")
            return _conv_transpose_nd(
                x[0],
                x[1],
                a.get("strides", [1] * n_sp),
                a.get("pads", [0] * 2 * n_sp),
                a.get("group", 1),
            )
        raise NotImplementedError(f"ONNX op {op}")
