"""The custom-op namespace of the kernels' inference entry points.

K1's and K2's no-grad launches (`ops/attention.py`, `ops/mrf.py`) are ops
of the `torch.library` namespace `bv2` (`torch.ops.bv2.*`): a CUDA
implementation that launches the kernel (and counts the launch), a CPU
implementation that is the kernel's plain version, and a fake one that
gives `torch.export` the output's shape and dtype. The wrappers decide
which op a call takes and refuse what no kernel takes before they call it;
the modules reach the kernels through these ops on every path (the engine,
the server, the stages), so a program that `torch.export` traces through
the modules holds `torch.ops.bv2.*` calls and launches the kernels when it
runs on the card. The kernels are bound through ctypes, which
`torch.export` cannot trace; as ops they are opaque calls it records.

The ops are registered on a `torch.library.Library` directly (a schema and
one implementation per dispatch key), without `torch.library.custom_op`'s
Python layers around each call, and the wrappers hold the `OpOverload`s,
so a launch pays the dispatcher's call into Python and nothing more.

`plain_functions()` is the counterpart of the JAX package's
`force_lax_attention` (ops/attention_pallas.py:476): inside it the wrappers
call the plain versions directly on CPU tensors, so a trace holds ATen ops
only. The ONNX exporter (`compat/torch2onnx.py`) enters it; no serving path
does. A tensor on any other device raises there (`refuse_plain`): a context
that leaked onto a serving thread must not put the plain versions in the
kernels' place on the card.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

NAMESPACE = "bv2"

_LIB = torch.library.Library(NAMESPACE, "DEF")

_PLAIN = contextvars.ContextVar("bv2_plain_functions", default=False)


@contextlib.contextmanager
def plain_functions():
    """Within this context (in this thread) the kernel wrappers call the
    plain versions on CPU tensors instead of the `bv2` ops, and refuse
    tensors on any other device."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_only() -> bool:
    """Whether the caller is inside `plain_functions()`."""
    return _PLAIN.get()


def refuse_plain(device: torch.device) -> None:
    """Raise inside `plain_functions()`: a wrapper's branch for tensors off
    the CPU calls this before anything else."""
    if _PLAIN.get():
        raise RuntimeError(
            f"plain_functions() takes CPU tensors only (it serves the ONNX "
            f"exporter's trace); tensors on {device} launch the kernels outside it")


def define(name: str, schema: str, plain, launch, fake) -> torch._ops.OpOverload:
    """Register `bv2::<name>` with this schema (arguments and result, as
    "(Tensor x, ...) -> Tensor"): `plain` its CPU implementation, `launch`
    its CUDA one, `fake` its fake (meta) one. Returns the op's overload,
    `torch.ops.bv2.<name>.default`."""
    _LIB.define(name + schema)
    _LIB.impl(name, plain, "CPU")
    _LIB.impl(name, launch, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
