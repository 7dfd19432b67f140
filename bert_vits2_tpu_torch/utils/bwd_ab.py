"""Time another build of the attention backward kernels (B5, B6) against the
checkout's, on one card, in turns.

    python -m bert_vits2_tpu_torch.utils.bwd_ab OTHER/banded_attn_bwd.cu

OTHER is a copy of `csrc/` from another commit (for example `git archive
<commit> bert_vits2_tpu_torch/csrc` unpacked under `build/`); its source is
built with the same nvcc flags into its own library. At the training
step's shapes ([16, 2, t, 96], t = 512 and 128, p_drop 0.1) the script
times B5 and B6 through their wrappers with each library in the order
other, this, this, other: CUDA events over 10 launches after 2 warm-ups,
and the profiler's device time over 10 launches. Prints the card (name,
power limit) first.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

from bert_vits2_tpu_torch import _build
from bert_vits2_tpu_torch.ops.attention import (
    banded_attention_bwd_k,
    banded_attention_bwd_q,
    banded_attention_fwd_train,
)

SOURCE = "banded_attn_bwd.cu"


class _NoSalt:
    """A library whose B5/B6 entry points predate the salt arguments: calls
    with this checkout's arguments drop salt_base and salt_stride (the two
    before scale, device, stream)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name.endswith("_blocks"):
            return fn
        return lambda *args: fn(*args[:-5], *args[-3:])


def load_other(path: Path):
    out = path.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    salted = "salt_stride" in path.read_text()
    for name, argtypes in _build.SIGNATURES[SOURCE].items():
        fn = getattr(lib, name)
        if not salted and len(argtypes) > 3:
            argtypes = argtypes[:-5] + argtypes[-3:]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib if salted else _NoSalt(lib)


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit("usage: python -m bert_vits2_tpu_torch.utils.bwd_ab "
                         "OTHER/banded_attn_bwd.cu (needs a CUDA device)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[bwd_ab] {smi}", flush=True)
    libs = {"other": load_other(Path(argv[0]).resolve()),
            "this": _build.library(SOURCE)}
    dev = torch.device("cuda")
    b, h, d, w, p_drop, seed = 16, 2, 96, 4, 0.1, 5
    for t in (512, 128):
        g = torch.Generator(device=dev).manual_seed(t)
        q, k, v, go = (torch.randn(b, h, t, d, device=dev, generator=g)
                       for _ in range(4))
        q = q / math.sqrt(d)
        ek, ev = (torch.randn(2 * w + 1, d, device=dev, generator=g) / math.sqrt(d)
                  for _ in range(2))
        m = (torch.arange(t, device=dev)[None, :]
             < torch.tensor([t - (t // 16) * i for i in range(b)], device=dev)[:, None]).float()
        out, mr, lr = banded_attention_fwd_train(q, k, v, m, ek, ev, w, p_drop, seed)
        args = (q, k, v, m, ek, ev, go, mr, lr, (go * out).sum(-1), w, p_drop, seed)
        for name in ("other", "this", "this", "other"):
            _build._libs[SOURCE] = libs[name]
            row = []
            for kernel, fn in (("B5", banded_attention_bwd_q), ("B6", banded_attention_bwd_k)):
                call = lambda: fn(*args)  # noqa: E731
                row.append(f"{kernel} {event_ms(call):.4f} ms (device {device_ms(call):.4f} ms)")
            print(f"[bwd_ab] [{b},{h},{t},{d}] p_drop {p_drop} {name}: " + ", ".join(row),
                  flush=True)
    _build._libs[SOURCE] = libs["this"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
