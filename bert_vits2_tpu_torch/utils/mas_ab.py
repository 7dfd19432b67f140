"""Time another build of the MAS kernel (K3) against the checkout's, on one
card, in turns; or time each launch shape the plan can choose from.

    python -m bert_vits2_tpu_torch.utils.mas_ab OTHER/mas.cu
    python -m bert_vits2_tpu_torch.utils.mas_ab --sweep

OTHER is a copy of `csrc/mas.cu` from another commit (for example `git
archive <commit> bert_vits2_tpu_torch/csrc` unpacked under `build/`),
built with the same nvcc flags into its own library; a source without
`mas_link_probe` is called with the entry point of the block-per-item
kernel it had (always a device scratch for the decisions). At [16, 512,
128] with the ragged lengths `chip_smoke.py` uses and at [2, 1500, 1100],
both builds run in the order other, this, this, other: CUDA events over 20
launches after 2 warm-ups and the profiler's device time over 20 launches;
every launch's path is first checked against the plain version.

`--sweep` times the checkout's kernel at each K template with the fewest
warps that cover t_x (and each shape's plan) at the training shapes and a
few longer ones: the data behind `ops/align.py`'s plan (`PLAN_WARPS`).
Prints the card (name, power limit) first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from bert_vits2_tpu_torch import _build
from bert_vits2_tpu_torch.ops.align import (
    K_CHOICES, mas_plan, maximum_path, maximum_path_plain, plan_for_k)
from bert_vits2_tpu_torch.utils.bwd_ab import device_ms, event_ms

SOURCE = "mas.cu"
SHAPES = ((16, 512, 128), (2, 1500, 1100))
SWEEP_SHAPES = ((16, 512, 128), (16, 512, 64), (16, 800, 256), (8, 1500, 769),
                (2, 1500, 1100))
# the entry point of the block-per-item kernel before this one: neg_cent,
# t_ys, t_xs, path, decisions, b, t_y, t_x, device, stream
OLD_MAS_FWD = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def ragged_lengths(rng, b, t_y, t_x):
    """Per-item (t_y, t_x) with t_x <= t_y, the first item at full length
    (chip_smoke.py's)."""
    t_ys = rng.integers(t_y // 2, t_y + 1, b)
    t_xs = np.minimum(rng.integers(max(t_x // 2, 1), t_x + 1, b), t_ys)
    t_ys[0], t_xs[0] = t_y, min(t_x, t_y)
    return t_ys, t_xs


def inputs(b, t_y, t_x, rng, dev):
    g = torch.Generator(device=dev).manual_seed(t_y)
    neg = torch.randn(b, t_y, t_x, device=dev, generator=g) * 30.0 - 300.0
    t_ys, t_xs = ragged_lengths(rng, b, t_y, t_x)
    lens = [torch.as_tensor(a, device=dev, dtype=torch.int32) for a in (t_ys, t_xs)]
    return neg, lens


def load_other(path: Path):
    out = path.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    new = hasattr(lib, "mas_link_probe")
    lib.mas_fwd.argtypes = _build.SIGNATURES[SOURCE]["mas_fwd"] if new else OLD_MAS_FWD
    lib.mas_fwd.restype = ctypes.c_int
    return lib, new


def launcher(lib, new, neg, lens, plan=None):
    """A call of `lib`'s kernel on these inputs: through the plan's launch
    (the wrapper's, or `plan`) or the old entry point."""
    b, t_y, t_x = neg.shape
    path = torch.empty_like(neg)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (neg, *lens, path)]
    if not new:
        dec = torch.empty((b, t_y, (t_x + 31) // 32), dtype=torch.int32, device=neg.device)
        args = (*ptrs, dec.data_ptr(), b, t_y, t_x, 0, stream)
    else:
        k, warps, in_smem, smem = plan or mas_plan(t_y, t_x)
        dec = None if in_smem else torch.empty((b, t_y, warps * k), dtype=torch.int32,
                                               device=neg.device)
        args = (*ptrs, None if dec is None else dec.data_ptr(), b, t_y, t_x, k, warps,
                smem, 0, stream)

    def call():
        _build.check(lib.mas_fwd(*args), "mas_fwd")
        return path
    call.keep = dec  # the scratch lives as long as the call
    return call


def checked_ms(call, want) -> tuple[float, float]:
    got = call()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("the kernel's path differs from the plain version")
    return event_ms(call, iters=20), device_ms(call, iters=20)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def compare(other_path: str) -> None:
    this = _build.library(SOURCE)
    other, other_new = load_other(Path(other_path).resolve())
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for b, t_y, t_x in SHAPES:
        neg, lens = inputs(b, t_y, t_x, rng, dev)
        want = maximum_path_plain(neg, *lens)
        calls = {"other": launcher(other, other_new, neg, lens),
                 "this": launcher(this, True, neg, lens)}
        for name in ("other", "this", "this", "other"):
            ms, dms = checked_ms(calls[name], want)
            print(f"[mas_ab] [{b},{t_y},{t_x}] {name}: {ms:.4f} ms (device "
                  f"{dms:.4f} ms)", flush=True)


def sweep() -> None:
    lib = _build.library(SOURCE)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for b, t_y, t_x in SWEEP_SHAPES:
        neg, lens = inputs(b, t_y, t_x, rng, dev)
        want = maximum_path_plain(neg, *lens)
        chosen = mas_plan(t_y, t_x)
        for k in K_CHOICES:
            plan = plan_for_k(t_y, t_x, k)
            if plan is None:
                continue
            ms, dms = checked_ms(launcher(lib, True, neg, lens, plan), want)
            mark = " (the plan's)" if chosen == plan else ""
            print(f"[mas_ab] sweep [{b},{t_y},{t_x}] k {k} warps {plan.warps} "
                  f"decisions {'shared' if plan.dec_in_smem else 'device'}: {ms:.4f} "
                  f"ms (device {dms:.4f} ms){mark}", flush=True)
        before = maximum_path.launches
        maximum_path(neg, *lens)
        if maximum_path.launches != before + 1:
            raise AssertionError("the wrapper did not launch the kernel once")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit("usage: python -m bert_vits2_tpu_torch.utils.mas_ab "
                         "OTHER/mas.cu | --sweep (needs a CUDA device)")
    print(f"[mas_ab] {smi()}", flush=True)
    if argv[0] == "--sweep":
        sweep()
    else:
        compare(argv[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
