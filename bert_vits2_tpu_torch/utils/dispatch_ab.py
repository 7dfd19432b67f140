"""Time the kernels' inference launches through other checkouts' wrappers
against this checkout's, on one card, in turns: the host time that the way
from a module to a kernel (the wrapper's checks, the op dispatch, the
ctypes call) adds to each launch.

    python -m bert_vits2_tpu_torch.utils.dispatch_ab NAME=DIR [NAME=DIR ...]

Each DIR is another checkout of the repository (for example `git archive
<commit> | tar -x -C build/ab/<name>`); `this` is the checkout that holds
the script. Every checkout runs in processes of its own that import its
package: first one per checkout, all at once, that builds its K1 and K2
sources into its own `build/`, then one per turn in the order a b ... this
this ... b a. Each turn times, through the public wrappers
`banded_rel_self_attention` and `fused_mrf` under `torch.inference_mode()`,
K1 at the serving path's [8, 2, 128, 96] and [8, 2, 768, 96] (w 4) and K2
at the V2.3 decoder's stages C = 64, 32, 16 of a 768-frame batch of 8:
CUDA events over 10 launches after 2 warm-ups (as `chip_smoke.py` times
its kernel table) and over 100, the host's microseconds per call over 100
calls without a sync between them, and the profiler's device time per
launch. A turn fails if the wrapper launched its kernel fewer times than
it was called. Prints the card (name, power limit) first, one JSON line per
turn, and the medians per checkout last.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

_BOOT = ("import runpy, sys; sys.path.insert(0, sys.argv[2]); "
         "runpy.run_path(sys.argv[1], run_name='__dispatch_ab__')")
SOURCES = ("banded_attn.cu", "mrf.cu")
THIS = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _events_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, iters: int = 100) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _device_ms(fn, iters: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def _time(fn, counter) -> dict:
    before = counter.launches
    row = {"events10_ms": _events_ms(fn, 10), "events100_ms": _events_ms(fn, 100),
           "host_us": _host_us(fn), "device_ms": _device_ms(fn)}
    # 2 + 10 + 2 + 100 + 100 + 1 + 10 calls above
    if counter.launches - before != 225:
        raise AssertionError(f"{counter.__name__}: {counter.launches - before} launches "
                             f"for 225 calls: the wrapper did not take its kernel")
    return row


def _measure() -> dict:
    """One turn in the checkout on sys.path[0]."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models.generator import ResBlock1
    from bert_vits2_tpu_torch.ops.attention import banded_rel_self_attention
    from bert_vits2_tpu_torch.ops.mrf import fused_mrf, prepare_mrf_weights

    dev = torch.device("cuda")
    b, frames, rows = 8, 768, {}

    def mask(t):
        return (torch.arange(t, device=dev)[None, :] < torch.tensor(
            [t - (t // 16) * i for i in range(b)], device=dev)[:, None]).float()

    with torch.inference_mode():
        for t in (128, frames):
            g = torch.Generator(device=dev).manual_seed(t)
            q, k, v = (torch.randn(b, 2, t, 96, device=dev, generator=g) for _ in range(3))
            ek, ev = (torch.randn(9, 96, device=dev, generator=g) / math.sqrt(96)
                      for _ in range(2))
            args = (q / math.sqrt(96), k, v, mask(t), ek, ev, 4)
            rows[f"K1 t={t}"] = _time(lambda: banded_rel_self_attention(*args),
                                      banded_rel_self_attention)
        cfg = ModelConfig()
        up = 1
        for i, rate in enumerate(cfg.upsample_rates):
            up *= rate
            c = cfg.upsample_initial_channel // 2 ** (i + 1)
            if c >= 128:
                continue
            torch.manual_seed(i)
            blocks = [ResBlock1(c, ks, ds).to(dev) for ks, ds in
                      zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
            weights = prepare_mrf_weights(blocks, torch.float32)
            x = torch.randn(b, c, frames * up, device=dev)
            m = mask(frames).repeat_interleave(up, dim=1).contiguous()
            rows[f"K2 C={c}"] = _time(lambda: fused_mrf(x, m, weights), fused_mrf)
    return rows


def _spawn(root: str, mode: str) -> subprocess.Popen:
    """This script in a process of its own over the checkout at `root`."""
    return subprocess.Popen([sys.executable, "-c", _BOOT, os.path.abspath(__file__), root,
                             mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or not all("=" in a for a in argv) or not torch.cuda.is_available():
        raise SystemExit("usage: python -m bert_vits2_tpu_torch.utils.dispatch_ab "
                         "NAME=DIR [NAME=DIR ...] (needs a CUDA device)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[dispatch_ab] {smi}", flush=True)
    trees = dict(a.split("=", 1) for a in argv)
    trees = {k: os.path.abspath(v) for k, v in trees.items()}
    trees["this"] = THIS
    builds = {name: _spawn(root, "build") for name, root in trees.items()}
    for name, proc in builds.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"[dispatch_ab] {name}: the build failed:\n{err[-4000:]}")
    order = list(trees)[:-1]
    turns = order + ["this", "this"] + order[::-1]
    results = {name: [] for name in trees}
    for name in turns:
        proc = _spawn(trees[name], "measure")
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"[dispatch_ab] {name}: the turn failed:\n{err[-4000:]}")
        rows = json.loads(out.strip().splitlines()[-1])
        results[name].append(rows)
        print(json.dumps({"tree": name, **rows}), flush=True)
    print(f"[dispatch_ab] {smi}: medians over each checkout's turns "
          "(events over 10 / 100 launches ms, host us per call, device ms):", flush=True)
    for name, runs in results.items():
        for case in runs[0]:
            med = {k: statistics.median(r[case][k] for r in runs) for k in runs[0][case]}
            print(f"[dispatch_ab] {name:>8} {case:>9}: {med['events10_ms']:.4f} / "
                  f"{med['events100_ms']:.4f} ms, host {med['host_us']:.1f} us, device "
                  f"{med['device_ms']:.4f} ms", flush=True)
    return 0


if __name__ == "__dispatch_ab__":
    if sys.argv[3] == "build":
        from bert_vits2_tpu_torch import _build
        started = {source: _build._start(source) for source in SOURCES}  # nvcc at once
        for source, (out, proc) in started.items():
            _build._finish(source, out, proc)
    else:
        print(json.dumps(_measure()), flush=True)
elif __name__ == "__main__":
    raise SystemExit(main())
