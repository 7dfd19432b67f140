"""Probe the card's TF32 tensor-core paths (csrc/tc_probe.cu).

    python -m bert_vits2_tpu_torch.utils.tc_probe

Prints the card (nvidia-smi name and power limit), then:

- which wgmma B-descriptor convention reproduces A B^T for the core-matrix
  layout the kernels use (leading and stride byte offsets 128 and 256, and
  swapped), as the max-abs-err against the product on the card in fp32;
- the TF32 rate of mma.sync.m16n8k8 and of wgmma.m64n64k8 (A from
  registers), each from CUDA events around a grid that issues independent
  products back to back, in TFLOP/s of TF32 products.
"""

from __future__ import annotations

import subprocess

import torch

from bert_vits2_tpu_torch import _build


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tc_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[tc_probe] {smi}")
    lib = _build.library("tc_probe.cu")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(64, 8, device="cuda", generator=g)
    b = torch.randn(16, 8, device="cuda", generator=g)
    want = a @ b.T
    for lbo, sbo in ((128, 256), (256, 128)):
        d = torch.full((64, 16), float("nan"), device="cuda")
        _build.check(lib.tc_probe_layout(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                         lbo, sbo, stream), "tc_probe_layout")
        torch.cuda.synchronize()
        err = (d - want).abs().max().item()
        print(f"[tc_probe] wgmma m64n16k8 tf32, B core matrices: lbo {lbo} sbo "
              f"{sbo}: max_abs_err {err:.3e} against fp32 A B^T (TF32 ~1e-2)")
    sink = torch.zeros(1, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, name, threads, flop in ((0, "mma.sync m16n8k8", 256, 8 * 8 * 2048),
                                      (1, "wgmma m64n64k8", 128, 4 * 65536)):
        for per_sm in (1, 2, 4):
            blocks, iters = sms * per_sm, 4000
            run = lambda: _build.check(lib.tc_probe_rate(  # noqa: E731
                sink.data_ptr(), kind, iters, blocks, stream), "tc_probe_rate")
            run()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            tflops = blocks * iters * flop / (ms * 1e-3) / 1e12
            print(f"[tc_probe] {name} tf32: {blocks} blocks of {threads} threads "
                  f"({per_sm} per SM): {ms:.3f} ms, {tflops:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
