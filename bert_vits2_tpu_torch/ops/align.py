"""Monotonic alignment search (MAS): the wrapper of kernel K3.

Counterpart of `bert_vits2_tpu/ops/align.py` and `ops/align_pallas.py`. The
kernel, `csrc/mas.cu`, replaces the TPU kernel `_mas_kernel`
(align_pallas.py:39); its source note says what bounds it on the card and
how the design answers that. Beside it:

- `maximum_path_plain`, the same function in plain PyTorch: a loop over
  frames, each step vectorized over [b, t_x], then the backtrack loop (the
  shape of the JAX package's `maximum_path_scan`). The CPU runs it, and the
  tests and `chip_smoke.py` hold the kernel against it, bit for bit.
- `maximum_path`, the wrapper: plain version for CPU tensors, the kernel
  for CUDA tensors, an error for anything else. Its `launches` attribute
  counts kernel launches.

Semantics are the reference numba kernel's (monotonic_align/core.py:4-47):
the band max(0, t_x + y - t_y) <= x < min(t_x, y + 1) and the strict
tie-break `value[y-1, x] < value[y-1, x-1]` of the backtrack. Everything
stays on the tensors' device; the result carries no gradient.
"""

from __future__ import annotations

import torch

from bert_vits2_tpu_torch import _build

NEG = -1e9
SMEM_BYTES = 232448  # dynamic shared memory a block may take (227 KB)
SMEM_ROWS = 6  # csrc/mas.cu: two value rows and a ring of STAGES = 4


@torch.no_grad()
def maximum_path_plain(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                       t_xs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3 (same arguments as the wrapper)."""
    b, t_y, t_x = neg_cent.shape
    neg = neg_cent.to(torch.float32)
    dev = neg.device
    xs = torch.arange(t_x, device=dev)[None, :]
    t_ys = t_ys.to(device=dev, dtype=torch.int64)[:, None]
    t_xs = t_xs.to(device=dev, dtype=torch.int64)[:, None]
    neg_col = neg.new_full((b, 1), NEG)
    zero, floor = neg.new_zeros(()), neg.new_full((), NEG)
    row = neg.new_full((b, t_x), NEG)
    moves = []
    for y in range(t_y):
        shifted = torch.cat([neg_col, row[:, :-1]], dim=1)  # v[y-1, x-1]
        moves.append((xs == y) | (row < shifted))
        v_prev = torch.where(xs == 0, zero if y == 0 else floor, shifted)
        v_cur = torch.where(xs == y, floor, row)
        lo = (t_xs + y - t_ys).clamp(min=0)
        hi = t_xs.clamp(max=y + 1)
        in_band = (xs >= lo) & (xs < hi)
        row = neg[:, y] + torch.where(in_band, torch.maximum(v_prev, v_cur), zero)
    path = neg.new_zeros((b, t_y, t_x))
    index = t_xs - 1
    for y in range(t_y - 1, -1, -1):
        active = y < t_ys
        path[:, y] = ((xs == index) & active).to(path.dtype)
        decided = torch.gather(moves[y], 1, index.clamp(min=0))
        index = torch.where(active & (index != 0) & decided, index - 1, index)
    return path


def maximum_path(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                 t_xs: torch.Tensor) -> torch.Tensor:
    """neg_cent: [b, t_y, t_x] float32; t_ys, t_xs: [b] integer lengths
    (t_x <= t_y per item) -> the 0/1 path [b, t_y, t_x] float32, zero
    outside each item's lengths."""
    if neg_cent.dim() != 3:
        raise ValueError(f"neg_cent {tuple(neg_cent.shape)} is not [b, t_y, t_x]")
    b, t_y, t_x = neg_cent.shape
    if t_ys.shape != (b,) or t_xs.shape != (b,):
        raise ValueError("t_ys and t_xs must be [b]")
    if neg_cent.device.type == "cpu":
        return maximum_path_plain(neg_cent, t_ys, t_xs)
    if neg_cent.device.type != "cuda":
        raise ValueError(f"no kernel for device {neg_cent.device}")
    if t_ys.device != neg_cent.device or t_xs.device != neg_cent.device:
        raise ValueError("all inputs must lie on one device")
    if neg_cent.dtype != torch.float32:
        raise ValueError("the kernel takes float32 scores")
    if not neg_cent.is_contiguous():
        raise ValueError("the kernel takes contiguous scores")
    if b < 1 or t_y < 1 or t_x < 1 or SMEM_ROWS * 4 * t_x > SMEM_BYTES:
        raise ValueError(f"unsupported shape {tuple(neg_cent.shape)}")
    neg = neg_cent.detach()
    t_ys = t_ys.to(torch.int32).contiguous()
    t_xs = t_xs.to(torch.int32).contiguous()
    path = torch.empty_like(neg)
    decisions = torch.empty((b, t_y, (t_x + 31) // 32), dtype=torch.int32,
                            device=neg.device)
    lib = _build.library("mas.cu")
    err = lib.mas_fwd(
        neg.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), path.data_ptr(),
        decisions.data_ptr(), b, t_y, t_x, neg.device.index or 0,
        torch.cuda.current_stream(neg.device).cuda_stream,
    )
    _build.check(err, "mas_fwd")
    maximum_path.launches += 1
    return path


maximum_path.launches = 0
