"""Monotonic alignment search (MAS): the wrapper of kernel K3.

Counterpart of `bert_vits2_tpu/ops/align.py` and `ops/align_pallas.py`. The
kernel, `csrc/mas.cu`, replaces the TPU kernel `_mas_kernel`
(align_pallas.py:39); its source note says what bounds it on the card and
how the design answers that. Beside it:

- `maximum_path_plain`, the same function in plain PyTorch: a loop over
  frames, each step vectorized over [b, t_x], then the backtrack loop (the
  shape of the JAX package's `maximum_path_scan`). The CPU runs it, and the
  tests and `chip_smoke.py` hold the kernel against it, bit for bit.
- `mas_plan`, the launch's shape by (t_y, t_x): columns per lane K, warps
  per item, and whether the move-left bits fit in shared memory (else a
  scratch in device memory); `plan_for_k` builds the plan for one K.
  Plain functions, so the CPU tests read them.
- `maximum_path`, the wrapper: plain version for CPU tensors, the kernel
  for CUDA tensors, an error for anything else. Its `launches` attribute
  counts kernel launches.

Semantics are the reference numba kernel's (monotonic_align/core.py:4-47):
the band max(0, t_x + y - t_y) <= x < min(t_x, y + 1) and the strict
tie-break `value[y-1, x] < value[y-1, x-1]` of the backtrack. Everything
stays on the tensors' device; the result carries no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bert_vits2_tpu_torch import _build

NEG = -1e9
SMEM_BYTES = 232448  # dynamic shared memory a block may take (227 KB)
# csrc/mas.cu: its templates of K (columns per lane), the warps a block may
# have (compute warps and at least one helper) and the boundary ring
# between two warps
K_CHOICES = (1, 2, 4, 8, 16, 32)
MAX_WARPS = 16
RING_FRAMES = 64
# the plan takes the fewest columns per lane whose warps number at most
# PLAN_WARPS: a frame's time grows with K (its chain and its instructions),
# while warps beyond one per SM sub-partition cost little
# (`python -m bert_vits2_tpu_torch.utils.mas_ab --sweep` on the card)
PLAN_WARPS = 12


def _stages(k: int) -> int:
    """Frames of scores in flight per warp (csrc/mas.cu `stages`)."""
    return 32 if k <= 2 else 16 if k == 4 else 8 if k <= 16 else 4


def mas_smem_bytes(t_y: int, k: int, warps: int, dec_in_smem: bool) -> int:
    """Shared memory of one block (csrc/mas.cu `smem_bytes`): the score
    rings, the boundary rings, the progress counters and, where they fit,
    the move-left bits."""
    words = warps * _stages(k) * 32 * k + warps * RING_FRAMES + MAX_WARPS
    if dec_in_smem:
        words += t_y * warps * k
    return 4 * words


class MasPlan(NamedTuple):
    k: int  # columns per lane
    warps: int  # compute warps per item: 32 * k * warps >= t_x
    dec_in_smem: bool  # move-left bits in shared memory, else device scratch
    smem_bytes: int


def plan_for_k(t_y: int, t_x: int, k: int,
               dec_in_smem: bool | None = None) -> MasPlan | None:
    """The launch with K columns per lane for scores [b, t_y, t_x]: the
    fewest warps that cover t_x, the move-left bits in shared memory where
    t_y * warps * k words fit beside the rings (or where `dec_in_smem`
    says); None where the block does not fit. Every plan, the wrapper's,
    the tests' and `utils/mas_ab.py`'s, is made here; the kernel refuses a
    launch whose shared-memory figure is not its own."""
    warps = -(-t_x // (32 * k))
    if dec_in_smem is None:
        dec_in_smem = mas_smem_bytes(t_y, k, warps, True) <= SMEM_BYTES
    smem = mas_smem_bytes(t_y, k, warps, dec_in_smem)
    if warps + 1 > MAX_WARPS or smem > SMEM_BYTES:
        return None
    return MasPlan(k, warps, dec_in_smem, smem)


def mas_plan(t_y: int, t_x: int) -> MasPlan:
    """The kernel's launch for scores [b, t_y, t_x]: the least K whose
    `plan_for_k` fits with at most PLAN_WARPS warps. Raises ValueError
    where no template fits."""
    for k in K_CHOICES:
        plan = plan_for_k(t_y, t_x, k)
        if plan is not None and plan.warps <= PLAN_WARPS:
            return plan
    raise ValueError(f"unsupported shape t_y={t_y} t_x={t_x}")


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
    if b < 1 or t_y < 1 or t_x < 1:
        raise ValueError(f"unsupported shape {tuple(neg_cent.shape)}")
    return _launch(neg_cent.detach(), t_ys, t_xs, mas_plan(t_y, t_x))


def _launch(neg: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor,
            plan: MasPlan) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs with this plan (the
    tests also give it plans other than `mas_plan`'s)."""
    b, t_y, t_x = neg.shape
    t_ys = t_ys.to(torch.int32).contiguous()
    t_xs = t_xs.to(torch.int32).contiguous()
    path = torch.empty_like(neg)
    decisions = None if plan.dec_in_smem else torch.empty(
        (b, t_y, plan.warps * plan.k), dtype=torch.int32, device=neg.device)
    err = _build.library("mas.cu").mas_fwd(
        neg.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), path.data_ptr(),
        None if decisions is None else decisions.data_ptr(), b, t_y, t_x,
        plan.k, plan.warps, plan.smem_bytes, neg.device.index or 0,
        torch.cuda.current_stream(neg.device).cuda_stream,
    )
    _build.check(err, "mas_fwd")
    maximum_path.launches += 1
    return path


maximum_path.launches = 0
