"""Banded relative-position self-attention: the wrapper of kernel K1.

Counterpart of `bert_vits2_tpu/ops/attention_pallas.py`. The kernel,
`csrc/banded_attn.cu`, replaces the TPU kernel `_attn_fwd_kernel`
(attention_pallas.py:88) at inference; its source note says what bounds it
on the card and how the design answers that. Beside it:

- `banded_attention_plain`, the same function in plain PyTorch: the JAX
  package's `_dense` branch (nn/attention.py:183-194). The CPU runs it, and
  the tests and `chip_smoke.py` hold the kernel against it. It masks query
  rows as well as keys; the kernel masks keys only, so the two agree on
  valid rows, which is all any caller reads.
- `banded_rel_self_attention`, the wrapper: plain version for CPU tensors,
  the kernel for CUDA tensors, and an error for anything else. Its
  `launches` attribute counts kernel launches.

The kernel serves the no-grad direction only: the backward kernels come
later, so the wrapper refuses tensors that require grad while grad mode is
on (a kernel result without a graph would train with zero attention
gradients), and it refuses attention dropout. The training direction calls
`banded_attention_plain` itself, which is differentiable and takes the
dropout rate (`nn/attention.py` holds that dispatch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bert_vits2_tpu_torch import _build

NEG_FILL = -1e4  # the reference's mask fill: a fully masked row is uniform
MAX_HEAD_DIM = 128
MAX_WINDOW = 4


def _band_index(t: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[t, t] index of the band column c = j - i + w (clamped) and the band
    mask |j - i| <= w."""
    pos = torch.arange(t, device=device)
    c = pos[None, :] - pos[:, None] + w
    inside = (c >= 0) & (c <= 2 * w)
    return c.clamp(0, 2 * w), inside


def band_to_abs(rel: torch.Tensor, w: int) -> torch.Tensor:
    """[b, h, t, 2w+1] band logits -> [b, h, t, t] with B[i, j] =
    rel[i, j - i + w] inside the band and 0 outside."""
    b, h, t, _ = rel.shape
    c, inside = _band_index(t, w, rel.device)
    out = torch.gather(rel, 3, c.expand(b, h, t, t))
    return out * inside.to(rel.dtype)


def abs_to_band(p: torch.Tensor, w: int) -> torch.Tensor:
    """[b, h, t, t] weights -> [b, h, t, 2w+1] with band[i, c] =
    p[i, i + c - w] (0 where i + c - w is outside [0, t))."""
    b, h, t, _ = p.shape
    pos = torch.arange(t, device=p.device)
    cols = pos[:, None] + torch.arange(2 * w + 1, device=p.device)[None, :] - w
    valid = (cols >= 0) & (cols < t)
    idx = cols.clamp(0, t - 1).expand(b, h, t, 2 * w + 1)
    return torch.gather(p, 3, idx) * valid.to(p.dtype)


def banded_attention_plain(q, k, v, x_mask, emb_rel_k, emb_rel_v,
                           window_size: int,
                           dropout_p: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of K1 (same arguments as the wrapper), and
    the training direction: differentiable, with dropout on the
    probabilities when `dropout_p` > 0."""
    w = int(window_size)
    scores = torch.matmul(q, k.transpose(-1, -2))
    rel = torch.einsum("bhtd,cd->bhtc", q, emb_rel_k)
    scores = scores + band_to_abs(rel, w)
    am = x_mask[:, None, :, None] * x_mask[:, None, None, :]
    scores = scores.masked_fill(am == 0, NEG_FILL)
    p = torch.softmax(scores, dim=-1)
    if dropout_p:
        p = F.dropout(p, dropout_p)
    out = torch.matmul(p, v)
    return out + torch.einsum("bhtc,cd->bhtd", abs_to_band(p, w), emb_rel_v)


def _check_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(
            "banded_rel_self_attention has no backward: run it under "
            "torch.inference_mode() or torch.no_grad(), or call "
            "banded_attention_plain"
        )


def banded_rel_self_attention(q, k, v, x_mask, emb_rel_k, emb_rel_v,
                              window_size: int,
                              dropout_p: float = 0.0) -> torch.Tensor:
    """q, k, v: [b, h, t, d] (q pre-scaled by 1/sqrt(d)); x_mask: [b, t] 0/1;
    emb_rel_k/v: [2w+1, d] (one table shared by the heads).
    Returns [b, h, t, d]; rows where x_mask is 0 are unspecified."""
    if dropout_p:
        raise ValueError("the kernel has no dropout: the training direction "
                         "calls banded_attention_plain")
    _check_no_grad(q, k, v, emb_rel_k, emb_rel_v)
    w = int(window_size)
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    if x_mask.shape != (b, t):
        raise ValueError(f"x_mask {tuple(x_mask.shape)} is not {(b, t)}")
    if emb_rel_k.shape != (2 * w + 1, d) or emb_rel_v.shape != (2 * w + 1, d):
        raise ValueError("emb_rel_k/v must be [2w+1, d]")
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, x_mask, emb_rel_k, emb_rel_v, w)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    tensors = (q, k, v, x_mask, emb_rel_k, emb_rel_v)
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must lie on one device")
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("the kernel takes float32 inputs")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("the kernel takes contiguous inputs")
    if not (1 <= d <= MAX_HEAD_DIM and 0 <= w <= MAX_WINDOW and t >= 2 * w):
        raise ValueError(f"unsupported shape t={t} d={d} w={w}")
    out = torch.empty_like(q)
    lib = _build.library("banded_attn.cu")
    err = lib.banded_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), x_mask.data_ptr(),
        emb_rel_k.data_ptr(), emb_rel_v.data_ptr(), out.data_ptr(),
        b, h, t, d, w, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "banded_attn_fwd")
    banded_rel_self_attention.launches += 1
    return out


banded_rel_self_attention.launches = 0
