"""Sequence-mask, path and slicing primitives (reference: commons.py:22-140).

Counterpart of `bert_vits2_tpu/ops/masking.py`, with the same signatures:
masks are float tensors [b, t] and the path is [b, t_y, t_x]. The slicing
functions cut windows along the LAST axis (time in the port's [b, c, t]
layout, and in a [b, t] batch of waves).
"""

from __future__ import annotations

import torch

from bert_vits2_tpu_torch.ops import noise


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[b] int lengths -> [b, t] float32 0/1 mask."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return (pos[None, :] < lengths[:, None]).to(torch.float32)


def generate_path(duration: torch.Tensor, x_mask: torch.Tensor,
                  y_mask: torch.Tensor) -> torch.Tensor:
    """Monotonic 0/1 alignment from integer-valued durations.

    duration: [b, t_x] (already masked), x_mask: [b, t_x], y_mask: [b, t_y]
    -> path [b, t_y, t_x]: frame y belongs to token x when
    cum[x-1] <= y < cum[x].
    """
    t_y = y_mask.shape[1]
    cum = torch.cumsum(duration, dim=-1)  # [b, t_x]
    pos = torch.arange(t_y, device=duration.device, dtype=cum.dtype)
    path = (pos[None, None, :] < cum[:, :, None]).to(torch.float32)  # [b,t_x,t_y]
    path = path - torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    path = path.transpose(1, 2)  # [b, t_y, t_x]
    return path * x_mask[:, None, :] * y_mask[:, :, None]


def slice_segments(x: torch.Tensor, starts: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """Fixed-length time windows: x [b, ..., t], starts [b] -> [b, ..., s]."""
    idx = starts.to(torch.int64).view(-1, *([1] * (x.dim() - 1)))
    idx = idx + torch.arange(segment_size, device=x.device)
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], segment_size))


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor,
                        segment_size: int,
                        generator: torch.Generator | None = None):
    """Random training windows (commons.py:56-62): x [b, ..., t], lengths [b]
    -> (segments [b, ..., s], starts [b]); start = int(u * max(len - s + 1, 0))
    with u uniform in [0, 1)."""
    max_start = (lengths - segment_size + 1).clamp(min=0).to(torch.float32)
    u = noise.rand((x.shape[0],), generator, x.device, batch_axis=0)
    starts = (u * max_start).to(torch.int64)
    return slice_segments(x, starts, segment_size), starts


def kl_divergence_gaussian(m_p, logs_p, m_q, logs_q):
    """KL(P||Q) per element for diagonal Gaussians (commons.py:28-34)."""
    return ((logs_q - logs_p) - 0.5
            + 0.5 * (torch.exp(2.0 * logs_p) + (m_p - m_q) ** 2)
            * torch.exp(-2.0 * logs_q))
