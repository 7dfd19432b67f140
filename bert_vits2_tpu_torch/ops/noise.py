"""Random draws of the training and synthesis paths, from an explicit
`torch.Generator`.

Every draw of the model goes through `randn` or `rand`, so a test can
replace the two and feed the port the numbers it feeds the JAX package.
A generator on another device than the tensors (a CPU generator beside a
model on the card) draws on its own device and the numbers are copied over:
one seed then gives one stream of numbers on either device. The module
dropouts draw here too (`dropout`), from torch's global generator as
`torch.nn.Dropout` does, except inside a train step, whose mask generator
(`parallel/data.py:DropoutMasks`) every rank draws from alike; a parity
test's replacement of `randn` and `rand` leaves them alone.

Every call names its batch axis. Inside a data shard (`parallel/data.py`:
a rank of a data-parallel step, a replica of the data-parallel engine) the
draw has the global batch's rows on that axis, as the JAX package draws
the global array from one key, and the shard's rows are returned: the
numbers of a row do not depend on how the batch is split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bert_vits2_tpu_torch.parallel.data import dropout_masks, shard_rows


def _draw(fn, shape, generator, device, dtype, batch_axis):
    src = device if generator is None else generator.device
    shape = tuple(shape)
    rows = shard_rows(shape[batch_axis])
    if rows is None:
        return fn(shape, generator=generator, device=src, dtype=dtype).to(device)
    offset, total = rows
    full = shape[:batch_axis] + (total,) + shape[batch_axis + 1:]
    x = fn(full, generator=generator, device=src, dtype=dtype)
    n = min(shape[batch_axis], max(total - offset, 0))
    x = x.narrow(batch_axis, min(offset, total), n)
    if n < shape[batch_axis]:  # rows past the draw (padding): zeros
        pad = list(shape)
        pad[batch_axis] -= n
        x = torch.cat([x, x.new_zeros(pad)], dim=batch_axis)
    return x.contiguous().to(device)


def randn(shape, generator: torch.Generator | None, device,
          dtype: torch.dtype = torch.float32, batch_axis: int = 0) -> torch.Tensor:
    """Standard normal numbers of `shape` on `device`; `batch_axis` is the
    axis of the batch's rows."""
    return _draw(torch.randn, shape, generator, device, dtype, batch_axis)


def rand(shape, generator: torch.Generator | None, device,
         dtype: torch.dtype = torch.float32, batch_axis: int = 0) -> torch.Tensor:
    """Uniform numbers in [0, 1) of `shape` on `device`; `batch_axis` as
    `randn`'s."""
    return _draw(torch.rand, shape, generator, device, dtype, batch_axis)


def dropout(x: torch.Tensor, p: float,
            channels: tuple[int, int] | None = None) -> torch.Tensor:
    """Dropout of x at rate p (train mode). Inside a train step the mask is
    drawn for the global batch's rows (axis 0) and, where a model rank
    holds channels [r c, (r+1) c) of axis 1 (`channels` = (r, n)), for
    every rank's channels, from the step's mask generator, and the shard's
    part is kept: a row's mask does not depend on how the batch or the
    channels are split. Elsewhere `F.dropout` from torch's global
    generator."""
    if not p:
        return x
    gen = dropout_masks(x.device)
    if gen is None:
        if channels is not None and channels[1] > 1:
            raise ValueError("a dropout on a model-parallel activation needs the "
                             "train step's mask generator")
        return F.dropout(x, p)
    shape = list(x.shape)
    if channels is not None:
        shape[1] *= channels[1]
    u = _draw(torch.rand, shape, gen, x.device, torch.float32, 0)
    if channels is not None:
        u = u.narrow(1, channels[0] * x.shape[1], x.shape[1])
    return _Masked.apply(x, u >= p, 1.0 / (1.0 - p))


class _Masked(torch.autograd.Function):
    """x * keep * scale, `F.dropout`'s formula (the scale in float32 also
    for a bf16 x), keeping the bool mask for the backward as `F.dropout`
    does, not a mask in x's dtype."""

    @staticmethod
    def forward(ctx, x, keep, scale):
        ctx.save_for_backward(keep)
        ctx.scale = scale
        return x * keep * scale

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return g * keep * ctx.scale, None, None
