"""Random draws of the training and synthesis paths, from an explicit
`torch.Generator`.

Every draw of the model goes through `randn` or `rand`, so a test can
replace the two and feed the port the numbers it feeds the JAX package.
A generator on another device than the tensors (a CPU generator beside a
model on the card) draws on its own device and the numbers are copied over:
one seed then gives one stream of numbers on either device. Dropout is not
drawn here; it uses torch's global generator, as `torch.nn.Dropout` does.

Every call names its batch axis. Inside a data shard (`parallel/data.py`:
a rank of a data-parallel step, a replica of the data-parallel engine) the
draw has the global batch's rows on that axis, as the JAX package draws
the global array from one key, and the shard's rows are returned: the
numbers of a row do not depend on how the batch is split.
"""

from __future__ import annotations

import torch

from bert_vits2_tpu_torch.parallel.data import shard_rows


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
