"""Random draws of the training and synthesis paths, from an explicit
`torch.Generator`.

Every draw of the model goes through `randn` or `rand`, so a test can
replace the two and feed the port the numbers it feeds the JAX package.
A generator on another device than the tensors (a CPU generator beside a
model on the card) draws on its own device and the numbers are copied over:
one seed then gives one stream of numbers on either device. Dropout is not
drawn here; it uses torch's global generator, as `torch.nn.Dropout` does.
"""

from __future__ import annotations

import torch


def _draw(fn, shape, generator, device, dtype):
    src = device if generator is None else generator.device
    return fn(tuple(shape), generator=generator, device=src, dtype=dtype).to(device)


def randn(shape, generator: torch.Generator | None, device,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal numbers of `shape` on `device`."""
    return _draw(torch.randn, shape, generator, device, dtype)


def rand(shape, generator: torch.Generator | None, device,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform numbers in [0, 1) of `shape` on `device`."""
    return _draw(torch.rand, shape, generator, device, dtype)
