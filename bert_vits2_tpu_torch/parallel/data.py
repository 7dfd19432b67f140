"""The global batch under a data mesh: what each rank (or each replica of
one process) must compute so that its rows get what the one-process run
over the whole batch gives them.

The JAX package runs data parallelism as one program over the global
batch (XLA splits the arrays), so every random draw, statistic and mask is
the global batch's. The port runs one program per shard, and a shard sees
its own rows only. `data_shard` says, for the code that runs inside it,
which rows of which global batch these are; the model's code asks:

- `ops/noise.py` draws the global batch's numbers and keeps the shard's
  rows (`shard_rows`);
- `nn/attention.py` salts the hash dropout with the global row
  (`dropout_salt`) and draws its seeds from the shard's shared generator,
  so a row's masks do not depend on the split;
- the masked ratios divide by `global_count` and the MAS noise scales by
  `global_std`, all-reduced over the data group;
- the train step averages the gradients (`reduce_gradients`) and the
  losses (`reduce_mean`) over the data group.

Outside any shard, and on a shard with no group, each of these is the
one-process code: the draws are the local batch's, the salt is b * heads +
head, the counts and the std are the local ones. The shard is a context
variable (per thread, set and reset by `data_shard`) rather than an
argument, because the draws and ratios sit deep inside the modules, whose
signatures stay the reference's.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.distributed as dist


class DataShard(NamedTuple):
    """offset: the shard's first row of the global batch; rows: the global
    batch's rows; group: the process group whose ranks hold the other rows
    (statistics are all-reduced over it; None: no reduction, as for the
    replicas of one process); size: the group's ranks (1 without one);
    seeds: the generator every shard draws the hash dropout's seeds from
    alike (None: torch's global generator); draw_rows: the rows the noise
    is drawn for, when fewer than `rows` (the engine's padding to the data
    axis adds rows that the one-device batch does not have: they get zero
    noise, and their outputs are discarded)."""

    offset: int
    rows: int
    group: object | None = None
    size: int = 1
    seeds: torch.Generator | None = None
    draw_rows: int | None = None


_SHARD: contextvars.ContextVar[DataShard | None] = contextvars.ContextVar(
    "bv2_data_shard", default=None)


@contextlib.contextmanager
def data_shard(offset: int, rows: int, group=None, size: int = 1,
               seeds: torch.Generator | None = None, draw_rows: int | None = None):
    """Run the body as the shard of rows [offset, offset + local) of a
    `rows`-row global batch (see the module note). Per thread."""
    token = _SHARD.set(DataShard(int(offset), int(rows), group, int(size), seeds,
                                 None if draw_rows is None else int(draw_rows)))
    try:
        yield
    finally:
        _SHARD.reset(token)


def shard_rows(local: int) -> tuple[int, int] | None:
    """(offset, rows drawn) for a draw whose batch axis has `local` rows,
    or None when the draw is the local batch's own (no shard, or a shard
    that is the whole batch). Rows of the shard past the rows drawn
    (`DataShard.draw_rows`) take zeros."""
    shard = _SHARD.get()
    if shard is None or shard.rows == local and shard.offset == 0:
        return None
    if shard.offset + local > shard.rows:
        raise ValueError(f"rows [{shard.offset}, {shard.offset + local}) are not in "
                         f"the global batch of {shard.rows}")
    return shard.offset, shard.rows if shard.draw_rows is None else shard.draw_rows


def dropout_salt(heads: int) -> tuple[int, int]:
    """(salt_base, salt_stride) of the hash dropout for a [b, heads, ...]
    attention: batch row b, head h is salted salt_base + b * salt_stride +
    h, the salt of its global row (stride heads; the base the shard's first
    row times heads)."""
    shard = _SHARD.get()
    return (0 if shard is None else shard.offset * heads), heads


def dropout_seeds() -> torch.Generator | None:
    shard = _SHARD.get()
    return None if shard is None else shard.seeds


def _group() -> tuple[object, int] | None:
    shard = _SHARD.get()
    if shard is None or shard.group is None:
        return None
    return shard.group, shard.size


def global_count(local: torch.Tensor) -> torch.Tensor:
    """A masked ratio's denominator: the local count (a mask's sum) summed
    over the data group, without gradient, and divided by the group's size
    (the gradients are averaged, `reduce_gradients`), so that the ranks'
    ratios average to the global batch's. Without a group: `local`."""
    g = _group()
    if g is None:
        return local
    total = local.detach().reshape(1).clone()
    dist.all_reduce(total, group=g[0])
    return total[0] / g[1]


def global_std(x: torch.Tensor) -> torch.Tensor:
    """The population std of x over the global batch (every shard's x has
    one shape): the mean from the all-reduced sum, then the all-reduced sum
    of squared deviations, without gradient. Without a group, or with one
    rank: torch.std(x, correction=0)."""
    g = _group()
    if g is None or g[1] == 1:
        return torch.std(x, correction=0)
    n = x.numel() * g[1]
    s = x.detach().sum().reshape(1)
    dist.all_reduce(s, group=g[0])
    ss = ((x.detach() - s[0] / n) ** 2).sum().reshape(1)
    dist.all_reduce(ss, group=g[0])
    return torch.sqrt(ss[0] / n)


def reduce_gradients(grads: list[torch.Tensor], group, size: int) -> None:
    """Average the gradients over the data group in place: one flattened
    buffer per call (one all-reduce), summed, divided by the size."""
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    flat /= size
    for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def reduce_mean(values: dict[str, torch.Tensor], group, size: int) -> dict:
    """The 0-d tensors of `values` averaged over the data group (one
    all-reduce of their stack)."""
    if not values:
        return values
    names = list(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in names])
    dist.all_reduce(flat, group=group)
    flat /= size
    return dict(zip(names, flat.unbind()))
