"""The model axis's collectives (Megatron-LM's f and g operators).

The JAX package lays the transformer and WaveNet stacks out over the
mesh's "model" axis and lets XLA insert the collectives
(`bert_vits2_tpu/parallel/sharding.py`). The port runs one program per
rank, so the sharded modules call these by hand:

- `copy_to_model` before a column-parallel product (each rank computes
  its share of the output features from the whole input): identity
  forward, all-reduce of the input's gradient backward, since each rank's
  gradient covers only its own columns. A replicated parameter that a
  sharded computation reads (the attention's relative tables, a
  row-parallel layer's weight-norm gain) goes through it too, so its
  gradient sums every rank's share.
- `reduce_from_model` after a row-parallel product (each rank holds a
  partial sum over its share of the input features): all-reduce forward,
  identity backward.
- `sum_over_model`: an all-reduce both ways, for a quantity each rank holds
  a part of and each rank's result depends on (the squared norm of a
  row-parallel layer's weight under weight norm, ROADMAP §C D.4).
- `average_replicas`: the train step's mean of the replicated parameters'
  gradients over every rank, which keeps a model group's copies of them
  one value.

`ModelAxis` names this rank's place on the axis and its model group. In
one process (the engine's BERT over a mesh's model-axis devices,
`text/bert_encoder.py:shard_bert`) `sum_partials` adds the shards' partial
sums on the first device, in rank order. With no axis, or an axis of size
1, every function is the identity.

`counts` tallies the collectives of the model group (calls and bytes) so a
caller can read them per step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

counts = {"all_reduces": 0, "bytes": 0}


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """rank, size: this rank's coordinate on the model axis and the axis's
    length; group: the process group of the axis (None in one process)."""

    rank: int = 0
    size: int = 1
    group: object | None = None

    @property
    def distributed(self) -> bool:
        return self.group is not None


def active(axis: ModelAxis | None) -> bool:
    """Whether `axis` splits a module over processes (else every function
    here is the identity)."""
    return axis is not None and axis.size > 1 and axis.distributed


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    counts["all_reduces"] += 1
    counts["bytes"] += x.numel() * x.element_size()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """x, whose gradient is summed over the model group (module note)."""
    return _CopyToModel.apply(x, axis.group) if active(axis) else x


def reduce_from_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """The sum of every rank's x, whose gradient passes unchanged."""
    return _ReduceFromModel.apply(x, axis.group) if active(axis) else x


def sum_over_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """The sum of every rank's x; the gradient is summed as well."""
    return _SumOverModel.apply(x, axis.group) if active(axis) else x


def average_replicas(grads: list[torch.Tensor], size: int) -> None:
    """Average the gradients of replicated parameters over every rank in
    place (one flat all-reduce over the world group of `size` ranks,
    counted with the model group's collectives): the data group's mean,
    and one value on every rank of a model group. The model ranks compute
    these gradients alike only up to rounding (atomic adds in a backward),
    and AdamW would turn such differences into copies of one parameter that
    drift apart."""
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    counts["all_reduces"] += 1
    counts["bytes"] += flat.numel() * flat.element_size()
    dist.all_reduce(flat)
    flat /= size
    for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def sum_partials(partials: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """One process: the shards' partial sums added on `device` in rank order
    (the one-process form of `reduce_from_model`)."""
    out = partials[0].to(device)
    for p in partials[1:]:
        out = out + p.to(device)
    return out
