"""Tensor-parallel specs of the port's parameters, and the shards
themselves (counterpart of `bert_vits2_tpu/parallel/sharding.py`, keyed on
the port's state_dict names, for example
`enc_p.encoder.attn_layers.0.conv_q.weight`).

The rules are the JAX package's:

- the attention's `conv_q` / `conv_k` / `conv_v` and the FFN's `conv_1`
  (weight and bias) are column-parallel: dimension 0, the output channels;
- the attention's `conv_o` and the FFN's `conv_2` are row-parallel: the
  weight's dimension 1, the input channels; the bias is replicated and
  added once, after the reduce;
- WN's `in_layers` and `cond_layer` (weight_v, weight_g, bias) are
  column-parallel, its `res_skip_layers` row-parallel (weight_v; weight_g
  and the bias replicated);
- everything else is replicated (embeddings, LayerNorms, the relative
  tables, the vocoder, the duration predictors, the discriminators), and
  so is a stack whose dimension does not divide n_model.

The JAX spec is a layout that GSPMD completes: XLA reshards behind any
split the math does not allow. A hand-written split must be one the
modules can compute on, and departs from the JAX layout in three places
(ROADMAP §C):

- D.2, heads: attention shards whole heads. Where n_heads % n_model != 0
  the attention block stays replicated (its FFN is still sharded), and
  `shard_module` logs it; the JAX spec would cut channels through a head.
- D.3, the gate halves of WN: a layer computes tanh(a[:h]) * sigmoid(a[h:]),
  so rank r takes channels [r h/n, (r+1) h/n) of each half of `in_layers`'
  output, and of each layer's halves of `cond_layer`'s output; `Split`'s
  `blocks` says how many such blocks a dimension holds. A contiguous split
  (the JAX spec's) would give rank 0 only tanh channels. `gather_tensor`
  undoes the interleave.
- D.4, weight norm of a row-parallel layer: its norm runs over the input
  channels, which the ranks split, so the squared norm is summed over the
  model group (`nn/conv.py:row_parallel`). A column-parallel layer's norm
  stays local.

Adam's moments shard with their parameters (`shard_optimizer`), and
`gather_state` rebuilds the reference layout of a module and its
optimizer for a checkpoint.
"""

from __future__ import annotations

import logging
import re
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.nn.utils.weight_norm import WeightNorm

from bert_vits2_tpu_torch.parallel.tensor import ModelAxis

logger = logging.getLogger(__name__)


class Split(NamedTuple):
    """A sharded leaf: `dim` is split over the model axis (0 column-parallel,
    1 row-parallel); the dimension holds `blocks` equal blocks, each split
    alike (D.3; 1 for a contiguous split)."""

    dim: int
    blocks: int = 1


_ATTN = re.compile(r"^(?:(.*)\.)?(conv_[qkvo])\.(weight|bias)$")
_FFN = re.compile(r"^(?:(.*)\.)?ffn_layers\.(\d+)\.(conv_[12])\.(weight|bias)$")
_WN = re.compile(r"^(?:(.*)\.)?(in_layers\.\d+|cond_layer|res_skip_layers\.\d+)"
                 r"\.(weight_v|weight_g|bias)$")


def _join(*parts) -> str:
    return ".".join(p for p in parts if p)


def tp_spec(name: str, shapes: dict, n_model: int) -> Split | None:
    """The split of leaf `name` of a state_dict whose leaves have `shapes`
    (name -> shape; the siblings give the heads and widths), or None
    where it is replicated."""
    if n_model <= 1:
        return None
    m = _ATTN.match(name)
    if m and _join(m.group(1), "emb_rel_k") in shapes:  # a MultiHeadAttention
        layer, conv, leaf = m.groups()
        heads = shapes[_join(layer, "conv_q.weight")][0] // shapes[_join(layer, "emb_rel_k")][-1]
        if heads % n_model:  # D.2
            return None
        if conv == "conv_o":
            return Split(1) if leaf == "weight" else None
        return Split(0)
    m = _FFN.match(name)
    if m:
        owner, i, conv, leaf = m.groups()
        layer = _join(owner, f"ffn_layers.{i}")
        if shapes[layer + ".conv_1.weight"][0] % n_model:
            return None
        if conv == "conv_2":
            return Split(1) if leaf == "weight" else None
        return Split(0)
    m = _WN.match(name)
    if m:
        owner, layer, leaf = m.groups()
        h = shapes[_join(owner, "in_layers.0.weight_v")][1]
        if h % n_model:
            return None
        if layer.startswith("res_skip_layers"):
            return Split(1) if leaf == "weight_v" else None
        return Split(0, shapes[name][0] // h)  # D.3: 2 gates, or 2 per layer
    return None


def tp_specs(state_dict: dict, n_model: int) -> dict[str, Split | None]:
    """name -> `tp_spec` for every leaf of a full (unsharded) state_dict
    (tensors, or shapes)."""
    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in state_dict.items()}
    return {k: tp_spec(k, shapes, n_model) for k in shapes}


def shard_tensor(x: torch.Tensor, split: Split, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s shard of the full tensor x."""
    blocks = x.chunk(split.blocks, split.dim)
    return torch.cat([b.chunk(n, split.dim)[rank] for b in blocks], split.dim)


def gather_tensor(shards: list[torch.Tensor], split: Split) -> torch.Tensor:
    """The full tensor from every rank's shard, in rank order."""
    parts = [s.chunk(split.blocks, split.dim) for s in shards]
    return torch.cat([parts[r][b] for b in range(split.blocks)
                      for r in range(len(shards))], split.dim)


def tp_shard(state_dict: dict, n_model: int, rank: int,
             specs: dict | None = None) -> dict:
    """A full state_dict -> rank `rank`'s shards (replicated leaves as
    they are)."""
    specs = tp_specs(state_dict, n_model) if specs is None else specs
    return {k: v if specs.get(k) is None else shard_tensor(v, specs[k], rank, n_model)
            for k, v in state_dict.items()}


def tp_gather(shard_dicts: list[dict], specs: dict) -> dict:
    """Every rank's shards (in rank order) -> the full state_dict in the
    reference layout; `specs` are the full state_dict's `tp_specs`."""
    first = shard_dicts[0]
    return {k: v if specs.get(k) is None else
            gather_tensor([sd[k] for sd in shard_dicts], specs[k])
            for k, v in first.items()}


def shard_module(module: torch.nn.Module, axis: ModelAxis,
                 specs: dict | None = None) -> dict:
    """Shard `module`'s parameters in place to this rank's (`axis.rank`)
    shards, and hand `axis` to each module whose stack the specs shard (the
    ones with a `tp_key`: `MultiHeadAttention`, `FFN`, `WN`), which then
    computes on its shard with the model group's collectives. The
    Parameter objects stay (an optimizer built over them stays valid);
    sharded ones are marked `model_parallel`. -> the specs, also kept as
    `module.tp_specs`."""
    if axis.size > 1 and not axis.distributed:
        raise ValueError("shard_module runs a module's shards in processes of a "
                         "model group; in one process only the BERT encoder splits "
                         "(text/bert_encoder.py:shard_bert)")
    if specs is None:
        specs = tp_specs(module.state_dict(), axis.size)
    with torch.no_grad():
        for name, p in module.named_parameters():
            split = specs.get(name)
            if split is not None:
                p.data = shard_tensor(p.data, split, axis.rank, axis.size).contiguous()
                p.model_parallel = True
        # a weight-normed layer keeps its last resolved weight, whose graph
        # holds the full-size parameters' gradient accumulators: resolve it
        # anew, without a graph, so no later backward meets the old shapes
        for m in module.modules():
            for hook in m._forward_pre_hooks.values():
                if isinstance(hook, WeightNorm):
                    setattr(m, hook.name, hook.compute_weight(m))
    for prefix, m in module.named_modules():
        key = getattr(m, "tp_key", None)
        if key is None or axis.size <= 1:
            continue
        if specs.get(_join(prefix, key)) is None:
            if hasattr(m, "n_heads"):
                logger.info("model axis: %s stays replicated (D.2: %d heads over "
                            "%d ranks)", prefix, m.n_heads, axis.size)
            else:
                logger.info("model axis: %s stays replicated (its width does not "
                            "split over %d ranks)", prefix, axis.size)
            continue
        m.model_axis = axis
    module.tp_specs = specs
    return specs


def shard_optimizer(opt: torch.optim.Optimizer, module: torch.nn.Module,
                    axis: ModelAxis) -> None:
    """Shard the full-size state tensors (Adam's moments) of `module`'s
    sharded parameters like the parameters, in place, after
    `shard_module`."""
    names = {id(p): n for n, p in module.named_parameters()}
    for p, state in opt.state.items():
        split = module.tp_specs.get(names.get(id(p)))
        if split is None:
            continue
        for key, t in state.items():
            if isinstance(t, torch.Tensor) and t.dim() and t.shape != p.shape:
                state[key] = shard_tensor(t, split, axis.rank, axis.size).contiguous()


def gather_from_model(t: torch.Tensor, split: Split, axis: ModelAxis) -> torch.Tensor:
    """The full tensor from every rank's shard, over the model group: each
    rank writes its shard into zeros of the full shape and the group sums
    them (exact: every entry has one nonzero term)."""
    shape = list(t.shape)
    shape[split.dim] *= axis.size
    full = t.new_zeros(shape)
    for block, part in zip(full.chunk(split.blocks, split.dim),
                           t.chunk(split.blocks, split.dim)):
        block.chunk(axis.size, split.dim)[axis.rank].copy_(part)
    dist.all_reduce(full, group=axis.group)
    return full


def gather_state(module: torch.nn.Module, opt: torch.optim.Optimizer | None,
                 axis: ModelAxis) -> tuple[dict, dict | None]:
    """Every rank of the model group together: (`module`'s state_dict, the
    optimizer's state_dict) in the reference layout, gathered from the
    ranks' shards (collective: every rank of the group calls it, in one
    order)."""
    specs = module.tp_specs
    model_sd = {k: v if specs.get(k) is None else gather_from_model(v, specs[k], axis)
                for k, v in module.state_dict().items()}
    if opt is None:
        return model_sd, None
    opt_sd = opt.state_dict()
    names = {id(p): n for n, p in module.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    state = {}
    for i, st in opt_sd["state"].items():
        p = params[i]
        split = specs.get(names.get(id(p)))
        state[i] = {k: gather_from_model(v, split, axis)
                    if split is not None and isinstance(v, torch.Tensor)
                    and v.shape == p.shape else v for k, v in st.items()}
    return model_sd, {**opt_sd, "state": state}
