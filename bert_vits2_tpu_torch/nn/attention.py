"""Relative-position transformer encoder (reference: attentions.py:37-464).

Counterpart of `bert_vits2_tpu/nn/attention.py`, in the reference layout
[b, c, t] with masks [b, 1, t] and the reference's parameter names. The
attention keeps the JAX package's dispatch (`MultiHeadAttention.forward`):
a +-w window that fits the sequence (2w+1 <= t+1) goes through the banded
kernel K1 (`ops/attention.py`) in the no-grad direction. When gradients are
wanted (grad mode on, or the module in train() mode) it takes the dense
formula in plain PyTorch with dropout on the probabilities, or, with
`BV2_FUSED_ATTENTION_TRAIN=1` in the environment (read at each call, as
the JAX package reads it while tracing), the fused op: K1 in train mode
and the backward kernels B5/B6 on the card, the plain version on the CPU,
both with the position-hash dropout, salted with each row's place in the
global batch and seeded alike on every rank under a data-parallel step
(`parallel/data.py`), so a rank's rows get the masks the one-process
step gives them. Every head width, window and b*h
goes to the kernels, as the JAX module sends them to its TPU kernels (the
wrappers pick the tensor-core kernels or, outside their range, those of
`csrc/banded_attn_wide.cu`). A shorter sequence takes the window-embedding
path in plain PyTorch. Speaker conditioning enters before layer
`cond_layer_idx`. Dropout sits where the JAX modules have it and is active
in train() mode only.

The modules compute in the dtype of their input: float32, or bfloat16 in
the bf16 inference copy of the flow (`models/synthesizer.py:cast_copy`)
and in training under `train_compute_dtype` "bfloat16" (the convs cast the
float32 parameters, `nn/conv.py`), with the JAX package's casts: the mask
is cast to the activations' dtype up front, q is scaled in that dtype, the
relative tables are cast to q's dtype, and the LayerNorms normalize in
float32 and return the input's dtype. A bf16 call goes to the bf16 modes
of K1 (inference and train mode), B5 and B6 (or the wide kernels') on the
card, the dense training direction rounds where they do, and the
short-sequence path runs in bf16.

Under the model axis (`parallel/sharding.py:shard_module` hands a module
its `model_axis`) the attention runs its shard of whole heads: q, k and v
column-parallel, `conv_o` row-parallel, the relative tables replicated
and their gradients summed over the model group (each rank's covers only
its heads), the hash dropout salted with the global head
(`dropout_salt`), the other dropouts drawn over every head. The FFN runs
its share of `filter_channels`: `conv_1` column-parallel, `conv_2`
row-parallel, its dropout's mask the full activation's, cut to this
rank's channels.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from bert_vits2_tpu_torch.nn.conv import Linear, column_parallel, conv1d, row_parallel
from bert_vits2_tpu_torch.nn.dropout import Dropout
from bert_vits2_tpu_torch.nn.norm import LayerNorm
from bert_vits2_tpu_torch.ops import noise
from bert_vits2_tpu_torch.ops.attention import (
    NEG_FILL,
    banded_attention_plain,
    banded_rel_self_attention,
)
from bert_vits2_tpu_torch.parallel.data import dropout_salt, dropout_seeds
from bert_vits2_tpu_torch.parallel.tensor import copy_to_model


def _dropout_seed() -> int:
    """One int32 seed of the hash dropout: inside a data shard (the train
    step, `parallel/data.py`) from the shard's generator, which every rank
    draws from alike; elsewhere from torch's global generator (the one the
    other dropouts draw from)."""
    return int(torch.randint(-2**31, 2**31, (), dtype=torch.int64,
                             generator=dropout_seeds()))


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[b, h, t, 2t-1] relative logits -> [b, h, t, t] (attentions.py:360-377)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, t * 2 * t)
    x = F.pad(x, (0, t - 1)).reshape(b, h, t + 1, 2 * t - 1)
    return x[:, :, :t, t - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[b, h, t, t] weights -> [b, h, t, 2t-1] (attentions.py:379-392)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).reshape(b, h, t * t + t * (t - 1))
    x = F.pad(x, (t, 0)).reshape(b, h, t, 2 * t)
    return x[:, :, :, 1:]


def _window_embeddings(emb: torch.Tensor, length: int, w: int) -> torch.Tensor:
    """Slice or pad the +-w table to 2*length-1 positions (attentions.py:344-358)."""
    pad = max(length - (w + 1), 0)
    start = max((w + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """Relative-position self-attention (attentions.py:205-341), heads
    sharing one +-window table."""

    tp_key = "conv_q.weight"  # the leaf whose split says the heads are sharded
    model_axis = None

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 4, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = conv1d(channels, channels, 1)
        self.conv_k = conv1d(channels, channels, 1)
        self.conv_v = conv1d(channels, channels, 1)
        self.conv_o = conv1d(channels, out_channels, 1)
        std = self.k_channels ** -0.5
        shape = (1, 2 * window_size + 1, self.k_channels)
        self.emb_rel_k = nn.Parameter(torch.randn(shape) * std)
        self.emb_rel_v = nn.Parameter(torch.randn(shape) * std)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x: [b, c, t]; x_mask: [b, 1, t] -> [b, out, t]."""
        b, _, t = x.shape
        d, w, axis = self.k_channels, self.window_size, self.model_axis
        # this rank's heads: all of them, or its shard under the model axis
        h = self.n_heads if axis is None else self.n_heads // axis.size
        head_offset = 0 if axis is None else axis.rank * h
        emb_k, emb_v = (copy_to_model(e, axis)[0] for e in (self.emb_rel_k, self.emb_rel_v))

        def heads(y):  # [b, h * d, t] -> [b, h, t, d]
            return y.view(b, h, d, t).transpose(2, 3)

        x = copy_to_model(x, axis)  # one all-reduce of its gradient for q, k and v
        q, k, v = (heads(conv(x)) for conv in (self.conv_q, self.conv_k, self.conv_v))
        q = q * (1.0 / math.sqrt(d))
        x_mask = x_mask.to(q.dtype)
        p_drop = self.p_dropout if self.training else 0.0
        # the probabilities' dropout, drawn over every head, this rank's kept
        shard = None if axis is None else (axis.rank, axis.size)
        if 2 * w + 1 > t + 1:
            out = self._window_attention(q, k, v, x_mask, p_drop, emb_k, emb_v, shard)
        elif (os.environ.get("BV2_FUSED_ATTENTION_TRAIN") == "1"
              or not (torch.is_grad_enabled() or self.training)):
            # the kernels: the inference launch, or the fused training
            # direction. The JAX package takes the latter only where its
            # TPU tiling allows (t % 8 == 0), and its general dense path
            # with flax's dropout elsewhere; the port takes it at every
            # t >= 2w, so the only difference is which dropout stream a
            # layer with t % 8 != 0 uses
            seed = _dropout_seed() if p_drop else None
            out = banded_rel_self_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                x_mask[:, 0].contiguous(), emb_k.to(q.dtype), emb_v.to(q.dtype), w,
                dropout_p=p_drop, dropout_seed=seed,
                dropout_salt=dropout_salt(h, head_offset, self.n_heads))
        else:
            # the training direction (the JAX package's deterministic=False)
            out = banded_attention_plain(
                q, k, v, x_mask[:, 0], emb_k.to(q.dtype), emb_v.to(q.dtype), w,
                dropout_p=p_drop, dropout_shard=shard)
        out = out.transpose(2, 3).reshape(b, h * d, t)
        return row_parallel(self.conv_o, out, axis)

    def _window_attention(self, q, k, v, x_mask, p_drop, emb_k, emb_v, shard):
        """Short sequences (t < 2w): the reference's skew formulation."""
        t, w = q.shape[2], self.window_size
        scores = torch.matmul(q, k.transpose(-1, -2))
        key_rel = _window_embeddings(emb_k[None].to(q.dtype), t, w)
        rel = torch.einsum("bhtd,gmd->bhtm", q, key_rel)
        scores = scores + _rel_to_abs(rel)
        am = x_mask[:, :, :, None] * x_mask[:, :, None, :]
        scores = scores.masked_fill(am == 0, NEG_FILL)
        p = noise.dropout(torch.softmax(scores, dim=-1), p_drop, shard)
        out = torch.matmul(p, v)
        value_rel = _window_embeddings(emb_v[None].to(q.dtype), t, w)
        return out + torch.einsum("bhtm,gmd->bhtd", _abs_to_rel(p), value_rel)


class FFN(nn.Module):
    """Conv feed-forward (attentions.py:398-464): relu, 'same' padding."""

    tp_key = "conv_1.weight"
    model_axis = None

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.drop = Dropout(p_dropout)
        self.conv_1 = conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = conv1d(filter_channels, out_channels, kernel_size)

    def _pad(self, x):
        k = self.kernel_size
        return x if k == 1 else F.pad(x, ((k - 1) // 2, k // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        axis = self.model_axis
        x = torch.relu(column_parallel(self.conv_1, self._pad(x * x_mask), axis))
        x = self.drop(x, channels=None if axis is None else (axis.rank, axis.size))
        return row_parallel(self.conv_2, self._pad(x * x_mask), axis) * x_mask


class Encoder(nn.Module):
    """Post-norm transformer encoder (attentions.py:37-120)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, window_size: int = 4,
                 gin_channels: int = 0, cond_layer_idx: int = 2):
        super().__init__()
        self.n_layers = n_layers
        self.drop = Dropout(p_dropout)
        self.cond_layer_idx = cond_layer_idx
        self.gin_channels = gin_channels
        if gin_channels > 0:
            self.spk_emb_linear = Linear(gin_channels, hidden_channels)
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads,
                               window_size=window_size, p_dropout=p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(
            LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size,
                p_dropout=p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(
            LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x: [b, c, t]; x_mask: [b, 1, t]; g: [b, gin] or None."""
        x_mask = x_mask.to(x.dtype)
        x = x * x_mask
        for i in range(self.n_layers):
            if i == self.cond_layer_idx and g is not None and self.gin_channels:
                x = (x + self.spk_emb_linear(g)[:, :, None]) * x_mask
            y = self.drop(self.attn_layers[i](x, x_mask))
            x = self.norm_layers_1[i](x + y)
            y = self.drop(self.ffn_layers[i](x, x_mask))
            x = self.norm_layers_2[i](x + y)
        return x * x_mask
