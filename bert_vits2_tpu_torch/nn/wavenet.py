"""Non-causal WaveNet stack with gated tanh/sigmoid units (reference:
modules.py:133-218).

Counterpart of `bert_vits2_tpu/nn/wavenet.py`, in the reference layout
[b, c, t]. All convs are weight-normed. The speaker conditioning comes from
one 1x1 conv over g producing 2 * hidden * n_layers channels, sliced per
layer; the last layer's `res_skip` conv has `hidden` outputs (no residual
half).

It computes in the dtype of x (the convs cast their float32 parameters,
`nn/conv.py`): the mask is cast to it up front, and g is taken in the same
dtype (the bf16 training policy casts both, JAX models/synthesizer.py:143-150).

Under the model axis (`parallel/sharding.py:shard_module` hands the stack
its `model_axis`) a rank holds a share of the gated channels: `in_layers`
and `cond_layer` column-parallel, rank r's output channels being
[r h/n, (r+1) h/n) of the tanh half and the same of the sigmoid half (of
each layer's pair, for `cond_layer`: ROADMAP §C D.3), so that the gate
pairs its own channels; `res_skip_layers` row-parallel over those
channels, with weight norm over every rank's (D.4); the dropout on `acts`
the full activation's mask, cut to this rank's channels.
"""

from __future__ import annotations

import torch
from torch import nn

from bert_vits2_tpu_torch.nn.conv import column_parallel, conv1d, row_parallel
from bert_vits2_tpu_torch.nn.dropout import Dropout


class WN(nn.Module):
    tp_key = "in_layers.0.weight_v"
    model_axis = None

    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("WN takes an odd kernel size")
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        h = hidden_channels
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            self.in_layers.append(conv1d(
                h, 2 * h, kernel_size, dilation=dilation,
                padding=(kernel_size * dilation - dilation) // 2,
                weight_norm=True))
            self.res_skip_layers.append(conv1d(
                h, 2 * h if i < n_layers - 1 else h, 1, weight_norm=True))
        self.cond_layer = (conv1d(gin_channels, 2 * h * n_layers, 1,
                                  weight_norm=True) if gin_channels else None)
        self.drop = Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x: [b, h, t]; x_mask: [b, 1, t]; g: [b, gin] or None."""
        h, axis = self.hidden_channels, self.model_axis
        # the gated channels this rank computes: all, or its share
        hl = h if axis is None else h // axis.size
        shard = None if axis is None else (axis.rank, axis.size)
        x_mask = x_mask.to(x.dtype)
        output = torch.zeros_like(x)
        g_all = None
        if g is not None and self.cond_layer is not None:
            # [b, 2 * hl * n_layers, 1]
            g_all = column_parallel(self.cond_layer, g[:, :, None], axis)
        for i in range(self.n_layers):
            a = column_parallel(self.in_layers[i], x, axis)
            if g_all is not None:
                a = a + g_all[:, 2 * hl * i:2 * hl * (i + 1)]
            acts = self.drop(torch.tanh(a[:, :hl]) * torch.sigmoid(a[:, hl:]),
                             channels=shard)
            res_skip = row_parallel(self.res_skip_layers[i], acts, axis)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask
