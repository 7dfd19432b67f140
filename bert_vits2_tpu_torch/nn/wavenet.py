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
"""

from __future__ import annotations

import torch
from torch import nn

from bert_vits2_tpu_torch.nn.conv import conv1d


class WN(nn.Module):
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
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x: [b, h, t]; x_mask: [b, 1, t]; g: [b, gin] or None."""
        h = self.hidden_channels
        x_mask = x_mask.to(x.dtype)
        output = torch.zeros_like(x)
        g_all = None
        if g is not None and self.cond_layer is not None:
            g_all = self.cond_layer(g[:, :, None])  # [b, 2 * h * n_layers, 1]
        for i in range(self.n_layers):
            a = self.in_layers[i](x)
            if g_all is not None:
                a = a + g_all[:, 2 * h * i:2 * h * (i + 1)]
            acts = self.drop(torch.tanh(a[:, :h]) * torch.sigmoid(a[:, h:]))
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask
