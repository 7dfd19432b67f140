"""Dilated depth-separable conv stack (reference: modules.py:84-130).

Counterpart of `bert_vits2_tpu/nn/ddsconv.py`: the condition encoder of the
stochastic duration predictor and of its spline couplings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bert_vits2_tpu_torch.nn.conv import conv1d
from bert_vits2_tpu_torch.nn.dropout import Dropout
from bert_vits2_tpu_torch.nn.norm import LayerNorm


class DDSConv(nn.Module):
    def __init__(self, channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.drop = Dropout(p_dropout)
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            dilation = kernel_size ** i
            padding = (kernel_size * dilation - dilation) // 2
            self.convs_sep.append(conv1d(channels, channels, kernel_size,
                                         dilation=dilation, padding=padding,
                                         groups=channels))
            self.convs_1x1.append(conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels))
            self.norms_2.append(LayerNorm(channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = self.convs_sep[i](x * x_mask)
            y = F.gelu(self.norms_1[i](y))
            y = self.convs_1x1[i](y)
            y = self.drop(F.gelu(self.norms_2[i](y)))
            x = x + y
        return x * x_mask
