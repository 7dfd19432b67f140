"""Normalizing-flow building blocks (reference: modules.py:363-580).

Counterpart of `bert_vits2_tpu/nn/flows.py`, in the reference layout
[b, c, t] with masks [b, 1, t]. Every flow returns (y, logdet [b]) forward
and y in reverse. `Flip` holds no parameters but keeps its slot in the flow
lists, so the state_dict indices are the reference's (flow.flows.0/2/4/6,
sdp.flows.0/1/3/5/7); it returns a tensor in both directions.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bert_vits2_tpu_torch.nn.attention import Encoder
from bert_vits2_tpu_torch.nn.conv import conv1d
from bert_vits2_tpu_torch.nn.ddsconv import DDSConv
from bert_vits2_tpu_torch.nn.wavenet import WN
from bert_vits2_tpu_torch.ops.spline import unconstrained_rational_quadratic_spline


class Log(nn.Module):
    """y = log(max(x, 1e-5)), logdet = sum(-y) (modules.py:363-371)."""

    def forward(self, x, x_mask, g=None, reverse=False):
        if reverse:
            return torch.exp(x) * x_mask
        y = torch.log(x.clamp(min=1e-5)) * x_mask
        return y, torch.sum(-y, dim=(1, 2))


class Flip(nn.Module):
    """Reverses the channel axis (modules.py:374-381); its own inverse."""

    def forward(self, x, x_mask=None, g=None, reverse=False):
        return torch.flip(x, [1])


class ElementwiseAffine(nn.Module):
    """Per-channel affine (modules.py:384-399)."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, g=None, reverse=False):
        if reverse:
            return (x - self.m) * torch.exp(-self.logs) * x_mask
        y = (self.m + torch.exp(self.logs) * x) * x_mask
        return y, torch.sum(self.logs * x_mask, dim=(1, 2))


class ConvFlow(nn.Module):
    """Rational-quadratic-spline coupling over a 2-channel stream
    (modules.py:459-516)."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, n_layers: int, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, c, t = x0.shape
        h = h.reshape(b, c, -1, t).permute(0, 1, 3, 2)  # [b, c, t, 3K-1]
        denom = math.sqrt(self.filter_channels)
        nb = self.num_bins
        x1, logabsdet = unconstrained_rational_quadratic_spline(
            x1, h[..., :nb] / denom, h[..., nb:2 * nb] / denom, h[..., 2 * nb:],
            inverse=reverse, tail_bound=self.tail_bound)
        x = torch.cat([x0, x1], 1) * x_mask
        if reverse:
            return x
        return x, torch.sum(logabsdet * x_mask, dim=(1, 2))


class _MeanOnlyCoupling(nn.Module):
    """`pre` (1x1 conv), `enc`, `post` (1x1 conv, zero init) on the first
    half of the channels shift the second: volume-preserving, so the logdet
    is zero."""

    def __init__(self, channels: int, hidden_channels: int, enc: nn.Module):
        super().__init__()
        self.half = channels // 2
        self.pre = conv1d(self.half, hidden_channels, 1)
        self.enc = enc
        self.post = conv1d(hidden_channels, self.half, 1)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        if reverse:
            return torch.cat([x0, (x1 - m) * x_mask], 1)
        return torch.cat([x0, m + x1 * x_mask], 1), x.new_zeros(x.shape[0])


class ResidualCouplingLayer(_MeanOnlyCoupling):
    """WN-parameterized coupling of the vits1 flow (modules.py:402-456),
    mean-only as `ResidualCouplingBlock` builds it."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__(channels, hidden_channels, WN(
            hidden_channels, kernel_size, dilation_rate, n_layers,
            gin_channels=gin_channels))


class TransformerCouplingLayer(_MeanOnlyCoupling):
    """Transformer-parameterized mean-only coupling (modules.py:519-580)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 n_layers: int, n_heads: int, filter_channels: int,
                 p_dropout: float = 0.0, gin_channels: int = 0):
        super().__init__(channels, hidden_channels, Encoder(
            hidden_channels, filter_channels, n_heads, n_layers,
            kernel_size=kernel_size, p_dropout=p_dropout,
            gin_channels=gin_channels))
