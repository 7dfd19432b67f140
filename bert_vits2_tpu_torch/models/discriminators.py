"""GAN discriminators (reference: models.py:18-79, 567-700).

Counterpart of `bert_vits2_tpu/models/discriminators.py`, with the
reference's state_dict names (`discriminators.0` is the scale
discriminator, `discriminators.1..` the period ones; `LSTM`,
`output_layer.0`):

- MultiPeriodDiscriminator: one scale discriminator (DiscriminatorS) and
  the period discriminators (periods 2, 3, 5, 7, 11), each returning logits
  and per-layer feature maps.
- DurationDiscriminator (vits2): a conv stack and a bidirectional LSTM
  scoring (encoder states, duration) pairs. `torch.nn.LSTM` keeps two bias
  vectors per direction where the JAX cell keeps one; their sum is the
  JAX bias.

- WavLMDiscriminator (the SLM losses): a conv head over the stacked
  WavLM hidden states.

All convs are weight-normed. Waves are [b, t]; the period discriminators
view them as [b, 1, t / p, p] images.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bert_vits2_tpu_torch.nn.conv import conv1d, conv2d
from bert_vits2_tpu_torch.nn.dropout import Dropout
from bert_vits2_tpu_torch.nn.norm import LayerNorm

LRELU_SLOPE = 0.1


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024),
                 final_channels: int = 1024):
        super().__init__()
        self.period = period
        pad = ((kernel_size - 1) // 2, 0)
        self.convs = nn.ModuleList()
        ch_in = 1
        for ch in channels:
            self.convs.append(conv2d(ch_in, ch, (kernel_size, 1), (stride, 1),
                                     pad, weight_norm=True))
            ch_in = ch
        self.convs.append(conv2d(ch_in, final_channels, (kernel_size, 1),
                                 (1, 1), pad, weight_norm=True))
        self.conv_post = conv2d(final_channels, 1, (3, 1), (1, 1), (1, 0),
                                weight_norm=True)

    def forward(self, x):
        """x: [b, t] -> (logits [b, n], feature maps [b, c, t', p])."""
        b, t = x.shape
        p = self.period
        if t % p != 0:
            x = F.pad(x[:, None, :], (0, p - t % p), mode="reflect")[:, 0]
        x = x.view(b, 1, -1, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorS(nn.Module):
    # (channels, kernel, stride, groups, padding) per layer; models.py:645-660
    SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
             (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))

    def __init__(self, specs: Sequence[Sequence[int]] = SPECS):
        super().__init__()
        self.convs = nn.ModuleList()
        ch_in = 1
        for ch, k, s, groups, pad in specs:
            self.convs.append(conv1d(ch_in, ch, k, stride=s, groups=groups,
                                     padding=pad, weight_norm=True))
            ch_in = ch
        self.conv_post = conv1d(ch_in, 1, 3, padding=1, weight_norm=True)

    def forward(self, x):
        """x: [b, t] -> (logits [b, n], feature maps [b, c, t'])."""
        x = x[:, None, :]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """`p_channels` and `s_specs` override the reference widths for tests at
    a small size; None keeps them."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 p_channels: Sequence[int] | None = None,
                 s_specs: Sequence[Sequence[int]] | None = None):
        super().__init__()
        self.periods = tuple(periods)
        s_kw = {} if s_specs is None else {"specs": tuple(s_specs)}
        p_kw = ({} if p_channels is None else
                {"channels": tuple(p_channels), "final_channels": p_channels[-1]})
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(**s_kw)]
            + [DiscriminatorP(p, **p_kw) for p in self.periods])

    def forward(self, y, y_hat):
        """y, y_hat: [b, t] -> (real logits, fake logits, real feature maps,
        fake feature maps), one entry per discriminator."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            r_logit, r_fmap = d(y)
            g_logit, g_fmap = d(y_hat)
            y_d_rs.append(r_logit)
            y_d_gs.append(g_logit)
            fmap_rs.append(r_fmap)
            fmap_gs.append(g_fmap)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class DurationDiscriminator(nn.Module):
    """Scores (encoder states, duration) pairs (models.py:18-79). `x` and
    `g` are detached: its losses do not reach the text encoder."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float, gin_channels: int = 0):
        super().__init__()
        fc = filter_channels
        pad = kernel_size // 2
        self.drop = Dropout(p_dropout)
        self.conv_1 = conv1d(in_channels, fc, kernel_size, padding=pad)
        self.norm_1 = LayerNorm(fc)
        self.conv_2 = conv1d(fc, fc, kernel_size, padding=pad)
        self.norm_2 = LayerNorm(fc)
        self.dur_proj = conv1d(1, fc, 1)
        self.LSTM = nn.LSTM(2 * fc, fc, batch_first=True, bidirectional=True)
        self.output_layer = nn.Sequential(nn.Linear(2 * fc, 1), nn.Sigmoid())
        self.cond = conv1d(gin_channels, in_channels, 1) if gin_channels else None

    def _probability(self, x, dur):
        h = torch.cat([x, self.dur_proj(dur)], dim=1).transpose(1, 2)
        h, _ = self.LSTM(h)
        return self.output_layer(h)  # [b, t, 1]

    def forward(self, x, x_mask, dur_r, dur_hat, g=None):
        """x: [b, c, t]; x_mask: [b, 1, t]; dur_r, dur_hat: [b, 1, t];
        g: [b, gin] -> [probability of dur_r, of dur_hat], each [b, t, 1]."""
        x = x.detach()
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach()[:, :, None])
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return [self._probability(x, d) for d in (dur_r, dur_hat)]


class WavLMDiscriminator(nn.Module):
    """Conv head over the stacked SLM hidden states (models.py:703-749):
    x [b, slm_hidden * slm_layers, frames], layer-major (`SLM.embed`) ->
    logits [b, frames]."""

    def __init__(self, slm_hidden: int = 768, slm_layers: int = 13,
                 initial_channel: int = 64):
        super().__init__()
        ic = initial_channel
        self.pre = conv1d(slm_hidden * slm_layers, ic, 1, weight_norm=True)
        self.convs = nn.ModuleList(
            conv1d(c_in, c_out, 5, padding=2, weight_norm=True)
            for c_in, c_out in ((ic, 2 * ic), (2 * ic, 4 * ic), (4 * ic, 4 * ic)))
        self.conv_post = conv1d(4 * ic, 1, 3, padding=1, weight_norm=True)

    def forward(self, x):
        x = self.pre(x)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
        return self.conv_post(x).flatten(1)
