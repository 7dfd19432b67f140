"""Posterior spectrogram encoder (reference: models.py:448-487).

Counterpart of `bert_vits2_tpu/models/posterior.py`: a 1x1 conv over the
linear-spectrogram channels, a 16-layer WN, and (m_q, logs_q); z is sampled
by reparameterization from an explicit generator. It computes in y's dtype:
under the bf16 training policy y and g come in bf16, the mask is cast to
bf16 and the noise is drawn in bf16 (JAX posterior.py:28, 42).
"""

from __future__ import annotations

import torch
from torch import nn

from bert_vits2_tpu_torch.nn.conv import conv1d
from bert_vits2_tpu_torch.nn.wavenet import WN
from bert_vits2_tpu_torch.ops import noise
from bert_vits2_tpu_torch.ops.masking import sequence_mask


class PosteriorEncoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, y, y_lengths, g=None, generator=None):
        """y: [b, spec, t]; y_lengths: [b]; g: [b, gin]
        -> (z, m, logs [b, out, t], y_mask [b, 1, t])."""
        y_mask = sequence_mask(y_lengths, y.shape[2])[:, None, :].to(y.dtype)
        h = self.pre(y) * y_mask
        h = self.enc(h, y_mask, g=g)
        stats = self.proj(h) * y_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        eps = noise.randn(m.shape, generator, m.device, m.dtype, batch_axis=0)
        z = (m + eps * torch.exp(logs)) * y_mask
        return z, m, logs, y_mask
