"""GST-style reference encoder, the speaker embedding when n_speakers == 0
(reference: models.py:752-808).

Counterpart of `bert_vits2_tpu/models/reference_encoder.py`: six
weight-normed stride-2 Conv2d over the linear spectrogram with ReLU, the
(channel, frequency) axes flattened channel-major, a GRU over every frame,
and its final state projected to the speaker embedding width. Names are the
reference's: `convs.{i}`, `gru.*_l0`, `proj`.
"""

from __future__ import annotations

import torch
from torch import nn

from bert_vits2_tpu_torch.nn.conv import conv2d

FILTERS = (32, 32, 64, 64, 128, 128)
GRU_UNITS = 128


class ReferenceEncoder(nn.Module):
    def __init__(self, spec_channels: int, gin_channels: int = 0):
        super().__init__()
        chans = (1, *FILTERS)
        self.convs = nn.ModuleList(
            conv2d(chans[i], chans[i + 1], (3, 3), (2, 2), (1, 1), weight_norm=True)
            for i in range(len(FILTERS)))
        freq = spec_channels
        for _ in FILTERS:
            freq = (freq - 3 + 2) // 2 + 1
        self.gru = nn.GRU(FILTERS[-1] * freq, GRU_UNITS, batch_first=True)
        self.proj = nn.Linear(GRU_UNITS, gin_channels)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        """spec [b, t, spec_channels] -> [b, gin_channels]."""
        x = spec[:, None]  # [b, 1, t, f]
        for conv in self.convs:
            x = torch.relu(conv(x))
        x = x.transpose(1, 2).flatten(2)  # [b, t', c * f'], channel-major
        _, h = self.gru(x)
        return self.proj(h[0])
