"""`torch.nn.Dropout` whose masks follow the train step's shards.

The module keeps `nn.Dropout`'s name, rate and train/eval switch, and
draws through `ops/noise.py:dropout`: from torch's global generator
outside a train step, and inside one the global batch's mask (and every
model rank's channels of it, `channels`), so that a data rank or a model
rank drops what the one-process step drops.
"""

from __future__ import annotations

import torch
from torch import nn

from bert_vits2_tpu_torch.ops import noise


class Dropout(nn.Dropout):
    def forward(self, x: torch.Tensor,
                channels: tuple[int, int] | None = None) -> torch.Tensor:
        """channels: (rank, n) where this rank holds a 1/n share of x's
        axis 1 (a model-parallel activation)."""
        return noise.dropout(x, self.p, channels) if self.training else x
