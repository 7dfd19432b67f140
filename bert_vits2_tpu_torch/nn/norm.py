"""LayerNorm over the channel axis of [b, c, t] (reference: modules.py:17-29).

Counterpart of `bert_vits2_tpu/nn/norm.py`; the parameters keep the
reference's names `gamma` and `beta`. It normalizes in float32 and returns
the input's dtype, as the JAX module does, so a bf16 activation stays bf16
while gamma and beta stay float32 (the bf16 inference copies of
`models/synthesizer.py:compute_stages` leave them so).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.transpose(1, -1).float()
        y = F.layer_norm(y, (self.channels,), self.gamma.float(),
                         self.beta.float(), self.eps)
        return y.transpose(1, -1).to(x.dtype)
