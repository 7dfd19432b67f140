"""Latent normalizing flow (reference: models.py:403-445).

Counterpart of `TransformerCouplingBlock` in `bert_vits2_tpu/models/flow.py`:
n_flows x (transformer coupling + channel flip), forward in training
(posterior latent -> prior space) and reverse at inference. The vits1
`ResidualCouplingBlock` (use_transformer_flow=false) comes with the
old-version slice.
"""

from __future__ import annotations

from torch import nn

from bert_vits2_tpu_torch.nn.flows import Flip, TransformerCouplingLayer


class TransformerCouplingBlock(nn.Module):
    def __init__(self, channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(TransformerCouplingLayer(
                channels, hidden_channels, kernel_size, n_layers, n_heads,
                filter_channels, p_dropout=p_dropout,
                gin_channels=gin_channels))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse=False):
        """x: [b, c, t]; x_mask: [b, 1, t]; g: [b, gin]."""
        if reverse:
            for f in reversed(self.flows):
                x = f(x, x_mask, g=g, reverse=True)
            return x
        for coupling, flip in zip(self.flows[0::2], self.flows[1::2]):
            x, _ = coupling(x, x_mask, g=g)
            x = flip(x)
        return x
