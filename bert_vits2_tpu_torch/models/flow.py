"""Latent normalizing flows (reference: models.py:82-145, 403-445).

Counterpart of `bert_vits2_tpu/models/flow.py`: n_flows x (coupling +
channel flip), forward in training (posterior latent -> prior space) and
reverse at inference. `TransformerCouplingBlock` is the vits2 default
(use_transformer_flow=true); `ResidualCouplingBlock` the vits1 WN variant
(4 mean-only couplings of 4 WN layers, kernel 5, dilation 1). Both keep the Flip layers
in their lists, so the couplings sit at flow.flows.{0,2,4,6}.
"""

from __future__ import annotations

from torch import nn

from bert_vits2_tpu_torch.nn.flows import (
    Flip,
    ResidualCouplingLayer,
    TransformerCouplingLayer,
)


class _CouplingBlock(nn.Module):
    def __init__(self, couplings):
        super().__init__()
        self.flows = nn.ModuleList()
        for coupling in couplings:
            self.flows.append(coupling)
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse=False):
        """x: [b, c, t]; x_mask: [b, 1, t]; g: [b, gin]. Computes in x's
        dtype (the mask is cast to it)."""
        x_mask = x_mask.to(x.dtype)
        if reverse:
            for f in reversed(self.flows):
                x = f(x, x_mask, g=g, reverse=True)
            return x
        for coupling, flip in zip(self.flows[0::2], self.flows[1::2]):
            x, _ = coupling(x, x_mask, g=g)
            x = flip(x)
        return x


class TransformerCouplingBlock(_CouplingBlock):
    def __init__(self, channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__([
            TransformerCouplingLayer(
                channels, hidden_channels, kernel_size, n_layers, n_heads,
                filter_channels, p_dropout=p_dropout, gin_channels=gin_channels)
            for _ in range(n_flows)])


class ResidualCouplingBlock(_CouplingBlock):
    """The vits1 flow as the JAX package builds it: 4 couplings of 4 WN
    layers, kernel 5, dilation 1 (ROADMAP §C R.4)."""

    def __init__(self, channels: int, hidden_channels: int,
                 gin_channels: int = 0):
        super().__init__([
            ResidualCouplingLayer(channels, hidden_channels, 5, 1, 4,
                                  gin_channels=gin_channels)
            for _ in range(4)])
