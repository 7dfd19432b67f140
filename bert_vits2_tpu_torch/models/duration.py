"""Duration predictors (reference: models.py:148-299).

Counterpart of `bert_vits2_tpu/models/duration.py`. `DurationPredictor` is
a deterministic conv stack giving log-durations. `StochasticDurationPredictor`
is flow-based: `nll` gives the per-utterance training loss, `reverse` samples
log-durations from noise. Both detach their inputs `x` and `g`, as the
reference does (torch.detach at models.py:199, 283): the duration losses
train the predictors, not the text encoder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bert_vits2_tpu_torch.nn.conv import conv1d
from bert_vits2_tpu_torch.nn.ddsconv import DDSConv
from bert_vits2_tpu_torch.nn.dropout import Dropout
from bert_vits2_tpu_torch.nn.flows import ConvFlow, ElementwiseAffine, Flip, Log
from bert_vits2_tpu_torch.nn.norm import LayerNorm
from bert_vits2_tpu_torch.ops import noise

_LOG_2PI = math.log(2 * math.pi)


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 gin_channels: int = 0):
        super().__init__()
        pad = kernel_size // 2
        self.drop = Dropout(p_dropout)
        self.conv_1 = conv1d(in_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = conv1d(filter_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = conv1d(filter_channels, 1, 1)
        self.cond = conv1d(gin_channels, in_channels, 1) if gin_channels else None

    def forward(self, x, x_mask, g=None):
        """x: [b, c, t]; x_mask: [b, 1, t]; g: [b, gin] -> logw [b, 1, t]."""
        x = x.detach()
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach()[:, :, None])
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask


def _run_flows(flows, z, x_mask, g, logdet=0.0):
    """A flow list forward -> (z, `logdet` plus the flows' logdets [b])."""
    for f in flows:
        if isinstance(f, Flip):
            z = f(z)
        else:
            z, ld = f(z, x_mask, g=g)
            logdet = logdet + ld
    return z, logdet


class StochasticDurationPredictor(nn.Module):
    def __init__(self, in_channels: int, kernel_size: int,
                 p_dropout: float = 0.0, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        fc = in_channels  # reference quirk: filter_channels = in_channels
        self.log_flow = Log()
        self.flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(n_flows):
            self.flows.append(ConvFlow(2, fc, kernel_size, n_layers=3))
            self.flows.append(Flip())
        self.post_pre = conv1d(1, fc, 1)
        self.post_proj = conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, n_layers=3,
                                  p_dropout=p_dropout)
        self.post_flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(4):
            self.post_flows.append(ConvFlow(2, fc, kernel_size, n_layers=3))
            self.post_flows.append(Flip())
        self.pre = conv1d(in_channels, fc, 1)
        self.proj = conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        self.cond = conv1d(gin_channels, fc, 1) if gin_channels else None

    def _condition(self, x, x_mask, g):
        x = self.pre(x.detach())
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach()[:, :, None])
        x = self.convs(x, x_mask)
        return self.proj(x) * x_mask

    def nll(self, x, x_mask, w, g=None, generator=None):
        """Training negative log-likelihood [b] of the durations w [b, 1, t]
        (models.py:206-240): a variational dequantization through the
        posterior flows, then the main flows on (log(w - u), z1)."""
        x = self._condition(x, x_mask, g)
        h_w = self.post_pre(w)
        h_w = self.post_convs(h_w, x_mask)
        h_w = self.post_proj(h_w) * x_mask

        b, _, t = x.shape
        e_q = noise.randn((b, 2, t), generator, x.device, x.dtype, batch_axis=0) * x_mask
        z_q, logdet_tot_q = _run_flows(self.post_flows, e_q, x_mask, x + h_w)
        z_u, z1 = z_q[:, :1], z_q[:, 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_tot_q = logdet_tot_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        logq = torch.sum(-0.5 * (_LOG_2PI + e_q ** 2) * x_mask,
                         dim=(1, 2)) - logdet_tot_q

        z0, logdet_tot = self.log_flow(z0, x_mask)
        z, logdet_tot = _run_flows(self.flows, torch.cat([z0, z1], 1), x_mask,
                                   x, logdet_tot)
        nll = torch.sum(0.5 * (_LOG_2PI + z ** 2) * x_mask,
                        dim=(1, 2)) - logdet_tot
        return nll + logq

    def reverse(self, x, x_mask, z, g=None):
        """Log-durations [b, 1, t] from noise z [b, 2, t] (already scaled).

        The reversed chain drops the first ConvFlow, as the reference does
        (models.py:241-256): flip, CF3^-1, flip, CF2^-1, flip, CF1^-1, flip,
        EA^-1."""
        x = self._condition(x, x_mask, g)
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]
        for f in flows:
            z = f(z, x_mask, g=x, reverse=True)
        return z[:, :1]
