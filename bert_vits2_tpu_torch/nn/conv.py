"""Convolutions in the reference layout, with weight norm.

Counterpart of `bert_vits2_tpu/nn/conv.py`. Activations are [b, c, t] and
the modules are stock `torch.nn.Conv1d` / `ConvTranspose1d`, so parameter
names and shapes are those of a reference `G_*.pth`:

- Conv1d weight [out, in, k]; with weight norm, `weight_g` [out, 1, 1] (one
  gain per OUT channel) and `weight_v` [out, in, k].
- ConvTranspose1d weight [in, out, k]; `torch.nn.utils.weight_norm` with
  dim=0 puts `weight_g` [in, 1, 1] per IN channel, as the reference does.
- Conv2d weight [out, in, kh, kw], `weight_g` [out, 1, 1, 1] (the period
  discriminators' (k, 1) kernels over [b, c, t / p, p] images).
- Dense layers are `nn.Linear` where the reference has one
  (`spk_emb_linear`) and a k=1 `nn.Conv1d` elsewhere (attention q/k/v/o).

The JAX package's time folding and sub-pixel transposed conv fill the TPU's
lanes; `F.conv1d` / `F.conv_transpose1d` compute the same function.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn


def _weight_norm(module: nn.Module) -> nn.Module:
    # torch.nn.utils.weight_norm writes the reference's weight_g / weight_v
    # keys; the parametrizations API would rename them.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return nn.utils.weight_norm(module)


def conv1d(in_ch: int, out_ch: int, kernel_size: int = 1, dilation: int = 1,
           padding: int = 0, groups: int = 1, bias: bool = True,
           weight_norm: bool = False, stride: int = 1) -> nn.Conv1d:
    conv = nn.Conv1d(in_ch, out_ch, kernel_size, stride=stride,
                     dilation=dilation, padding=padding, groups=groups,
                     bias=bias)
    return _weight_norm(conv) if weight_norm else conv


def conv2d(in_ch: int, out_ch: int, kernel_size: tuple[int, int],
           stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
           weight_norm: bool = False) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding)
    return _weight_norm(conv) if weight_norm else conv


def conv_transpose1d(in_ch: int, out_ch: int, kernel_size: int, stride: int,
                     padding: int = 0) -> nn.ConvTranspose1d:
    """A weight-normed transposed conv, as every one of the reference's."""
    return _weight_norm(nn.ConvTranspose1d(in_ch, out_ch, kernel_size, stride,
                                           padding=padding))


def resolved_weight(conv: nn.Module) -> torch.Tensor:
    """The conv's effective weight, g * v / ||v|| for a weight-normed one."""
    if not hasattr(conv, "weight_g"):
        return conv.weight
    v, g = conv.weight_v, conv.weight_g
    norm = v.flatten(1).norm(dim=1).view(-1, *([1] * (v.dim() - 1)))
    return v * (g / norm)
