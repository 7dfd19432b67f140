"""Convolutions in the reference layout, with weight norm.

Counterpart of `bert_vits2_tpu/nn/conv.py`. Activations are [b, c, t] and
the modules are subclasses of the stock `torch.nn.Conv1d` /
`ConvTranspose1d` / `Conv2d` / `Linear`, so parameter names and shapes are
those of a reference `G_*.pth`:

- Conv1d weight [out, in, k]; with weight norm, `weight_g` [out, 1, 1] (one
  gain per OUT channel) and `weight_v` [out, in, k].
- ConvTranspose1d weight [in, out, k]; `torch.nn.utils.weight_norm` with
  dim=0 puts `weight_g` [in, 1, 1] per IN channel, as the reference does.
- Conv2d weight [out, in, kh, kw], `weight_g` [out, 1, 1, 1] (the period
  discriminators' (k, 1) kernels over [b, c, t / p, p] images).
- Dense layers are `Linear` where the reference has one
  (`spk_emb_linear`) and a k=1 `Conv1d` elsewhere (attention q/k/v/o).

Each computes in its input's dtype, the JAX modules' rule
(bert_vits2_tpu/nn/conv.py `Conv1d`, `ConvTranspose1d`, `Dense`): weight
norm is resolved in float32 from the float32 `weight_g` / `weight_v`, and
the resolved weight and the bias are cast to the input's dtype inside the
forward, so the gradient reaches the float32 parameters through the cast.
A float32 input computes exactly what the stock module computes (the cast
is then the tensor itself); a bfloat16 one (the bf16 training policy,
`train_compute_dtype`) computes in bf16 from float32 master parameters.

The JAX package's time folding and sub-pixel transposed conv fill the TPU's
lanes; `F.conv1d` / `F.conv_transpose1d` compute the same function.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn


def _as(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """A parameter (or the resolved weight) in the dtype of the input x
    (the tensor itself when it has that dtype: no cast in a traced graph)."""
    return p if p is None or p.dtype == x.dtype else p.to(x.dtype)


class Conv1d(nn.Conv1d):
    def _conv_forward(self, x, weight, bias):
        return super()._conv_forward(x, _as(weight, x), _as(bias, x))


class Conv2d(nn.Conv2d):
    def _conv_forward(self, x, weight, bias):
        return super()._conv_forward(x, _as(weight, x), _as(bias, x))


class ConvTranspose1d(nn.ConvTranspose1d):
    def forward(self, x, output_size=None):
        if output_size is not None:
            raise ValueError("the port's transposed convs take no output_size")
        w, b = _as(self.weight, x), _as(self.bias, x)
        if x.device.type == "cpu" and x.dtype != torch.float32:
            # oneDNN's bf16 transposed conv on the CPU returns wrong input
            # gradients when padding > 0 (torch 2.13: off by the gradient's
            # own size); on the CPU it runs on the same bf16 values in fp32
            # and rounds once, which is what a bf16 conv with fp32 sums (the
            # card's) computes
            return self._conv_t(x.float(), w.float(), None if b is None
                                else b.float()).to(x.dtype)
        return self._conv_t(x, w, b)

    def _conv_t(self, x, w, b):
        return F.conv_transpose1d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, _as(self.weight, x), _as(self.bias, x))


def _weight_norm(module: nn.Module) -> nn.Module:
    # torch.nn.utils.weight_norm writes the reference's weight_g / weight_v
    # keys; the parametrizations API would rename them.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return nn.utils.weight_norm(module)


def conv1d(in_ch: int, out_ch: int, kernel_size: int = 1, dilation: int = 1,
           padding: int = 0, groups: int = 1, bias: bool = True,
           weight_norm: bool = False, stride: int = 1) -> Conv1d:
    conv = Conv1d(in_ch, out_ch, kernel_size, stride=stride,
                  dilation=dilation, padding=padding, groups=groups, bias=bias)
    return _weight_norm(conv) if weight_norm else conv


def conv2d(in_ch: int, out_ch: int, kernel_size: tuple[int, int],
           stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
           weight_norm: bool = False) -> Conv2d:
    conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding)
    return _weight_norm(conv) if weight_norm else conv


def conv_transpose1d(in_ch: int, out_ch: int, kernel_size: int, stride: int,
                     padding: int = 0) -> ConvTranspose1d:
    """A weight-normed transposed conv, as every one of the reference's."""
    return _weight_norm(ConvTranspose1d(in_ch, out_ch, kernel_size, stride,
                                        padding=padding))


def resolved_weight(conv: nn.Module) -> torch.Tensor:
    """The conv's effective weight, g * v / ||v|| for a weight-normed one."""
    if not hasattr(conv, "weight_g"):
        return conv.weight
    v, g = conv.weight_v, conv.weight_g
    norm = v.flatten(1).norm(dim=1).view(-1, *([1] * (v.dim() - 1)))
    return v * (g / norm)
