"""HiFi-GAN upsampling decoder (reference: models.py:490-564).

Counterpart of `bert_vits2_tpu/models/generator.py`: conv_pre (k7) plus
speaker conditioning, transposed-conv upsample stages, each followed by an
MRF of ResBlocks averaged; leaky_relu (slope 0.01) and conv_post (k7, no
bias) and tanh. Layout [b, c, t].

Static-shape re-masking: with a frame mask, the mask is repeated per stage
and applied before every conv, after every block and on the wave, so the
padded frames of a batched call cannot bleed into the valid audio.

The caller chooses the MRF path by what it passes: with `mrf_packed`
(`pack_mrf()`, weight norm resolved once per engine) the stages that have
an entry run through the kernel K2 (`ops.mrf.fused_mrf`, inference only);
the other stages, and every stage when `mrf_packed` is None (always so in
training), run the ResBlock modules, which are differentiable.

The forward runs in the dtype of its input: float32, or bfloat16 in
training under `train_compute_dtype` (the convs cast their float32
parameters, `nn/conv.py`; the caller passes g in bf16) and on the bf16
inference copy (`models/synthesizer.py:cast_copy`), where the frame mask is cast to the activation dtype up front (JAX
generator.py:183), the upsample convs, the C >= 128 ResBlocks and
`conv_post` compute in bf16, and K2 takes the stages packed by
`pack_mrf(torch.bfloat16)` (from the float32 module: weights resolved in
float32, then rounded; float32 biases, as the TPU kernel's packing).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bert_vits2_tpu_torch.nn.conv import conv1d, conv_transpose1d
from bert_vits2_tpu_torch.ops.mrf import (
    MrfWeights,
    fused_mrf,
    prepare_mrf_weights,
    stage_supported,
)

LRELU_SLOPE = 0.1


@torch.no_grad()
def _init_normal(conv: nn.Module) -> None:
    # as the JAX package: direction v ~ normal(0, 0.01), gain g = ||v||
    nn.init.normal_(conv.weight_v, 0.0, 0.01)
    v = conv.weight_v
    conv.weight_g.copy_(v.flatten(1).norm(dim=1).view_as(conv.weight_g))


class ResBlock1(nn.Module):
    """3 dilated + 3 plain convs with residuals (modules.py:221-322)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations=(1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size * d - d) // 2, weight_norm=True)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            conv1d(channels, channels, kernel_size,
                   padding=(kernel_size - 1) // 2, weight_norm=True)
            for _ in dilations)
        for c in (*self.convs1, *self.convs2):
            _init_normal(c)

    def forward(self, x, x_mask=None):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            xt = F.leaky_relu(c1(xt), LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = c2(xt) + x
        return x * x_mask if x_mask is not None else x


class ResBlock2(nn.Module):
    """2 dilated convs with residuals (modules.py:325-360)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size * d - d) // 2, weight_norm=True)
            for d in dilations)
        for c in self.convs:
            _init_normal(c)

    def forward(self, x, x_mask=None):
        for c in self.convs:
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = c(xt) + x
        return x * x_mask if x_mask is not None else x


class Generator(nn.Module):
    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes, resblock_dilation_sizes,
                 upsample_rates, upsample_initial_channel: int,
                 upsample_kernel_sizes, gin_channels: int = 0):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.resblock = resblock
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.upsample_rates = tuple(upsample_rates)
        self.conv_pre = conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3)
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_in = upsample_initial_channel // (2 ** i)
            ch = upsample_initial_channel // (2 ** (i + 1))
            up = conv_transpose1d(ch_in, ch, k, u, padding=(k - u) // 2)
            _init_normal(up)
            self.ups.append(up)
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, rd))
        self.conv_post = conv1d(ch, 1, 7, padding=3, bias=False)
        self.cond = (conv1d(gin_channels, upsample_initial_channel, 1)
                     if gin_channels else None)

    def _stage_blocks(self, i: int):
        n = self.num_kernels
        return list(self.resblocks[i * n:(i + 1) * n])

    def _fused_stage(self, i: int, dtype: torch.dtype) -> bool:
        ch = self.ups[i].out_channels
        return self.resblock == "1" and stage_supported(
            ch, self.kernel_sizes, self.dilation_sizes, dtype)

    def pack_mrf(self, dtype: torch.dtype = torch.float32) -> list[MrfWeights | None]:
        """Weight-norm-resolved MRF weights per stage for activations of
        `dtype`: an entry for a stage whose channel count K2 takes (0 < C <
        128, C % 8 == 0; bf16: C % 16 == 0), None for one that runs the
        ResBlock modules. Resolve once and pass to forward."""
        return [prepare_mrf_weights(self._stage_blocks(i), dtype)
                if self._fused_stage(i, dtype) else None
                for i in range(len(self.ups))]

    def forward(self, x, g=None, y_mask=None, mrf_packed=None):
        """x: [b, c, t]; g: [b, gin]; y_mask: [b, t] or None; mrf_packed:
        `pack_mrf()` or None -> wave [b, t * hop]."""
        mask = None if y_mask is None else y_mask[:, None, :].to(x.dtype)
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g[:, :, None])
        if mask is not None:
            x = x * mask
        for i, (u, up) in enumerate(zip(self.upsample_rates, self.ups)):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if mask is not None:
                mask = mask.repeat_interleave(u, dim=2)
                x = x * mask
            packed = None if mrf_packed is None else mrf_packed[i]
            if packed is not None:
                m = (mask[:, 0] if mask is not None
                     else x.new_ones(x.shape[0], x.shape[2]))
                x = fused_mrf(x.contiguous(), m.contiguous(), packed)
            else:
                xs = None
                for block in self._stage_blocks(i):
                    y = block(x, mask)
                    xs = y if xs is None else xs + y
                x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x))  # default slope 0.01, as the reference
        wave = torch.tanh(x)[:, 0]
        if mask is not None:
            wave = wave * mask[:, 0]
        return wave
