"""Fused MRF resblock stack: the wrapper of kernel K2.

Counterpart of `bert_vits2_tpu/ops/mrf_pallas.py`. The kernel,
`csrc/mrf.cu`, replaces both TPU kernels there, `_mrf_kernel`
(mrf_pallas.py:128) and `_mrf_folded_kernel` (mrf_pallas.py:434): they
compute one function, and the phase fold of the second only fills the TPU's
matrix-unit rows. Its source note says what bounds it on the card and how
the design answers that. Beside it:

- `prepare_mrf_weights`, run once per engine: resolves weight norm and packs
  every conv of the stage's `ResBlock1` blocks (reference layout) and the
  kernel's flat buffer, each conv weight split into TF32 hi and lo parts
  (`split_tf32`) and laid out as the kernel's tensor-core B fragments
  (`pack_conv_weight`).
- `fused_mrf_plain`, the same function in plain PyTorch (`F.conv1d`), which
  the CPU runs and the tests and `chip_smoke.py` hold the kernel against.
- `fused_mrf`, the wrapper: plain version for CPU tensors, the kernel for
  CUDA tensors. Its `launches` attribute counts kernel launches.

Layout is the port's [B, C, T]; the mask is [B, T] and always applied (an
all-ones mask reproduces the unmasked ResBlock, the zero padding at the
edges included).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from bert_vits2_tpu_torch import _build
from bert_vits2_tpu_torch.nn.conv import resolved_weight

LRELU_SLOPE = 0.1
MAX_BLOCKS = 4  # csrc/mrf.cu MAXB
MAX_STAGES = 4  # csrc/mrf.cu MAXS
SMEM_BYTES = 232448  # dynamic shared memory a block may take (227 KB)
# the kernel's work split (csrc/mrf.cu): WGS warpgroups, each holding MT
# M tiles of 64 samples for NT = min(C / 8, 8) N tiles of 8 channels, so a
# window of at most 64 * WGS * MT samples, by NT; weight slabs stream
# through NSTAGE ring stages of STAGE_FLOATS floats; SLACK floats past the
# mask
NSTAGE = 3
STAGE_FLOATS = 2048
SLACK = 32
MAX_WINDOW = {1: 4096, 2: 2048, 3: 1280, 4: 1024, 5: 768, 6: 512, 7: 384, 8: 384}


def stage_supported(channels: int, kernel_sizes, dilations) -> bool:
    """The stages the kernel takes: 0 < C < 128 and C % 8 == 0 (the JAX
    package's pack_generator_mrf selection), with odd kernels and at most
    MAX_BLOCKS blocks of MAX_STAGES dilations."""
    return (0 < channels < 128 and channels % 8 == 0
            and len(kernel_sizes) <= MAX_BLOCKS
            and all(k % 2 == 1 for k in kernel_sizes)
            and all(len(ds) <= MAX_STAGES for ds in dilations))


@dataclasses.dataclass(frozen=True)
class MrfWeights:
    """Weight-norm-resolved weights of one stage's MRF blocks.

    convs[j][s] = (w1, b1, w2, b2) in the reference layout [C, C, k];
    flat / offsets: the kernel's buffer (`pack_conv_weight` per conv
    weight, the biases as they are) and the (w1, b1, w2, b2) float offsets
    per (block, stage) into it."""

    kernel_sizes: tuple
    dilations: tuple
    convs: tuple
    flat: torch.Tensor
    offsets: tuple

    @property
    def channels(self) -> int:
        return self.convs[0][0][0].shape[0]

    @property
    def halo(self) -> int:
        return max(sum((k - 1) // 2 * d + (k - 1) // 2 for d in ds)
                   for k, ds in zip(self.kernel_sizes, self.dilations))


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as
    `cvt.rna.tf32.f32`: the low 13 mantissa bits rounded off."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v -> (hi, lo), both TF32 values, hi = tf32(v), lo = tf32(v - hi):
    hi + lo equals v within 2**-22 of |v| (the 3xTF32 split)."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """A conv weight [C_out, C_in, k] -> the kernel's B operands, flat: per
    slab (tap, kstep) of 8 input channels, the hi part, then the lo part,
    each as `wgmma` core matrices: 8-channel output group j, K half kh,
    row r, column c holds w[8j + r, 8*kstep + 4*kh + c, tap]
    (csrc/mrf.cu)."""
    co, ci, k = w.shape
    parts = []
    for part in split_tf32(w.float()):
        # [tap, ci, co] -> [tap, kstep, kh, c, j, r] -> [tap, kstep, j, kh, r, c]
        t = part.permute(2, 1, 0).reshape(k, ci // 8, 2, 4, co // 8, 8)
        parts.append(t.permute(0, 1, 4, 2, 5, 3))
    return torch.stack(parts, dim=2).reshape(-1)


@torch.no_grad()
def prepare_mrf_weights(blocks) -> MrfWeights:
    """blocks: the stage's ResBlock1 modules (each with `convs1`, `convs2`,
    `kernel_size`, `dilations`)."""
    convs, pieces, offsets = [], [], []
    n = 0
    for blk in blocks:
        stages = []
        for c1, c2 in zip(blk.convs1, blk.convs2):
            quad = (resolved_weight(c1).detach().clone(), c1.bias.detach().clone(),
                    resolved_weight(c2).detach().clone(), c2.bias.detach().clone())
            stages.append(quad)
            offs = []
            for i, p in enumerate(quad):
                flat = pack_conv_weight(p) if i % 2 == 0 else p
                offs.append(n)
                pieces.append(flat)
                n += flat.numel()
            offsets.append(tuple(offs))
        convs.append(tuple(stages))
    return MrfWeights(
        kernel_sizes=tuple(b.kernel_size for b in blocks),
        dilations=tuple(tuple(b.dilations) for b in blocks),
        convs=tuple(convs),
        flat=torch.cat(pieces).contiguous(),
        offsets=tuple(offsets),
    )


def fused_mrf_plain(x: torch.Tensor, mask: torch.Tensor,
                    weights: MrfWeights) -> torch.Tensor:
    """The plain PyTorch version of K2: x [B, C, T], mask [B, T]."""
    m = mask[:, None, :]
    acc = None
    for k, ds, stages in zip(weights.kernel_sizes, weights.dilations,
                             weights.convs):
        y = x
        for d, (w1, b1, w2, b2) in zip(ds, stages):
            a = F.leaky_relu(y, LRELU_SLOPE) * m
            a = F.conv1d(a, w1, b1, padding=(k - 1) // 2 * d, dilation=d)
            a = F.leaky_relu(a, LRELU_SLOPE) * m
            a = F.conv1d(a, w2, b2, padding=(k - 1) // 2)
            y = a + y
        y = y * m
        acc = y if acc is None else acc + y
    return acc / len(weights.convs)


def _smem_bytes(channels: int, window: int) -> int:
    """csrc/mrf.cu's shared memory for a window: the weight ring, two
    [C][Wp] buffers (Wp >= window, 8 mod 32), the mask and the slack."""
    wp = (window + 23) // 32 * 32 + 8
    return 4 * (NSTAGE * STAGE_FLOATS + 2 * channels * wp + wp + SLACK)


def pick_tile(channels: int, t: int, halo: int) -> int:
    """Largest output tile whose window (tile + 2*halo samples) fits both
    the warpgroups' M tiles and shared memory."""
    window = MAX_WINDOW[min(channels // 8, 8)]
    while window > 32 and _smem_bytes(channels, window) > SMEM_BYTES:
        window -= 32
    tile = min(window - 2 * halo, t)
    if tile < 1:
        raise ValueError(f"C={channels} leaves no room for a tile")
    return tile


def fused_mrf(x: torch.Tensor, mask: torch.Tensor,
              weights: MrfWeights) -> torch.Tensor:
    """Averaged MRF output [B, C, T] of x [B, C, T] under mask [B, T]."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_mrf is inference-only")
    b, c, t = x.shape
    if mask.shape != (b, t):
        raise ValueError(f"mask {tuple(mask.shape)} is not {(b, t)}")
    if c != weights.channels or not stage_supported(
            c, weights.kernel_sizes, weights.dilations):
        raise ValueError(f"unsupported MRF stage: C={c}")
    if x.device.type == "cpu":
        return fused_mrf_plain(x, mask, weights)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if (x.dtype != torch.float32 or mask.dtype != torch.float32
            or weights.flat.dtype != torch.float32):
        raise ValueError("the kernel takes float32 inputs")
    if mask.device != x.device or weights.flat.device != x.device:
        raise ValueError("all inputs must lie on one device")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("the kernel takes contiguous inputs")
    nb = len(weights.kernel_sizes)
    ks = (ctypes.c_int * nb)(*weights.kernel_sizes)
    ns = (ctypes.c_int * nb)(*(len(ds) for ds in weights.dilations))
    dils = (ctypes.c_int * (nb * MAX_STAGES))()
    offs = (ctypes.c_longlong * (nb * MAX_STAGES * 4))()
    i = 0
    for j, ds in enumerate(weights.dilations):
        for s, d in enumerate(ds):
            dils[j * MAX_STAGES + s] = d
            offs[(j * MAX_STAGES + s) * 4:(j * MAX_STAGES + s + 1) * 4] = list(
                weights.offsets[i])
            i += 1
    out = torch.empty_like(x)
    tile = pick_tile(c, t, weights.halo)
    lib = _build.library("mrf.cu")
    err = lib.mrf_fwd(
        x.data_ptr(), mask.data_ptr(), weights.flat.data_ptr(), out.data_ptr(),
        b, c, t, tile, nb, ks, ns, dils, offs, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "mrf_fwd")
    fused_mrf.launches += 1
    return out


fused_mrf.launches = 0
