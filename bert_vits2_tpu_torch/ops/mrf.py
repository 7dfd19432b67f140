"""Fused MRF resblock stack: the wrapper of kernel K2.

Counterpart of `bert_vits2_tpu/ops/mrf_pallas.py`. The kernel,
`csrc/mrf.cu`, replaces both TPU kernels there, `_mrf_kernel`
(mrf_pallas.py:128) and `_mrf_folded_kernel` (mrf_pallas.py:434): they
compute one function, and the phase fold of the second only fills the TPU's
matrix-unit rows. Its source note says what bounds it on the card and how
the design answers that. Beside it:

- `prepare_mrf_weights`, run once per engine: resolves weight norm in
  float32 and packs every conv of the stage's `ResBlock1` blocks (reference
  layout) and the kernel's flat buffer. For float32 activations each conv
  weight is split into TF32 hi and lo parts (`split_tf32`) and laid out as
  the kernel's tensor-core B fragments (`pack_conv_weight`); for bfloat16
  ones (the TPU kernel's bf16 mode, mrf_pallas.py:54-67) it is rounded to
  bf16 and laid out as the bf16 B fragments (`pack_conv_weight_bf16`); the
  biases stay float32 in both.
- `fused_mrf_plain`, the same function in plain PyTorch (`F.conv1d`), which
  the CPU runs and the tests and `chip_smoke.py` hold the kernel against;
  in bf16 it rounds where the TPU kernel rounds (mrf_pallas.py:150-203).
- `fused_mrf`, the wrapper: through the custom op of x's dtype,
  `torch.ops.bv2.mrf_fwd` or `mrf_fwd_bf16` (`MRF_OPS`, `ops/library.py`,
  the weights as `MrfWeights.op_args`), the plain version for CPU tensors,
  the kernel for CUDA tensors. Its `launches` attribute counts launches of
  the float32 mode (`mrf_fwd`), `mrf_fwd_bf16.launches` those of the bf16
  mode.

Layout is the port's [B, C, T]; the mask is [B, T] and always applied (an
all-ones mask reproduces the unmasked ResBlock, the zero padding at the
edges included).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from bert_vits2_tpu_torch import _build
from bert_vits2_tpu_torch.ops import library
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


def stage_supported(channels: int, kernel_sizes, dilations,
                    dtype: torch.dtype = torch.float32) -> bool:
    """The stages the kernel takes with activations of `dtype`: 0 < C < 128
    and C % 8 == 0 (the JAX package's pack_generator_mrf selection; bf16:
    C % 16 == 0, the depth of one bf16 tensor-core step), with odd kernels
    and at most MAX_BLOCKS blocks of MAX_STAGES dilations."""
    step = {torch.float32: 8, torch.bfloat16: 16}.get(dtype)
    return (step is not None and 0 < channels < 128 and channels % step == 0
            and len(kernel_sizes) <= MAX_BLOCKS
            and all(k % 2 == 1 for k in kernel_sizes)
            and all(len(ds) <= MAX_STAGES for ds in dilations))


@dataclasses.dataclass(frozen=True)
class MrfWeights:
    """Weight-norm-resolved weights of one stage's MRF blocks.

    convs[j][s] = (w1, b1, w2, b2) in the reference layout [C, C, k], the
    weights in `dtype` (the activations' dtype), the biases float32;
    flat / offsets: the kernel's float32 buffer (`pack_conv_weight` or,
    in bf16, `pack_conv_weight_bf16` per conv weight, the biases as they
    are) and the (w1, b1, w2, b2) float offsets per (block, stage) into
    it."""

    kernel_sizes: tuple
    dilations: tuple
    convs: tuple
    flat: torch.Tensor
    offsets: tuple
    dtype: torch.dtype = torch.float32

    @property
    def channels(self) -> int:
        return self.convs[0][0][0].shape[0]

    @property
    def halo(self) -> int:
        return max(sum((k - 1) // 2 * d + (k - 1) // 2 for d in ds)
                   for k, ds in zip(self.kernel_sizes, self.dilations))

    @functools.cached_property
    def op_args(self) -> tuple:
        """The weights as the `bv2` MRF ops take them: (flat, convs,
        kernel_sizes, stages, dilations, offsets), the nested tuples
        flattened (`stages`: the dilations per block)."""
        return (self.flat, [p for blk in self.convs for quad in blk for p in quad],
                list(self.kernel_sizes), [len(ds) for ds in self.dilations],
                [d for ds in self.dilations for d in ds],
                [o for offs in self.offsets for o in offs])

    @classmethod
    def from_op_args(cls, flat, convs, kernel_sizes, stages, dilations, offsets,
                     dtype: torch.dtype) -> "MrfWeights":
        """The inverse of `op_args`."""
        nested, dils, i = [], [], 0
        for n in stages:
            nested.append(tuple(tuple(convs[4 * (i + s):4 * (i + s + 1)])
                                for s in range(n)))
            dils.append(tuple(dilations[i:i + n]))
            i += n
        return cls(kernel_sizes=tuple(kernel_sizes), dilations=tuple(dils),
                   convs=tuple(nested), flat=flat,
                   offsets=tuple(tuple(offsets[4 * j:4 * j + 4]) for j in range(i)),
                   dtype=dtype)


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


def pack_conv_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """A bf16 conv weight [C_out, C_in, k] -> the bf16 mode's B operands,
    as float32 words holding two bf16 values each (the first in the low
    half): per slab (tap, kstep) of 16 input channels, `wgmma` core
    matrices of 8 rows x 8 values: 8-channel output group j, K half kh,
    row r, column c holds w[8j + r, 16*kstep + 8*kh + c, tap]
    (csrc/mrf.cu)."""
    co, ci, k = w.shape
    # [tap, ci, co] -> [tap, kstep, kh, c, j, r] -> [tap, kstep, j, kh, r, c]
    t = w.permute(2, 1, 0).reshape(k, ci // 16, 2, 8, co // 8, 8)
    return t.permute(0, 1, 4, 2, 5, 3).reshape(-1).contiguous().view(torch.float32)


@torch.no_grad()
def prepare_mrf_weights(blocks, dtype: torch.dtype = torch.float32) -> MrfWeights:
    """blocks: the stage's ResBlock1 modules (each with `convs1`, `convs2`,
    `kernel_size`, `dilations`), float32; dtype: the activations' dtype
    (float32 or bfloat16). Raises ValueError for a stage the kernel does
    not take in that dtype."""
    if not stage_supported(blocks[0].convs1[0].out_channels,
                           [b.kernel_size for b in blocks],
                           [b.dilations for b in blocks], dtype):
        raise ValueError(f"no K2 stage of {blocks[0].convs1[0].out_channels} "
                         f"channels in {dtype}")
    pack = {torch.float32: pack_conv_weight,
            torch.bfloat16: pack_conv_weight_bf16}[dtype]
    convs, pieces, offsets = [], [], []
    n = 0
    for blk in blocks:
        stages = []
        for c1, c2 in zip(blk.convs1, blk.convs2):
            quad = (resolved_weight(c1).detach().float().to(dtype).clone(),
                    c1.bias.detach().float().clone(),
                    resolved_weight(c2).detach().float().to(dtype).clone(),
                    c2.bias.detach().float().clone())
            stages.append(quad)
            offs = []
            for i, p in enumerate(quad):
                flat = pack(p) if i % 2 == 0 else p
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
        dtype=dtype,
    )


def fused_mrf_plain(x: torch.Tensor, mask: torch.Tensor,
                    weights: MrfWeights) -> torch.Tensor:
    """The plain PyTorch version of K2: x [B, C, T], mask [B, T]."""
    if x.dtype != torch.float32:
        return _fused_mrf_plain_bf16(x, mask, weights)
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


def _fused_mrf_plain_bf16(x, mask, weights):
    """The plain version in bf16, rounding where the TPU kernel rounds
    (mrf_pallas.py:150-203): each conv an fp32 sum of the bf16 products
    plus the fp32 bias, rounded to bf16; leaky ReLU, masking and the
    residual add in bf16; the blocks' outputs summed in fp32, divided by
    their number, then rounded."""
    dt = x.dtype
    m = mask[:, None, :].to(dt)
    acc = None
    for k, ds, stages in zip(weights.kernel_sizes, weights.dilations,
                             weights.convs):
        y = x
        for d, (w1, b1, w2, b2) in zip(ds, stages):
            a = F.leaky_relu(y, LRELU_SLOPE) * m
            a = F.conv1d(a.float(), w1.float(), b1, padding=(k - 1) // 2 * d,
                         dilation=d).to(dt)
            a = F.leaky_relu(a, LRELU_SLOPE) * m
            a = F.conv1d(a.float(), w2.float(), b2, padding=(k - 1) // 2).to(dt)
            y = a + y
        y = (y * m).float()
        acc = y if acc is None else acc + y
    return (acc / len(weights.convs)).to(dt)


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
    """Averaged MRF output [B, C, T] of x [B, C, T] under mask [B, T],
    through the `bv2` MRF op of x's dtype (`ops/library.py`): the kernel
    for CUDA tensors, the plain version for CPU ones; inside
    `plain_functions()` the plain version directly on CPU tensors (others
    raise)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_mrf is inference-only")
    b, c, t = x.shape
    if mask.shape != (b, t):
        raise ValueError(f"mask {tuple(mask.shape)} is not {(b, t)}")
    if x.dtype != weights.dtype:
        raise ValueError(f"x is {x.dtype}, the packed weights are for "
                         f"{weights.dtype}")
    if c != weights.channels or not stage_supported(
            c, weights.kernel_sizes, weights.dilations, x.dtype):
        raise ValueError(f"unsupported MRF stage: C={c}, {x.dtype}")
    if x.device.type != "cpu":
        library.refuse_plain(x.device)
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        if mask.dtype != x.dtype or weights.flat.dtype != torch.float32:
            raise ValueError("the kernel takes x and the mask in one dtype")
        if mask.device != x.device or weights.flat.device != x.device:
            raise ValueError("all inputs must lie on one device")
        if not (x.is_contiguous() and mask.is_contiguous()):
            raise ValueError("the kernel takes contiguous inputs")
    elif library.plain_only():
        return fused_mrf_plain(x, mask, weights)
    return MRF_OPS[x.dtype](x, mask, *weights.op_args)


def _launch(entry: str, x, mask, weights, out, *scratch) -> None:
    """One launch of an entry point of csrc/mrf.cu on checked inputs."""
    b, c, t = x.shape
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
    tile = pick_tile(c, t, weights.halo)
    err = getattr(_build.library("mrf.cu"), entry)(
        x.data_ptr(), mask.data_ptr(), weights.flat.data_ptr(),
        *(a.data_ptr() for a in scratch), out.data_ptr(),
        b, c, t, tile, nb, ks, ns, dils, offs, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, entry)


def mrf_fwd(x: torch.Tensor, mask: torch.Tensor,
            weights: MrfWeights) -> torch.Tensor:
    """K2's float32 mode on checked inputs (`fused_mrf` checks them),
    counted in `fused_mrf.launches`."""
    out = torch.empty_like(x)
    _launch("mrf_fwd", x, mask, weights, out)
    fused_mrf.launches += 1
    return out


def mrf_fwd_bf16(x: torch.Tensor, mask: torch.Tensor,
                 weights: MrfWeights) -> torch.Tensor:
    """K2's bf16 mode on checked inputs (`fused_mrf` checks them): bf16 x,
    mask and output, fp32 accumulation; the blocks' outputs summed in an
    fp32 scratch [B, C, T] when there is more than one."""
    acc = torch.empty(x.shape if len(weights.kernel_sizes) > 1 else (1,),
                      device=x.device)
    out = torch.empty_like(x)
    _launch("mrf_fwd_bf16", x, mask, weights, out, acc)
    mrf_fwd_bf16.launches += 1
    return out


_MRF_SCHEMA = ("(Tensor x, Tensor mask, Tensor flat, Tensor[] convs, int[] kernel_sizes, "
               "int[] stages, int[] dilations, int[] offsets) -> Tensor")


def _define_mrf(name: str, launch):
    """bv2::<name>: the CPU implementation the plain version, the CUDA one
    `launch` on the inputs `fused_mrf` checked."""

    def unpack(fn):
        return lambda x, mask, *args: fn(x, mask, MrfWeights.from_op_args(*args, x.dtype))

    return library.define(name, _MRF_SCHEMA, unpack(fused_mrf_plain), unpack(launch),
                          lambda x, *_: torch.empty_like(x))


# the inference entry points: torch.ops.bv2.mrf_fwd and mrf_fwd_bf16
MRF_OPS = {torch.float32: _define_mrf("mrf_fwd", mrf_fwd),
           torch.bfloat16: _define_mrf("mrf_fwd_bf16", mrf_fwd_bf16)}

fused_mrf.launches = 0
mrf_fwd_bf16.launches = 0
