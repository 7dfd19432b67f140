"""Banded relative-position self-attention: the wrappers of kernels K1, B5
and B6.

Counterpart of `bert_vits2_tpu/ops/attention_pallas.py`. Three kernels
replace its three TPU kernels; each source note says what bounds it on the
card and how the design answers that:

- `csrc/banded_attn.cu` (K1) replaces `_attn_fwd_kernel`
  (attention_pallas.py:88). Its inference launch writes the output only;
  its train mode also writes the softmax row statistics `m`, `l` and
  applies the hash dropout in the kernel.
- `csrc/banded_attn_bwd.cu` replaces `_attn_bwd_q_kernel` (B5,
  attention_pallas.py:147) and `_attn_bwd_k_kernel` (B6,
  attention_pallas.py:228).
- `csrc/banded_attn_wide.cu` holds the same four functions for the shapes
  those tensor-core kernels do not take (a head wider than 128, a window
  above 4, b*h above 65535), which the TPU kernels take by padding: simple
  fp32 kernels (`wide_fwd`, `wide_fwd_train`, `wide_bwd_q`, `wide_bwd_k`).
  Each wrapper picks the variant by shape, `banded_kernels_support`.

Beside them:

- `banded_attention_plain`, the same function in plain PyTorch: the JAX
  package's `_dense` branch (nn/attention.py:183-194), differentiable, with
  the hash dropout of `hash_dropout_probs` when given a seed. The CPU runs
  it, and the tests and `chip_smoke.py` hold the kernels against it (the
  backward kernels against its autograd, `banded_attention_bwd_plain`). It
  masks query rows as well as keys; the kernels mask keys only, so the two
  agree on valid rows, which is all any caller reads. On bf16 operands it
  rounds where the TPU kernel does (attention_pallas.py:88-146): scores
  and softmax in fp32, the probabilities rounded to bf16 for P.V with an
  fp32 sum, the band term from the fp32 probabilities against the bf16
  table, the output rounded to bf16. (The JAX package's own CPU path, its
  XLA formula, softmaxes in bf16 instead; the port follows the kernel.)
- `banded_attention_bwd_plain_bf16`, the plain version of B5 and B6 on
  bf16 operands, written out where autograd of the bf16 forward would not
  round as the TPU kernels do (attention_pallas.py:147-300, 396-431):
  p, dp and ds in fp32 from the bf16 operands; ds and the dropped p
  rounded to bf16 only as operands of the three t x t products (fp32
  sums); the band terms from the fp32 ds and dropped p against the table;
  dq, dk, dv rounded to bf16 at the end; dek, dev summed in fp32 and
  rounded to the table's dtype.
- `banded_rel_self_attention`, the public wrapper: without a gradient or
  dropout, one of the four forward ops `torch.ops.bv2.banded_attn_fwd`,
  `banded_attn_fwd_bf16`, `banded_attn_wide_fwd`, `banded_attn_wide_fwd_bf16`
  (`FORWARD_OPS`, `ops/library.py`), chosen by dtype and shape: on CUDA
  tensors the op launches the kernel, on CPU tensors it runs the plain
  version; when a gradient is wanted or dropout is on, the plain version
  on the CPU (in bf16 with a gradient, `BandedAttentionFn` on the plain
  versions, so the backward rounds as the kernels do) and
  `BandedAttentionFn` on the card (K1 in train mode forward, B5 and B6
  backward), each in the variant the shape takes; an error for anything
  else. Every entry point takes float32 or bfloat16 operands: the bf16
  modes are K1's (`banded_attention_fwd_bf16`,
  `banded_attention_fwd_train_bf16`), B5's and B6's
  (`banded_attention_bwd_q_bf16`, `banded_attention_bwd_k_bf16`) and the
  wide kernels' (`wide_*_bf16`); the row statistics m, l and delta stay
  float32.
- `banded_kernels_support`, the tensor-core kernels' range of shapes.

Each kernel launcher counts its launches in its `launches` attribute: the
wrappers count the tensor-core kernels' float32 launches (the inference
one in `banded_attention_fwd`, the launch of the `banded_attn_fwd` op),
the `*_bf16` and `wide_*` functions their own; a program that
`torch.export` traced runs the same ops, so its launches count too.

Dropout is the JAX package's counter-based position hash (`hash_keep`):
the keep mask of probability (row i, column j) of batch row b and head
h_idx is a function of (i, j, salt, seed), so the backward kernels
regenerate it instead of storing a [t, t] mask. The salt is affine,
salt_base + b * salt_stride + h_idx (`dropout_salt` = (salt_base,
salt_stride), every entry point's argument): the default (0, h) is the
JAX kernels' b * h + h_idx, and a data-parallel rank passes (row_offset *
h, h), the salt its rows have in the global batch, which the TPU kernels
see whole (`parallel/data.py:dropout_salt`).
"""

from __future__ import annotations

import ctypes

import torch

from bert_vits2_tpu_torch import _build
from bert_vits2_tpu_torch.ops import library, noise

NEG_FILL = -1e4  # the reference's mask fill: a fully masked row is uniform
MAX_HEAD_DIM = 128  # the tensor-core kernels' widest head and window
MAX_WINDOW = 4
WIDE_MAX_HEAD_DIM = 8192  # csrc/banded_attn_wide.cu MAX_D
KERNEL_DTYPES = (torch.float32, torch.bfloat16)  # the operand dtypes the kernels take
_M32 = 0xFFFFFFFF


def drop_threshold(p_drop: float) -> int:
    """The hash's keep threshold: a position is kept when its 31-bit hash
    is >= this (attention_pallas.py:67)."""
    return min(int(p_drop * 2147483648.0), 2**31 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c modulo 2**32, for int64 x in [0, 2**32): the int32 wrapping
    multiply, split in 16-bit halves so no int64 product overflows."""
    c &= _M32
    return (((x & 0xFFFF) * c) + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def hash_keep(rows: torch.Tensor, cols: torch.Tensor, salt: torch.Tensor,
              seed, thr: int) -> torch.Tensor:
    """The JAX package's `_hash_keep` (attention_pallas.py:71-85), bit for
    bit: a murmur-style finalizer over (row, col, salt, seed) in int32
    arithmetic with wrapping multiplies and logical right shifts. Here the
    int32 values live in int64 tensors as their uint32 bit patterns, where
    `>>` is logical. rows, cols, salt: non-negative integer tensors that
    broadcast together; seed: an int32 value (Python int or integer
    tensor). Returns the keep mask in {0.0, 1.0}, float32."""
    rows, cols, salt = (torch.as_tensor(a).to(torch.int64) for a in (rows, cols, salt))
    seed = torch.as_tensor(seed, dtype=torch.int64, device=rows.device) & _M32
    x = (_mul32(rows, -1640531527) + _mul32(cols, -2048144777)) & _M32
    x = x ^ ((_mul32(salt, 374761393) + seed) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, -2048144789)
    x = x ^ (x >> 13)
    x = _mul32(x, -1028477387)
    x = x ^ (x >> 16)
    return ((x & 0x7FFFFFFF) >= thr).to(torch.float32)


def salt_args(dropout_salt, h: int) -> tuple[int, int]:
    """(salt_base, salt_stride) of a `dropout_salt` (None: (0, h), the
    salt b * h + head)."""
    if dropout_salt is None:
        return 0, h
    base, stride = dropout_salt
    return int(base), int(stride)


def hash_dropout_probs(p_attn: torch.Tensor, p_drop: float,
                       seed, dropout_salt=None) -> torch.Tensor:
    """[b, h, t, t] probabilities -> dropped and rescaled with the position
    hash (attention_pallas.py:458-470): the same keep mask as the kernels,
    row b and head h_idx salted salt_base + b * salt_stride + h_idx."""
    b, h, t, _ = p_attn.shape
    dev = p_attn.device
    base, stride = salt_args(dropout_salt, h)
    pos = torch.arange(t, device=dev)
    salt = ((base + torch.arange(b, device=dev)[:, None] * stride
             + torch.arange(h, device=dev)[None, :]) & _M32)[:, :, None, None]
    keep = hash_keep(pos[:, None], pos[None, :], salt, seed,
                     drop_threshold(p_drop))
    return p_attn * keep.to(p_attn.dtype) / (1.0 - p_drop)


def _band_index(t: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[t, t] index of the band column c = j - i + w (clamped) and the band
    mask |j - i| <= w."""
    pos = torch.arange(t, device=device)
    c = pos[None, :] - pos[:, None] + w
    inside = (c >= 0) & (c <= 2 * w)
    return c.clamp(0, 2 * w), inside


def band_to_abs(rel: torch.Tensor, w: int) -> torch.Tensor:
    """[b, h, t, 2w+1] band logits -> [b, h, t, t] with B[i, j] =
    rel[i, j - i + w] inside the band and 0 outside."""
    b, h, t, _ = rel.shape
    c, inside = _band_index(t, w, rel.device)
    out = torch.gather(rel, 3, c.expand(b, h, t, t))
    return out * inside.to(rel.dtype)


def abs_to_band(p: torch.Tensor, w: int) -> torch.Tensor:
    """[b, h, t, t] weights -> [b, h, t, 2w+1] with band[i, c] =
    p[i, i + c - w] (0 where i + c - w is outside [0, t))."""
    b, h, t, _ = p.shape
    pos = torch.arange(t, device=p.device)
    cols = pos[:, None] + torch.arange(2 * w + 1, device=p.device)[None, :] - w
    valid = (cols >= 0) & (cols < t)
    idx = cols.clamp(0, t - 1).expand(b, h, t, 2 * w + 1)
    return torch.gather(p, 3, idx) * valid.to(p.dtype)


def banded_scores_plain(q, k, x_mask, emb_rel_k, window_size: int) -> torch.Tensor:
    """The masked logits [b, h, t, t] of the plain version."""
    w = int(window_size)
    scores = torch.matmul(q, k.transpose(-1, -2))
    rel = torch.einsum("bhtd,cd->bhtc", q, emb_rel_k)
    scores = scores + band_to_abs(rel, w)
    am = x_mask[:, None, :, None] * x_mask[:, None, None, :]
    return scores.masked_fill(am == 0, NEG_FILL)


def banded_attention_plain(q, k, v, x_mask, emb_rel_k, emb_rel_v,
                           window_size: int, dropout_p: float = 0.0,
                           dropout_seed=None, dropout_salt=None,
                           dropout_shard=None) -> torch.Tensor:
    """The plain PyTorch version of the kernels (same arguments as the
    wrapper): differentiable. With `dropout_p` > 0 it drops probabilities
    with the position hash when given a `dropout_seed` (the JAX `_dense`
    branch), and without one by `noise.dropout` (torch's generator outside
    a train step; `dropout_shard` (rank, n): these are a model rank's heads
    of n shares)."""
    w = int(window_size)
    dt = q.dtype
    if dt != torch.float32:  # the TPU kernel's rounding points (module note)
        q, k, v, emb_rel_k, emb_rel_v = (
            a.float() for a in (q, k, v, emb_rel_k, emb_rel_v))
    p = torch.softmax(banded_scores_plain(q, k, x_mask, emb_rel_k, w), dim=-1)
    if dropout_p and dropout_seed is not None:
        p = hash_dropout_probs(p, dropout_p, dropout_seed, dropout_salt)
    elif dropout_p:
        p = noise.dropout(p, dropout_p, dropout_shard)
    out = torch.matmul(p.to(dt).float() if dt != torch.float32 else p, v)
    out = out + torch.einsum("bhtc,cd->bhtd", abs_to_band(p, w), emb_rel_v)
    return out.to(dt)


def banded_attention_stats_plain(q, k, x_mask, emb_rel_k, window_size: int):
    """The softmax row statistics of the plain version: the row max m and
    the sum l of exp(s - m), each [b, h, t], float32 (K1's train-mode
    outputs; fp32 scores from bf16 operands)."""
    q, k, x_mask, emb_rel_k = (a.float() for a in (q, k, x_mask, emb_rel_k))
    s = banded_scores_plain(q, k, x_mask, emb_rel_k, window_size)
    m = s.amax(dim=-1)
    return m, torch.exp(s - m[..., None]).sum(dim=-1)


def banded_attention_bwd_plain(q, k, v, x_mask, emb_rel_k, emb_rel_v, g,
                               window_size: int, dropout_p: float = 0.0,
                               dropout_seed=None, dropout_salt=None):
    """The plain version of B5 and B6: the autograd of
    `banded_attention_plain` for the output gradient g ->
    (dq, dk, dv, dek, dev)."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in
                  (q, k, v, emb_rel_k, emb_rel_v)]
        out = banded_attention_plain(leaves[0], leaves[1], leaves[2], x_mask,
                                     leaves[3], leaves[4], window_size,
                                     dropout_p, dropout_seed, dropout_salt)
        return torch.autograd.grad(out, leaves, g)


def banded_attention_bwd_plain_bf16(q, k, v, x_mask, emb_rel_k, emb_rel_v, g,
                                    m, l, delta, window_size: int,
                                    dropout_p: float = 0.0, dropout_seed=None,
                                    dropout_salt=None):
    """The plain version of B5 and B6 on bf16 operands (module note) ->
    (dq, dk, dv, dek, dev), the first three bf16, the tables' in their
    dtype. m, l: the forward's row statistics; delta: rowsum(g * out) in
    float32, each [b, h, t] (what the kernels take)."""
    w = int(window_size)
    dt, tdt = q.dtype, emb_rel_k.dtype
    qf, kf, vf, ekf, evf, gf = (a.float() for a in
                                (q, k, v, emb_rel_k, emb_rel_v, g))
    s = banded_scores_plain(qf, kf, x_mask.float(), ekf, w)
    p = torch.exp(s - m[..., None]) / l[..., None]
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    dp = dp + band_to_abs(torch.einsum("bhtd,cd->bhtc", gf, evf), w)
    pd = p
    if dropout_p:
        scale = hash_dropout_probs(torch.ones_like(p), dropout_p, dropout_seed,
                                   dropout_salt)
        pd, dp = p * scale, dp * scale
    key = (x_mask != 0)[:, None, None, :]
    ds = torch.where(key, p * (dp - delta[..., None]), 0.0)
    ds_r, pd_r = ds.to(dt).float(), pd.to(dt).float()  # the products' operands
    ds_band = abs_to_band(ds, w)
    dq = torch.matmul(ds_r, kf) + torch.einsum("bhtc,cd->bhtd", ds_band, ekf)
    dk = torch.matmul(ds_r.transpose(-1, -2), qf)
    dv = torch.matmul(pd_r.transpose(-1, -2), gf)
    dek = torch.einsum("bhtc,bhtd->cd", ds_band, qf)
    dev = torch.einsum("bhtc,bhtd->cd", abs_to_band(pd, w), gf)
    return dq.to(dt), dk.to(dt), dv.to(dt), dek.to(tdt), dev.to(tdt)


def _check_shapes(q, k, v, x_mask, emb_rel_k, emb_rel_v, w: int) -> None:
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    if x_mask.shape != (b, t):
        raise ValueError(f"x_mask {tuple(x_mask.shape)} is not {(b, t)}")
    if emb_rel_k.shape != (2 * w + 1, d) or emb_rel_v.shape != (2 * w + 1, d):
        raise ValueError("emb_rel_k/v must be [2w+1, d]")


def _check_bwd_shapes(q, g, m, l, delta) -> None:
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} is not {tuple(q.shape)}")
    if any(x.shape != q.shape[:3] for x in (m, l, delta)):
        raise ValueError(f"m, l, delta must be {tuple(q.shape[:3])}")


def banded_kernels_support(b: int, h: int, t: int, d: int, w: int,
                           dtype: torch.dtype = torch.float32) -> bool:
    """Whether the tensor-core kernels (csrc/banded_attn.cu,
    banded_attn_bwd.cu) take inputs of this shape and dtype: float32 or
    bfloat16 (every entry point), at d <= 128, w <= 4, t >= 2w, b*h <=
    65535; the wrappers send every other shape they accept to
    csrc/banded_attn_wide.cu."""
    return (dtype in KERNEL_DTYPES and 1 <= d <= MAX_HEAD_DIM
            and 0 <= w <= MAX_WINDOW and t >= 2 * w and b * h <= 65535)


def _check_kernel_inputs(tensors, w: int) -> bool:
    """Raise on what no kernel takes (CUDA tensors only; tensors: q, k, v,
    x_mask, emb_rel_k, emb_rel_v, and for B5 and B6 g, m, l, delta): a
    device other than one card, a dtype outside KERNEL_DTYPES, operands
    (q, k, v, the tables, g) of mixed dtypes, a mask in neither their dtype
    nor float32, statistics m, l, delta other than float32, a shape out of
    every kernel's range. True where the tensor-core kernels take the
    shape, False where the wide ones do."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must lie on one device")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernels take {' or '.join(map(str, KERNEL_DTYPES))} "
                         f"inputs, not {q.dtype}")
    if any(x.dtype != q.dtype for i, x in enumerate(tensors[:7]) if i != 3):
        raise ValueError("the kernel takes operands of one dtype: "
                         f"{[x.dtype for x in tensors]}")
    if tensors[3].dtype not in (q.dtype, torch.float32):
        raise ValueError(f"the mask is {tensors[3].dtype}")
    if any(x.dtype != torch.float32 for x in tensors[7:]):
        raise ValueError("the row statistics m, l and delta are float32")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("the kernel takes contiguous inputs")
    b, h, t, d = q.shape
    if not (1 <= d <= WIDE_MAX_HEAD_DIM and 0 <= w and 1 <= t and t >= 2 * w
            and b * h < 2**31):
        raise ValueError(f"unsupported shape b={b} h={h} t={t} d={d} w={w}")
    return banded_kernels_support(b, h, t, d, w, q.dtype)


def _stream(x: torch.Tensor):
    return x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream


def _i32(x: int) -> int:
    """x modulo 2**32 as a signed int32 (the kernels read it as uint32)."""
    return ((int(x) + 2**31) % 2**32) - 2**31


def _dropout_args(p_drop: float, seed, salt, h: int) -> tuple:
    """(dropping, threshold, seed, salt_base, salt_stride, 1 / (1 - p)) as
    the kernels take them."""
    if not p_drop:
        return 0, 0, 0, 0, 0, ctypes.c_float(1.0)
    if seed is None:
        raise ValueError("dropout in the kernels needs a dropout_seed")
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"dropout_seed {seed} is not an int32")
    base, stride = salt_args(salt, h)
    return (1, drop_threshold(p_drop), seed, _i32(base), _i32(stride),
            ctypes.c_float(1.0 / (1.0 - p_drop)))


def banded_attention_fwd_train(q, k, v, x_mask, emb_rel_k, emb_rel_v,
                               window_size: int, dropout_p: float = 0.0,
                               dropout_seed=None, dropout_salt=None):
    """K1 in train mode -> (out [b, h, t, d], m [b, h, t], l [b, h, t]):
    the output with the hash dropout applied (in the operands' dtype), and
    the float32 softmax row max and sum that B5 and B6 rebuild the
    probabilities from."""
    w = int(window_size)
    tensors = (q, k, v, x_mask, emb_rel_k, emb_rel_v)
    _check_shapes(*tensors, w)
    if q.device.type == "cpu":
        out = banded_attention_plain(*tensors, w, dropout_p, dropout_seed,
                                     dropout_salt)
        return (out, *banded_attention_stats_plain(q, k, x_mask, emb_rel_k, w))
    tensor_cores = _check_kernel_inputs(tensors, w)
    if q.dtype == torch.bfloat16:
        tensors = (q, k, v, x_mask.to(q.dtype), emb_rel_k, emb_rel_v)
        return (banded_attention_fwd_train_bf16 if tensor_cores
                else wide_fwd_train_bf16)(tensors, w, dropout_p, dropout_seed,
                                                      dropout_salt)
    if not tensor_cores:
        return wide_fwd_train(tensors, w, dropout_p, dropout_seed, dropout_salt)
    out, m, l = _fwd_train_launch("banded_attn_fwd_train", tensors, w, dropout_p,
                                  dropout_seed, dropout_salt)
    banded_attention_fwd_train.launches += 1
    return out, m, l


def _fwd_train_launch(entry: str, tensors, w: int, dropout_p: float, dropout_seed,
                      dropout_salt=None, source: str = "banded_attn.cu"):
    """One train-mode forward launch of `entry` on checked inputs ->
    (out in the operands' dtype, m, l float32)."""
    q = tensors[0]
    b, h, t, d = q.shape
    drop = _dropout_args(dropout_p, dropout_seed, dropout_salt, h)
    out = torch.empty_like(q)
    m = torch.empty((b, h, t), device=q.device)
    l = torch.empty_like(m)
    err = getattr(_build.library(source), entry)(
        *(x.data_ptr() for x in (*tensors, out, m, l)),
        b, h, t, d, w, *drop, *_stream(q))
    _build.check(err, entry)
    return out, m, l


def _bwd_args(q, k, v, x_mask, emb_rel_k, emb_rel_v, g, m, l, delta, w):
    """The backward wrappers' checked inputs; bf16 operands take the mask
    in their dtype."""
    tensors = (q, k, v, x_mask, emb_rel_k, emb_rel_v, g, m, l, delta)
    _check_shapes(*tensors[:6], w)
    _check_bwd_shapes(q, g, m, l, delta)
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        tensors = (*tensors[:3], x_mask.to(q.dtype), *tensors[4:])
    return tensors


def _bwd_plain(tensors, w: int, dropout_p: float, dropout_seed,
               dropout_salt=None):
    """B5's and B6's plain versions on the CPU -> (dq, dk, dv, dek, dev):
    the autograd of the plain forward in float32, the explicit bf16
    backward on bf16 operands."""
    if tensors[0].dtype == torch.float32:
        return banded_attention_bwd_plain(*tensors[:7], w, dropout_p, dropout_seed,
                                          dropout_salt)
    return banded_attention_bwd_plain_bf16(*tensors, w, dropout_p, dropout_seed,
                                           dropout_salt)


def banded_attention_bwd_q(q, k, v, x_mask, emb_rel_k, emb_rel_v, g, m, l,
                           delta, window_size: int, dropout_p: float = 0.0,
                           dropout_seed=None, dropout_salt=None):
    """B5 -> (dq [b, h, t, d], dek [2w+1, d], dev [2w+1, d]) for the output
    gradient g, from K1's row statistics m, l and delta = rowsum(g * out)
    [b, h, t] (all three float32)."""
    w = int(window_size)
    tensors = _bwd_args(q, k, v, x_mask, emb_rel_k, emb_rel_v, g, m, l, delta, w)
    if q.device.type == "cpu":
        dq, _, _, dek, dev = _bwd_plain(tensors, w, dropout_p, dropout_seed,
                                        dropout_salt)
        return dq, dek, dev
    tensor_cores = _check_kernel_inputs(tensors, w)
    if q.dtype == torch.bfloat16:
        return (banded_attention_bwd_q_bf16 if tensor_cores
                else wide_bwd_q_bf16)(tensors, w, dropout_p, dropout_seed,
                                                  dropout_salt)
    if not tensor_cores:
        return wide_bwd_q(tensors, w, dropout_p, dropout_seed, dropout_salt)
    out = _bwd_q_launch("banded_attn_bwd_q", tensors, w, dropout_p, dropout_seed,
                        dropout_salt)
    banded_attention_bwd_q.launches += 1
    return out


def _bwd_q_launch(entry: str, tensors, w: int, dropout_p: float, dropout_seed,
                  dropout_salt=None):
    """One launch of B5 (`entry` of csrc/banded_attn_bwd.cu, its partials
    reduced in block order) on checked inputs -> (dq, dek, dev)."""
    q = tensors[0]
    b, h, t, d = q.shape
    drop = _dropout_args(dropout_p, dropout_seed, dropout_salt, h)
    dq = torch.empty_like(q)
    dek, dev = torch.empty_like(tensors[4]), torch.empty_like(tensors[5])
    lib = _build.library("banded_attn_bwd.cu")
    n_blocks = lib.banded_attn_bwd_q_blocks(b, h, t)
    partials = torch.empty((n_blocks, 2, 2 * w + 1, d), device=q.device)
    err = getattr(lib, entry)(
        *(x.data_ptr() for x in (*tensors, dq, partials, dek, dev)),
        b, h, t, d, w, *drop, *_stream(q))
    _build.check(err, entry)
    return dq, dek, dev


def banded_attention_bwd_k(q, k, v, x_mask, emb_rel_k, emb_rel_v, g, m, l,
                           delta, window_size: int, dropout_p: float = 0.0,
                           dropout_seed=None, dropout_salt=None):
    """B6 -> (dk, dv), each [b, h, t, d]; arguments as B5's."""
    w = int(window_size)
    tensors = _bwd_args(q, k, v, x_mask, emb_rel_k, emb_rel_v, g, m, l, delta, w)
    if q.device.type == "cpu":
        _, dk, dv, _, _ = _bwd_plain(tensors, w, dropout_p, dropout_seed,
                                     dropout_salt)
        return dk, dv
    tensor_cores = _check_kernel_inputs(tensors, w)
    if q.dtype == torch.bfloat16:
        return (banded_attention_bwd_k_bf16 if tensor_cores
                else wide_bwd_k_bf16)(tensors, w, dropout_p, dropout_seed,
                                                  dropout_salt)
    if not tensor_cores:
        return wide_bwd_k(tensors, w, dropout_p, dropout_seed, dropout_salt)
    out = _bwd_k_launch("banded_attn_bwd_k", tensors, w, dropout_p, dropout_seed,
                        dropout_salt)
    banded_attention_bwd_k.launches += 1
    return out


def _bwd_k_launch(entry: str, tensors, w: int, dropout_p: float, dropout_seed,
                  dropout_salt=None, source: str = "banded_attn_bwd.cu"):
    """One launch of B6 (`entry` of `source`) on checked inputs -> (dk, dv)."""
    q = tensors[0]
    drop = _dropout_args(dropout_p, dropout_seed, dropout_salt, q.shape[1])
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    err = getattr(_build.library(source), entry)(
        *(x.data_ptr() for x in (*tensors, dk, dv)), *q.shape, w, *drop, *_stream(q))
    _build.check(err, entry)
    return dk, dv


def banded_attention_fwd_train_bf16(tensors, w: int, dropout_p: float, dropout_seed,
                                    dropout_salt=None):
    """K1's train mode on bf16 operands (checked; the mask in their dtype)
    -> (out bf16, m, l float32)."""
    out = _fwd_train_launch("banded_attn_fwd_train_bf16", tensors, w, dropout_p,
                            dropout_seed, dropout_salt)
    banded_attention_fwd_train_bf16.launches += 1
    return out


def banded_attention_bwd_q_bf16(tensors, w: int, dropout_p: float, dropout_seed,
                                dropout_salt=None):
    """B5 on bf16 operands (checked, as `banded_attention_bwd_q`'s) -> (dq
    bf16, dek and dev in the tables' dtype: fp32 partials, reduced in block
    order, then rounded)."""
    out = _bwd_q_launch("banded_attn_bwd_q_bf16", tensors, w, dropout_p, dropout_seed,
                        dropout_salt)
    banded_attention_bwd_q_bf16.launches += 1
    return out


def banded_attention_bwd_k_bf16(tensors, w: int, dropout_p: float, dropout_seed,
                                dropout_salt=None):
    """B6 on bf16 operands (checked) -> (dk, dv), bf16."""
    out = _bwd_k_launch("banded_attn_bwd_k_bf16", tensors, w, dropout_p, dropout_seed,
                        dropout_salt)
    banded_attention_bwd_k_bf16.launches += 1
    return out


def wide_fwd(tensors, w: int) -> torch.Tensor:
    """The inference launch of csrc/banded_attn_wide.cu on checked inputs
    (q, k, v, x_mask, emb_rel_k, emb_rel_v) -> out."""
    q = tensors[0]
    out = torch.empty_like(q)
    err = _build.library("banded_attn_wide.cu").banded_attn_wide_fwd(
        *(x.data_ptr() for x in (*tensors, out)), *q.shape, w, *_stream(q))
    _build.check(err, "banded_attn_wide_fwd")
    wide_fwd.launches += 1
    return out


def banded_attention_fwd_bf16(tensors, w: int) -> torch.Tensor:
    """K1's bf16 mode (the inference launch of csrc/banded_attn.cu on
    bf16 operands) on checked inputs (q, k, v, x_mask, emb_rel_k,
    emb_rel_v, the mask in the operands' dtype) -> out, bf16."""
    q = tensors[0]
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    err = _build.library("banded_attn.cu").banded_attn_fwd_bf16(
        *(x.data_ptr() for x in (*tensors, out)), b, h, t, d, w, *_stream(q))
    _build.check(err, "banded_attn_fwd_bf16")
    banded_attention_fwd_bf16.launches += 1
    return out


def wide_fwd_bf16(tensors, w: int) -> torch.Tensor:
    """The inference launch of csrc/banded_attn_wide.cu on bf16 operands
    (checked, as `banded_attention_fwd_bf16`'s) -> out, bf16."""
    q = tensors[0]
    out = torch.empty_like(q)
    err = _build.library("banded_attn_wide.cu").banded_attn_wide_fwd_bf16(
        *(x.data_ptr() for x in (*tensors, out)), *q.shape, w, *_stream(q))
    _build.check(err, "banded_attn_wide_fwd_bf16")
    wide_fwd_bf16.launches += 1
    return out


def wide_fwd_train(tensors, w: int, dropout_p: float, dropout_seed,
                   dropout_salt=None):
    """The train-mode launch of csrc/banded_attn_wide.cu -> (out, m, l)."""
    out = _fwd_train_launch("banded_attn_wide_fwd_train", tensors, w, dropout_p,
                            dropout_seed, dropout_salt, "banded_attn_wide.cu")
    wide_fwd_train.launches += 1
    return out


def wide_fwd_train_bf16(tensors, w: int, dropout_p: float, dropout_seed,
                        dropout_salt=None):
    """The train-mode launch of csrc/banded_attn_wide.cu on bf16 operands
    -> (out bf16, m, l float32)."""
    out = _fwd_train_launch("banded_attn_wide_fwd_train_bf16", tensors, w,
                            dropout_p, dropout_seed, dropout_salt,
                            "banded_attn_wide.cu")
    wide_fwd_train_bf16.launches += 1
    return out


def _wide_bwd_q_launch(entry: str, tensors, w: int, dropout_p: float, dropout_seed,
                       dropout_salt=None):
    """One launch of the wide B5 (`entry`) on checked inputs -> (dq, dek,
    dev); its band scratch float32."""
    q = tensors[0]
    b, h, t, _ = q.shape
    drop = _dropout_args(dropout_p, dropout_seed, dropout_salt, h)
    dq = torch.empty_like(q)
    dek, dev = torch.empty_like(tensors[4]), torch.empty_like(tensors[5])
    band = torch.empty((2, b * h * t, 2 * w + 1), device=q.device)
    err = getattr(_build.library("banded_attn_wide.cu"), entry)(
        *(x.data_ptr() for x in (*tensors, dq, band[0], band[1], dek, dev)),
        *q.shape, w, *drop, *_stream(q))
    _build.check(err, entry)
    return dq, dek, dev


def wide_bwd_q(tensors, w: int, dropout_p: float, dropout_seed,
               dropout_salt=None):
    """B5 of csrc/banded_attn_wide.cu on checked inputs (q, k, v, x_mask,
    emb_rel_k, emb_rel_v, g, m, l, delta) -> (dq, dek, dev)."""
    out = _wide_bwd_q_launch("banded_attn_wide_bwd_q", tensors, w, dropout_p,
                             dropout_seed, dropout_salt)
    wide_bwd_q.launches += 1
    return out


def wide_bwd_q_bf16(tensors, w: int, dropout_p: float, dropout_seed,
                    dropout_salt=None):
    """B5 of csrc/banded_attn_wide.cu on bf16 operands -> (dq, dek, dev) in
    the operands' and the tables' dtype."""
    out = _wide_bwd_q_launch("banded_attn_wide_bwd_q_bf16", tensors, w, dropout_p,
                             dropout_seed, dropout_salt)
    wide_bwd_q_bf16.launches += 1
    return out


def wide_bwd_k(tensors, w: int, dropout_p: float, dropout_seed,
               dropout_salt=None):
    """B6 of csrc/banded_attn_wide.cu on checked inputs (as `wide_bwd_q`'s)
    -> (dk, dv)."""
    out = _bwd_k_launch("banded_attn_wide_bwd_k", tensors, w, dropout_p,
                        dropout_seed, dropout_salt, "banded_attn_wide.cu")
    wide_bwd_k.launches += 1
    return out


def wide_bwd_k_bf16(tensors, w: int, dropout_p: float, dropout_seed,
                    dropout_salt=None):
    """B6 of csrc/banded_attn_wide.cu on bf16 operands -> (dk, dv), bf16."""
    out = _bwd_k_launch("banded_attn_wide_bwd_k_bf16", tensors, w, dropout_p,
                        dropout_seed, dropout_salt, "banded_attn_wide.cu")
    wide_bwd_k_bf16.launches += 1
    return out


class BandedAttentionFn(torch.autograd.Function):
    """The attention's training direction on the kernels: K1 in train mode
    forward, B5 and B6 backward (the JAX package's `_banded_core` custom
    VJP, attention_pallas.py:355-443), in float32 or on bf16 operands; on
    the CPU the same wrappers run the plain versions. Gradients flow to q,
    k, v and the two relative tables; none to the mask, the seed or the
    salt."""

    @staticmethod
    def forward(ctx, q, k, v, x_mask, emb_rel_k, emb_rel_v, window_size,
                dropout_p, dropout_seed, dropout_salt=None):
        out, m, l = banded_attention_fwd_train(
            q, k, v, x_mask, emb_rel_k, emb_rel_v, window_size, dropout_p,
            dropout_seed, dropout_salt)
        ctx.save_for_backward(q, k, v, x_mask, emb_rel_k, emb_rel_v, m, l, out)
        ctx.args = (window_size, dropout_p, dropout_seed, dropout_salt)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, x_mask, ek, ev, m, l, out = ctx.saved_tensors
        g = g.contiguous()
        # D_i = g_i . out_i: the softmax backward's rowsum(dp * p), with
        # the band term and the dropout folded in, summed in float32 from
        # the operands' dtype (attention_pallas.py:396-401)
        delta = (g.float() * out.float()).sum(dim=-1)
        args = (q, k, v, x_mask, ek, ev, g, m, l, delta, *ctx.args)
        dq, dek, dev = banded_attention_bwd_q(*args)
        dk, dv = banded_attention_bwd_k(*args)
        # one entry per input given to apply (the salt may be left out)
        grads = (dq, dk, dv, None, dek, dev, None, None, None, None)
        return grads[:len(ctx.needs_input_grad)]


def banded_rel_self_attention(q, k, v, x_mask, emb_rel_k, emb_rel_v,
                              window_size: int, dropout_p: float = 0.0,
                              dropout_seed=None, dropout_salt=None) -> torch.Tensor:
    """q, k, v: [b, h, t, d] (q pre-scaled by 1/sqrt(d)); x_mask: [b, t] 0/1;
    emb_rel_k/v: [2w+1, d] (one table shared by the heads); dropout on the
    probabilities at rate `dropout_p` from the int32 `dropout_seed`
    (required when dropout_p > 0), batch row b and head h_idx salted
    salt_base + b * salt_stride + h_idx for `dropout_salt` = (salt_base,
    salt_stride) (None: (0, h)). Returns [b, h, t, d]; rows where x_mask
    is 0 are unspecified. Differentiable with respect to q, k, v and the
    tables.

    Without a gradient or dropout the call goes through one of the four
    `bv2` forward ops (`ops/library.py`), chosen by dtype and by
    `banded_kernels_support`: on the card each launches its kernel, on the
    CPU each runs the plain version. Inside `plain_functions()` the plain
    version runs directly on CPU tensors, and other tensors raise."""
    w = int(window_size)
    tensors = (q, k, v, x_mask, emb_rel_k, emb_rel_v)
    _check_shapes(*tensors, w)
    if dropout_p and dropout_seed is None:
        raise ValueError("dropout_p > 0 needs a dropout_seed: the hash "
                         "dropout of the kernels (and of their plain version)")
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v, emb_rel_k, emb_rel_v))
    if q.device.type == "cpu":
        if grad and q.dtype == torch.bfloat16:  # the explicit bf16 backward
            return BandedAttentionFn.apply(*tensors, w, float(dropout_p),
                                           dropout_seed, dropout_salt)
        if grad or dropout_p or library.plain_only():
            return banded_attention_plain(*tensors, w, dropout_p, dropout_seed,
                                          dropout_salt)
        return _forward_op(q.dtype, banded_kernels_support(*q.shape, w, q.dtype))(
            *tensors, w)
    library.refuse_plain(q.device)
    if grad or dropout_p:
        return BandedAttentionFn.apply(*tensors, w, float(dropout_p),
                                       dropout_seed, dropout_salt)
    tensor_cores = _check_kernel_inputs(tensors, w)
    if q.dtype == torch.bfloat16:
        tensors = (q, k, v, x_mask.to(q.dtype), emb_rel_k, emb_rel_v)
    return _forward_op(q.dtype, tensor_cores)(*tensors, w)


def banded_attention_fwd(tensors, w: int) -> torch.Tensor:
    """K1's inference launch (csrc/banded_attn.cu) on checked float32
    inputs (q, k, v, x_mask, emb_rel_k, emb_rel_v) -> out, counted in
    `banded_rel_self_attention.launches`."""
    q = tensors[0]
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    err = _build.library("banded_attn.cu").banded_attn_fwd(
        *(x.data_ptr() for x in (*tensors, out)), b, h, t, d, w, *_stream(q))
    _build.check(err, "banded_attn_fwd")
    banded_rel_self_attention.launches += 1
    return out


_FWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor x_mask, Tensor emb_rel_k, "
               "Tensor emb_rel_v, int window_size) -> Tensor")


def _define_forward(name: str, launch):
    """bv2::<name>: the CPU implementation the plain version, the CUDA one
    `launch` on the inputs the wrapper checked."""
    return library.define(
        name, _FWD_SCHEMA,
        lambda q, k, v, x_mask, ek, ev, window_size: banded_attention_plain(
            q, k, v, x_mask, ek, ev, window_size),
        lambda q, k, v, x_mask, ek, ev, window_size: launch(
            (q, k, v, x_mask, ek, ev), window_size),
        lambda q, *_: torch.empty_like(q))


# the inference entry points: torch.ops.bv2.banded_attn_fwd (K1 fp32),
# banded_attn_fwd_bf16 (K1 bf16), banded_attn_wide_fwd and
# banded_attn_wide_fwd_bf16 (csrc/banded_attn_wide.cu)
FORWARD_OPS = {
    (torch.float32, True): _define_forward("banded_attn_fwd", banded_attention_fwd),
    (torch.bfloat16, True): _define_forward("banded_attn_fwd_bf16",
                                            banded_attention_fwd_bf16),
    (torch.float32, False): _define_forward("banded_attn_wide_fwd", wide_fwd),
    (torch.bfloat16, False): _define_forward("banded_attn_wide_fwd_bf16",
                                             wide_fwd_bf16),
}


def _forward_op(dtype: torch.dtype, tensor_cores: bool):
    """The forward op of a dtype (bf16, or float32 for any other on the
    CPU) and of the tensor-core kernels or the wide ones."""
    return FORWARD_OPS[(torch.bfloat16 if dtype == torch.bfloat16 else torch.float32,
                        tensor_cores)]


banded_rel_self_attention.launches = 0
banded_attention_fwd_train.launches = 0
banded_attention_bwd_q.launches = 0
banded_attention_bwd_k.launches = 0
banded_attention_fwd_bf16.launches = 0
banded_attention_fwd_train_bf16.launches = 0
banded_attention_bwd_q_bf16.launches = 0
banded_attention_bwd_k_bf16.launches = 0
wide_fwd.launches = 0
wide_fwd_bf16.launches = 0
wide_fwd_train.launches = 0
wide_fwd_train_bf16.launches = 0
wide_bwd_q.launches = 0
wide_bwd_q_bf16.launches = 0
wide_bwd_k.launches = 0
wide_bwd_k_bf16.launches = 0
