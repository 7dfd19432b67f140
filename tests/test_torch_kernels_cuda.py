"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version, on the card. Every test here is marked `cuda` and skips inside the
test where torch.cuda.is_available() is False.

On a machine with a card (the JAX package need not be installed there, so
skip the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

TF32 is off for matmuls and cuDNN convolutions, so the plain versions run
in full fp32. K1, K2, B5 and B6 do their products on the tensor cores in
TF32, but split each operand into two TF32 parts (v = hi + lo, hi rounded to TF32,
lo within 2**-21 |v| of v - hi) and sum hi*hi + hi*lo + lo*hi in fp32
(3xTF32): each product is then within ~2**-20 of its fp32 value, the size
of the rounding of the fp32 sums the bounds are set for (outputs of
O(1) from sums of up to 11*C or t terms), so the fp32 bounds stay. Bounds: K1 1e-4 absolute (outputs O(1); fp32 sums of up to t
terms in another order); K1's train mode, B5 and B6 against the plain
version's autograd, the row statistics and each gradient within 1e-4 of
its max (fp32 sums of up to t terms, and of b*h*t terms for the tables,
whose per-block partials add in block order); K2 2e-4 absolute (18 chained convs of up to
11*C-term fp32 sums, in another order than cuDNN's), K3 exact (one fp32 add
and one max per cell: the 0/1 path equals the plain version's bit for bit,
for the wrapper's plan and for every K template, warp count and place of
the move-left bits the tests give it). The kernels of banded_attn_wide.cu
(outside the tensor-core kernels' range: d > 128, w > 4, b*h > 65535) in
fp32 on the CUDA cores, with K1's and B5/B6's bounds; the attention module
through them within 1e-5 of the CPU module (one fp32 attention, TF32 off)
and its parameter gradients within 1e-4 of the largest gradient entry.

The bf16 modes (bf16 operands, fp32 accumulators and softmax: K1's
inference launch, the wide forward and K2) against their plain bf16
versions, which round where the TPU kernels round: within 4 bf16 ulps of
the largest reference entry (bf16 keeps 8 significant bits; the kernels
round P relative to the running row max and sum in another order, K2
chains 18 convs whose roundings a reordered sum can flip, each flip an ulp
of an intermediate). The bf16 engine at the V2.3 widths card against CPU
within 1e-2 (the two bf16 paths, kernels and cuDNN against the plain
versions and the CPU's convs, round at different points; the bf16 waves
lie ~1e-3 from the fp32 ones at these widths, PERF.md §6).
"""

import math

import pytest
import torch

from bert_vits2_tpu_torch.models.generator import ResBlock1
from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
from bert_vits2_tpu_torch.ops import align
from bert_vits2_tpu_torch.ops.align import (
    K_CHOICES,
    mas_plan,
    maximum_path,
    maximum_path_plain,
    plan_for_k,
)
from bert_vits2_tpu_torch.ops.attention import (
    WIDE_MAX_HEAD_DIM,
    banded_attention_bwd_k,
    banded_attention_bwd_k_bf16,
    banded_attention_bwd_plain,
    banded_attention_bwd_plain_bf16,
    banded_attention_bwd_q,
    banded_attention_bwd_q_bf16,
    banded_attention_fwd_train,
    banded_attention_fwd_train_bf16,
    banded_attention_plain,
    banded_attention_stats_plain,
    banded_kernels_support,
    banded_rel_self_attention,
    wide_bwd_k,
    wide_bwd_k_bf16,
    wide_bwd_q,
    wide_bwd_q_bf16,
    banded_attention_fwd_bf16,
    wide_fwd,
    wide_fwd_bf16,
    wide_fwd_train,
    wide_fwd_train_bf16,
)
from bert_vits2_tpu_torch.ops.mrf import (
    fused_mrf,
    fused_mrf_plain,
    mrf_fwd_bf16,
    prepare_mrf_weights,
)

TC_COUNTERS = (banded_rel_self_attention, banded_attention_fwd_train,
               banded_attention_bwd_q, banded_attention_bwd_k)
WIDE_COUNTERS = (wide_fwd, wide_fwd_train, wide_bwd_q, wide_bwd_k)
KS = (3, 7, 11)


def _launchers(b, h, t, d, w):
    """The launchers (inference, train forward, B5, B6) whose counts the
    wrappers move at this shape."""
    return TC_COUNTERS if banded_kernels_support(b, h, t, d, w) else WIDE_COUNTERS
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
BF16_ULPS = 4


def _bf16_bound(want: torch.Tensor) -> float:
    """BF16_ULPS bf16 ulps of the largest entry of `want`."""
    import math
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _lens_mask(lens, t, dev):
    return (torch.arange(t, device=dev)[None, :]
            < torch.as_tensor(lens, device=dev)[:, None]).float()


ATTN_CASES = [
    (2, 2, 200, 96, [200, 131]),   # several key tiles, ragged last tile
    (3, 2, 13, 4, [13, 8, 1]),     # t < one tile, tiny head width
    (1, 1, 8, 128, [8]),           # t == 2w, widest head
    (8, 2, 768, 96, None),         # the flow's shape at a 768-frame cap
    (2, 2, 9, 96, [9, 5]),         # t = 2w + 1
    (2, 2, 17, 96, [17, 1]),       # one row past a warp's 16 rows
    (2, 2, 33, 36, [33, 32]),      # one key past a 32-key tile; d % 8 != 0
    (3, 2, 97, 96, [97, 64, 2]),   # a 64-row query block and 33 rows
    (8, 2, 129, 96, None),         # one row past two 64-row query blocks
    (2, 2, 40, 10, [40, 23]),      # d % 4 != 0: rows staged element-wise
    (2, 1, 200, 160, [200, 131]),  # wide kernel: a head of 160 channels
    (3, 1, 257, 300, [257, 256, 3]),  # wide: d > 2 * 128, one past two tiles
    (1, 65536, 8, 2, None),        # wide: b * h above the grid's 65535
]


def _attention_inputs(card, b, h, t, d, lens, dtype=torch.float32):
    g = torch.Generator(device=card).manual_seed(t)
    lens = lens or [t - 37 * i for i in range(b)]
    q, k, v = (torch.randn(b, h, t, d, device=card, generator=g)
               for _ in range(3))
    q = q / d ** 0.5
    ek, ev = (torch.randn(9, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    return (*(a.to(dtype) for a in (q, k, v)), _lens_mask(lens, t, card),
            *(a.to(dtype) for a in (ek, ev)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,lens", ATTN_CASES)
def test_banded_attention_kernel(card, b, h, t, d, lens):
    g = torch.Generator(device=card).manual_seed(t)
    lens = lens or [t - 37 * i for i in range(b)]
    q, k, v = (torch.randn(b, h, t, d, device=card, generator=g)
               for _ in range(3))
    q = q / d ** 0.5
    ek, ev = (torch.randn(9, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    m = _lens_mask(lens, t, card)
    launcher = _launchers(b, h, t, d, 4)[0]
    before = launcher.launches
    with torch.inference_mode():
        got = banded_rel_self_attention(q, k, v, m, ek, ev, 4)
        want = banded_attention_plain(q, k, v, m, ek, ev, 4)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    valid = m.bool()[:, None, :, None].expand_as(got)
    err = (got - want).abs()[valid].max().item()
    assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,lens", ATTN_CASES)
def test_banded_attention_kernel_bf16(card, b, h, t, d, lens):
    """K1's bf16 mode (the wide kernel's outside its range) on bf16
    operands and an fp32 mask, at the fp32 cases' shapes: bf16 out within
    BF16_ULPS of the plain bf16 version on valid rows, one launch of the
    bf16 launcher and none of the fp32 ones."""
    q, k, v, m, ek, ev = _attention_inputs(card, b, h, t, d, lens, torch.bfloat16)
    launcher = (banded_attention_fwd_bf16 if banded_kernels_support(
        b, h, t, d, 4, torch.bfloat16) else wide_fwd_bf16)
    counters = (launcher, banded_rel_self_attention, wide_fwd)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        got = banded_rel_self_attention(q, k, v, m, ek, ev, 4)
        want = banded_attention_plain(q, k, v, m, ek, ev, 4)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 0, 0]
    assert got.dtype == want.dtype == torch.bfloat16
    valid = m.bool()[:, None, :, None].expand_as(got)
    err = (got.float() - want.float()).abs()[valid].max().item()
    assert err <= _bf16_bound(want.float()[valid]), err


BWD_CASES = [
    (16, 2, 512, 96, None, 4),          # the flow's shape in the training step
    (16, 2, 128, 96, None, 4),          # enc_p's
    (2, 2, 1001, 96, [1001, 640], 4),   # ragged, odd, several tiles
    (2, 2, 33, 96, [33, 17], 4),        # one past a 32-row/32-key tile
    (3, 2, 9, 20, [9, 9, 3], 4),        # t = 2w + 1, d % 8 != 0
    (2, 2, 65, 96, [65, 40], 4),        # one past a 64-row/64-key block
    (2, 2, 17, 128, [17, 9], 4),        # d = 128: 16-wide tiles; one past one
    (2, 2, 300, 128, [300, 201], 4),    # d = 128 (the shared-memory limit)
    (2, 2, 130, 64, [130, 77], 4),      # d = 64
    (2, 2, 97, 96, [97, 50], 1),        # w = 1
    (2, 2, 70, 96, [70, 31], 0),        # w = 0: no band terms
    (2, 1, 200, 160, [200, 131], 4),    # wide kernels: a head of 160 channels
    (3, 1, 257, 300, [257, 256, 3], 4),  # wide: d > 2 * 128; one past two tiles
    (2, 2, 150, 16, [150, 77], 5),      # wide: w = 5
    (2, 2, 40, 8, [40, 21], 9),         # wide: w = 9, a band of 19
    (2, 1, 8, 160, [8, 5], 4),          # wide: t == 2w
    (1, 65536, 8, 2, None, 4),          # wide: b * h above the grid's 65535
]


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("b,h,t,d,lens,w", BWD_CASES)
def test_banded_attention_backward_kernels(card, b, h, t, d, lens, w, p_drop):
    """K1 in train mode (out, m, l), B5 (dq, dek, dev) and B6 (dk, dv), in
    the variant the shape takes, against the plain version's autograd,
    valid rows, one dropout seed."""
    g = torch.Generator(device=card).manual_seed(t + b)
    lens = lens or [t - (t // 16) * i for i in range(b)]
    q, k, v = (torch.randn(b, h, t, d, device=card, generator=g)
               for _ in range(3))
    q = q / d ** 0.5
    ek, ev = (torch.randn(2 * w + 1, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    m = _lens_mask(lens, t, card)
    go = torch.randn(b, h, t, d, device=card, generator=g) * m[:, None, :, None]
    launchers = _launchers(b, h, t, d, w)[1:]
    counts = [fn.launches for fn in launchers]
    seed = -987654321
    out, mr, lr = banded_attention_fwd_train(q, k, v, m, ek, ev, w, p_drop, seed)
    args = (q, k, v, m, ek, ev, go, mr, lr, (go * out).sum(-1), w, p_drop, seed)
    dq, dek, dev = banded_attention_bwd_q(*args)
    dk, dv = banded_attention_bwd_k(*args)
    torch.cuda.synchronize()
    assert [fn.launches for fn in launchers] == [c + 1 for c in counts]
    valid = m.bool()[:, None, :].expand(b, h, t)
    want_out = banded_attention_plain(q, k, v, m, ek, ev, w, p_drop, seed)
    assert (out - want_out)[valid].abs().max().item() <= 1e-4
    want = (*banded_attention_stats_plain(q, k, m, ek, w),
            *banded_attention_bwd_plain(q, k, v, m, ek, ev, go, w, p_drop, seed))
    for name, got, ref in zip(("m", "l", "dq", "dk", "dv", "dek", "dev"),
                              (mr, lr, dq, dk, dv, dek, dev), want):
        if got.dim() > 2:
            got, ref = got[valid], ref[valid]
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("b,h,t,d,lens,w", BWD_CASES)
def test_banded_attention_backward_kernels_bf16(card, b, h, t, d, lens, w, p_drop):
    """K1's train mode, B5 and B6 on bf16 operands (the wide kernels' bf16
    modes outside the tensor-core range), at the fp32 cases' shapes,
    against their plain bf16 versions (the backward's given the kernels' m,
    l and delta): out and the five gradients (bf16) within BF16_ULPS of the
    largest reference entry on valid rows, m and l (fp32) within 1e-4 of
    the largest; one launch of each bf16 launcher and none of the fp32
    ones."""
    g = torch.Generator(device=card).manual_seed(t + b)
    lens = lens or [t - (t // 16) * i for i in range(b)]
    q, k, v = (torch.randn(b, h, t, d, device=card, generator=g)
               for _ in range(3))
    q = q / d ** 0.5
    ek, ev = (torch.randn(2 * w + 1, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    m = _lens_mask(lens, t, card)
    go = torch.randn(b, h, t, d, device=card, generator=g) * m[:, None, :, None]
    q, k, v, ek, ev, go = (a.to(torch.bfloat16) for a in (q, k, v, ek, ev, go))
    bf16 = ((banded_attention_fwd_train_bf16, banded_attention_bwd_q_bf16,
             banded_attention_bwd_k_bf16)
            if banded_kernels_support(b, h, t, d, w, torch.bfloat16)
            else (wide_fwd_train_bf16, wide_bwd_q_bf16, wide_bwd_k_bf16))
    counters = (*bf16, *TC_COUNTERS[1:], *WIDE_COUNTERS[1:])
    before = [c.launches for c in counters]
    seed = -987654321
    out, mr, lr = banded_attention_fwd_train(q, k, v, m, ek, ev, w, p_drop, seed)
    args = (q, k, v, m, ek, ev, go, mr, lr, (go.float() * out.float()).sum(-1), w,
            p_drop, seed)
    dq, dek, dev = banded_attention_bwd_q(*args)
    dk, dv = banded_attention_bwd_k(*args)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1] + [0] * 6
    assert all(x.dtype == torch.bfloat16 for x in (out, dq, dk, dv, dek, dev))
    valid = m.bool()[:, None, :].expand(b, h, t)
    want = (banded_attention_plain(q, k, v, m, ek, ev, w, p_drop, seed),
            *banded_attention_stats_plain(q, k, m, ek, w),
            *banded_attention_bwd_plain_bf16(*args))
    for name, got, ref in zip(("out", "m", "l", "dq", "dk", "dv", "dek", "dev"),
                              (out, mr, lr, dq, dk, dv, dek, dev), want):
        got, ref = got.float(), ref.float()
        if got.dim() > 2:
            got, ref = got[valid], ref[valid]
        err = (got - ref).abs().max().item()
        if name in ("m", "l"):
            assert err <= 1e-4 * ref.abs().max().item(), (name, err)
        else:
            assert err <= _bf16_bound(ref), (name, err)


SALT_CASES = [(4, 2, 200, 96), (4, 1, 200, 160)]  # tensor-core kernels; wide kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d", SALT_CASES)
def test_salted_kernels_give_a_half_the_full_batchs_masks(card, b, h, t, d, dtype):
    """K1's train mode, B5 and B6 (tensor-core or wide, fp32 or bf16) with
    the hash dropout on each half of the batch, salted (row_offset * h, h):
    out, dq, dk and dv bit-equal to the full batch's rows, the tables'
    gradients of the halves summed within 1e-5 (fp32) or 8 bf16 ulps of
    the largest entry (each half rounded once, then the two added); each
    half against its plain version within the
    fp32 tests' bounds (fp32); the explicit default salt (0, h) bit-equal
    to none."""
    w, p_drop, seed = 4, 0.1, 123457
    g = torch.Generator(device=card).manual_seed(t + d)
    q, k, v, go = (torch.randn(b, h, t, d, device=card, generator=g) for _ in range(4))
    q = q / d ** 0.5
    ek, ev = (torch.randn(2 * w + 1, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    m = _lens_mask([t, t - 31, t - 70, t - 5], t, card)
    go = go * m[:, None, :, None]
    q, k, v, ek, ev, go = (a.to(dtype) for a in (q, k, v, ek, ev, go))

    def run(rows, salt):
        qq, kk, vv, mm, gg = (a[rows].contiguous() for a in (q, k, v, m, go))
        out, mr, lr = banded_attention_fwd_train(qq, kk, vv, mm, ek, ev, w, p_drop, seed,
                                                 salt)
        args = (qq, kk, vv, mm, ek, ev, gg, mr, lr,
                (gg.float() * out.float()).sum(-1), w, p_drop, seed, salt)
        return (out, *banded_attention_bwd_q(*args), *banded_attention_bwd_k(*args))

    full = run(slice(0, b), None)
    assert all(torch.equal(x, y) for x, y in zip(full, run(slice(0, b), (0, h))))
    halves = [run(slice(o, o + b // 2), (o * h, h)) for o in (0, b // 2)]
    for i, name in ((0, "out"), (1, "dq"), (4, "dk"), (5, "dv")):
        assert torch.equal(torch.cat([hv[i] for hv in halves]), full[i]), name
    for i, name in ((2, "dek"), (3, "dev")):
        got = (halves[0][i].float() + halves[1][i].float())
        ref = full[i].float()
        bound = (1e-5 * ref.abs().max().item() if dtype == torch.float32
                 else 2 * _bf16_bound(ref))
        assert (got - ref).abs().max().item() <= bound, name
    if dtype == torch.float32:
        o = b // 2
        rows = slice(o, b)
        want = banded_attention_bwd_plain(q[rows], k[rows], v[rows], m[rows], ek, ev,
                                          go[rows], w, p_drop, seed, (o * h, h))
        valid = m[rows].bool()[:, None, :].expand(b - o, h, t)
        for name, got, ref in zip(("dq", "dk", "dv"), (halves[1][1], halves[1][4],
                                                       halves[1][5]), want):
            rel = ((got - ref)[valid].abs().max() / ref[valid].abs().max()).item()
            assert rel <= 1e-4, (name, rel)


HEAD_CASES = [(4, 2, 200, 96), (2, 4, 200, 96), (4, 2, 200, 160)]  # tensor-core; wide


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d", HEAD_CASES)
def test_salted_kernels_give_a_head_half_the_full_calls_masks(card, b, h, t, d, dtype):
    """The model axis: K1's train mode, B5 and B6 (tensor-core or wide,
    fp32 or bf16) with the hash dropout on one half of the heads, salted
    (row_offset * h + head_offset, h), alone and on a half of the rows too:
    out, dq, dk and dv bit-equal to the full call's heads (so every
    dropout mask is the full call's), and the tables' gradients of the two
    head halves summed (the model group's all-reduce) within 1e-5 (fp32)
    or 8 bf16 ulps of the largest entry."""
    w, p_drop, seed = 4, 0.1, 98765
    g = torch.Generator(device=card).manual_seed(t + d + h)
    q, k, v, go = (torch.randn(b, h, t, d, device=card, generator=g) for _ in range(4))
    q = q / d ** 0.5
    ek, ev = (torch.randn(2 * w + 1, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    m = _lens_mask([t, t - 31, t - 70, t - 5][:b], t, card)
    go = go * m[:, None, :, None]
    q, k, v, ek, ev, go = (a.to(dtype) for a in (q, k, v, ek, ev, go))

    def run(rows, heads, salt):
        qq, kk, vv, gg = (a[rows, heads].contiguous() for a in (q, k, v, go))
        mm = m[rows].contiguous()
        out, mr, lr = banded_attention_fwd_train(qq, kk, vv, mm, ek, ev, w, p_drop, seed,
                                                 salt)
        args = (qq, kk, vv, mm, ek, ev, gg, mr, lr,
                (gg.float() * out.float()).sum(-1), w, p_drop, seed, salt)
        return (out, *banded_attention_bwd_q(*args), *banded_attention_bwd_k(*args))

    hl = h // 2
    for r0 in (0, b // 2):  # the whole batch, and the second half of its rows
        rows = slice(r0, b)
        full = run(rows, slice(0, h), (r0 * h, h))
        parts = [run(rows, slice(o, o + hl), (r0 * h + o, h)) for o in (0, hl)]
        for i, name in ((0, "out"), (1, "dq"), (4, "dk"), (5, "dv")):
            assert torch.equal(torch.cat([p[i] for p in parts], dim=1), full[i]), name
        for i, name in ((2, "dek"), (3, "dev")):
            got = parts[0][i].float() + parts[1][i].float()
            ref = full[i].float()
            bound = (1e-5 * ref.abs().max().item() if dtype == torch.float32
                     else 2 * _bf16_bound(ref))
            assert (got - ref).abs().max().item() <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 128, 160])
def test_banded_attention_backward_is_deterministic(card, d):
    """Two B5 launches on the same inputs give bit-equal dq, dek and dev
    (dek, dev: per-block partials added in block order, no atomics; at
    d = 160 the wide kernels' per-row band entries summed in row order),
    and two B6 launches bit-equal dk and dv."""
    b, h, t, w = 4, 2, 333, 4
    g = torch.Generator(device=card).manual_seed(d)
    q, k, v, go = (torch.randn(b, h, t, d, device=card, generator=g)
                   for _ in range(4))
    q = q / d ** 0.5
    ek, ev = (torch.randn(2 * w + 1, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    m = _lens_mask([t, 300, 201, 64], t, card)
    out, mr, lr = banded_attention_fwd_train(q, k, v, m, ek, ev, w, 0.1, 7)
    args = (q, k, v, m, ek, ev, go, mr, lr, (go * out).sum(-1), w, 0.1, 7)
    first_q, second_q = banded_attention_bwd_q(*args), banded_attention_bwd_q(*args)
    first_k, second_k = banded_attention_bwd_k(*args), banded_attention_bwd_k(*args)
    torch.cuda.synchronize()
    for a, b_ in zip((*first_q, *first_k), (*second_q, *second_k)):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,lens,ks,ds", [
    (64, 1000, [1000, 611], KS, DS),
    (32, 3000, [2999, 3000], KS, DS),
    (16, 5000, [5000, 1], KS, DS),
    (8, 70, [70, 33], KS, DS),  # T shorter than one tile
    # C / 8 not dividing the warp count: units with their own weights
    (24, 700, [700, 455], KS, DS),
    (48, 900, [900, 1], KS, DS),
    # the tiny test config's single block, and two blocks of 4 stages
    (8, 333, [333, 200], (3,), ((1, 3),)),
    (16, 1200, [1200, 999], (5, 9), ((1, 2, 4, 8), (1, 3, 1, 3))),
    # T one past a multiple of the sample tile (264 / 648 / 1416 at C = 64 /
    # 32 / 16 and halo 60), lengths of 1
    (64, 793, [793, 1], KS, DS),
    (32, 1297, [1, 1297], KS, DS),
    (16, 2833, [2833, 1], KS, DS),
    # N not 16, 32 or 64: 8, 24 and 48 channels, tile-edge T
    (8, 2921, [2921, 1], KS, DS),
    (24, 905, [1, 905], KS, DS),
    (48, 393, [393, 1], KS, DS),
    # above 64 channels the N tiles run in two passes of the weights
    (72, 500, [500, 311], KS, DS),
])
def test_mrf_kernel(card, c, t, lens, ks, ds):
    torch.manual_seed(c)
    blocks = [ResBlock1(c, k, d) for k, d in zip(ks, ds)]
    with torch.no_grad():
        for blk in blocks:  # unit-gain convs, not the near-identity init
            for conv in (*blk.convs1, *blk.convs2):
                conv.weight_g.fill_(1.0)
                conv.bias.normal_(0.0, 0.1)
    blocks = [blk.to(card) for blk in blocks]
    w = prepare_mrf_weights(blocks)
    g = torch.Generator(device=card).manual_seed(t)
    x = torch.randn(len(lens), c, t, device=card, generator=g)
    m = _lens_mask(lens, t, card)
    before = fused_mrf.launches
    with torch.inference_mode():
        got = fused_mrf(x, m, w)
        want = fused_mrf_plain(x, m, w)
    torch.cuda.synchronize()
    assert fused_mrf.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= 2e-4, err
    assert got[m[:, None, :].expand_as(got) == 0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,lens,ks,ds", [
    (64, 1000, [1000, 611], KS, DS),
    (32, 3000, [2999, 3000], KS, DS),
    (16, 5000, [5000, 1], KS, DS),
    (48, 900, [900, 1], KS, DS),  # C / 16 odd: N tiles 6
    (16, 1200, [1200, 999], (5, 9), ((1, 2, 4, 8), (1, 3, 1, 3))),
    (16, 333, [333, 200], (3,), ((1, 3),)),  # one block: no fp32 scratch sum
    (64, 793, [793, 1], KS, DS),  # T one past a multiple of the sample tile
    (32, 1297, [1, 1297], KS, DS),
    (16, 2833, [2833, 1], KS, DS),
    (80, 500, [500, 311], KS, DS),  # above 64 channels: two passes of N tiles
])
def test_mrf_kernel_bf16(card, c, t, lens, ks, ds):
    """K2's bf16 mode (weights packed in bf16, biases fp32, bf16 x and
    mask) against the plain bf16 version: within BF16_ULPS of it, the
    masked outputs exactly 0, one bf16 launch and no fp32 one."""
    torch.manual_seed(c)
    blocks = [ResBlock1(c, k, d) for k, d in zip(ks, ds)]
    with torch.no_grad():
        for blk in blocks:  # unit-gain convs, not the near-identity init
            for conv in (*blk.convs1, *blk.convs2):
                conv.weight_g.fill_(1.0)
                conv.bias.normal_(0.0, 0.1)
    w = prepare_mrf_weights([blk.to(card) for blk in blocks], torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(t)
    x = torch.randn(len(lens), c, t, device=card, generator=g).bfloat16()
    m = _lens_mask(lens, t, card).bfloat16()
    before = (mrf_fwd_bf16.launches, fused_mrf.launches)
    with torch.inference_mode():
        got = fused_mrf(x, m, w)
        want = fused_mrf_plain(x, m, w)
    torch.cuda.synchronize()
    assert (mrf_fwd_bf16.launches - before[0], fused_mrf.launches - before[1]) == (1, 0)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_bound(want.float()), err
    assert got[m[:, None, :].expand_as(got) == 0].abs().max().item() == 0.0


def _mas_inputs(card, b, t_y, t_x, ties, seed=None):
    g = torch.Generator(device=card).manual_seed(t_y if seed is None else seed)
    neg = torch.randn(b, t_y, t_x, device=card, generator=g)
    if ties:
        neg = torch.round(neg * 2) / 2
    t_ys = torch.randint(max(t_x, t_y // 2), t_y + 1, (b,), device=card, generator=g)
    t_xs = torch.minimum(
        torch.randint(1, t_x + 1, (b,), device=card, generator=g), t_ys)
    t_ys[0], t_xs[0] = t_y, t_x  # one item at full length
    return neg, t_ys, t_xs


def _assert_exact_path(got, neg, t_ys, t_xs):
    t_y = neg.shape[1]
    assert torch.equal(got, maximum_path_plain(neg, t_ys, t_xs))
    assert torch.equal(got.sum(2), (torch.arange(t_y, device=neg.device)[None, :]
                                    < t_ys[:, None]).float())
    assert torch.equal(got.sum((1, 2)), t_ys.float())


def _smem_edge(t_x):
    """The longest t_y whose plan keeps the move-left bits in shared memory."""
    lo, hi = t_x, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if mas_plan(mid, t_x).dec_in_smem else (lo, mid)
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_y,t_x,ties", [
    (16, 512, 128, False),   # the training step's shape, ragged lengths
    (2, 1500, 1100, False),  # a long text: decisions in device memory
    (1, 40, 7, False),       # b = 1
    (3, 33, 33, False),      # t_x == t_y: the path is the diagonal
    (4, 64, 1, False),       # a single token
    (5, 200, 70, True),      # scores on a coarse grid: many exact ties
    (2, 1500, 769, False),   # the Trainer's longest text (2 * 384 + 1)
    (1, 1500, 769, True),    # b = 1, ties, at that width
    (3, 700, 640, True),     # ties across several warps
])
def test_mas_kernel(card, b, t_y, t_x, ties):
    """The wrapper's launch (its plan) against the plain version, bit for
    bit; one launch per call."""
    neg, t_ys, t_xs = _mas_inputs(card, b, t_y, t_x, ties)
    before = maximum_path.launches
    got = maximum_path(neg, t_ys, t_xs)
    torch.cuda.synchronize()
    assert maximum_path.launches == before + 1
    _assert_exact_path(got, neg, t_ys, t_xs)


@pytest.mark.cuda
@pytest.mark.parametrize("k", K_CHOICES)
@pytest.mark.parametrize("extra", [0, 1])
def test_mas_kernel_template_edges(card, k, extra):
    """Each K template at t_x = 32*K (one warp's columns, full) and 32*K + 1
    (a second warp with one column), against the plain version, exactly."""
    t_x = 32 * k + extra
    t_y = t_x + 37
    plan = plan_for_k(t_y, t_x, k)
    neg, t_ys, t_xs = _mas_inputs(card, 3, t_y, t_x, ties=k % 2 == 0)
    got = align._launch(neg, t_ys, t_xs, plan)
    torch.cuda.synchronize()
    _assert_exact_path(got, neg, t_ys, t_xs)


@pytest.mark.cuda
@pytest.mark.parametrize("t_x", [128, 769])
@pytest.mark.parametrize("side", [0, 1])
def test_mas_kernel_decisions_shared_or_device(card, t_x, side):
    """The longest t_y whose move-left bits fit in shared memory and one
    frame more (a device scratch), exactly; b = 1 and 2."""
    t_y = _smem_edge(t_x) + side
    plan = mas_plan(t_y, t_x)
    assert plan.dec_in_smem == (side == 0)
    neg, t_ys, t_xs = _mas_inputs(card, 1 + side, t_y, t_x, ties=False)
    got = maximum_path(neg, t_ys, t_xs)
    torch.cuda.synchronize()
    _assert_exact_path(got, neg, t_ys, t_xs)


@pytest.mark.cuda
def test_mas_kernel_plans_agree_and_repeat(card):
    """Every feasible K at one shape gives the same path, the plan's twice
    over bit for bit; the kernel takes each plan's shared-memory figure
    (it refuses a launch whose figure is not its own)."""
    neg, t_ys, t_xs = _mas_inputs(card, 4, 600, 300, ties=True)
    first = maximum_path(neg, t_ys, t_xs)
    assert torch.equal(maximum_path(neg, t_ys, t_xs), first)
    for k in K_CHOICES:
        for in_smem in (True, False):
            plan = plan_for_k(600, 300, k, in_smem)
            got = align._launch(neg, t_ys, t_xs, plan)
            assert torch.equal(got, first), plan
    bad = plan._replace(smem_bytes=plan.smem_bytes + 4)
    with pytest.raises(RuntimeError, match="mas_fwd"):
        align._launch(neg, t_ys, t_xs, bad)
    torch.cuda.synchronize()
    _assert_exact_path(first, neg, t_ys, t_xs)


@pytest.mark.cuda
@pytest.mark.parametrize("t_y,t_x", [(1500, 1100), (512, 128)])
def test_mas_kernel_empty_and_short_items(card, t_y, t_x):
    """An item with t_x = 0 (no path) first and one of three frames beside
    a full one, with the move-left bits in device memory (1500 x 1100) and
    in shared memory (512 x 128), exactly."""
    assert mas_plan(t_y, t_x).dec_in_smem == (t_x == 128)
    neg, _, _ = _mas_inputs(card, 3, t_y, t_x, ties=False)
    t_ys = torch.tensor([5, 3, t_y], device=card)
    t_xs = torch.tensor([0, 2, t_x], device=card)
    got = maximum_path(neg, t_ys, t_xs)
    torch.cuda.synchronize()
    assert torch.equal(got, maximum_path_plain(neg, t_ys, t_xs))
    assert got[0].sum().item() == 0 and got[1].sum().item() == 3


@pytest.mark.cuda
@pytest.mark.parametrize("channels,heads,window", [(160, 1, 4), (16, 2, 5)])
def test_attention_outside_the_kernels_range(card, channels, heads, window,
                                             monkeypatch):
    """A head of 160 channels or a window of 5 runs on the card through the
    kernels of csrc/banded_attn_wide.cu (the tensor-core ones launch no
    time) and gives the CPU module's output within 1e-5, at inference and
    in fused training (BV2_FUSED_ATTENTION_TRAIN=1, the hash dropout from
    one seed), and its parameter gradients within 1e-4 of the largest
    gradient entry."""
    monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")
    torch.manual_seed(channels)
    cpu = MultiHeadAttention(channels, channels, heads, window_size=window,
                             p_dropout=0.1)
    gpu = MultiHeadAttention(channels, channels, heads, window_size=window,
                             p_dropout=0.1).to(card)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, channels, 40)
    m = _lens_mask([40, 27], 40, "cpu")[:, None, :]
    r = torch.randn(2, channels, 40)
    before = [fn.launches for fn in TC_COUNTERS + WIDE_COUNTERS]
    for train in (False, True):
        outs, grads = [], []
        for mod, dev in ((cpu, "cpu"), (gpu, card)):
            mod.train(train)
            mod.zero_grad()
            torch.manual_seed(7)  # the hash dropout's seed
            with torch.set_grad_enabled(train):
                out = mod(x.to(dev), m.to(dev)) * m.to(dev)
                if train:
                    (out * r.to(dev)).sum().backward()
            outs.append(out.detach().cpu())
            grads.append([p.grad.cpu() for p in mod.parameters()] if train else [])
        assert (outs[0] - outs[1]).abs().max().item() <= 1e-5, train
        # against the largest gradient entry: conv_k's bias has a zero
        # gradient in exact arithmetic (a shift of every key's logit)
        scale = max((g.abs().max() for g in grads[0]), default=1.0)
        for want, got in zip(*grads):
            assert ((got - want).abs().max() / scale).item() <= 1e-4
    torch.cuda.synchronize()
    after = [fn.launches for fn in TC_COUNTERS + WIDE_COUNTERS]
    # inference: one wide_fwd; training: wide_fwd_train, wide_bwd_q, wide_bwd_k
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 0, 1, 1, 1, 1]


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 1, 16, WIDE_MAX_HEAD_DIM + 1, device=card)  # too wide
    e = torch.randn(9, WIDE_MAX_HEAD_DIM + 1, device=card)
    m = torch.ones(1, 16, device=card)
    with pytest.raises(ValueError):
        banded_rel_self_attention(q, q, q, m, e, e, 4)
    q, e = torch.randn(1, 1, 7, 8, device=card), torch.randn(9, 8, device=card)
    with pytest.raises(ValueError):  # t = 2w - 1: the window path's, not a kernel's
        banded_rel_self_attention(q, q, q, m[:, :7], e, e, 4)
    q = torch.randn(1, 1, 16, 8, device=card, dtype=torch.float64)
    e = torch.randn(9, 8, device=card, dtype=torch.float64)
    with pytest.raises(ValueError):
        banded_rel_self_attention(q, q, q, m, e, e, 4)
    lens = torch.tensor([4], device=card)
    with pytest.raises(ValueError):  # float64 scores
        maximum_path(torch.zeros(1, 8, 4, device=card, dtype=torch.float64),
                     lens * 2, lens)
    with pytest.raises(ValueError):  # lengths on another device
        maximum_path(torch.zeros(1, 8, 4, device=card), lens.cpu() * 2, lens)


@pytest.mark.cuda
def test_bf16_inputs_no_kernel_takes_raise(card):
    """bf16 tensors that no kernel takes raise, never run upcast or on the
    plain version: a head wider than the wide kernels', operands of mixed
    dtypes (in inference and in training), float16 operands in either
    direction (the bf16 training direction runs: test above), a K2 stage
    whose channels are not a multiple of 16, x and packed weights of
    different dtypes."""
    bf = torch.bfloat16
    q = torch.randn(1, 1, 16, WIDE_MAX_HEAD_DIM + 1, device=card, dtype=bf)
    e = torch.randn(9, WIDE_MAX_HEAD_DIM + 1, device=card, dtype=bf)
    m = torch.ones(1, 16, device=card)
    counters = (banded_attention_fwd_bf16, wide_fwd_bf16, banded_rel_self_attention,
                wide_fwd, mrf_fwd_bf16, fused_mrf, banded_attention_fwd_train_bf16,
                wide_fwd_train_bf16, banded_attention_fwd_train, wide_fwd_train)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError):
        banded_rel_self_attention(q, q, q, m, e, e, 4)
    q, e = torch.randn(1, 1, 16, 8, device=card, dtype=bf), torch.randn(9, 8, device=card)
    with pytest.raises(ValueError, match="one dtype"):
        banded_rel_self_attention(q, q, q, m, e, e, 4)
    with pytest.raises(ValueError, match="one dtype"):  # the training direction
        banded_rel_self_attention(q.clone().requires_grad_(), q, q, m, e, e, 4)
    h16 = torch.float16
    q16, e16 = q.to(h16), e.to(h16)
    for grad in (False, True):
        with pytest.raises(ValueError, match="float16"):
            banded_rel_self_attention(q16.clone().requires_grad_(grad), q16, q16, m,
                                      e16, e16, 4)
    blocks = [ResBlock1(24, k, d).to(card) for k, d in zip(KS, DS)]
    for dtype in (bf, torch.float16):  # 24 channels: no bf16 stage; no fp16 mode
        with pytest.raises(ValueError):
            prepare_mrf_weights(blocks, dtype)
    blocks = [ResBlock1(32, k, d).to(card) for k, d in zip(KS, DS)]
    x, mb = torch.randn(1, 32, 100, device=card, dtype=bf), m.new_ones(1, 100).to(bf)
    with pytest.raises(ValueError, match="packed weights"):
        fused_mrf(x, mb, prepare_mrf_weights(blocks))
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before


@pytest.mark.cuda
def test_bf16_engine_card_against_cpu(card):
    """The default V2.3 model with infer_compute_dtype "bfloat16" (random
    weights, the zero-init couplings made random): one request at zero
    noise through TTSEngine.run_prepared on the card and on the CPU, equal
    frames and waves within 1e-2; the card call launches K1 12 times in
    fp32 (enc_p) and 16 in bf16 (the flow) and K2 3 times in bf16, the CPU
    none."""
    import numpy as np

    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.infer import PreparedRequest, TTSEngine
    from bert_vits2_tpu_torch.models import build_synthesizer

    cfg = ModelConfig(infer_compute_dtype="bfloat16")
    model = build_synthesizer(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".post." in name or (name.startswith("sdp.") and ".proj." in name):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
        model.dp.proj.bias.fill_(1.5)
    sd = model.state_dict()
    rng = np.random.default_rng(2)
    t = 77
    inputs = (rng.integers(1, cfg.n_vocab, t), rng.integers(0, cfg.num_tones, t),
              rng.integers(0, 3, t),
              *(0.5 * rng.normal(size=(t, 1024)).astype(np.float32) for _ in range(3)))
    req = PreparedRequest(inputs=inputs, sid=3, noise_scale=0.0, noise_scale_w=0.0)
    counters = (banded_rel_self_attention, banded_attention_fwd_bf16, fused_mrf,
                mrf_fwd_bf16)
    waves = []
    for dev in ("cpu", card):
        engine = TTSEngine(build_synthesizer(cfg, device=dev, state_dict=sd), device=dev)
        assert all(p is not None and p.dtype == torch.bfloat16
                   for p in engine.mrf_packed[2:])
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        waves.append(engine.run_prepared([req])[0])
        torch.cuda.synchronize()
        want = (12, 16, 0, 3) if engine.device.type == "cuda" else (0, 0, 0, 0)
        assert tuple(c.launches for c in counters) == want
    want_wave, wave = waves
    assert len(wave) == len(want_wave) > 0 and np.isfinite(wave).all()
    assert np.abs(wave - want_wave).max() <= 1e-2


@pytest.mark.cuda
def test_server_round_trip_launches_k1_and_k2(card):
    """The HTTP server on the card at the default V2.3 width (random weights,
    seeded-noise BERT): two concurrent /voice requests and one auto_split
    paragraph reach TTSEngine.run_prepared through the micro-batcher, and
    every device call that the batcher reports launches K1 28 times and K2
    3 times; the responses are WAVs of finite, non-empty audio."""
    import io
    import json
    import threading
    import urllib.request

    import numpy as np
    from scipy.io import wavfile

    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.infer import TTSEngine
    from bert_vits2_tpu_torch.models import build_synthesizer
    from bert_vits2_tpu_torch.serve import ModelRegistry
    from bert_vits2_tpu_torch.serve.server import make_server
    from bert_vits2_tpu_torch.text.bert import RandomBertExtractor

    cfg = ModelConfig()
    engine = TTSEngine(build_synthesizer(cfg, device=card, seed=0),
                       spk2id={"spk0": 0}, bert_extractor=RandomBertExtractor(0),
                       device=card)
    registry = ModelRegistry()
    registry.init_model("G_0.pth", "config.json", engine=engine)
    srv = make_server(registry, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/voice"
    bodies = []

    def post(text, **kw):
        data = json.dumps(dict(text=text, speaker_name="spk0", language="EN", **kw))
        req = urllib.request.Request(url, data=data.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            bodies.append(r.read())

    n_attn = 2 * cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow
    n_mrf = sum(1 for w in engine.mrf_packed if w is not None)
    try:
        post("Warm up.")
        torch.cuda.synchronize()
        banded_rel_self_attention.launches = fused_mrf.launches = 0
        clients = [threading.Thread(target=post, args=(t,)) for t in
                   ("Hello world.", "The quick brown fox jumps over the lazy dog.")]
        clients.append(threading.Thread(target=post, args=(
            "One sentence.\nTwo sentences.\nThree sentences.",), kwargs={"auto_split": True}))
        for c in clients:
            c.start()
        for c in clients:
            c.join(300)
        torch.cuda.synchronize()
        (batcher,) = srv.RequestHandlerClass.service._batchers.values()
        calls = len(batcher.batch_sizes) - 1  # the warm-up's call first
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(bodies) == 4 and calls >= 1 and sum(batcher.batch_sizes[1:]) == 5
    assert (n_attn, n_mrf) == (28, 3)
    assert banded_rel_self_attention.launches == n_attn * calls
    assert fused_mrf.launches == n_mrf * calls
    for body in bodies:
        sr, pcm = wavfile.read(io.BytesIO(body))
        assert body[:4] == b"RIFF" and sr == engine.sampling_rate and len(pcm) > 0
        assert np.isfinite(pcm.astype(np.float32)).all()


# the SLM slice at a small width: the training config of
# tests/test_torch_train_modules.py (hidden 8, two heads of 4 channels) and
# a WavLM on the geometry of tests/test_slm.py
SLM_TINY = dict(
    n_vocab=20, bert_dim=16, ja_bert_dim=16, spec_channels=33, segment_size=8,
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
    n_layers=3, kernel_size=3, p_dropout=0.1, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 4),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 8), n_speakers=4,
    gin_channels=8, n_flow_layer=2, n_layers_trans_flow=3,
    slm_hidden=32, slm_layers=4, slm_initial_channel=8,
)
SLM_WAVLM = dict(hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64,
                 conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                 num_buckets=32, max_bucket_distance=50)


@pytest.mark.cuda
def test_wavlm_card_against_cpu(card):
    """The frozen SLM (the sinc resampler and a WavLM at the wavlm-base-plus
    widths, random weights from a seed) on the card: every hidden state
    within 1e-3 of the CPU's (post-LN states of O(1), 12 layers of 768- and
    3072-term fp32 sums in another order, TF32 off), on two 44.1 kHz
    segments of 16384 samples."""
    from bert_vits2_tpu_torch.models.slm import SLM, WavLM, WavLMConfig

    torch.manual_seed(0)
    cpu = SLM(WavLM(WavLMConfig()))
    gpu = SLM(WavLM(WavLMConfig())).to(card)
    gpu.load_state_dict(cpu.state_dict())
    wave = torch.rand(2, 16384, generator=torch.Generator().manual_seed(1)) - 0.5
    with torch.no_grad():
        want, got = cpu(wave), gpu(wave.to(card))
    assert len(got) == 13 and got[0].shape == (2, 18, 768)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g.cpu() - w).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_slm_train_step_card_against_cpu(card, monkeypatch):
    """One training step with the SLM losses at a small width, dropout off,
    the same weights and one CPU generator's noise, on the card (the
    attention on K1-train/B5/B6, MAS on K3) and on the CPU: every metric
    within 1e-3 relative (fp32 sums in another order, compounded through
    the posterior, the flow, the vocoder and the WavLM), and the kernels
    launched once per attention layer (K3 once)."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models.slm import SLM, WavLM, WavLMConfig
    from bert_vits2_tpu_torch.train import (DataConfig, TrainConfig,
                                            init_train_state, make_train_step)
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")
    cfg = ModelConfig(**SLM_TINY)
    data = DataConfig(sampling_rate=1600, filter_length=64, hop_length=16,
                      win_length=64, n_mel_channels=16)
    wl_cfg = WavLMConfig(**SLM_WAVLM)
    torch.manual_seed(0)
    wavlm = WavLM(wl_cfg)
    g = torch.Generator().manual_seed(2)
    b, t_x, t_y = 3, 9, 24
    batch = dict(x=torch.randint(1, 20, (b, t_x), generator=g),
                 x_lengths=torch.tensor([9, 9, 6]),
                 spec=0.3 * torch.randn(b, t_y, 33, generator=g),
                 spec_lengths=torch.tensor([24, 24, 16]),
                 wave=torch.rand(b, t_y * 16, generator=g) - 0.5,
                 sid=torch.tensor([0, 1, 3]),
                 tone=torch.randint(0, 12, (b, t_x), generator=g),
                 language=torch.randint(0, 3, (b, t_x), generator=g),
                 bert=0.3 * torch.randn(b, t_x, 16, generator=g),
                 ja_bert=0.3 * torch.randn(b, t_x, 16, generator=g),
                 en_bert=0.3 * torch.randn(b, t_x, 16, generator=g))
    runs = []
    for dev in ("cpu", card):
        models = init_params(build_models(cfg, use_wavlm_disc=True, device=dev,
                                          wavlm=wl_cfg), cfg, seed=3)
        for m in models:
            for mod in m.modules():
                if isinstance(mod, torch.nn.Dropout):
                    mod.p = 0.0
                if hasattr(mod, "p_dropout"):
                    mod.p_dropout = 0.0
        slm = SLM(WavLM(wl_cfg), data.sampling_rate, 16000)
        slm.wavlm.load_state_dict(wavlm.state_dict())
        step = make_train_step(models, TrainConfig(), data, cfg.segment_size,
                               slm=slm.to(dev))
        before = [fn.launches for fn in TC_COUNTERS[1:]] + [maximum_path.launches]
        _, metrics = step(init_train_state(models, TrainConfig()),
                          {k: v.to(dev) for k, v in batch.items()},
                          torch.Generator().manual_seed(4), 2e-4)
        after = [fn.launches for fn in TC_COUNTERS[1:]] + [maximum_path.launches]
        runs.append(({k: float(v) for k, v in metrics.items()},
                     [a - c for a, c in zip(after, before)]))
    (want, cpu_launches), (got, card_launches) = runs
    assert cpu_launches == [0, 0, 0, 0]
    assert card_launches == [9, 9, 9, 1]  # 3 encoder layers, 2 couplings of 3
    assert {"loss/wd/total", "loss/g/lm", "loss/g/lm_gen"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-3 * abs(w), (k, got[k], w)


@pytest.mark.cuda
def test_bf16_train_step_card_against_cpu(card, monkeypatch):
    """One bf16 training step (train_compute_dtype "bfloat16", bf16_run:
    the posterior, the flow and the vocoder slice in bf16, the multi-period
    discriminator on bf16 waves, global-norm clipping) at a small width,
    dropout off, the same weights and one CPU generator's noise, on the
    card (the flow's attention on the bf16 modes of K1-train, B5 and B6,
    enc_p's on the fp32 ones, MAS on K3) and on the CPU (the plain
    versions): every metric finite, the master parameters float32 on both;
    the losses that do not depend on the alignment (the waveform
    discriminator's, the generator's adversarial, feature and mel losses)
    within 2e-2 relative (bf16 roundings at other points: cuDNN's and the
    kernels' against the CPU's and the plain versions', ~3 bf16 ulps), and
    the kernels' launches per attention layer."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.train import (DataConfig, TrainConfig,
                                            init_train_state, make_train_step)
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")
    cfg = ModelConfig(**SLM_TINY, train_compute_dtype="bfloat16")
    tcfg = TrainConfig(bf16_run=True)
    data = DataConfig(sampling_rate=1600, filter_length=64, hop_length=16,
                      win_length=64, n_mel_channels=16)
    g = torch.Generator().manual_seed(2)
    b, t_x, t_y = 3, 9, 24
    batch = dict(x=torch.randint(1, 20, (b, t_x), generator=g),
                 x_lengths=torch.tensor([9, 9, 6]),
                 spec=0.3 * torch.randn(b, t_y, 33, generator=g),
                 spec_lengths=torch.tensor([24, 24, 16]),
                 wave=torch.rand(b, t_y * 16, generator=g) - 0.5,
                 sid=torch.tensor([0, 1, 3]),
                 tone=torch.randint(0, 12, (b, t_x), generator=g),
                 language=torch.randint(0, 3, (b, t_x), generator=g),
                 bert=0.3 * torch.randn(b, t_x, 16, generator=g),
                 ja_bert=0.3 * torch.randn(b, t_x, 16, generator=g),
                 en_bert=0.3 * torch.randn(b, t_x, 16, generator=g))
    counters = (*TC_COUNTERS[1:], banded_attention_fwd_train_bf16,
                banded_attention_bwd_q_bf16, banded_attention_bwd_k_bf16, maximum_path)
    runs = []
    for dev in ("cpu", card):
        models = init_params(build_models(cfg, device=dev), cfg, seed=3)
        for m in models[:3]:
            for mod in m.modules():
                if isinstance(mod, torch.nn.Dropout):
                    mod.p = 0.0
                if hasattr(mod, "p_dropout"):
                    mod.p_dropout = 0.0
        step = make_train_step(models, tcfg, data, cfg.segment_size)
        before = [fn.launches for fn in counters]
        _, metrics = step(init_train_state(models, tcfg),
                          {k: v.to(dev) for k, v in batch.items()},
                          torch.Generator().manual_seed(4), 2e-4)
        after = [fn.launches for fn in counters]
        assert {p.dtype for m in models[:3] for p in m.parameters()} == {torch.float32}
        runs.append(({k: float(v) for k, v in metrics.items()},
                     [a - c for a, c in zip(after, before)]))
    (want, cpu_launches), (got, card_launches) = runs
    assert cpu_launches == [0] * 7
    # enc_p's 3 layers in fp32, the flow's 2 couplings of 3 in bf16
    assert card_launches == [3, 3, 3, 6, 6, 6, 1]
    assert all(math.isfinite(v) for v in (*want.values(), *got.values()))
    for k in ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel"):
        assert abs(got[k] - want[k]) <= 2e-2 * abs(want[k]), (k, got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("family,transformer_flow,n_attn", [
    ("2.1", True, 28), ("2.3", False, 12)])
def test_old_family_card_against_cpu(card, family, transformer_flow, n_attn):
    """A V2.1 model (the vq210 emotion branch; a codebook index and a
    1024-d vector) and a vits1-flow model (use_transformer_flow false, WN
    couplings on stock convs) at the default V2.3 widths, random weights
    with the zero-init couplings made random: one request at zero noise
    through TTSEngine.run_prepared on the card and on the CPU, equal
    frames and waves within 1e-3; every card call launches K1 n_attn times
    (enc_p's 6 layers twice, plus the transformer flow's 16) and K2 3
    times, the CPU none."""
    import dataclasses

    import numpy as np

    from bert_vits2_tpu_torch.compat.versions import spec_for
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.infer import PreparedRequest, TTSEngine
    from bert_vits2_tpu_torch.models import build_synthesizer

    cfg = dataclasses.replace(ModelConfig(**spec_for(family).model_overrides()),
                              use_transformer_flow=transformer_flow)
    model = build_synthesizer(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".post." in name or (name.startswith("sdp.") and ".proj." in name):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
        model.dp.proj.bias.fill_(1.5)
    sd = model.state_dict()
    rng = np.random.default_rng(2)
    t = 77
    inputs = (rng.integers(1, cfg.n_vocab, t), rng.integers(0, cfg.num_tones, t),
              rng.integers(0, 3, t),
              *(0.5 * rng.normal(size=(t, 1024)).astype(np.float32) for _ in range(3)))
    emos = ([np.asarray([3], np.int32),
             rng.normal(size=(1, 1024)).astype(np.float32)] if cfg.emotion == "vq210"
            else [None])
    engines = [TTSEngine(build_synthesizer(cfg, device=dev, state_dict=sd), device=dev)
               for dev in ("cpu", card)]
    for emo in emos:
        req = PreparedRequest(inputs=inputs, sid=3, emo=emo, noise_scale=0.0,
                              noise_scale_w=0.0)
        waves = []
        for engine in engines:
            torch.cuda.synchronize()
            banded_rel_self_attention.launches = fused_mrf.launches = 0
            waves.append(engine.run_prepared([req])[0])
            torch.cuda.synchronize()
            want = (n_attn, 3) if engine.device.type == "cuda" else (0, 0)
            assert (banded_rel_self_attention.launches, fused_mrf.launches) == want
        want_wave, wave = waves
        assert len(wave) == len(want_wave) > 0 and np.isfinite(wave).all()
        assert np.abs(wave - want_wave).max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["banded_attn_fwd", "banded_attn_fwd_bf16",
                                  "banded_attn_wide_fwd", "banded_attn_wide_fwd_bf16",
                                  "mrf_fwd", "mrf_fwd_bf16"])
def test_custom_op_launches_its_kernel(card, name):
    """Each bv2 custom op (ops/library.py) on the card: bit for bit its
    kernel's direct launch, within the kernel's bound of the plain version
    (fp32: K1 1e-4, K2 2e-4; bf16: 4 bf16 ulps), one launch counted by the
    op; the same op on CPU tensors is the plain version and counts none."""
    from bert_vits2_tpu_torch.ops import attention, mrf

    op = getattr(torch.ops.bv2, name)
    bf16 = name.endswith("bf16")
    dt = torch.bfloat16 if bf16 else torch.float32
    if name.startswith("banded"):
        direct, counter = {
            "banded_attn_fwd": (attention.banded_attention_fwd, banded_rel_self_attention),
            "banded_attn_fwd_bf16": (banded_attention_fwd_bf16, banded_attention_fwd_bf16),
            "banded_attn_wide_fwd": (wide_fwd, wide_fwd),
            "banded_attn_wide_fwd_bf16": (wide_fwd_bf16, wide_fwd_bf16)}[name]
        tensors = _attention_inputs(card, 8, 2, 768, 96, None, dt)
        if bf16:
            tensors = (*tensors[:3], tensors[3].to(dt), *tensors[4:])
        args, plain = (*tensors, 4), banded_attention_plain(*tensors, 4)
        want = direct(tensors, 4)
        bound = 1e-4
    else:
        direct, counter = {"mrf_fwd": (mrf.mrf_fwd, fused_mrf),
                           "mrf_fwd_bf16": (mrf_fwd_bf16, mrf_fwd_bf16)}[name]
        torch.manual_seed(0)
        blocks = [ResBlock1(32, k, d).to(card) for k, d in zip(KS, DS)]
        weights = prepare_mrf_weights(blocks, dt)
        x = torch.randn(4, 32, 5000, device=card).to(dt)
        m = _lens_mask([5000, 4000, 1234, 17], 5000, card).to(dt)
        args, plain = (x, m, *weights.op_args), fused_mrf_plain(x, m, weights)
        want = direct(x, m, weights)
        bound = 2e-4
    torch.cuda.synchronize()
    before = counter.launches
    with torch.inference_mode():
        got = op(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == dt and torch.equal(got, want)
    bound = _bf16_bound(plain.float()) if bf16 else bound
    if name.startswith("banded"):  # rows the mask drops are unspecified
        keep = tensors[3][:, None, :, None].expand_as(got) != 0
        assert (got.float() - plain.float())[keep].abs().max().item() <= bound
    else:
        assert (got.float() - plain.float()).abs().max().item() <= bound
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else
                [t.cpu() if isinstance(t, torch.Tensor) else t for t in a]
                if isinstance(a, list) else a for a in args]
    cpu_plain = (banded_attention_plain(*cpu_args) if name.startswith("banded") else
                 fused_mrf_plain(*cpu_args[:2], mrf.MrfWeights.from_op_args(*cpu_args[2:], dt)))
    assert torch.equal(op(*cpu_args), cpu_plain) and counter.launches == before + 1


@pytest.mark.cuda
def test_plain_functions_refuse_card_tensors(card):
    """Inside plain_functions() (the ONNX exporter's CPU trace) the
    wrappers raise on card tensors, in inference and in training, and
    launch nothing: the plain versions never take a kernel's place on the
    card."""
    from bert_vits2_tpu_torch.ops.library import plain_functions

    tensors = _attention_inputs(card, 2, 2, 128, 96, None, torch.float32)
    blocks = [ResBlock1(32, k, d).to(card) for k, d in zip(KS, DS)]
    weights = prepare_mrf_weights(blocks, torch.float32)
    x, m = torch.randn(2, 32, 256, device=card), torch.ones(2, 256, device=card)
    before = (banded_rel_self_attention.launches, fused_mrf.launches)
    q = tensors[0].clone().requires_grad_(True)
    with plain_functions():
        for call in (lambda: banded_rel_self_attention(*tensors, 4),
                     lambda: banded_rel_self_attention(q, *tensors[1:], 4),
                     lambda: fused_mrf(x, m, weights)):
            with pytest.raises(RuntimeError, match="plain_functions"):
                call()
    torch.cuda.synchronize()
    assert (banded_rel_self_attention.launches, fused_mrf.launches) == before
    with torch.inference_mode():  # outside it, the kernels
        banded_rel_self_attention(*tensors, 4)
        fused_mrf(x, m, weights)
    assert (banded_rel_self_attention.launches, fused_mrf.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_stage_programs_launch_k1_and_k2(card, tmp_path):
    """make_stages / run_stages and export_stages on the card for a small
    model (K2 on its two vocoder stages): run_stages equals
    Synthesizer.infer; each program loaded by torch.export.load launches K1
    in enc_p (n_layers) and in the flow (n_flow_layer x its layers) and K2
    in dec (2), and gives the live stage's outputs."""
    from bert_vits2_tpu_torch.compat.stages import (
        STAGES, export_stages, load_stages, make_stages, run_stages, stage_inputs)
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models import build_synthesizer

    cfg = ModelConfig(hidden_channels=32, filter_channels=64, inter_channels=16,
                      n_layers=2, n_layers_trans_flow=2, gin_channels=16,
                      upsample_initial_channel=64, upsample_rates=(4, 4),
                      upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7),
                      resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
    model = build_synthesizer(cfg, device=card, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".post." in name or (name.startswith("sdp.") and ".proj." in name):
                p.copy_(0.02 * torch.randn(p.shape, generator=g).to(card))
    b, t_x, frames = 2, 24, 128
    stages = make_stages(model)
    gen = torch.Generator(device=card)
    text = dict(x=torch.randint(1, cfg.n_vocab, (b, t_x), device=card, generator=gen),
                x_lengths=torch.tensor([t_x, 17], device=card),
                sid=torch.tensor([0, 3], device=card),
                tone=torch.randint(0, cfg.num_tones, (b, t_x), device=card, generator=gen),
                language=torch.randint(0, 3, (b, t_x), device=card, generator=gen),
                **{k: 0.5 * torch.randn(b, t_x, 1024, device=card, generator=gen)
                   for k in ("bert", "ja_bert", "en_bert")})
    with torch.inference_mode():
        want, _, _, y_want = model.infer(max_frames=frames, mrf_packed=model.dec.pack_mrf(),
                                         generator=gen.manual_seed(4), **text)
    wave, y_len = run_stages(stages, max_frames=frames, generator=gen.manual_seed(4), **text)
    assert torch.equal(y_len, y_want) and (wave - want).abs().max().item() <= 1e-6

    export_stages(model, str(tmp_path), t_x=t_x, max_frames=frames, batch=b)
    progs = load_stages(str(tmp_path))
    args = stage_inputs(cfg, t_x, frames, b, card)
    args["emb"] = (text["sid"],)
    args["enc_p"] = (*(text[k] for k in ("x", "x_lengths", "tone", "language", "bert",
                                          "ja_bert", "en_bert")), stages["emb"](text["sid"]))
    for k in ("sdp", "dp", "flow", "dec"):  # random features, masks kept
        args[k] = tuple(torch.randn(a.shape, device=card, generator=gen)
                        if a.is_floating_point() and a.dim() == 3 and a.shape[1] != 1
                        else a for a in args[k])
    want_launches = {"enc_p": (2, 0), "flow": (8, 0), "dec": (0, 2)}
    for name in STAGES:
        torch.cuda.synchronize()
        banded_rel_self_attention.launches = fused_mrf.launches = 0
        got = progs[name](*args[name])
        torch.cuda.synchronize()
        assert (banded_rel_self_attention.launches, fused_mrf.launches) == \
            want_launches.get(name, (0, 0)), name
        live = (stages[name](*args[name]) if name != "sdp"
                else stages["sdp"](*args[name][:4], z=args[name][4]))
        for o, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, live))):
            assert (o - w).abs().max().item() <= 1e-6, name
