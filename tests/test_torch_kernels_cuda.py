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
"""

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
    banded_attention_bwd_plain,
    banded_attention_bwd_q,
    banded_attention_fwd_train,
    banded_attention_plain,
    banded_attention_stats_plain,
    banded_kernels_support,
    banded_rel_self_attention,
    wide_bwd_k,
    wide_bwd_q,
    wide_fwd,
    wide_fwd_train,
)
from bert_vits2_tpu_torch.ops.mrf import (
    fused_mrf,
    fused_mrf_plain,
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,lens", [
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
])
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
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("b,h,t,d,lens,w", [
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
])
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
