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
and one max per cell: the 0/1 path equals the plain version's bit for bit).
"""

import pytest
import torch

from bert_vits2_tpu_torch.models.generator import ResBlock1
from bert_vits2_tpu_torch.ops.align import maximum_path, maximum_path_plain
from bert_vits2_tpu_torch.ops.attention import (
    banded_attention_bwd_k,
    banded_attention_bwd_plain,
    banded_attention_bwd_q,
    banded_attention_fwd_train,
    banded_attention_plain,
    banded_attention_stats_plain,
    banded_rel_self_attention,
)
from bert_vits2_tpu_torch.ops.mrf import (
    fused_mrf,
    fused_mrf_plain,
    prepare_mrf_weights,
)

KS = (3, 7, 11)
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
    before = banded_rel_self_attention.launches
    with torch.inference_mode():
        got = banded_rel_self_attention(q, k, v, m, ek, ev, 4)
        want = banded_attention_plain(q, k, v, m, ek, ev, 4)
    torch.cuda.synchronize()
    assert banded_rel_self_attention.launches == before + 1
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
])
def test_banded_attention_backward_kernels(card, b, h, t, d, lens, w, p_drop):
    """K1 in train mode (out, m, l), B5 (dq, dek, dev) and B6 (dk, dv)
    against the plain version's autograd, valid rows, one dropout seed."""
    g = torch.Generator(device=card).manual_seed(t + b)
    lens = lens or [t - (t // 16) * i for i in range(b)]
    q, k, v = (torch.randn(b, h, t, d, device=card, generator=g)
               for _ in range(3))
    q = q / d ** 0.5
    ek, ev = (torch.randn(2 * w + 1, d, device=card, generator=g) / d ** 0.5
              for _ in range(2))
    m = _lens_mask(lens, t, card)
    go = torch.randn(b, h, t, d, device=card, generator=g) * m[:, None, :, None]
    counts = [fn.launches for fn in (banded_attention_fwd_train,
                                     banded_attention_bwd_q, banded_attention_bwd_k)]
    seed = -987654321
    out, mr, lr = banded_attention_fwd_train(q, k, v, m, ek, ev, w, p_drop, seed)
    args = (q, k, v, m, ek, ev, go, mr, lr, (go * out).sum(-1), w, p_drop, seed)
    dq, dek, dev = banded_attention_bwd_q(*args)
    dk, dv = banded_attention_bwd_k(*args)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (banded_attention_fwd_train, banded_attention_bwd_q,
                                   banded_attention_bwd_k)] == [c + 1 for c in counts]
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
@pytest.mark.parametrize("d", [96, 128])
def test_banded_attention_backward_is_deterministic(card, d):
    """Two B5 launches on the same inputs give bit-equal dq, dek and dev
    (dek, dev: per-block partials added in block order, no atomics), and
    two B6 launches bit-equal dk and dv."""
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
@pytest.mark.parametrize("b,t_y,t_x,ties", [
    (16, 512, 128, False),   # the training step's shape, ragged lengths
    (2, 1500, 1100, False),  # t_x above one block of 1024 threads
    (1, 40, 7, False),       # b = 1
    (3, 33, 33, False),      # t_x == t_y: the path is the diagonal
    (4, 64, 1, False),       # a single token
    (5, 200, 70, True),      # scores on a coarse grid: many exact ties
])
def test_mas_kernel(card, b, t_y, t_x, ties):
    g = torch.Generator(device=card).manual_seed(t_y)
    neg = torch.randn(b, t_y, t_x, device=card, generator=g)
    if ties:
        neg = torch.round(neg * 2) / 2
    t_ys = torch.randint(max(t_x, t_y // 2), t_y + 1, (b,), device=card, generator=g)
    t_xs = torch.minimum(
        torch.randint(1, t_x + 1, (b,), device=card, generator=g), t_ys)
    t_ys[0], t_xs[0] = t_y, t_x  # one item at full length
    before = maximum_path.launches
    got = maximum_path(neg, t_ys, t_xs)
    want = maximum_path_plain(neg, t_ys, t_xs)
    torch.cuda.synchronize()
    assert maximum_path.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.sum(2), (torch.arange(t_y, device=card)[None, :]
                                    < t_ys[:, None]).float())
    assert torch.equal(got.sum((1, 2)), t_ys.float())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 1, 16, 160, device=card)  # d > 128
    e = torch.randn(9, 160, device=card)
    m = torch.ones(1, 16, device=card)
    with pytest.raises(ValueError):
        banded_rel_self_attention(q, q, q, m, e, e, 4)
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
