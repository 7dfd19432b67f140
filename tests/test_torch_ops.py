"""PyTorch port, ops layer: the kernels' plain versions and the primitives
against the JAX package, on the CPU.

The plain versions are what the port runs on the CPU and what the CUDA
kernels are held against on the card (tests/test_torch_kernels_cuda.py), so
each is held here against the JAX function the TPU kernel computes: the
attention's Pallas kernel in interpret mode, as the JAX package's own tests
run it, and the JAX dense attention path; the MRF against the JAX ResBlock1
stack, which tests/test_mrf_pallas.py holds both MRF kernels to (their
interpret mode costs ~10 s a case on a CPU). Inputs come from numpy with a
fixed seed.

Tolerances: fp32 max-abs-err <= 1e-5 on valid positions (fp32 sums taken in
another order by the two frameworks; values are O(1)).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from bert_vits2_tpu.models.generator import ResBlock1 as JResBlock1
from bert_vits2_tpu.nn.attention import MultiHeadAttention as JMHA
from bert_vits2_tpu.ops import masking as jmask
from bert_vits2_tpu.ops import spline as jspline
from bert_vits2_tpu.ops.attention_pallas import banded_rel_self_attention as j_banded
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.models.generator import ResBlock1
from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
from bert_vits2_tpu_torch.ops import masking, spline
from bert_vits2_tpu_torch.ops.attention import (
    banded_attention_plain,
    banded_kernels_support,
    banded_rel_self_attention,
)
from bert_vits2_tpu_torch.ops.mrf import (
    fused_mrf,
    fused_mrf_plain,
    prepare_mrf_weights,
)
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _mask(lens, t):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def _attn_inputs(b, h, t, d, w, lens, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, d)) for _ in range(3))
    ek, ev = (rng.normal(size=(2 * w + 1, d)) / np.sqrt(d) for _ in range(2))
    return tuple(a.astype(np.float32) for a in
                 (q / np.sqrt(d), k, v, _mask(lens, t), ek, ev))


def _t(a):
    return torch.tensor(np.asarray(a))


def _valid_rows(out, mask):
    """[b, h, t, d] -> the rows of valid query positions."""
    return out.transpose(0, 2, 1, 3)[mask.astype(bool)]


@pytest.mark.parametrize("t,lens", [(16, [16, 11]), (24, [9, 24])])
def test_banded_plain_matches_pallas_kernel(t, lens):
    """Plain K1 vs the TPU kernel `_attn_fwd_kernel` in interpret mode (it
    needs t % 8 == 0). Valid rows only: the TPU kernel masks keys only."""
    q, k, v, m, ek, ev = _attn_inputs(2, 2, t, 16, 4, lens, seed=t)
    want = np.asarray(j_banded(q, k, v, m, ek, ev, 4, interpret=True))
    with torch.inference_mode():
        got = banded_rel_self_attention(*map(_t, (q, k, v, m, ek, ev)), 4).numpy()
    err = np.abs(_valid_rows(got, m) - _valid_rows(want, m)).max()
    assert err <= ATOL, err


def _jax_mha(t, lens, seed, c=8, h=2, w=4):
    """JAX MultiHeadAttention on random input and weights -> (out, port out)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, c)).astype(np.float32)
    m = _mask(lens, t)
    mod = JMHA(c, c, h, window_size=w)
    attn_mask = m[:, None, :, None] * m[:, None, None, :]
    scale = 0.5 * (8 / c) ** 0.5  # activations of O(1) at any width
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * scale,
        mod.init(jax.random.key(0), x, x, attn_mask)["params"])
    want = np.asarray(mod.apply({"params": params}, x, x, attn_mask,
                                x_mask_vec=m))
    port = MultiHeadAttention(c, c, h, window_size=w)
    port.load_state_dict(from_jax_params(params), strict=True)
    with torch.inference_mode():
        got = port(_t(x.transpose(0, 2, 1)), _t(m[:, None, :])).numpy()
    return got.transpose(0, 2, 1)[m.astype(bool)], want[m.astype(bool)]


def test_attention_ragged_t_matches_jax_dense_path():
    """t = 13 (not a multiple of 8: the JAX package takes its dense banded
    path there; the port's K1 has no such limit)."""
    got, want = _jax_mha(13, [13, 7], seed=1)
    assert np.abs(got - want).max() <= ATOL


def test_attention_short_t_window_path():
    """t = 5 < 2w: the window-embedding (_rel_to_abs) path in plain torch."""
    got, want = _jax_mha(5, [5, 3], seed=2)
    assert np.abs(got - want).max() <= ATOL


@pytest.mark.parametrize("c,h,w", [(160, 1, 4), (8, 2, 5)])
def test_attention_outside_the_tensor_core_range_matches_jax(c, h, w):
    """A head of 160 channels and a window of 5 (the shapes the port sends
    to csrc/banded_attn_wide.cu on the card): the port's formula against
    the JAX module's dense path."""
    got, want = _jax_mha(16, [16, 11], seed=5, c=c, h=h, w=w)
    assert np.abs(got - want).max() <= ATOL


def test_banded_plain_is_the_dense_formula():
    """The CPU wrapper returns the plain version exactly and counts no
    launch."""
    q, k, v, m, ek, ev = _attn_inputs(1, 2, 12, 8, 4, [10], seed=3)
    before = banded_rel_self_attention.launches
    with torch.inference_mode():
        a = banded_rel_self_attention(*map(_t, (q, k, v, m, ek, ev)), 4)
        b = banded_attention_plain(*map(_t, (q, k, v, m, ek, ev)), 4)
    assert torch.equal(a, b)
    assert banded_rel_self_attention.launches == before


@pytest.mark.parametrize("b,h,t,d,w,ok", [
    (2, 2, 64, 128, 4, True), (2, 2, 64, 129, 4, False),  # head width
    (1, 1, 64, 96, 4, True), (1, 1, 64, 96, 5, False),    # window
    (65535, 1, 8, 8, 4, True), (65536, 1, 8, 8, 4, False),  # b * h
    (1, 1, 7, 8, 4, False), (1, 1, 8, 8, 4, True),        # t = 2w - 1, 2w
    (1, 1, 1, 8, 0, True), (1, 1, 8, 0, 4, False),        # w = 0; d = 0
])
def test_banded_kernels_support_edges(b, h, t, d, w, ok):
    """The tensor-core kernels' range, which the wrappers read to choose
    between them and csrc/banded_attn_wide.cu: d <= 128, w <= 4, t >= 2w,
    b*h <= 65535."""
    assert banded_kernels_support(b, h, t, d, w) is ok


def test_wrappers_refuse_grad_and_dropout():
    """The attention wrapper takes gradients and the hash dropout (its
    backward kernels exist) but refuses dropout without a seed; the MRF
    wrapper, whose kernel has no backward, refuses tensors that require
    grad."""
    q, k, v, m, ek, ev = map(_t, _attn_inputs(1, 1, 8, 4, 4, [8], seed=4))
    with pytest.raises(ValueError, match="dropout_seed"):
        banded_rel_self_attention(q, k, v, m, ek, ev, 4, dropout_p=0.1)
    out = banded_rel_self_attention(q.requires_grad_(), k, v, m, ek, ev, 4,
                                    dropout_p=0.1, dropout_seed=3)
    assert out.requires_grad
    blocks = [ResBlock1(8, 3, (1, 3))]
    with pytest.raises(RuntimeError):
        fused_mrf(torch.zeros(1, 8, 16, requires_grad=True), torch.ones(1, 16),
                  prepare_mrf_weights(blocks))


class _JMRF(fnn.Module):
    ch: int

    @fnn.compact
    def __call__(self, x, x_mask):
        xs = None
        for j, (k, d) in enumerate(zip(KS, DS)):
            blk = JResBlock1(self.ch, k, d, time_fold=1, name=f"rb_{j}")
            xs = blk(x, x_mask) if xs is None else xs + blk(x, x_mask)
        return xs / len(KS)


def _mrf_case(c, t):
    """Random MRF weights (unit-gain convs, not the near-identity init) and
    input; -> (JAX params per block, port MrfWeights, x, mask)."""
    rng = np.random.default_rng(c + t)
    x = rng.normal(size=(2, t, c)).astype(np.float32)
    m = _mask([t, t - 57], t)
    shapes = _JMRF(c).init(jax.random.key(0), x, m)["params"]

    def fill(path, a):
        if path[-1].key == "v":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0] * c)).astype(np.float32)
        if path[-1].key == "g":
            return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    blocks = []
    for j, (k, d) in enumerate(zip(KS, DS)):
        blk = ResBlock1(c, k, d)
        blk.load_state_dict(from_jax_params(params[f"rb_{j}"]), strict=True)
        blocks.append(blk)
    port_w = prepare_mrf_weights(blocks)
    return [params[f"rb_{j}"] for j in range(3)], port_w, x, m


def _port_mrf(port_w, x, m):
    with torch.inference_mode():
        out = fused_mrf(_t(x.transpose(0, 2, 1)), _t(m), port_w)
    return out.numpy().transpose(0, 2, 1)


def _jax_mrf(jblocks, c, x, m):
    """The JAX package's ResBlock1 stack (the generator's path during
    training), which tests/test_mrf_pallas.py holds the TPU kernels to."""
    params = {f"rb_{j}": p for j, p in enumerate(jblocks)}
    return np.asarray(_JMRF(c).apply({"params": params}, x, m))


@pytest.mark.parametrize("c,t", [(16, 512), (32, 256)])
def test_mrf_plain_matches_pallas_kernel(c, t):
    """Plain K2 vs the function of the TPU kernel `_mrf_kernel`: the JAX
    ResBlock1 stack it is held to by the JAX package's own tests."""
    jblocks, port_w, x, m = _mrf_case(c, t)
    want = _jax_mrf(jblocks, c, x, m)
    got = _port_mrf(port_w, x, m)
    valid = m.astype(bool)
    assert np.abs(got - want)[valid].max() <= ATOL
    assert np.abs(got[1, t - 57:]).max() == 0.0  # masked tail silent


@pytest.mark.parametrize("c,t", [(16, 1024), (64, 256)])
def test_mrf_plain_matches_pallas_folded_kernel(c, t):
    """Plain K2 vs the function of the TPU kernel `_mrf_folded_kernel` (the
    same function in the TPU's phase-folded layout), at its widths: the
    JAX ResBlock1 stack, as above."""
    jblocks, port_w, x, m = _mrf_case(c, t)
    want = _jax_mrf(jblocks, c, x, m)
    got = _port_mrf(port_w, x, m)
    assert np.abs(got - want)[m.astype(bool)].max() <= ATOL


def test_mrf_plain_matches_resblock_modules():
    """The wrapper's plain version vs the port's own ResBlock1 stack on a
    ragged T (the kernel has no tile-divisibility limit)."""
    c, t = 8, 203
    rng = np.random.default_rng(5)
    blocks = [ResBlock1(c, k, d) for k, d in zip(KS, DS)]
    x = _t(rng.normal(size=(2, c, t)).astype(np.float32))
    m = _t(_mask([t, 150], t))
    with torch.inference_mode():
        want = sum(blk(x, m[:, None, :]) for blk in blocks) / 3
        got = fused_mrf_plain(x, m, prepare_mrf_weights(blocks))
    assert (got - want).abs().max().item() <= ATOL


def test_spline_inverse_matches_jax():
    rng = np.random.default_rng(6)
    shape = (2, 3, 7)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    x[0, 0, :2] = [-7.0, 6.5]  # outside +-tail_bound: the identity tails
    uw, uh = (rng.normal(size=shape + (10,)).astype(np.float32) for _ in range(2))
    ud = rng.normal(size=shape + (9,)).astype(np.float32)
    jo, jl = jspline.unconstrained_rational_quadratic_spline(
        x, uw, uh, ud, inverse=True, tail_bound=5.0)
    to, tl = spline.unconstrained_rational_quadratic_spline(
        *map(_t, (x, uw, uh, ud)), inverse=True, tail_bound=5.0)
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= ATOL
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= ATOL


def test_mel_weights_cached_under_inference_mode_serve_autograd():
    """The mel filterbank is cached per device: one first made under
    inference_mode (a wave's log-mel in synthesis) must still serve a
    training loss that autograd tracks."""
    from bert_vits2_tpu_torch.ops.stft import _mel_weights, mel_spectrogram

    args = (64, 10, 22050, 16, 64, 0.0, None)
    _mel_weights.cache_clear()
    with torch.inference_mode():
        mel_spectrogram(torch.randn(1, 256), *args)
    y = torch.randn(1, 256, requires_grad=True)
    mel_spectrogram(y, *args).sum().backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().max() > 0


def test_masks_and_path_match_jax():
    rng = np.random.default_rng(7)
    lens = np.asarray([5, 3, 1])
    dur = np.ceil(rng.uniform(0, 3, size=(3, 5))).astype(np.float32)
    x_mask = _mask(lens, 5)
    dur = dur * x_mask
    y_lens = np.minimum(dur.sum(-1), 9).astype(np.int32)
    y_mask = np.asarray(jmask.sequence_mask(jnp.asarray(y_lens), 9))
    assert np.array_equal(masking.sequence_mask(_t(y_lens), 9).numpy(), y_mask)
    want = np.asarray(jmask.generate_path(dur, x_mask, y_mask))
    got = masking.generate_path(_t(dur), _t(x_mask), _t(y_mask)).numpy()
    assert np.array_equal(got, want)


def test_mrf_weight_split_and_packing():
    """K2's weights as the kernel reads them (csrc/mrf.cu note): per conv
    and slab (tap, kstep), the hi part, then the lo part, each as core
    matrices: output group j, K half kh, row r, column c holds
    W[8j + r, 8*kstep + 4*kh + c, tap]. Read back by that rule, hi and lo
    are TF32 values (13 low mantissa bits zero), hi is W rounded to TF32,
    and hi + lo is W within 2**-20 of |W|; the biases lie as they are."""
    c = 24
    torch.manual_seed(3)
    blocks = [ResBlock1(c, k, d) for k, d in zip(KS, DS)]
    with torch.no_grad():
        for blk in blocks:
            for conv in (*blk.convs1, *blk.convs2):
                conv.weight_g.uniform_(0.5, 2.0)
                conv.bias.normal_()
    w = prepare_mrf_weights(blocks)
    quads = [q for stages in w.convs for q in stages]
    assert len(quads) == len(w.offsets) == 9
    for quad, offs in zip(quads, w.offsets):
        for wt, off in ((quad[0], offs[0]), (quad[2], offs[2])):
            k = wt.shape[2]
            tap, ks, part, j, kh, r, cc = torch.meshgrid(
                *(torch.arange(n) for n in (k, c // 8, 2, c // 8, 2, 8, 4)),
                indexing="ij")
            idx = ((((((tap * (c // 8) + ks) * 2 + part) * (c // 8) + j) * 2 + kh)
                    * 8 + r) * 4 + cc)
            assert idx.numel() == 2 * wt.numel()
            assert sorted(idx.reshape(-1).tolist()) == list(range(idx.numel()))
            co, ci = 8 * j + r, 8 * ks + 4 * kh + cc
            read = w.flat[off + idx]
            hi, lo = (torch.zeros_like(wt).index_put_(
                (co[:, :, p_], ci[:, :, p_], tap[:, :, p_]), read[:, :, p_])
                for p_ in (0, 1))
            for part_ in (hi, lo):
                assert not (part_.view(torch.int32) & 0x1FFF).any()
            assert ((hi - wt).abs() <= wt.abs() * 2.0 ** -11).all()
            assert ((hi + lo - wt).abs() <= wt.abs() * 2.0 ** -20).all()
        for b_, off in ((quad[1], offs[1]), (quad[3], offs[3])):
            assert torch.equal(w.flat[off:off + c], b_)
