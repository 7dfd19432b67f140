"""PyTorch port, the fused attention's training direction on the CPU: the
position-hash dropout, the differentiable op against the JAX op, the
autograd Function's plumbing, and the module's dispatch.

The CUDA kernels (K1 in train mode, B5, B6) run only on the card, where
tests/test_torch_kernels_cuda.py holds them against the plain version's
autograd; here the plain version, which the port runs on the CPU, is held
against the JAX op `banded_rel_self_attention(..., interpret=True)`: its
Pallas forward and backward kernels in interpret mode, as the JAX
package's own tests run them. Inputs come from numpy with a fixed seed.

Tolerances (tests/test_ops.py:307-334): the output within 1e-5 on valid
rows (fp32, values O(1)); each gradient within 3e-5 of its max (fp32 sums
of up to t and, for the tables, b*h*t terms in another order).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_vits2_tpu.ops.attention_pallas import _drop_threshold, _hash_keep
from bert_vits2_tpu.ops.attention_pallas import (
    banded_rel_self_attention as jax_banded,
)
from bert_vits2_tpu_torch.nn import attention as port_attention
from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
from bert_vits2_tpu_torch.ops.attention import (
    BandedAttentionFn,
    banded_attention_plain,
    banded_rel_self_attention,
    drop_threshold,
    hash_keep,
)
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

OUT_ATOL = 1e-5
GRAD_REL = 3e-5
SEED = -123456789  # a negative int32 seed: its bits are not its value


@pytest.mark.parametrize("salt", [0, 7])
@pytest.mark.parametrize("seed", [12345, -2**31 + 5])
def test_hash_keep_matches_jax_bit_for_bit(salt, seed):
    t = 512
    rows = jax.lax.broadcasted_iota(jnp.int32, (t, t), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (t, t), 1)
    want = np.asarray(_hash_keep(rows, cols, jnp.int32(salt), jnp.int32(seed),
                                 _drop_threshold(0.1)))
    pos = torch.arange(t)
    got = hash_keep(pos[:, None], pos[None, :], torch.tensor(salt), seed,
                    drop_threshold(0.1)).numpy()
    assert drop_threshold(0.1) == _drop_threshold(0.1)
    assert np.array_equal(got, want)
    assert 0.89 < got.mean() < 0.91


def _inputs(b=2, h=2, t=64, d=32, w=4, lens=(64, 45), seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, d)) for _ in range(3))
    ek, ev = (rng.normal(size=(2 * w + 1, d)) / np.sqrt(d) for _ in range(2))
    m = (np.arange(t)[None, :] < np.asarray(lens)[:, None])
    return [a.astype(np.float32) for a in (q / np.sqrt(d), k, v, ek, ev)], \
        m.astype(np.float32)


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_fused_op_matches_jax_op_under_autograd(p_drop):
    """The port's op on CPU tensors (the plain version with the hash
    dropout) against the JAX op with its Pallas backward kernels, for the
    loss sum((out * mask)^2): the output on valid rows and the gradients of
    q, k, v and the two tables."""
    (q, k, v, ek, ev), m = _inputs()

    def loss(q, k, v, ek, ev):
        out = jax_banded(q, k, v, m, ek, ev, 4, dropout_p=p_drop,
                         dropout_seed=jnp.asarray([SEED], jnp.int32),
                         interpret=True)
        return jnp.sum((out * m[:, None, :, None]) ** 2), out

    (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                             has_aux=True)(q, k, v, ek, ev)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, ek, ev)]
    mt = torch.tensor(m)
    out = banded_rel_self_attention(leaves[0], leaves[1], leaves[2], mt,
                                    leaves[3], leaves[4], 4, dropout_p=p_drop,
                                    dropout_seed=SEED)
    ((out * mt[:, None, :, None]) ** 2).sum().backward()
    valid = np.broadcast_to(m.astype(bool)[:, None, :], out.shape[:3])
    err = np.abs(out.detach().numpy() - np.asarray(want_out))[valid].max()
    assert err <= OUT_ATOL, err
    for name, leaf, ref in zip(("dq", "dk", "dv", "dek", "dev"), leaves, want):
        ref = np.asarray(ref)
        rel = np.abs(leaf.grad.numpy() - ref).max() / np.abs(ref).max()
        assert rel <= GRAD_REL, (name, rel)


def test_autograd_function_matches_plain_autograd_on_cpu():
    """BandedAttentionFn (the kernels' wrappers; on CPU tensors each takes
    its plain version) passes the saved statistics and D = rowsum(g * out)
    to the backward as the card does, and gives the plain version's
    gradients."""
    (q, k, v, ek, ev), m = _inputs(t=37, lens=(37, 20), seed=1)
    mt = torch.tensor(m)
    g = torch.randn(2, 2, 37, 32, generator=torch.Generator().manual_seed(0))
    grads = []
    for fn in (BandedAttentionFn.apply, banded_attention_plain):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, ek, ev)]
        out = fn(leaves[0], leaves[1], leaves[2], mt, leaves[3], leaves[4], 4,
                 0.1, SEED)
        grads.append(torch.autograd.grad(out, leaves, g))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_module_takes_the_hash_path_when_asked(monkeypatch):
    """MultiHeadAttention in train() mode with BV2_FUSED_ATTENTION_TRAIN=1:
    the dropout is the position hash from one int32 seed per call drawn
    from torch's generator outside a data shard, so one seed gives one set
    of gradients and two seeds give two, salted (0, heads) there (the
    salt b * heads + head); without the variable it is F.dropout."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(8, 8, 2, window_size=4, p_dropout=0.1).train()
    x = torch.randn(2, 8, 20)
    x_mask = torch.ones(2, 1, 20)
    x_mask[1, :, 13:] = 0

    def grads(seed):
        torch.manual_seed(seed)
        mha.zero_grad()
        mha(x, x_mask).pow(2).sum().backward()
        return [p.grad.clone() for p in mha.parameters()]

    monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")
    a, b, c = grads(1), grads(1), grads(2)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    assert not all(torch.equal(u, w) for u, w in zip(a, c))
    # the seed drawn is the hash's: the plain version with that seed agrees
    calls = []
    monkeypatch.setattr(port_attention, "banded_rel_self_attention",
                        lambda *args, **kw: calls.append(kw) or
                        banded_attention_plain(*args, **kw))
    torch.manual_seed(1)
    mha(x, x_mask)
    torch.manual_seed(1)
    assert calls == [{"dropout_p": 0.1,
                      "dropout_seed": port_attention._dropout_seed(),
                      "dropout_salt": (0, 2)}]
    monkeypatch.delenv("BV2_FUSED_ATTENTION_TRAIN")
    assert os.environ.get("BV2_FUSED_ATTENTION_TRAIN") is None
    mha(x, x_mask)
    assert len(calls) == 1
