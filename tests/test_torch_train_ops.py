"""PyTorch port, training slice, op layer: each function against its JAX
counterpart on the CPU, inputs from numpy seeds, fp32, JAX at matmul
precision "highest" (tests/conftest.py).

Tolerances, each stated where it is used: MAS exact (one fp32 add and one
max per cell; the path is 0/1); slicing exact (integer gathers); the linear
spectrogram 1e-4 and the log-mel 1e-4 absolute (an FFT against a DFT matmul,
sums of 64 terms in another order, then a log); the four losses 1e-6
relative (means and sums of a few thousand fp32 terms); one AdamW update
1e-6 absolute on O(1) parameters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bert_vits2_tpu.ops import masking as jax_masking
from bert_vits2_tpu.ops import stft as jax_stft
from bert_vits2_tpu.ops.align import maximum_path_numpy, maximum_path_scan
from bert_vits2_tpu.ops.align_pallas import maximum_path_pallas
from bert_vits2_tpu.train import losses as jax_losses
from bert_vits2_tpu.train import step as jax_step
from bert_vits2_tpu_torch.ops import masking, noise, stft
from bert_vits2_tpu_torch.ops.align import (
    K_CHOICES,
    MAX_WARPS,
    SMEM_BYTES,
    mas_plan,
    mas_smem_bytes,
    maximum_path,
    maximum_path_plain,
)
from bert_vits2_tpu_torch.train import losses, step
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.tensor(np.asarray(a))


# ---- (a) monotonic alignment search ----

@pytest.mark.parametrize("b,t_y,t_x,ties", [
    (3, 20, 7, False),
    (2, 9, 9, False),    # t_x == t_y: the diagonal
    (2, 6, 1, False),    # a single token
    (4, 33, 17, True),   # scores on a coarse grid: many exact ties
    (1, 12, 5, False),   # b = 1
    (5, 24, 24, True),   # ties on a square, ragged lengths
])
def test_mas_plain_is_exact(b, t_y, t_x, ties):
    """The plain version, the numpy golden model of the numba kernel, the
    Pallas kernel in interpret mode and the lax.scan formulation give the
    same 0/1 path, bit for bit, on ragged lengths."""
    rng = np.random.default_rng(t_y * 100 + t_x)
    neg = rng.normal(size=(b, t_y, t_x)).astype(np.float32)
    if ties:
        neg = np.round(neg * 2) / 2
    t_ys = rng.integers(max(t_x, t_y // 2), t_y + 1, b)
    t_xs = np.minimum(rng.integers(1, t_x + 1, b), t_ys)
    t_ys[0], t_xs[0] = t_y, t_x  # one item at full length
    want = maximum_path_numpy(neg, t_ys, t_xs)
    got = maximum_path_plain(_t(neg), _t(t_ys), _t(t_xs)).numpy()
    assert np.array_equal(got, want)
    lens = (jnp.asarray(t_ys, jnp.int32), jnp.asarray(t_xs, jnp.int32))
    assert np.array_equal(
        np.asarray(maximum_path_pallas(jnp.asarray(neg), *lens, interpret=True)), got)
    assert np.array_equal(np.asarray(maximum_path_scan(jnp.asarray(neg), *lens)), got)
    # every valid frame has one token; nothing outside the lengths
    assert np.array_equal(got.sum(2), np.arange(t_y)[None, :] < t_ys[:, None])
    # the wrapper on CPU tensors is the plain version, with no launch counted
    before = maximum_path.launches
    assert torch.equal(maximum_path(_t(neg), _t(t_ys), _t(t_xs)), _t(got))
    assert maximum_path.launches == before


def test_mas_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(4, 3), torch.tensor([4]), torch.tensor([3]))
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(2, 4, 3), torch.tensor([4]), torch.tensor([3, 3]))
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(1, 4, 3, device="meta"), torch.tensor([4]),
                     torch.tensor([3]))


@pytest.mark.parametrize("t_y,t_x", [
    (512, 128), (512, 64), (1500, 512), (1500, 769), (3000, 769), (1500, 1100), (40, 7),
    (64, 1), (100000, 9685), (10, 12000),
])
def test_mas_plan(t_y, t_x):
    """The kernel's launch by shape: its warps cover t_x, the block fits one
    SM's shared memory, the move-left bits sit in shared memory exactly
    where they fit (at the training shape and at [1500, 512] among them);
    every t_x up to 9,685 (the earlier kernel's range) is taken at any
    t_y."""
    plan = mas_plan(t_y, t_x)
    assert plan.k in K_CHOICES and 32 * plan.k * plan.warps >= t_x
    assert 32 * plan.k * (plan.warps - 1) < t_x  # no warp without columns
    assert plan.warps + 1 <= MAX_WARPS
    assert plan.smem_bytes == mas_smem_bytes(t_y, plan.k, plan.warps, plan.dec_in_smem)
    assert plan.smem_bytes <= SMEM_BYTES
    fits = mas_smem_bytes(t_y, plan.k, plan.warps, True) <= SMEM_BYTES
    assert plan.dec_in_smem == fits
    if (t_y, t_x) in ((512, 128), (1500, 512)):
        assert plan.dec_in_smem
    with pytest.raises(ValueError):
        mas_plan(t_y, 40000)


# ---- slicing and KL primitives ----

def test_slicing_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 20, 5)).astype(np.float32)  # [b, t, c]
    wave = rng.normal(size=(3, 80)).astype(np.float32)
    lengths = np.asarray([20, 13, 6])
    u = np.asarray([0.999, 0.5, 0.3], np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    monkeypatch.setattr(noise, "rand", lambda shape, gen, dev, batch_axis=0: _t(u))
    want, want_starts = jax_masking.rand_slice_segments(
        jnp.asarray(x), jnp.asarray(lengths), 8, None)
    got, starts = masking.rand_slice_segments(
        _t(x.transpose(0, 2, 1)), _t(lengths), 8)
    assert np.array_equal(starts.numpy(), np.asarray(want_starts))
    assert starts.tolist() == [12, 3, 0]
    assert np.array_equal(got.numpy().transpose(0, 2, 1), np.asarray(want))
    want_w = jax_masking.slice_segments(
        jnp.asarray(wave)[..., None], jnp.asarray(want_starts) * 4, 32)[..., 0]
    assert np.array_equal(
        masking.slice_segments(_t(wave), starts * 4, 32).numpy(), np.asarray(want_w))


def test_kl_divergence_gaussian_matches_jax():
    rng = np.random.default_rng(1)
    a = [rng.normal(size=(2, 7, 3)).astype(np.float32) * 0.5 for _ in range(4)]
    want = np.asarray(jax_masking.kl_divergence_gaussian(*map(jnp.asarray, a)))
    got = masking.kl_divergence_gaussian(*map(_t, a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---- STFT / mel ----

STFT = dict(n_fft=64, hop=16, win_length=64)
MEL = dict(n_fft=64, n_mels=16, sampling_rate=1600, fmin=0.0, fmax=None)


@pytest.mark.parametrize("win_length", [64, 48])
def test_spectrogram_and_mel_match_jax(win_length):
    rng = np.random.default_rng(2)
    y = rng.uniform(-0.5, 0.5, size=(2, 16 * 24)).astype(np.float32)
    kw = dict(STFT, win_length=win_length)
    want = np.asarray(jax_stft.spectrogram(jnp.asarray(y), **kw))  # [b, f, bins]
    got = stft.spectrogram(_t(y), **kw).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (2, 24, 33)
    assert np.abs(got - want).max() <= 1e-4
    want_mel = np.asarray(jax_stft.mel_spectrogram(
        jnp.asarray(y), hop=16, win_length=win_length, **MEL))
    got_mel = stft.mel_spectrogram(_t(y), hop=16, win_length=win_length, **MEL)
    assert np.abs(got_mel.numpy().transpose(0, 2, 1) - want_mel).max() <= 1e-4
    want_s2m = np.asarray(jax_stft.spec_to_mel(jnp.asarray(want), **MEL))
    got_s2m = stft.spec_to_mel(_t(want.transpose(0, 2, 1)), **MEL)
    assert np.abs(got_s2m.numpy().transpose(0, 2, 1) - want_s2m).max() <= 1e-4
    assert np.array_equal(stft.mel_filterbank(1600, 64, 16, 0.0, None),
                          jax_stft.mel_filterbank(1600, 64, 16, 0.0, None))


def test_mel_is_differentiable():
    y = torch.randn(1, 160, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    stft.mel_spectrogram(y, hop=16, win_length=64, **MEL).sum().backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().max() > 0


# ---- (c) the four losses ----

def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    shapes = [(2, 9, 2, 4), (2, 3, 2, 8), (2, 40, 8)]
    fr = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    fg = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    dr = [rng.normal(size=(2, n)).astype(np.float32) for n in (5, 9, 40)]
    dg = [rng.normal(size=(2, n)).astype(np.float32) for n in (5, 9, 40)]
    tj = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    tt = lambda xs: [_t(x) for x in xs]  # noqa: E731

    want = jax_losses.feature_loss([tj(f) for f in fr], [tj(f) for f in fg])
    got = losses.feature_loss([tt(f) for f in fr], [tt(f) for f in fg])
    assert _rel(got, want) <= 1e-6

    want, want_r, want_g = jax_losses.discriminator_loss(tj(dr), tj(dg))
    got, got_r, got_g = losses.discriminator_loss(tt(dr), tt(dg))
    assert _rel(got, want) <= 1e-6
    assert all(_rel(a, b) <= 1e-6 for a, b in zip(got_r + got_g, want_r + want_g))

    want, want_each = jax_losses.generator_loss(tj(dg))
    got, got_each = losses.generator_loss(tt(dg))
    assert _rel(got, want) <= 1e-6
    assert all(_rel(a, b) <= 1e-6 for a, b in zip(got_each, want_each))

    z_p, logs_q, m_p, logs_p = (
        rng.normal(size=(2, 12, 6)).astype(np.float32) * 0.5 for _ in range(4))
    mask = (np.arange(12)[None, :] < np.asarray([12, 7])[:, None]).astype(np.float32)
    want = jax_losses.kl_loss(*map(jnp.asarray, (z_p, logs_q, m_p, logs_p, mask)))
    cf = lambda a: _t(a.transpose(0, 2, 1))  # noqa: E731
    got = losses.kl_loss(cf(z_p), cf(logs_q), cf(m_p), cf(logs_p), _t(mask[:, None]))
    assert _rel(got, want) <= 1e-6


def test_feature_loss_detaches_the_real_maps():
    r = torch.randn(2, 3, requires_grad=True)
    g = torch.randn(2, 3, requires_grad=True)
    losses.feature_loss([[r]], [[g]]).backward()
    assert r.grad is None and g.grad is not None


# ---- (f) one AdamW update against optax ----

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.enc_p = torch.nn.Module()
        self.enc_p.bert_proj = torch.nn.Linear(3, 2)
        self.enc_p.proj = torch.nn.Linear(2, 2)
        self.dec = torch.nn.Linear(2, 4)


def test_adamw_update_matches_optax():
    """Two updates from equal gradients, the rate given per step, with a
    frozen subtree: parameters agree to 1e-6 after each; the frozen leaves
    do not move but keep optimizer moments, as optax's masked set_to_zero
    after adamw does."""
    rng = np.random.default_rng(4)
    cfg_kw = dict(learning_rate=2e-4, freeze_zh_bert=True)
    port, jcfg = _Tiny(), jax_step.TrainConfig(**cfg_kw)
    names = [n for n, _ in port.named_parameters()]
    values = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
              for n, p in port.named_parameters()}
    with torch.no_grad():
        for n, p in port.named_parameters():
            p.copy_(_t(values[n]))

    def tree(flat):  # "enc_p.bert_proj.weight" -> nested dicts
        out = {}
        for n, v in flat.items():
            node = out
            *path, leaf = n.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v)
        return out

    params = tree(values)
    tx = jax_step.make_optimizer(jcfg, None, jcfg.frozen_subtrees)
    opt_state = tx.init(params)
    opt = step.make_optimizer(step.TrainConfig(**cfg_kw), port,
                              step.TrainConfig(**cfg_kw).frozen_subtrees)
    for lr in (2e-4, 1.5e-4):
        grads = {n: rng.normal(size=values[n].shape).astype(np.float32)
                 for n in names}
        upd, opt_state = tx.update(
            tree(grads), jax_step._set_lr(opt_state, lr), params)
        params = optax.apply_updates(params, upd)
        for n, p in port.named_parameters():
            p.grad = _t(grads[n])
        step._set_lr(opt, lr)
        opt.step()
        for n, p in port.named_parameters():
            node = params
            for k in n.split("."):
                node = node[k]
            assert np.abs(p.detach().numpy() - np.asarray(node)).max() <= 1e-6, n
    frozen = [n for n in names if n.startswith("enc_p.bert_proj.")]
    assert len(frozen) == 2
    for n, p in port.named_parameters():
        moved = np.abs(p.detach().numpy() - values[n]).max()
        assert (moved == 0.0) if n in frozen else (moved > 0), n
        assert opt.state[p]["exp_avg"].abs().max() > 0  # moments kept for all


def test_bf16_training_is_refused():
    """bf16 training is ported (tests/test_torch_bf16_train.py); what stays
    refused is any other training dtype: float16 or an unknown name in
    train_compute_dtype raises ValueError when the config is made, and
    bfloat16 builds a model and a bf16_run optimizer that clips."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models.synthesizer import Synthesizer

    for name in ("float16", "bf16", "fp32"):
        with pytest.raises(ValueError, match="train_compute_dtype"):
            ModelConfig(train_compute_dtype=name)
    cfg = step.TrainConfig(bf16_run=True)
    assert step.make_optimizer(cfg, _Tiny(), clip=cfg.grad_clip_d).clip == 200.0
    small = dict(inter_channels=8, hidden_channels=8, filter_channels=16,
                 n_layers=1, n_layers_trans_flow=1, n_flow_layer=1,
                 upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 upsample_initial_channel=16, gin_channels=8)
    assert Synthesizer(ModelConfig(**small, train_compute_dtype="bfloat16")).cfg.\
        train_compute_dtype == "bfloat16"
