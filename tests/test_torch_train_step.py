"""PyTorch port, training slice as a whole: `Synthesizer.forward` and one
GAN step against the JAX package on the CPU, with the same random weights,
the same batch and the same noise (see tests/test_torch_train_modules.py
for the config, the weights and the noise tape). fp32; JAX at matmul
precision "highest".

Dropout is not a parity surface (the two frameworks draw other masks), and
the JAX step hard-codes `deterministic=False`. So the forward is held with
`deterministic=True` against the port in eval() mode, and the step is held
against a JAX step composed from the JAX package's own functions in the
order of its `d_loss_fn`, `dd_loss_fn` and `g_loss_fn`
(bert_vits2_tpu/train/step.py:294-421) with `deterministic=True`, while the
port runs its real `step` with every dropout rate set to 0. The JAX side's
values come from tests/goldens/train_step.npz, which
tests/goldens/make_train_step.py (that composition) computes from this
file's `reference_inputs`; the tests check the inputs' fingerprint first.

Tolerances: the forward's `attn` and `ids_slice` exactly, every other output
to 1e-4 max-abs-err (errors of ~1e-6 per module compound through the
posterior encoder, the flow, the SDP and the vocoder); the step's losses by
name to 1e-4 relative; every gradient leaf to 1e-3 of that leaf's norm
(gradients pass through every module twice and sum over the batch).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from bert_vits2_tpu.train import step as jax_step
from bert_vits2_tpu_torch.compat.params import (
    from_jax_dur_disc_params,
    from_jax_mpd_params,
    from_jax_params,
)
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models.discriminators import (
    DurationDiscriminator,
    MultiPeriodDiscriminator,
    WavLMDiscriminator,
)
from bert_vits2_tpu_torch.models.slm import WavLMConfig
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
from bert_vits2_tpu_torch.train import (
    DataConfig,
    Models,
    TrainConfig,
    init_train_state,
    make_train_step,
)
import golden_values
from test_torch_modules import _t
from test_torch_train_modules import (
    DD,
    MPD,
    TINY,
    build_discriminators,
    build_pair,
    patch_noise,
)
from torch_one_thread import one_torch_thread_except

DATA = dict(sampling_rate=1600, filter_length=64, hop_length=16, win_length=64,
            n_mel_channels=16, mel_fmin=0.0, mel_fmax=None)
MAS_DRAW = 1  # the forward's second draw is the MAS noise [b, t_y, t_x]
NOISE_SEED = 6
LR = 1e-4
BATCH_KEYS = ("x", "x_lengths", "spec", "spec_lengths", "sid", "tone",
              "language", "bert", "ja_bert", "en_bert")
GRADS = ("grads_g", "grads_d", "grads_dd")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "train_step.npz")

# the gradient bound holds in torch's default summation order (1.11e-3 of
# 1e-3 on sdp.post_flows.0.logs with one thread)
one_thread_but_gradients = one_torch_thread_except("test_train_step_losses_and_gradients")


def make_batch(b=4, t_x=9, t_y=24, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        x=rng.integers(1, 20, (b, t_x)),
        x_lengths=np.asarray([t_x] * (b // 2) + [t_x - 3] * (b - b // 2)),
        spec=f32(0.3 * rng.normal(size=(b, t_y, 33))),
        spec_lengths=np.asarray([t_y] * (b // 2) + [t_y - 8] * (b - b // 2)),
        wave=f32(rng.uniform(-0.5, 0.5, size=(b, t_y * 16))),
        sid=rng.integers(0, 4, (b,)),
        tone=rng.integers(0, 12, (b, t_x)),
        language=rng.integers(0, 3, (b, t_x)),
        bert=f32(0.3 * rng.normal(size=(b, t_x, 16))),
        ja_bert=f32(0.3 * rng.normal(size=(b, t_x, 16))),
        en_bert=f32(0.3 * rng.normal(size=(b, t_x, 16))),
    )


def _to_port_layout(name, a):
    a = np.asarray(a)
    if name in ("x_mask", "y_mask"):
        return a[:, None, :]
    if a.ndim == 3 and name != "attn":
        return a.transpose(0, 2, 1)
    return a


def reference_inputs():
    """(JAX Synthesizer, its random tree, the port's model), the same for
    the multi-period and the duration discriminator, and the batch: what
    tests/goldens/make_train_step.py computes the JAX values from."""
    return (build_pair(seed=30), *build_discriminators(seed=32), make_batch())


def fingerprint(p_g, p_d, p_dd, batch) -> np.ndarray:
    """Of every parameter and batch value, the models' configs and the
    step's constants."""
    consts = [LR, NOISE_SEED, MAS_DRAW, TINY, MPD, DD, DATA]
    return golden_values.fingerprint(p_g, p_d, p_dd, batch, consts)


@pytest.fixture(scope="module")
def ran():
    """Both packages' models with equal weights, one batch, and the JAX
    side's forward outputs, losses and gradients on it, from
    tests/goldens/train_step.npz (written by tests/goldens/make_train_step.py
    from `reference_inputs`, whose fingerprint must match)."""
    (_, p_g, synth), (_, p_d, mpd), (_, p_dd, dd), batch = reference_inputs()
    want = golden_values.load(GOLDENS, fingerprint(p_g, p_d, p_dd, batch),
                              "tests/goldens/make_train_step.py")
    grads = [golden_values.unflatten(golden_values.pick(want, name + "/"))
             for name in GRADS]
    return (synth, mpd, dd), batch, (golden_values.pick(want, "out/"),
                                     golden_values.pick(want, "metric/"), *grads)


def test_training_forward(ran, monkeypatch):
    """(d) `Synthesizer.forward` whole, deterministic, explicit noise."""
    (port, _, _), batch, (want, *_) = ran
    patch_noise(monkeypatch, seed=NOISE_SEED, keep_layout=(MAS_DRAW,))
    with torch.no_grad():
        got = port(*(_t(batch[k]) for k in BATCH_KEYS), mas_noise_scale=0.01)
    assert set(got) == set(want)
    attn = got["attn"].numpy()
    if not np.array_equal(attn, want["attn"]):
        first = np.argwhere(attn != want["attn"])[0]
        pytest.fail(f"attn differs first at [b, y, x] = {first}")
    assert np.array_equal(got["ids_slice"].numpy(), want["ids_slice"])
    # rows sum to 1 on valid frames, to 0 beyond; tokens advance monotonically
    assert np.array_equal(attn.sum(2), got["y_mask"][:, 0].numpy())
    token = attn.argmax(2)
    for i, n in enumerate(batch["spec_lengths"]):
        steps = np.diff(token[i, :n])
        assert (steps >= 0).all() and (steps <= 1).all()
    for name in sorted(set(got) - {"attn", "ids_slice"}):
        err = np.abs(got[name].numpy() - _to_port_layout(name, want[name])).max()
        assert err <= 1e-4, (name, err)


def _no_dropout(*modules):
    for module in modules:
        for m in module.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
            if hasattr(m, "p_dropout"):
                m.p_dropout = 0.0


def _check_grads(module, want_sd, skip=()):
    """Every gradient leaf to 1e-3 of its own norm. An attention key bias
    has no gradient at all (a constant added to every key shifts each score
    row by a constant, which the softmax ignores): both sides hold rounding
    noise there, held to 1e-6 of the whole gradient's norm instead."""
    total = np.sqrt(sum(float(w.square().sum()) for w in want_sd.values()))
    for name, p in module.named_parameters():
        if name in skip:
            continue
        want, got = want_sd[name].numpy(), p.grad.numpy()
        if name.endswith("conv_k.bias"):
            assert max(np.abs(want).max(), np.abs(got).max()) <= 1e-6 * total, name
            continue
        rel = np.abs(got - want).max() / np.linalg.norm(want)
        assert rel <= 1e-3, (name, rel)


def test_train_step_losses_and_gradients(ran, monkeypatch):
    """(e) The port's real `step`, dropout rates 0, against the JAX step's
    mathematics: every loss by name, and the gradients of all three
    parameter sets through the name and layout map of `from_jax_params`."""
    (synth, mpd, dd), batch, (_, want, grads_g, grads_d, grads_dd) = ran
    patch_noise(monkeypatch, seed=NOISE_SEED, keep_layout=(MAS_DRAW,))
    models = Models(synth, mpd, dd, None)
    _no_dropout(synth, mpd, dd)
    cfg = TrainConfig(learning_rate=LR)
    state = init_train_state(models, cfg)
    step = make_train_step(models, cfg, DataConfig(**DATA), TINY["segment_size"])
    state, got = step(state, {k: _t(v) for k, v in batch.items()}, None, LR)
    assert state.step == 1
    # torch's LSTM has two bias vectors where the JAX cell has one: both
    # receive the one bias's gradient, so the port's norm counts it twice
    want_dd = from_jax_dur_disc_params(grads_dd)
    ih = [n for n in want_dd if "bias_ih" in n]
    twice = sum(float(want_dd[n.replace("bias_ih", "bias_hh")].square().sum())
                for n in ih)
    want["grad_norm_dur"] = np.sqrt(float(want["grad_norm_dur"]) ** 2 + twice)
    for name, w in want.items():
        rel = abs(float(got[name]) - float(w)) / abs(float(w))
        assert rel <= 1e-4, (name, float(got[name]), float(w))
    assert float(got["learning_rate"]) == pytest.approx(LR)

    _check_grads(synth, from_jax_params(grads_g))
    _check_grads(mpd, from_jax_mpd_params(grads_d, MPD["periods"]))
    _check_grads(dd, want_dd, skip=ih)
    for n in ih:
        assert torch.equal(dd.get_parameter(n).grad,
                           dd.get_parameter(n.replace("bias_ih", "bias_hh")).grad)


@pytest.fixture
def seeded():
    """torch's global generator (module init, dropout masks) seeded for one
    test and restored after it."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        yield


def test_train_step_twice_with_dropout(seeded):
    """(g) Two steps in train() mode: finite metrics under the JAX step's
    names, the counter and the MAS noise scale advance, frozen leaves stay,
    every other parameter set moves, and the generator loss is taken
    against the UPDATED discriminators."""
    synth = Synthesizer(ModelConfig(**TINY))
    mpd, dd = MultiPeriodDiscriminator(**MPD), DurationDiscriminator(**DD)
    models = Models(synth, mpd, dd, None)
    cfg = TrainConfig(learning_rate=1e-3, freeze_zh_bert=True, freeze_jp_bert=True)
    state = init_train_state(models, cfg)
    scales = []
    real_forward = synth.forward
    synth.forward = lambda *a, **k: (scales.append(k["mas_noise_scale"])
                                     or real_forward(*a, **k))
    seen = {}
    real_mpd = mpd.forward

    def spy(y, y_hat):  # the D weights each MPD call of a step sees
        seen.setdefault(state.step, []).append(
            mpd.discriminators[0].conv_post.weight_v.detach().clone())
        return real_mpd(y, y_hat)

    mpd.forward = spy
    step = make_train_step(models, cfg, DataConfig(**DATA), TINY["segment_size"],
                           mas_noise_initial=0.01, mas_noise_delta=0.004)
    before = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in models[:3]]
    batch = {k: _t(v) for k, v in make_batch(seed=2).items()}
    gen = torch.Generator().manual_seed(0)
    names = {"loss/d/total", "grad_norm_d", "loss/dur_disc/total",
             "grad_norm_dur", "loss/g/gen", "loss/g/fm", "loss/g/mel",
             "loss/g/dur", "loss/g/kl", "loss/g/dur_gen", "loss/g/total",
             "grad_norm_g", "learning_rate"}
    for i in range(2):
        state, metrics = step(state, batch, gen, 1e-3)
        assert set(metrics) == names
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        assert state.step == i + 1
    assert scales == pytest.approx([0.01, 0.006])
    assert all(m.training for m in models[:3])
    # within a step the second MPD call (the generator's) sees other weights
    # than the first (the discriminator's own update came between)
    for calls in seen.values():
        assert len(calls) == 2 and not torch.equal(calls[0], calls[1])
    frozen = ("enc_p.bert_proj.", "enc_p.ja_bert_proj.")
    for module, old in zip(models[:3], before):
        moved = {n: not torch.equal(p.detach(), old[n])
                 for n, p in module.named_parameters()}
        assert not any(did for n, did in moved.items() if n.startswith(frozen))
        assert sum(moved.values()) >= 0.9 * (len(moved) - 4)
        if module is synth:  # the projection that is not frozen still trains
            assert moved["enc_p.en_bert_proj.weight"]
            assert sum(n.startswith(frozen) for n in moved) == 4


def test_build_models_and_init_params():
    """`build_models` + `init_params` + `init_train_state` +
    `make_train_step`, the way a trainer drives the step: the seed decides
    the parameters, and one step runs."""
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    cfg = ModelConfig(**dict(TINY, upsample_initial_channel=32))
    models = init_params(build_models(cfg, device="cpu"), cfg, seed=7)
    again = init_params(build_models(cfg, device="cpu"), cfg, seed=7)
    other = init_params(build_models(cfg, device="cpu"), cfg, seed=8)
    for m, a in zip(models[:3], again[:3]):
        assert all(torch.equal(p, q) for p, q in
                   zip(m.state_dict().values(), a.state_dict().values()))
    assert not torch.equal(models.synthesizer.emb_g.weight,
                           other.synthesizer.emb_g.weight)
    assert models.wavlm_disc is None and models.dur_disc is not None
    assert build_models(cfg, use_dur_disc=False, device="cpu").dur_disc is None
    # the WavLM discriminator of the SLM losses, at model.slm's widths (the
    # default V2.3 ones here), drawn from the seed with the rest
    with_wd = init_params(build_models(cfg, use_wavlm_disc=True, device="cpu",
                                       wavlm=WavLMConfig()), cfg, seed=7)
    wd = with_wd.wavlm_disc
    assert isinstance(wd, WavLMDiscriminator) and wd.training
    assert wd.pre.weight_v.shape == (cfg.slm_initial_channel,
                                     cfg.slm_hidden * cfg.slm_layers, 1)
    for m, a in zip(models[:3], with_wd[:3]):  # built last: the rest unchanged
        assert all(torch.equal(p, q) for p, q in
                   zip(m.state_dict().values(), a.state_dict().values()))
    with pytest.raises(ValueError, match="nlayers 12"):
        build_models(dataclasses.replace(cfg, slm_layers=12),
                     use_wavlm_disc=True, device="cpu", wavlm=WavLMConfig())
    with pytest.raises(RuntimeError):
        build_models(cfg)  # the default device is the card
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        jax_step.TrainConfig())
    assert dataclasses.asdict(DataConfig()) == dataclasses.asdict(
        jax_step.DataConfig())
