"""PyTorch port, training slice as a whole: `Synthesizer.forward` and one
GAN step against the JAX package on the CPU, with the same random weights,
the same batch and the same noise (see tests/test_torch_train_modules.py
for the config, the weights and the noise tape). fp32; JAX at matmul
precision "highest".

Dropout is not a parity surface (the two frameworks draw other masks), and
the JAX step hard-codes `deterministic=False`. So the forward is held with
`deterministic=True` against the port in eval() mode, and the step is held
against a JAX step composed here from the JAX package's own functions in
the order of its `d_loss_fn`, `dd_loss_fn` and `g_loss_fn`
(bert_vits2_tpu/train/step.py:294-421) with `deterministic=True`, while the
port runs its real `step` with every dropout rate set to 0.

Tolerances: the forward's `attn` and `ids_slice` exactly, every other output
to 1e-4 max-abs-err (errors of ~1e-6 per module compound through the
posterior encoder, the flow, the SDP and the vocoder); the step's losses by
name to 1e-4 relative; every gradient leaf to 1e-3 of that leaf's norm
(gradients pass through every module twice and sum over the batch).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bert_vits2_tpu.ops.masking import slice_segments as jax_slice_segments
from bert_vits2_tpu.ops.stft import mel_spectrogram as jax_mel_spectrogram
from bert_vits2_tpu.ops.stft import spec_to_mel as jax_spec_to_mel
from bert_vits2_tpu.train import losses as jax_losses
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
from test_torch_modules import _t
from test_torch_train_modules import (
    DD,
    MPD,
    TINY,
    build_discriminators,
    build_pair,
    patch_noise,
)

DATA = dict(sampling_rate=1600, filter_length=64, hop_length=16, win_length=64,
            n_mel_channels=16, mel_fmin=0.0, mel_fmax=None)
MAS_DRAW = 1  # the forward's second draw is the MAS noise [b, t_y, t_x]
NOISE_SEED = 6
LR = 1e-4
BATCH_KEYS = ("x", "x_lengths", "spec", "spec_lengths", "sid", "tone",
              "language", "bert", "ja_bert", "en_bert")


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


def _jax_forward(jax_model, params, batch):
    return jax_model.apply(
        {"params": params}, *(batch[k] for k in BATCH_KEYS),
        mas_noise_scale=0.01, deterministic=True,
        rngs={"noise": jax.random.key(0)})


def _to_port_layout(name, a):
    a = np.asarray(a)
    if name in ("x_mask", "y_mask"):
        return a[:, None, :]
    if a.ndim == 3 and name != "attn":
        return a.transpose(0, 2, 1)
    return a


def _jax_step(jax_model, jmpd, jdd, data_cfg, seg):
    """The JAX step's mathematics with deterministic=True: D update, duration
    D update, then the generator loss against the updated discriminators.
    The generator forward is traced once (`jax.vjp`) and serves all three
    losses, as the step's two forwards with equal rngs do."""
    hop = data_cfg.hop_length
    mel_args = (data_cfg.filter_length, data_cfg.n_mel_channels,
                data_cfg.sampling_rate)
    tx_d = jax_step.make_optimizer(jax_step.TrainConfig(), None)
    sg = jax.lax.stop_gradient

    def update(params, grads):
        opt = jax_step._set_lr(tx_d.init(params), LR)
        upd, _ = tx_d.update(grads, opt, params)
        return optax.apply_updates(params, upd)

    def dd_pairs(p_dd, o, sg):
        args = [sg(o[k]) for k in ("x_hidden", "x_mask", "logw_")]
        r1, g1 = jdd.apply({"params": p_dd}, *args, sg(o["logw"]), g=sg(o["g"]))
        r2, g2 = jdd.apply({"params": p_dd}, *args, sg(o["logw_sdp"]), g=sg(o["g"]))
        return [r1, r2], [g1, g2]

    def run(p_g, p_d, p_dd, batch):
        def forward(p):
            o = _jax_forward(jax_model, p, batch)
            return o, o.pop("ids_slice")

        out, vjp_fn, ids = jax.vjp(forward, p_g, has_aux=True)
        mel = jax_spec_to_mel(batch["spec"], *mel_args, data_cfg.mel_fmin,
                              data_cfg.mel_fmax)
        y_mel = jax_slice_segments(mel, ids, seg)
        y_slice = jax_slice_segments(batch["wave"][..., None], ids * hop,
                                     seg * hop)[..., 0]

        def d_loss_fn(p):
            y_d_r, y_d_g, _, _ = jmpd.apply({"params": p}, y_slice,
                                            sg(out["wave_slice"]))
            return jax_losses.discriminator_loss(y_d_r, y_d_g)[0]

        def dd_loss_fn(p):
            return jax_losses.discriminator_loss(*dd_pairs(p, out, sg))[0]

        loss_d, grads_d = jax.value_and_grad(d_loss_fn)(p_d)
        loss_dd, grads_dd = jax.value_and_grad(dd_loss_fn)(p_dd)
        p_d2, p_dd2 = update(p_d, grads_d), update(p_dd, grads_dd)

        def g_loss_fn(o):
            yh = o["wave_slice"]
            yh_mel = jax_mel_spectrogram(yh, *mel_args, hop, data_cfg.win_length,
                                         data_cfg.mel_fmin, data_cfg.mel_fmax)
            _, y_d_g, fmap_r, fmap_g = jmpd.apply({"params": p_d2}, y_slice, yh)
            aux = {
                "loss/g/gen": jax_losses.generator_loss(y_d_g)[0],
                "loss/g/fm": jax_losses.feature_loss(fmap_r, fmap_g),
                "loss/g/mel": jnp.mean(jnp.abs(y_mel - yh_mel)) * 45.0,
                "loss/g/dur": jnp.sum(o["l_length"]),
                "loss/g/kl": jax_losses.kl_loss(o["z_p"], o["logs_q"], o["m_p"],
                                                o["logs_p"], o["y_mask"]),
                "loss/g/dur_gen": jax_losses.generator_loss(
                    dd_pairs(p_dd2, o, lambda a: a)[1])[0],
            }
            return sum(aux.values()), aux

        (loss_g, aux), d_out = jax.value_and_grad(g_loss_fn, has_aux=True)(out)
        (grads_g,) = vjp_fn(d_out)
        metrics = dict(aux)
        metrics.update({"loss/d/total": loss_d, "loss/dur_disc/total": loss_dd,
                        "loss/g/total": loss_g,
                        "grad_norm_g": optax.global_norm(grads_g),
                        "grad_norm_d": optax.global_norm(grads_d),
                        "grad_norm_dur": optax.global_norm(grads_dd)})
        return dict(out, ids_slice=ids), metrics, grads_g, grads_d, grads_dd

    return jax.jit(run)


@pytest.fixture(scope="module")
def ran():
    """Both packages' models with equal weights, one batch, and the JAX
    side's forward outputs, losses and gradients on it (one compile)."""
    jax_model, p_g, synth = build_pair(seed=30)
    (jmpd, p_d, mpd), (jdd, p_dd, dd) = build_discriminators(seed=32)
    batch = make_batch()
    with pytest.MonkeyPatch.context() as mp:
        patch_noise(mp, seed=NOISE_SEED)
        run = _jax_step(jax_model, jmpd, jdd, jax_step.DataConfig(**DATA),
                        TINY["segment_size"])
        # the compile dominates this file: skip LLVM's expensive passes
        run = run.lower(p_g, p_d, p_dd, batch).compile(compiler_options={
            "xla_llvm_disable_expensive_passes": True,
            "xla_backend_optimization_level": 0})
        result = jax.device_get(run(p_g, p_d, p_dd, batch))
    return (synth, mpd, dd), batch, result


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
