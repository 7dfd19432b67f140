"""One GAN training step (reference: train_ms.py:394-607).

Counterpart of `bert_vits2_tpu/train/step.py`. The order of the updates is
the reference's: the waveform discriminators, the duration discriminator,
the WavLM discriminator of the SLM losses, then the generator against the
UPDATED discriminators. The JAX step runs the generator forward twice with
the same random numbers (once without gradients for the discriminator
updates, once under `grad`); here one forward with its graph serves both,
and the discriminator losses see its outputs detached, which is the same
mathematics. The frozen WavLM runs once on the real slice (no graph) and
once on the fake one (with its graph, detached for the WavLM
discriminator's update), where the JAX step runs it on each twice.

PyTorch's idiom replaces the functional state: the parameters live in the
modules of `Models` and are updated in place, the optimizers are
`torch.optim.AdamW` objects held by `TrainState`, and `step` returns the
state it was given with its counter advanced. Metrics are 0-d tensors on
the device, so the step itself never waits for the card.

With `bf16_run` (the reference's autocast(bf16), train_ms.py:458-480) the
step follows the JAX step's bf16 policy (bert_vits2_tpu/train/step.py:
132-137, 220-226): the synthesizer computes its hot stages in bf16 when its
config's `train_compute_dtype` is "bfloat16" (`Trainer` sets both from
config.json's `bf16_run`), the multi-period discriminator takes y and
y_hat in bf16 in both of its passes, the duration and WavLM
discriminators, the SLM and every loss stay float32, and each optimizer
first clips its gradients by their global norm (`grad_clip_g` for the
generator, `grad_clip_d` for the three discriminators) as optax's
`clip_by_global_norm` does. The parameters stay float32 either way.

Data parallelism (`make_train_step(mesh=)`, the JAX step's one program over
a batch sharded on the mesh's data axis): each rank steps on its own rows
inside a data shard (`parallel/data.py`), so its noise, its dropout masks
and the masked ratios' denominators are the global batch's; between each
backward and the clip, the optimizer's gradients are averaged over the
data group in one all-reduce, so the grad norms and the clip are the
global batch's, as optax's are; the losses come back averaged over the
ranks. An explicit all-reduce, not `DistributedDataParallel`: the step
runs the discriminators twice, the second time with their parameters'
gradients off, which DDP's reducer does not expect of a wrapped module,
and the all-reduce and the parameters' broadcast are the only collectives
(both of which gloo takes on CUDA tensors). The hash dropout's seeds come
from a generator seeded from the step's generator and counter, alike on
every rank and in one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from bert_vits2_tpu_torch.ops import noise
from bert_vits2_tpu_torch.parallel.data import data_shard, reduce_gradients, reduce_mean
from bert_vits2_tpu_torch.ops.masking import slice_segments
from bert_vits2_tpu_torch.ops.stft import mel_spectrogram, spec_to_mel
from bert_vits2_tpu_torch.train.losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
)

WEIGHT_DECAY = 0.01  # the reference's AdamW default, as in the JAX step


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """DSP/data parameters (configs/config.json `data` section)."""

    sampling_rate: int = 44100
    filter_length: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    n_mel_channels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: float | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization parameters (configs/config.json `train` section)."""

    learning_rate: float = 2e-4
    betas: tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.99995
    c_mel: float = 45.0
    c_kl: float = 1.0
    bf16_run: bool = False
    grad_clip_g: float = 500.0
    grad_clip_d: float = 200.0
    seed: int = 42
    # config.json train.freeze_{ZH,EN,JP}_bert: the reference stops updates
    # to the per-language BERT projections (train_ms.py:204-217)
    freeze_zh_bert: bool = False
    freeze_en_bert: bool = False
    freeze_jp_bert: bool = False
    freeze_emo: bool = False

    @property
    def frozen_subtrees(self) -> tuple[tuple[str, ...], ...]:
        """Generator submodule paths whose updates are zeroed."""
        out = []
        if self.freeze_zh_bert:
            out.append(("enc_p", "bert_proj"))
        if self.freeze_en_bert:
            out.append(("enc_p", "en_bert_proj"))
        if self.freeze_jp_bert:
            out.append(("enc_p", "ja_bert_proj"))
        if self.freeze_emo:
            out.append(("enc_p", "emo_proj"))
            out.append(("enc_p", "emo_quantizer"))
            out.append(("enc_p", "in_feature_net"))
            out.append(("enc_p", "out_feature_net"))
        return tuple(out)


class Models(NamedTuple):
    synthesizer: nn.Module  # Synthesizer
    mpd: nn.Module  # MultiPeriodDiscriminator
    dur_disc: nn.Module | None  # DurationDiscriminator
    wavlm_disc: nn.Module | None  # WavLMDiscriminator (the SLM losses)


@dataclasses.dataclass
class TrainState:
    """The step counter and the optimizers; the parameters are the modules'."""

    step: int
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    opt_dd: torch.optim.Optimizer | None
    opt_wd: torch.optim.Optimizer | None = None


def make_optimizer(cfg: TrainConfig, module: nn.Module,
                   frozen: tuple[tuple[str, ...], ...] = (),
                   clip: float | None = None) -> torch.optim.AdamW:
    """AdamW over the module's parameters, the learning rate set per step.

    Parameters under a `frozen` submodule path form a second group whose
    learning rate stays 0: their update is zero (the weight decay too, which
    scales with the rate) while their moments are kept, so the optimizer
    state has the same entries whether or not anything is frozen. With
    `bf16_run`, `clip` is the global norm the step clips the gradients to
    first (the optimizer's `clip` attribute; None without bf16_run, as the
    JAX `make_optimizer` chains `clip_by_global_norm` only then)."""
    prefixes = tuple(".".join(p) + "." for p in frozen)
    free, held = [], []
    for name, p in module.named_parameters():
        (held if name.startswith(prefixes) and prefixes else free).append(p)
    groups = [{"params": free, "frozen": False}]
    if held:
        groups.append({"params": held, "frozen": True, "lr": 0.0})
    opt = torch.optim.AdamW(groups, lr=cfg.learning_rate, betas=cfg.betas,
                            eps=cfg.eps, weight_decay=WEIGHT_DECAY)
    opt.clip = clip if cfg.bf16_run else None
    return opt


def init_train_state(models: Models, cfg: TrainConfig) -> TrainState:
    """The duration and WavLM discriminators take the discriminator's
    optimizer (grad_clip_d), as in the JAX step."""
    d_clip = cfg.grad_clip_d
    return TrainState(
        step=0,
        opt_g=make_optimizer(cfg, models.synthesizer, cfg.frozen_subtrees,
                             cfg.grad_clip_g),
        opt_d=make_optimizer(cfg, models.mpd, clip=d_clip),
        opt_dd=(make_optimizer(cfg, models.dur_disc, clip=d_clip)
                if models.dur_disc is not None else None),
        opt_wd=(make_optimizer(cfg, models.wavlm_disc, clip=d_clip)
                if models.wavlm_disc is not None else None),
    )


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        if not group["frozen"]:
            group["lr"] = lr


def clip_by_global_norm(grads: list[torch.Tensor], norm: torch.Tensor,
                        clip: float) -> None:
    """Scale the gradients in place to a global norm of at most `clip`, by
    optax's formula (`clip_by_global_norm`: g where norm < clip, else
    g / norm * clip); on the device, with no host sync. Unlike
    `torch.nn.utils.clip_grad_norm_` it adds no 1e-6 to the norm."""
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    torch._foreach_mul_(grads, scale)


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor,
            lr: float, mesh=None) -> torch.Tensor:
    """One optimizer update from `loss` -> the gradients' global norm,
    before any clipping. The norm covers the frozen group's gradients too,
    as optax's clip runs before its `masked(set_to_zero)`. Under a data
    mesh the gradients are first averaged over its data group."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for g in opt.param_groups for p in g["params"]
             if p.grad is not None]
    if mesh is not None:
        reduce_gradients(grads, mesh.data_group, mesh.n_data)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if opt.clip is not None:
        clip_by_global_norm(grads, norm, opt.clip)
    _set_lr(opt, lr)
    opt.step()
    return norm


@contextlib.contextmanager
def _no_param_grads(*modules):
    """Inside, the modules' parameters collect no gradients (their inputs
    still do): the generator's pass through the discriminators."""
    params = [p for m in modules if m is not None for p in m.parameters()]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def expand_bert(batch: dict, generator: torch.Generator | None) -> dict:
    """Fast-collate batches (`data.load_collated_batch`) carry only the
    active language's BERT features (`bert` [b, t, dim]) and `utt_lang`
    [b]: draw the inactive languages' N(0,1) placeholders here, on the
    batch's device, from the step's generator (the JAX step's `expand_bert`,
    bert_vits2_tpu/train/step.py:246-262). The placeholders are pure noise,
    as the reference's host-side randn is (data_utils.py:159-168). Other
    batches pass through unchanged."""
    if "utt_lang" not in batch:
        return batch
    active = batch["bert"]
    draw = noise.randn((3, *active.shape), generator, active.device, active.dtype,
                       batch_axis=1)
    sel = batch["utt_lang"][:, None, None]
    batch = dict(batch)
    batch["bert"] = torch.where(sel == 0, active, draw[0])
    batch["ja_bert"] = torch.where(sel == 1, active, draw[1])
    batch["en_bert"] = torch.where(sel == 2, active, draw[2])
    return batch


def _dropout_seeds(generator: torch.Generator | None,
                   step: int) -> torch.Generator | None:
    """The hash dropout's seed generator of one step: seeded from the step
    generator's seed and the step counter (no draw from it, no host sync),
    so every rank holds the same one; None without a generator (torch's
    global generator then)."""
    if generator is None:
        return None
    seed = np.random.SeedSequence([generator.initial_seed(), step]).generate_state(1)
    return torch.Generator().manual_seed(int(seed[0]))


def make_train_step(models: Models, train_cfg: TrainConfig,
                    data_cfg: DataConfig, segment_size_frames: int,
                    mas_noise_initial: float = 0.01,
                    mas_noise_delta: float = 2e-6,
                    slm: nn.Module | None = None, mesh=None) -> Callable:
    """Build the train step: (state, batch, generator, lr) -> (state, metrics).

    batch keys (tensors on the models' device): x, x_lengths, spec
    [b, t, spec_ch], spec_lengths, wave [b, t_samples], sid, tone, language,
    bert, ja_bert, en_bert [b, t_x, dim], or in place of the last two
    utt_lang [b] (see `expand_bert`). `generator` is the
    `torch.Generator` of the step's noise; `lr` the learning rate of this
    step. The modules are put in train() mode.

    slm: the frozen `models.slm.SLM` (wave at the data's rate -> WavLM
    hidden states) of the SLM losses. It comes with `models.wavlm_disc`:
    each needs the other.

    With `train_cfg.bf16_run` the multi-period discriminator takes its
    waves in bf16 and the optimizers clip (module note); the synthesizer's
    own `train_compute_dtype` decides its dtype.

    mesh: a `parallel.Mesh` of several processes (`make_mesh` after
    `init_distributed`): `batch` is then this rank's rows, every rank has
    the same number, the same padded shapes and the same generator seed,
    and the step is the one-process step on the concatenated global batch
    (module note). Its model axis must be 1."""
    if mesh is not None and (not mesh.distributed or mesh.n_model != 1):
        raise ValueError("the train step takes a data mesh of several processes "
                         "(make_mesh after init_distributed) with n_model 1")
    synth, mpd, dur_disc, wavlm_disc = models
    if (slm is None) != (wavlm_disc is None):
        raise ValueError("the SLM losses need both the frozen SLM and the WavLM "
                         "discriminator (Models.wavlm_disc), or neither")
    dc = data_cfg
    hop, seg = dc.hop_length, segment_size_frames
    disc_dtype = torch.bfloat16 if train_cfg.bf16_run else torch.float32
    mel_args = (dc.filter_length, dc.n_mel_channels, dc.sampling_rate)

    def dur_disc_pairs(out, detach):
        pick = (lambda k: out[k].detach()) if detach else (lambda k: out[k])
        hx, xm, lw_, g = (pick(k) for k in ("x_hidden", "x_mask", "logw_", "g"))
        r1, g1 = dur_disc(hx, xm, lw_, pick("logw"), g=g)
        r2, g2 = dur_disc(hx, xm, lw_, pick("logw_sdp"), g=g)
        return [r1, r2], [g1, g2]

    def step(state: TrainState, batch: dict, generator: torch.Generator | None,
             lr: float):
        b = batch["x"].shape[0]
        n = 1 if mesh is None else mesh.n_data
        shard = data_shard(b * (0 if mesh is None else mesh.data_rank), b * n,
                           None if mesh is None else mesh.data_group, n,
                           _dropout_seeds(generator, state.step))
        with shard:
            state, metrics = one_step(state, batch, generator, lr)
        if mesh is not None:
            losses = {k: v for k, v in metrics.items() if k.startswith("loss/")}
            metrics.update(reduce_mean(losses, mesh.data_group, n))
        return state, metrics

    def one_step(state, batch, generator, lr):
        for m in (synth, mpd, dur_disc, wavlm_disc):
            if m is not None:
                m.train()
        metrics = {}
        batch = expand_bert(batch, generator)
        mas_noise_scale = max(mas_noise_initial - mas_noise_delta * state.step, 0.0)

        # ---- 1. generator forward, once, with its graph ----
        out = synth(batch["x"], batch["x_lengths"], batch["spec"],
                    batch["spec_lengths"], batch["sid"], batch["tone"],
                    batch["language"], batch["bert"], batch["ja_bert"],
                    batch["en_bert"], mas_noise_scale=mas_noise_scale,
                    generator=generator)
        ids_slice, y_hat = out["ids_slice"], out["wave_slice"]
        mel = spec_to_mel(batch["spec"].transpose(1, 2), *mel_args,
                          dc.mel_fmin, dc.mel_fmax)
        y_mel = slice_segments(mel, ids_slice, seg)
        y = slice_segments(batch["wave"], ids_slice * hop, seg * hop)

        # ---- 2a. waveform discriminators (train_ms.py:508-556) ----
        y_d_r, y_d_g, _, _ = mpd(y.to(disc_dtype), y_hat.detach().to(disc_dtype))
        loss_disc, _, _ = discriminator_loss(y_d_r, y_d_g)
        metrics["loss/d/total"] = loss_disc.detach()
        metrics["grad_norm_d"] = _update(state.opt_d, loss_disc, lr, mesh)

        # ---- 2b. duration discriminator (train_ms.py:514-548) ----
        if dur_disc is not None:
            loss_dur_disc, _, _ = discriminator_loss(*dur_disc_pairs(out, True))
            metrics["loss/dur_disc/total"] = loss_dur_disc.detach()
            metrics["grad_norm_dur"] = _update(state.opt_dd, loss_dur_disc, lr, mesh)

        # ---- 2c. WavLM discriminator (train_ms.py:558-568) ----
        if slm is not None:
            with torch.no_grad():
                hs_real = slm(y)
            hs_fake = slm(y_hat)  # with its graph: the generator's SLM losses
            emb_fake = slm.embed(hs_fake)
            d_r = wavlm_disc(slm.embed(hs_real))
            d_g = wavlm_disc(emb_fake.detach())
            loss_wd = torch.mean((1.0 - d_r) ** 2) + torch.mean(d_g ** 2)
            metrics["loss/wd/total"] = loss_wd.detach()
            metrics["grad_norm_wd"] = _update(state.opt_wd, loss_wd, lr, mesh)

        # ---- 3. generator, against the updated discriminators ----
        with _no_param_grads(mpd, dur_disc, wavlm_disc):
            y_hat_mel = mel_spectrogram(y_hat.float(), *mel_args, hop,
                                        dc.win_length, dc.mel_fmin, dc.mel_fmax)
            _, y_d_g, fmap_r, fmap_g = mpd(y.to(disc_dtype), y_hat.to(disc_dtype))
            loss_gen, _ = generator_loss(y_d_g)
            loss_fm = feature_loss(fmap_r, fmap_g)
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * train_cfg.c_mel
            loss_dur = torch.sum(out["l_length"].float())
            loss_kl = kl_loss(out["z_p"], out["logs_q"], out["m_p"],
                              out["logs_p"], out["y_mask"]) * train_cfg.c_kl
            loss_all = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
            aux = {"loss/g/gen": loss_gen, "loss/g/fm": loss_fm,
                   "loss/g/mel": loss_mel, "loss/g/dur": loss_dur,
                   "loss/g/kl": loss_kl}
            if dur_disc is not None:
                loss_dur_gen, _ = generator_loss(dur_disc_pairs(out, False)[1])
                loss_all = loss_all + loss_dur_gen
                aux["loss/g/dur_gen"] = loss_dur_gen
            if slm is not None:
                loss_lm = sum(torch.mean(torch.abs(r - f))
                              for r, f in zip(hs_real, hs_fake))
                loss_lm_gen = torch.mean((1.0 - wavlm_disc(emb_fake)) ** 2)
                loss_all = loss_all + loss_lm + loss_lm_gen
                aux["loss/g/lm"] = loss_lm
                aux["loss/g/lm_gen"] = loss_lm_gen
            grad_norm_g = _update(state.opt_g, loss_all, lr, mesh)
        metrics.update({k: v.detach() for k, v in aux.items()})
        metrics["loss/g/total"] = loss_all.detach()
        metrics["grad_norm_g"] = grad_norm_g
        metrics["learning_rate"] = torch.as_tensor(lr)

        state.step += 1
        return state, metrics

    return step
