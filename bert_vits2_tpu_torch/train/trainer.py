"""Training loop (reference: train_ms.py:54-835 run / train_and_evaluate /
evaluate).

Counterpart of `bert_vits2_tpu/train/trainer.py`, with its method names:
`build_models` / `init_params` (train_ms.py:174-222), and `Trainer`, which
reads a reference config.json and a cleaned filelist, batches with the
bucket sampler, reads each batch through the native loader (`native/`;
numpy where it cannot be built) in a host thread, runs one GAN step per
batch (`train/step.py`), decays the
learning rate per epoch (gamma^epoch, train_ms.py:334-345), logs scalars
and eval clips to TensorBoard when it is installed, and keeps reference-
layout checkpoints with retention (`train/checkpoint.py`), resuming from
the newest or bootstrapping from reference G_/D_/DUR_/WD_*.pth files.

V2.3 trains with the SLM losses whenever config.json declares
`model.slm`: the frozen WavLM is read from `model.slm.model` (an HF
checkpoint directory) and the WavLM discriminator trains beside the
others. `slm_path=None` (the CLI's --no-slm) trains without them.

config.json's `train.bf16_run` trains with the reference's autocast(bf16)
policy, the JAX package's `train_compute_dtype` "bfloat16" and `bf16_run`
(`train/step.py`): float32 parameters and checkpoints, so a run resumes
under either dtype.

Data parallelism: in a process group (`parallel.init_distributed`, torchrun)
the Trainer builds its mesh from the group (n_data = world / n_model), as
the JAX one builds it from `jax.devices()`, and trains on N ranks: each rank
on its own device (cuda:LOCAL_RANK for device "cuda"), its own sampler shard
(`batch_size` rows per rank, every rank in the same bucket each step, the
text padded to the global batch's cap) and its own native loader; the step
is the one-process step on the global batch (`train/step.py`). Rank 0's
start is every rank's: its resumed step, parameters and optimizer state are
broadcast at start-up, after any resume; logging, the writers, `evaluate`
and `save` run on rank 0 only. The reference-layout
checkpoints carry no topology, so a run resumes under any rank count.

The model axis (`n_model` > 1, the CLI's `--n-model`, in a process group of
n_data x n_model ranks): after the resume and the start-up broadcast, each
rank shards the synthesizer and the generator's Adam moments to its model
coordinate (`train/step.py:shard_train_state`, the JAX `tp_shard_tree`
rules with the departures D.2-D.4 of `parallel/sharding.py`), and the step
runs the sharded stacks (ROADMAP §C R.8: the JAX Trainer builds the same
mesh but replicates its state). The ranks of the lead's model group
evaluate and save together: `save` gathers the shards and rank 0 writes
the full, reference-layout files.

`run(profile_at_step=, profile_steps=)` writes a device trace of
`profile_steps` steps to `<model_dir>/logs/profile` (`utils/profiling.py`),
as the JAX Trainer does.
"""

from __future__ import annotations

import os
import queue
import signal
import threading

import numpy as np
import torch
import torch.distributed as dist

from bert_vits2_tpu_torch.compat.hparams import (
    HParams,
    data_config_from_hparams,
    get_hparams_from_file,
    model_config_from_hparams,
)
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.data import BucketSampler, FilelistDataset
from bert_vits2_tpu_torch.data.dataset import load_collated_batch
from bert_vits2_tpu_torch.device import resolve_device
from bert_vits2_tpu_torch.models.discriminators import (
    DurationDiscriminator,
    MultiPeriodDiscriminator,
    WavLMDiscriminator,
)
from bert_vits2_tpu_torch.models.slm import SLM, WavLMConfig, load_wavlm
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
from bert_vits2_tpu_torch.parallel import (
    make_mesh,
    rank_device,
    replicate,
    replicate_optimizer,
)
from bert_vits2_tpu_torch.train import checkpoint as ckpt
from bert_vits2_tpu_torch.train.step import (
    Models,
    TrainConfig,
    init_train_state,
    make_train_step,
    shard_train_state,
)
from bert_vits2_tpu_torch.utils.logging import get_logger, make_writer, summarize
from bert_vits2_tpu_torch.utils.plot import alignment_to_image, spectrogram_to_image
from bert_vits2_tpu_torch.utils.profiling import StepTimer, trace
from bert_vits2_tpu_torch.utils.repro import check_git_hash


def train_config_from_hparams(hps: HParams) -> TrainConfig:
    t = hps.train
    return TrainConfig(
        learning_rate=t.learning_rate,
        betas=tuple(t.get("betas", (0.8, 0.99))),
        eps=t.get("eps", 1e-9),
        lr_decay=t.get("lr_decay", 0.99995),
        c_mel=t.get("c_mel", 45.0),
        c_kl=t.get("c_kl", 1.0),
        bf16_run=t.get("bf16_run", False),
        seed=t.get("seed", 1234),
        freeze_zh_bert=t.get("freeze_ZH_bert", False),
        freeze_en_bert=t.get("freeze_EN_bert", False),
        freeze_jp_bert=t.get("freeze_JP_bert", False),
        freeze_emo=t.get("freeze_emo", False),
    )


def build_models(mcfg: ModelConfig, use_dur_disc: bool = True,
                 use_wavlm_disc: bool = False,
                 device: str | torch.device = "cuda",
                 wavlm: WavLMConfig | None = None) -> Models:
    """The full-size models per configs/config.json, on `device`, in
    train() mode. Draw their parameters from a seed with `init_params`.

    The WavLM discriminator takes model.slm's hidden, nlayers and
    initial_channel; `wavlm`, the loaded WavLM's config, must give it that
    input width (hidden_size x (num_layers + 1))."""
    dev = resolve_device(device)
    if use_wavlm_disc and wavlm is not None and (
            mcfg.slm_hidden * mcfg.slm_layers
            != wavlm.hidden_size * (wavlm.num_layers + 1)):
        raise ValueError(
            f"model.slm declares hidden {mcfg.slm_hidden} x nlayers "
            f"{mcfg.slm_layers}, but the WavLM gives {wavlm.num_layers + 1} "
            f"hidden states of {wavlm.hidden_size}")
    dd = (DurationDiscriminator(mcfg.hidden_channels, 256, 3, 0.1,
                                gin_channels=mcfg.gin_channels)
          if use_dur_disc else None)
    synth, mpd = Synthesizer(mcfg), MultiPeriodDiscriminator()
    # built last, so that the seeded init of the others does not depend on it
    wd = (WavLMDiscriminator(mcfg.slm_hidden, mcfg.slm_layers,
                             mcfg.slm_initial_channel)
          if use_wavlm_disc else None)
    models = Models(synth, mpd, dd, wd)
    return Models(*(m if m is None else m.to(dev).train() for m in models))


def init_params(models: Models, mcfg: ModelConfig, seed: int = 1234) -> Models:
    """Draw every parameter anew from `seed`, in place: the modules'
    constructors hold the reference's initializers, so fresh copies are
    built under a seeded generator and their values loaded."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        fresh = build_models(mcfg, use_dur_disc=models.dur_disc is not None,
                             use_wavlm_disc=models.wavlm_disc is not None,
                             device="cpu")
    for module, new in zip(models, fresh):
        if module is not None:
            module.load_state_dict(new.state_dict())
    return models


class Trainer:
    """End-to-end training loop on one device, or on one rank of several
    (module note).

    Usage:
        t = Trainer(config_path, model_dir)
        t.run(epochs=100)

    `models` replaces the full-size models of config.json (the caller has
    drawn their parameters); `device` defaults to the card (in a process
    group, this rank's). `n_model`: the model axis of the mesh (several
    processes only; module note). `slm_path`:
    "auto" resolves config.json's model.slm.model, a directory loads that
    WavLM, None trains without the SLM losses. `use_wavlm_disc` asks for
    them too, and then needs a WavLM.
    """

    def __init__(
        self,
        config_path: str,
        model_dir: str,
        use_dur_disc: bool = True,
        use_wavlm_disc: bool = False,
        n_model: int = 1,
        models: Models | None = None,
        slm_path: str | None = "auto",
        device: str | torch.device = "cuda",
    ):
        self.mesh = None
        if dist.is_available() and dist.is_initialized():
            self.mesh = make_mesh(n_model=n_model)
            if torch.device(device) == torch.device("cuda"):
                device = rank_device()
        elif n_model != 1:
            raise ValueError(f"n_model {n_model}: the model axis runs on a process "
                             "group of n_data x n_model ranks (init_distributed; "
                             "the CLI's --multihost)")
        self.data_rank = 0 if self.mesh is None else self.mesh.data_rank
        self.n_data = 1 if self.mesh is None else self.mesh.n_data
        self.is_lead = not dist.is_initialized() or dist.get_rank() == 0
        # the ranks that evaluate and save: the lead, and under the model
        # axis the rest of its model group (they hold the other shards)
        self.in_lead_group = self.mesh is None or self.mesh.data_rank == 0
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        self.hps = get_hparams_from_file(config_path)
        if slm_path == "auto":
            # v2.3 trains with the SLM losses unconditionally
            # (train_ms.py:220-222, 344-356): a declared but missing WavLM
            # directory is an error, not a silent run without them
            declared = self.hps.model.get("slm", None)
            slm_path = None
            if declared is not None:
                cand = declared.get("model", "./slm/wavlm-base-plus")
                if not os.path.isdir(cand):
                    raise FileNotFoundError(
                        f"config declares model.slm.model={cand!r} but no WavLM "
                        "weights found there; pass slm_path=<dir>, or disable "
                        "the SLM losses explicitly with --no-slm / slm_path=None")
                slm_path = cand
        if use_wavlm_disc and slm_path is None:
            raise ValueError("the WavLM discriminator needs the frozen WavLM: "
                             "pass slm_path=<dir> or declare model.slm")
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self.logger = get_logger(model_dir if self.is_lead else None)
        if self.is_lead:
            check_git_hash(model_dir)
        # bf16_run (config.json train.bf16_run) is the reference's
        # autocast(bf16): the synthesizer's hot stages in bf16, and the
        # step's bf16 policy through self.tcfg.bf16_run
        mcfg_kw = ({"train_compute_dtype": "bfloat16"}
                   if self.hps.train.get("bf16_run", False) else {})
        self.mcfg = model_config_from_hparams(self.hps, **mcfg_kw)
        self.dcfg = data_config_from_hparams(self.hps)
        self.tcfg = train_config_from_hparams(self.hps)
        self.slm, wavlm_cfg = None, None
        if slm_path is not None:
            wavlm, wavlm_cfg = load_wavlm(slm_path, device=self.device)
            self.slm = SLM(wavlm, self.dcfg.sampling_rate,
                           self.mcfg.slm_sr).to(self.device)
            self.logger.info("SLM losses on: WavLM from %s (%d layers of %d)",
                             slm_path, wavlm_cfg.num_layers, wavlm_cfg.hidden_size)
        if models is None:
            models = init_params(
                build_models(self.mcfg, use_dur_disc, self.slm is not None,
                             device=self.device, wavlm=wavlm_cfg),
                self.mcfg, self.tcfg.seed)
        elif (models.wavlm_disc is None) != (self.slm is None):
            raise ValueError("models.wavlm_disc must be given exactly when the "
                             "SLM losses are on")
        self.models = Models(*(m if m is None else m.to(self.device).train()
                               for m in models))

        self.writer = self.eval_writer = None
        if self.is_lead:
            self.writer = make_writer(os.path.join(model_dir, "logs"))
            self.eval_writer = make_writer(os.path.join(model_dir, "logs", "eval"))

        d = self.hps.data
        spk2id = d.spk2id.to_dict() if isinstance(d.spk2id, HParams) else d.spk2id

        def dataset(filelist):
            return FilelistDataset(
                filelist, spk2id=spk2id, sampling_rate=d.sampling_rate,
                filter_length=d.filter_length, hop_length=d.hop_length,
                win_length=d.win_length, add_blank=d.get("add_blank", True),
                bert_dim=self.mcfg.bert_dim)

        self.train_ds = dataset(d.training_files)
        val = d.get("validation_files")
        self.val_ds = dataset(val) if val and os.path.isfile(val) else None
        # one sampler per data rank: this rank's, and the others' for the
        # global batch's text cap
        self.rank_samplers = [
            BucketSampler(self.train_ds.lengths(), batch_size=self.hps.train.batch_size,
                          num_replicas=self.n_data, rank=r, seed=self.tcfg.seed)
            for r in range(self.n_data)]
        self.sampler = self.rank_samplers[self.data_rank]
        self.logger.info("dataset: %d utterances (%d skipped), %d batches/epoch",
                         len(self.train_ds), self.train_ds.skipped,
                         len(self.sampler))

        self.state = init_train_state(self.models, self.tcfg)
        self.ckpt_dir = os.path.join(model_dir, "ckpt")
        self.state, step = ckpt.restore_train_state(self.ckpt_dir, self.models,
                                                    self.state)
        if step is None:
            it, _ = ckpt.bootstrap_from_reference(model_dir, self.models)
            if it:
                self.logger.info("bootstrapped from reference checkpoints "
                                 "(iteration %d)", it)
        if self.mesh is not None:
            step = self._replicate_start(step)
            if n_model > 1:
                shard_train_state(self.models, self.state, self.mesh)
        self.global_step = self.state.step = step or 0
        if step is not None:
            self.logger.info("resumed from step %d", step)
        self.start_epoch = self.global_step // max(len(self.sampler), 1)
        self.learning_rate = self.tcfg.learning_rate
        self.step_fn = make_train_step(
            self.models, self.tcfg, self.dcfg, self.mcfg.segment_size,
            mas_noise_initial=self.mcfg.mas_noise_scale_initial,
            mas_noise_delta=self.mcfg.noise_scale_delta, slm=self.slm, mesh=self.mesh)
        self.generator = torch.Generator(device=self.device)

    def _replicate_start(self, step: int | None) -> int | None:
        """Several ranks: the lead's start is every rank's, its resumed step
        (or none), parameters, buffers and optimizer state broadcast from
        global rank 0 to every rank, in the full layout (before the model
        axis shards it, so each rank then keeps its shard), so that a rank
        that does not see the lead's checkpoints (no shared model_dir)
        trains the same replica. -> the lead's step."""
        box = [step]
        dist.broadcast_object_list(box, 0)
        replicate(self.mesh, [m for m in self.models if m is not None])
        for opt in (self.state.opt_g, self.state.opt_d, self.state.opt_dd,
                    self.state.opt_wd):
            if opt is not None:
                replicate_optimizer(self.mesh, opt)
        return box[0]

    # ---- data ----

    def _device_batch(self, batch_np: dict) -> dict:
        """Host numpy batch -> tensors on the device (integers as int64);
        on the card through pinned memory, without waiting for the copy."""
        out = {}
        for key, a in batch_np.items():
            x = torch.from_numpy(a)
            if not x.is_floating_point():
                x = x.to(torch.int64)
            if self.device.type == "cuda":
                x = x.pin_memory()
            out[key] = x.to(self.device, non_blocking=True)
        return out

    @property
    def native_loader(self):
        """The threaded C++ batch loader (native/dataloader.cc), or None
        where it cannot be built: the batches then load with numpy."""
        if not hasattr(self, "_native_loader"):
            self._native_loader = None
            try:
                from bert_vits2_tpu_torch.native import BatchLoader, available

                if available():
                    self._native_loader = BatchLoader()
                    self.logger.info("native batch loader active")
                else:
                    self.logger.info("native batch loader unavailable (no g++?): "
                                     "batches load with numpy")
            except Exception as e:  # noqa: BLE001
                self.logger.info("native batch loader unavailable: %s", e)
        return self._native_loader

    def close(self) -> None:
        """Stop the native loader's threads (a later epoch starts them
        again)."""
        loader = self.__dict__.pop("_native_loader", None)
        if loader is not None:
            loader.close()

    def epoch_batches(self, epoch: int):
        """The host batches of one epoch (numpy), bucket by bucket as the
        sampler orders them, read by the native loader when it is
        available; `bert` carries the active language only. With several
        data ranks, this rank's rows, their text padded to the cap of the
        global batch (every rank's rows of the step), so that every rank's
        arrays have one shape."""
        for sampler in self.rank_samplers:
            sampler.set_epoch(epoch)
        for steps in zip(*self.rank_samplers):
            bucket_idx, ids = steps[self.data_rank]
            longest = None
            if self.n_data > 1:
                lengths = self.train_ds.text_lengths
                longest = max(lengths[i] for _, rank_ids in steps for i in rank_ids)
            yield load_collated_batch(
                self.train_ds, ids,
                max_frames=self.sampler.bucket_max_frames(bucket_idx),
                loader=self.native_loader, max_text=longest)

    def _prefetch(self, gen, depth: int = 2):
        """Load, collate and copy to the device ahead of the step in a host
        thread (the DataLoader(num_workers, prefetch) role,
        train_ms.py:127-146). Closing the generator stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            try:
                for item in gen:
                    if stop.is_set():
                        return
                    q.put(("ok", self._device_batch(item)))
            except Exception as e:  # noqa: BLE001 - re-raised on the main thread
                q.put(("err", e))
            finally:
                q.put(("end", None))

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "end":
                    return
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # drain: a blocked put must return
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()

    # ---- loop ----

    def _seed_step(self) -> None:
        """The step's random numbers are a function of (seed, step), as the
        JAX step folds the step into its key: the noise generator and
        torch's global generator are reseeded per step, so a resumed run
        draws what an uninterrupted one would. The noise generator (and
        with it the hash dropout's seeds and the module dropouts' masks,
        `train/step.py:_step_streams`) is seeded alike on every rank, since
        the step draws the global batch's numbers; torch's global
        generator, which nothing in the step draws from, per data rank
        (rank 0's seed is the one-process run's)."""
        seed = self.tcfg.seed * 1_000_003 + self.global_step
        self.generator.manual_seed(seed)
        if self.data_rank:
            seed = int(np.random.SeedSequence([seed, self.data_rank]).generate_state(1)[0])
        torch.manual_seed(seed)

    def run(self, epochs: int | None = None, log_interval: int | None = None,
            eval_interval: int | None = None, keep_ckpts: int | None = None,
            max_steps: int | None = None, profile_at_step: int | None = None,
            profile_steps: int = 5):
        """Train to `epochs` (config.json's by default) or `max_steps`. At
        global step `profile_at_step` the next `profile_steps` steps run on
        one batch inside a device trace written to
        `<model_dir>/logs/profile` (the JAX Trainer's loop: one batch,
        each step's random numbers from its own step counter)."""
        t = self.hps.train
        epochs = epochs if epochs is not None else t.get("epochs", 1000)
        log_interval = log_interval or t.get("log_interval", 200)
        eval_interval = eval_interval or t.get("eval_interval", 1000)
        keep_ckpts = keep_ckpts or 8
        timer = StepTimer()
        # preemption: save a resumable checkpoint at the next step boundary
        # on SIGTERM and return (the reference's only recovery is resume
        # from the latest checkpoint)
        stop = {"flag": False}

        def _on_term(signum, frame):  # noqa: ARG001
            stop["flag"] = True

        try:
            prev_term = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not on the main thread
            prev_term = None
        seg_audio_s = (t.batch_size * self.n_data * self.mcfg.segment_samples
                       / self.dcfg.sampling_rate)
        try:
            for epoch in range(self.start_epoch, epochs):
                self.learning_rate = self.tcfg.learning_rate * self.tcfg.lr_decay**epoch
                batches = self._prefetch(self.epoch_batches(epoch))
                try:
                    for batch in batches:
                        if (profile_at_step is not None
                                and self.global_step == profile_at_step):
                            self._profile(batch, profile_steps)
                            if max_steps is not None and self.global_step >= max_steps:
                                if self.in_lead_group:
                                    self.save(keep_ckpts)
                                return
                            continue
                        self._seed_step()
                        self.state, metrics = self.step_fn(
                            self.state, batch, self.generator, self.learning_rate)
                        timer.tick()
                        self.global_step += 1
                        if self.global_step % log_interval == 0 and self.is_lead:
                            m = self._assert_finite(metrics)
                            rate = timer.steps_per_sec()
                            self.logger.info(
                                "epoch %d step %d | g=%.3f d=%.3f mel=%.3f | "
                                "%.2f steps/s (train rtf %.1f)", epoch,
                                self.global_step, m.get("loss/g/total", 0),
                                m.get("loss/d/total", 0), m.get("loss/g/mel", 0),
                                rate, timer.rtf(seg_audio_s))
                            summarize(self.writer, self.global_step,
                                      scalars={**m, "steps_per_sec": rate,
                                               "train_rtf": timer.rtf(seg_audio_s)})
                        if self.global_step % eval_interval == 0:
                            # a non-finite step must never overwrite the
                            # last good checkpoint
                            self._assert_finite(metrics)
                            if self.in_lead_group:
                                self.evaluate()
                                self.save(keep_ckpts)
                        if stop["flag"]:
                            self.logger.info("SIGTERM: saving preemption checkpoint")
                        if stop["flag"] or (max_steps is not None
                                            and self.global_step >= max_steps):
                            self._assert_finite(metrics)
                            if self.in_lead_group:
                                self.save(keep_ckpts)
                            return
                finally:
                    batches.close()
        finally:
            self.close()
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)

    def _profile(self, batch: dict, steps: int) -> None:
        """`steps` steps on `batch` inside a device trace (torch.profiler)
        written to <model_dir>/logs/profile, each a step of its own."""
        with trace(os.path.join(self.model_dir, "logs", "profile")):
            for _ in range(steps):
                self._seed_step()
                self.state, _ = self.step_fn(self.state, batch, self.generator,
                                             self.learning_rate)
                self.global_step += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.logger.info("wrote device trace at step %d", self.global_step)

    def _assert_finite(self, metrics: dict) -> dict:
        """Failure detection: a NaN/inf metric means the run is already
        unrecoverable, so stop before a save can overwrite a good
        checkpoint. Reads the metric scalars to the host in one copy (called
        only at log and save points)."""
        names = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                            .reshape(()).to(self.device) for k in names]).cpu()
        m = dict(zip(names, vals.tolist()))
        bad = {k: v for k, v in m.items() if not np.isfinite(v)}
        if bad:
            raise FloatingPointError(
                f"non-finite training metrics at step {self.global_step}: "
                f"{bad}; the last good checkpoint is unaffected, rerun to resume")
        return m

    def save(self, keep: int = 8) -> None:
        """Write the checkpoints (the lead; under the model axis every rank
        of its model group calls it, and the shards are gathered)."""
        ckpt.save_train_state(self.ckpt_dir, self.global_step, self.models,
                              self.state, self.learning_rate, keep=keep, mesh=self.mesh)
        self.logger.info("saved checkpoint at step %d", self.global_step)

    # ---- eval (reference: evaluate(), train_ms.py:742-835) ----

    @torch.no_grad()
    def evaluate(self, max_items: int = 2, max_frames: int = 1024) -> None:
        """Synthesize the first validation items with the SDP and with the
        DP (`Synthesizer.infer`, eval mode; the item's spectrogram is the
        reference of an n_speakers == 0 model) and log clips and
        alignments."""
        if self.val_ds is None or len(self.val_ds) == 0:
            return
        synth = self.models.synthesizer
        synth.eval()
        hop = self.dcfg.hop_length
        audios, images = {}, {}
        try:
            for i in range(min(max_items, len(self.val_ds))):
                it = self.val_ds[i]
                n_ph = len(it["phones"])

                def dev(a, dtype=None):
                    return torch.as_tensor(np.asarray(a)[None], dtype=dtype,
                                           device=self.device)

                for sdp_ratio, tag in ((1.0, "sdp"), (0.0, "dp")):
                    wave, attn, _, y_len = synth.infer(
                        dev(it["phones"], torch.int64),
                        torch.tensor([n_ph], device=self.device),
                        dev(it["sid"], torch.int64), dev(it["tones"], torch.int64),
                        dev(it["lang"], torch.int64), dev(it["bert"]),
                        dev(it["ja_bert"]), dev(it["en_bert"]), max_frames,
                        sdp_ratio=sdp_ratio, y=dev(it["spec"]),
                        generator=torch.Generator(device=self.device).manual_seed(i))
                    n = int(y_len[0])
                    audios[f"gen/audio_{i}_{tag}"] = wave[0, :n * hop].cpu().numpy()
                    images[f"gen/attn_{i}_{tag}"] = alignment_to_image(
                        attn[0, :n].cpu().numpy())
                if self.global_step <= self.hps.train.get("eval_interval", 1000):
                    audios[f"gt/audio_{i}"] = it["wave"]
                    images[f"gt/spec_{i}"] = spectrogram_to_image(it["spec"])
        finally:
            synth.train()
        summarize(self.eval_writer, self.global_step, images=images,
                  audios=audios, audio_sampling_rate=self.dcfg.sampling_rate)
        self.logger.info("eval at step %d: %d clips", self.global_step, len(audios))
