"""Building the models of a training run (reference: train_ms.py:174-222).

Counterpart of `build_models` and `init_params` in
`bert_vits2_tpu/train/trainer.py`. The `Trainer` class, data loading,
checkpoints and the command line come with later slices.
"""

from __future__ import annotations

import torch

from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.device import resolve_device
from bert_vits2_tpu_torch.models.discriminators import (
    DurationDiscriminator,
    MultiPeriodDiscriminator,
)
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
from bert_vits2_tpu_torch.train.step import Models


def build_models(mcfg: ModelConfig, use_dur_disc: bool = True,
                 use_wavlm_disc: bool = False,
                 device: str | torch.device = "cuda") -> Models:
    """The full-size models per configs/config.json, on `device`, in
    train() mode. Draw their parameters from a seed with `init_params`."""
    if use_wavlm_disc:
        raise NotImplementedError("the SLM (WavLM) branch is not ported yet")
    dev = resolve_device(device)
    dd = (DurationDiscriminator(mcfg.hidden_channels, 256, 3, 0.1,
                                gin_channels=mcfg.gin_channels)
          if use_dur_disc else None)
    models = Models(Synthesizer(mcfg), MultiPeriodDiscriminator(), dd, None)
    return Models(*(m if m is None else m.to(dev).train() for m in models))


def init_params(models: Models, mcfg: ModelConfig, seed: int = 1234) -> Models:
    """Draw every parameter anew from `seed`, in place: the modules'
    constructors hold the reference's initializers, so fresh copies are
    built under a seeded generator and their values loaded."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        fresh = build_models(mcfg, use_dur_disc=models.dur_disc is not None,
                             device="cpu")
    for module, new in zip(models, fresh):
        if module is not None:
            module.load_state_dict(new.state_dict())
    return models
