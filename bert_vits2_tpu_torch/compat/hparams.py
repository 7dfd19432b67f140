"""Recursive attr-dict hyperparameters, reference-config.json compatible.

Behavior mirrors utils.py:381-410 (HParams) and utils.get_hparams_from_file
(utils.py:327-338): a per-model config.json with train/data/model sections,
`version`, and `spk2id` inside `data`. A copy of
`bert_vits2_tpu/compat/hparams.py` that builds the port's own configs; a
test pins the two together.
"""

from __future__ import annotations

import json

from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.train.step import DataConfig


class HParams:
    """Nested dicts exposed as attributes; dict protocol preserved."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, HParams) else v
            for k, v in self.__dict__.items()
        }

    def __len__(self):
        return len(self.__dict__)

    def __getitem__(self, key):
        return self.__dict__[key]

    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return f"HParams({self.__dict__!r})"


def get_hparams_from_file(config_path: str) -> HParams:
    with open(config_path, encoding="utf-8") as f:
        return HParams(**json.load(f))


def model_config_from_hparams(hps: HParams, **overrides):
    """Build a ModelConfig from a reference config.json HParams tree."""
    model = hps.model.to_dict() if isinstance(hps.model, HParams) else dict(hps.model)
    data = hps.data.to_dict() if isinstance(hps.data, HParams) else dict(hps.data)
    seg = hps.train.segment_size if "train" in hps and "segment_size" in hps.train else None
    kw = dict(overrides)
    if seg is not None and "segment_size" not in kw:
        kw["segment_size"] = seg
    return ModelConfig.from_json(model, data, **kw)


def data_config_from_hparams(hps: HParams):
    """Build a train.DataConfig from the config.json `data` section."""
    d = hps.data
    return DataConfig(
        sampling_rate=d.sampling_rate,
        filter_length=d.filter_length,
        hop_length=d.hop_length,
        win_length=d.win_length,
        n_mel_channels=d.n_mel_channels,
        mel_fmin=d.mel_fmin,
        mel_fmax=d.get("mel_fmax", None),
    )
