"""Model hyperparameters (mirrors configs/config.json `model`+`data` sections)
and the tools' global configuration from config.yml (reference:
config.py:13-261).

Copies of the JAX package's `ModelConfig` (`bert_vits2_tpu/models/config.py`)
and of `Config` with its seven section classes (`bert_vits2_tpu/config.py`),
field for field, so that the PyTorch port never imports that package; tests
pin each pair together.

config.yml is the two-tier system's upper tier: it drives the offline tools
and servers (dataset paths, preprocessing knobs, the server's port), while
the per-model config.json (`compat/hparams.py`) holds the training and model
hyperparameters. Every path inside a section resolves relative to
`dataset_path`, and a missing config.yml is copied from the template
`default_config.yml` on first use, as the reference does. The `train_ms`
section's `mesh_model_axis` is the mesh's model axis (the CLI's
`--n-model`), in place of the reference's torchrun variables.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Sequence

COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # symbol inventory (text/symbols.py: 112 symbols, 12 tones, 3 languages)
    n_vocab: int = 112
    num_tones: int = 12
    num_languages: int = 3
    bert_dim: int = 1024

    # --- version-family variants (compat.versions; V2.3 defaults) ---
    # V1.0.x has no ja/en BERT inputs; V1.1.x uses a 768-d ja_bert
    # (oldVersion/V110/models.py:343); V2.1/V2.2 add VQ emotion conditioning
    # ("vq210": 1024-d wav2vec2 vector or codebook index,
    #  "clap220": 512-d CLAP feature -> residual-MLP -> 32-head VQ).
    use_ja_bert: bool = True
    use_en_bert: bool = True
    ja_bert_dim: int = 1024
    emotion: str = "none"  # "none" | "vq210" | "clap220"

    spec_channels: int = 1025
    segment_size: int = 32  # decoder training window in FRAMES (16384 samples / hop 512)
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1

    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (8, 8, 2, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 2, 2)

    n_speakers: int = 256
    gin_channels: int = 512
    use_sdp: bool = True
    n_flow_layer: int = 4
    n_layers_trans_flow: int = 4
    use_transformer_flow: bool = True
    use_spk_conditioned_encoder: bool = True
    use_noise_scaled_mas: bool = True
    mas_noise_scale_initial: float = 0.01
    noise_scale_delta: float = 2e-6

    # Inference compute dtype for the flow + decoder ("float32" | "bfloat16").
    # Params stay fp32; activations in the two hot stages are cast. Text
    # encoder / duration predictors always run fp32 so predicted lengths are
    # bit-stable across dtypes. Any other value raises ValueError.
    infer_compute_dtype: str = "float32"

    # Training compute dtype for the hot forward stages (posterior WN stack,
    # latent flow, vocoder slice decode). Mirrors the reference's
    # autocast(bf16) policy (train_ms.py:458-480 under `bf16_run`):
    # fp32 master params, bf16 activations/matmuls (no loss scaling
    # needed — bf16 keeps fp32's exponent range). MAS statistics, duration
    # predictors, text encoder, and every loss stay fp32. The vocoder
    # slice gets the speaker embedding in bf16 and so runs in bf16 from
    # `cond` on; the JAX package passes it in fp32, which promotes that
    # slice back to fp32 (ROADMAP §C R.6). Any other value raises
    # ValueError.
    train_compute_dtype: str = "float32"

    # SLM discriminator (config.json model.slm)
    slm_hidden: int = 768
    slm_layers: int = 13
    slm_initial_channel: int = 64
    slm_sr: int = 16000

    def __post_init__(self):
        for name in ("infer_compute_dtype", "train_compute_dtype"):
            if getattr(self, name) not in COMPUTE_DTYPES:
                raise ValueError(f"{name} {getattr(self, name)!r} is not one of "
                                 f"{COMPUTE_DTYPES}")

    @property
    def hop_length(self) -> int:
        hop = 1
        for r in self.upsample_rates:
            hop *= r
        return hop

    @property
    def segment_samples(self) -> int:
        return self.segment_size * self.hop_length

    @classmethod
    def from_json(cls, model: dict, data: dict, **kw) -> "ModelConfig":
        """Build from reference-style config.json sections."""
        seg_samples = kw.pop("segment_size", None)
        hop = data.get("hop_length", 512)
        fields = {f.name for f in dataclasses.fields(cls)}
        args = {k: v for k, v in model.items() if k in fields}
        slm = model.get("slm", {})
        if slm:
            args["slm_hidden"] = slm.get("hidden", 768)
            args["slm_layers"] = slm.get("nlayers", 13)
            args["slm_initial_channel"] = slm.get("initial_channel", 64)
            args["slm_sr"] = slm.get("sr", 16000)
        args["spec_channels"] = data.get("filter_length", 2048) // 2 + 1
        args["n_speakers"] = data.get("n_speakers", 256)
        if seg_samples is not None:
            args["segment_size"] = seg_samples // hop
        for seq_key in (
            "resblock_kernel_sizes",
            "upsample_rates",
            "upsample_kernel_sizes",
        ):
            if seq_key in args:
                args[seq_key] = tuple(args[seq_key])
        if "resblock_dilation_sizes" in args:
            args["resblock_dilation_sizes"] = tuple(
                tuple(d) for d in args["resblock_dilation_sizes"]
            )
        args.update(kw)
        return cls(**args)


def _join(dataset_path: str, p: str | None) -> str | None:
    if not p:
        return p
    return os.path.join(dataset_path, p) if dataset_path else p


@dataclasses.dataclass
class ResampleConfig:
    in_dir: str = "audios/raw"
    out_dir: str = "audios/wavs"
    sampling_rate: int = 44100

    @classmethod
    def from_dict(cls, dataset_path: str, d: dict) -> "ResampleConfig":
        return cls(
            in_dir=_join(dataset_path, d.get("in_dir", "audios/raw")),
            out_dir=_join(dataset_path, d.get("out_dir", "audios/wavs")),
            sampling_rate=d.get("sampling_rate", 44100),
        )


@dataclasses.dataclass
class PreprocessTextConfig:
    transcription_path: str = "filelists/transcription.list"
    cleaned_path: str = ""
    train_path: str = "filelists/train.list"
    val_path: str = "filelists/val.list"
    config_path: str = "config.json"
    val_per_lang: int = 4
    max_val_total: int = 12
    clean: bool = True

    @classmethod
    def from_dict(cls, dataset_path: str, d: dict) -> "PreprocessTextConfig":
        out = cls(**{k: v for k, v in d.items() if k in _field_names(cls)})
        for f in ("transcription_path", "cleaned_path", "train_path",
                  "val_path", "config_path"):
            setattr(out, f, _join(dataset_path, getattr(out, f)))
        return out


@dataclasses.dataclass
class BertGenConfig:
    config_path: str = "config.json"
    num_processes: int = 4
    random_features: bool = False

    @classmethod
    def from_dict(cls, dataset_path: str, d: dict) -> "BertGenConfig":
        out = cls(**{k: v for k, v in d.items() if k in _field_names(cls)})
        out.config_path = _join(dataset_path, out.config_path)
        return out


@dataclasses.dataclass
class TrainConfig:
    model_dir: str = "models"
    config_path: str = "config.json"
    num_workers: int = 8
    keep_ckpts: int = 8
    # device mesh axes: data x model (replaces train_ms.env rendezvous vars)
    mesh_model_axis: int = 1

    @classmethod
    def from_dict(cls, dataset_path: str, d: dict) -> "TrainConfig":
        d = {k: v for k, v in d.items() if k in _field_names(cls)}
        out = cls(**d)
        out.model_dir = _join(dataset_path, out.model_dir)
        out.config_path = _join(dataset_path, out.config_path)
        return out


@dataclasses.dataclass
class WebuiConfig:
    model: str = "models/G_8000.pth"
    config_path: str = "config.json"
    port: int = 7860
    share: bool = False
    debug: bool = False
    language_identification_library: str = "unicode"

    @classmethod
    def from_dict(cls, dataset_path: str, d: dict) -> "WebuiConfig":
        out = cls(**{k: v for k, v in d.items() if k in _field_names(cls)})
        out.model = _join(dataset_path, out.model)
        out.config_path = _join(dataset_path, out.config_path)
        return out


@dataclasses.dataclass
class ServerConfig:
    port: int = 5000
    host: str = "0.0.0.0"
    models: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, _dataset_path: str, d: dict) -> "ServerConfig":
        return cls(**{k: v for k, v in d.items() if k in _field_names(cls)})


@dataclasses.dataclass
class TranslateConfig:
    app_key: str = ""
    secret_key: str = ""

    @classmethod
    def from_dict(cls, _dataset_path: str, d: dict) -> "TranslateConfig":
        return cls(**{k: v for k, v in d.items() if k in _field_names(cls)})


def _field_names(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


DEFAULT_YML = "config.yml"
TEMPLATE_YML = "default_config.yml"


class Config:
    """Load config.yml; auto-copy the template on first run like the
    reference (config.py:228-239)."""

    def __init__(self, config_path: str = DEFAULT_YML):
        if not os.path.isfile(config_path) and os.path.isfile(TEMPLATE_YML):
            shutil.copy(TEMPLATE_YML, config_path)
        data: dict[str, Any] = {}
        if os.path.isfile(config_path):
            import yaml

            with open(config_path, encoding="utf-8") as f:
                data = yaml.safe_load(f) or {}
        self.config_path = config_path
        self.dataset_path: str = data.get("dataset_path", "Data/")
        self.mirror: str = data.get("mirror", "")
        self.openi_token: str = data.get("openi_token", "")
        dp = self.dataset_path
        self.resample_config = ResampleConfig.from_dict(dp, data.get("resample", {}))
        self.preprocess_text_config = PreprocessTextConfig.from_dict(
            dp, data.get("preprocess_text", {})
        )
        self.bert_gen_config = BertGenConfig.from_dict(dp, data.get("bert_gen", {}))
        self.train_config = TrainConfig.from_dict(
            dp, data.get("train_ms", data.get("train", {}))
        )
        self.webui_config = WebuiConfig.from_dict(dp, data.get("webui", {}))
        self.server_config = ServerConfig.from_dict(dp, data.get("server", {}))
        self.translate_config = TranslateConfig.from_dict(
            dp, data.get("translate", {})
        )
