"""Model hyperparameters (mirrors configs/config.json `model`+`data` sections).

A copy of the JAX package's `ModelConfig`, field for field, so that the
PyTorch port never imports that package; a test pins the two together.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
