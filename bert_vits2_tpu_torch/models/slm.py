"""The frozen WavLM feature model and the sinc resampler of the SLM (speech
language model) adversarial losses (reference: losses.py:63-153 WavLMLoss,
a frozen `microsoft/wavlm-base-plus` behind torchaudio's Resample).

Counterpart of `bert_vits2_tpu/models/slm.py`, written as plain modules so
that transformers is not needed. `WavLM` is transformers' `WavLMModel`
(modeling_wavlm.py) at inference: the conv feature encoder (GroupNorm on
the first conv, or a LayerNorm after every conv), the feature projection,
the weight-normed grouped positional conv, and post-LN transformer layers
whose T5-style bucketed relative-position bias is computed once by layer 0
and gated in every layer from that layer's own input. It returns the
num_layers + 1 hidden states that the reference stacks for the WavLM
discriminator and the feature loss. The submodules carry the names of
`WavLMModel`'s state_dict, so a checkpoint loads with `load_state_dict`
once a `wavlm.` prefix is stripped; the positional conv takes its weight
norm as `weight_g` / `weight_v` or as `parametrizations.weight.original0/1`.

The attention is written out (matmul, softmax) rather than
`scaled_dot_product_attention`, as the JAX package's `einsum`s are: ~18
frames per 16384-sample segment, with a bias per item and head.

`Resampler` is torchaudio's sinc_interp_hann kernel (width-6 lowpass,
rolloff 0.99) as one strided conv: 44.1 kHz -> 16 kHz reduces to 441 -> 160
with 475 taps. `SLM` puts the two together, frozen: built in eval() mode, it
collects no parameter gradients, while the generator's losses still
take their gradient through it with respect to the wave.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bert_vits2_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """microsoft/wavlm-base-plus geometry."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf(cls, hf) -> "WavLMConfig":
        """From an HF config object or its config.json dict."""
        g = (lambda k, d=None: getattr(hf, k, d)) if not isinstance(hf, dict) else (
            lambda k, d=None: hf.get(k, d))
        return cls(
            hidden_size=g("hidden_size", 768),
            num_layers=g("num_hidden_layers", 12),
            num_heads=g("num_attention_heads", 12),
            intermediate_size=g("intermediate_size", 3072),
            conv_dim=tuple(g("conv_dim")),
            conv_kernel=tuple(g("conv_kernel")),
            conv_stride=tuple(g("conv_stride")),
            conv_bias=bool(g("conv_bias", False)),
            feat_extract_norm=g("feat_extract_norm", "group"),
            num_conv_pos_embeddings=g("num_conv_pos_embeddings", 128),
            num_conv_pos_embedding_groups=g("num_conv_pos_embedding_groups", 16),
            num_buckets=g("num_buckets", 320),
            max_bucket_distance=g("max_bucket_distance", 800),
            layer_norm_eps=g("layer_norm_eps", 1e-5),
        )

    def to_hf(self) -> dict:
        """The config.json keys of an HF WavLM checkpoint (`from_hf`'s inverse)."""
        return dict(
            model_type="wavlm", hidden_size=self.hidden_size,
            num_hidden_layers=self.num_layers, num_attention_heads=self.num_heads,
            intermediate_size=self.intermediate_size, conv_dim=list(self.conv_dim),
            conv_kernel=list(self.conv_kernel), conv_stride=list(self.conv_stride),
            conv_bias=self.conv_bias, feat_extract_norm=self.feat_extract_norm,
            num_conv_pos_embeddings=self.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=self.num_conv_pos_embedding_groups,
            num_buckets=self.num_buckets,
            max_bucket_distance=self.max_bucket_distance,
            layer_norm_eps=self.layer_norm_eps)


def _rel_pos_bucket(rel: torch.Tensor, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    """T5-style log bucket of rel = k - q (modeling_wavlm.py). The log's
    argument is clamped to 1 where the small branch is taken anyway, so that
    no log of 0 is cast to an integer."""
    nb = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * nb
    rel = rel.abs()
    max_exact = nb // 2
    large = max_exact + (
        torch.log(rel.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)).to(torch.long)
    large = large.clamp(max=nb - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class WavLMAttention(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        self.cfg, self.num_heads, self.head_dim = cfg, nh, h // nh
        self.q_proj, self.k_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.v_proj, self.out_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, nh, 1, 1))
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, nh)

    def forward(self, x, position_bias=None):
        """x [b, t, h]; position_bias [nh, t, t] or None (layer 0 computes
        it) -> (out [b, t, h], position_bias)."""
        b, t, h = x.shape
        nh, hd = self.num_heads, self.head_dim
        if position_bias is None:
            pos = torch.arange(t, device=x.device)
            bucket = _rel_pos_bucket(pos[None, :] - pos[:, None],
                                     self.cfg.num_buckets,
                                     self.cfg.max_bucket_distance)
            position_bias = self.rel_attn_embed(bucket).permute(2, 0, 1)

        def heads(y):
            return y.view(b, t, nh, hd).transpose(1, 2)  # [b, nh, t, hd]

        # the gate of this layer, from this layer's input
        proj = self.gru_rel_pos_linear(heads(x)).view(b, nh, t, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(proj).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
        scores = (heads(self.q_proj(x)) @ heads(self.k_proj(x)).transpose(-1, -2)
                  / math.sqrt(hd) + gate * position_bias)
        ctx = torch.softmax(scores, dim=-1) @ heads(self.v_proj(x))
        return self.out_proj(ctx.transpose(1, 2).reshape(b, t, h)), position_bias


class WavLMFeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMEncoderLayer(nn.Module):
    """One post-LN layer; layer 0 owns the relative-position embedding."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.attention = WavLMAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.feed_forward = WavLMFeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)

    def forward(self, x, position_bias=None):
        attn, position_bias = self.attention(x, position_bias)
        x = self.layer_norm(x + attn)
        return self.final_layer_norm(x + self.feed_forward(x)), position_bias


class WavLMConvLayer(nn.Module):
    """conv -> (GroupNorm with a group per channel on conv 0 | LayerNorm
    after every conv) -> GELU."""

    def __init__(self, cfg: WavLMConfig, i: int):
        super().__init__()
        if cfg.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm {cfg.feat_extract_norm!r}")
        ch_in = cfg.conv_dim[i - 1] if i else 1
        ch, eps = cfg.conv_dim[i], cfg.layer_norm_eps
        self.conv = nn.Conv1d(ch_in, ch, cfg.conv_kernel[i],
                              stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        self.channels_last = cfg.feat_extract_norm == "layer"
        self.layer_norm = (nn.LayerNorm(ch, eps=eps) if self.channels_last
                           else nn.GroupNorm(ch, ch, eps=eps) if i == 0 else None)

    def forward(self, x):  # [b, c, t]
        x = self.conv(x)
        if self.channels_last:
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class WavLMFeatureEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            WavLMConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, wave):  # [b, t] -> [b, c, frames]
        x = wave[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class WavLMFeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):  # [b, t, c]
        return self.projection(self.layer_norm(x))


class WavLMPositionalConvEmbedding(nn.Module):
    """The grouped positional conv, weight-normed over dim 2 (one gain per
    tap). An even kernel drops the conv's last frame."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                         groups=cfg.num_conv_pos_embedding_groups)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self.conv = nn.utils.weight_norm(conv, name="weight", dim=2)
        self.drop_last = k % 2 == 0

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the parametrizations API's names for the same two tensors
        for new, old in (("weight_g", "original0"), ("weight_v", "original1")):
            key = f"{prefix}conv.parametrizations.weight.{old}"
            if key in state_dict:
                state_dict[f"{prefix}conv.{new}"] = state_dict.pop(key)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):  # [b, t, h]
        pos = self.conv(x.transpose(1, 2))
        if self.drop_last:
            pos = pos[:, :, :-1]
        return F.gelu(pos).transpose(1, 2)


class WavLMEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = WavLMPositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(WavLMEncoderLayer(cfg, i == 0)
                                    for i in range(cfg.num_layers))

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        hidden_states, position_bias = [x], None
        for layer in self.layers:
            x, position_bias = layer(x, position_bias)
            hidden_states.append(x)
        return hidden_states


class WavLM(nn.Module):
    """wave [b, t] at 16 kHz -> the num_layers + 1 hidden states
    [b, frames, hidden] (index 0: the states before layer 0)."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = WavLMFeatureEncoder(cfg)
        self.feature_projection = WavLMFeatureProjection(cfg)
        self.encoder = WavLMEncoder(cfg)

    def forward(self, wave) -> list[torch.Tensor]:
        x = self.feature_extractor(wave).transpose(1, 2)
        return self.encoder(self.feature_projection(x))


def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """Polyphase windowed-sinc kernel [new, 1, 2 * width + orig] (built in
    float64, returned in float32), and width, orig, new."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t = t * math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * base_freq / orig
    return kernel.astype(np.float32)[:, None, :], width, orig, new


class Resampler(nn.Module):
    """wave [b, t] at orig_freq -> [b, ceil(t * new / orig)] at new_freq, as
    one conv of stride orig."""

    def __init__(self, orig_freq: int = 44100, new_freq: int = 16000,
                 lowpass_filter_width: int = 6, rolloff: float = 0.99):
        super().__init__()
        kernel, self.width, self.orig, self.new = sinc_resample_kernel(
            orig_freq, new_freq, lowpass_filter_width, rolloff)
        self.register_buffer("kernel", torch.from_numpy(kernel), persistent=False)

    def forward(self, wave):
        b, length = wave.shape
        x = F.pad(wave, (self.width, self.width + self.orig))[:, None, :]
        y = F.conv1d(x, self.kernel, stride=self.orig)  # [b, new, frames]
        y = y.transpose(1, 2).reshape(b, -1)
        return y[:, :-(-self.new * length // self.orig)]


class SLM(nn.Module):
    """The frozen feature model of the SLM losses: wave [b, t] at input_sr
    -> resampled to model_sr -> the WavLM's hidden states. It is built in
    eval() mode (it has no dropout, so the mode changes nothing) and its
    parameters take no gradient."""

    def __init__(self, wavlm: WavLM, input_sr: int = 44100, model_sr: int = 16000):
        super().__init__()
        self.resample = Resampler(input_sr, model_sr)
        self.wavlm = wavlm
        self.requires_grad_(False)
        self.eval()

    def forward(self, wave) -> list[torch.Tensor]:
        return self.wavlm(self.resample(wave))

    @staticmethod
    def embed(hidden_states: Sequence[torch.Tensor]) -> torch.Tensor:
        """The discriminator's input: the states stacked layer-major,
        [b, layers * hidden, frames] with channel l * hidden + j (the
        reference's torch.stack(hs, 1).transpose(-1, -2).flatten(1, 2))."""
        return torch.stack(tuple(hidden_states), 1).transpose(-1, -2).flatten(1, 2)


def wavlm_state_dict(sd: dict) -> dict:
    """An HF checkpoint's state_dict -> `WavLM`'s: the `wavlm.` prefix of a
    model with a head is stripped (the head dropped), and the training-time
    mask embedding, which inference never reads, is dropped."""
    if any(k.startswith("wavlm.") for k in sd):
        sd = {k[len("wavlm."):]: v for k, v in sd.items() if k.startswith("wavlm.")}
    return {k: v for k, v in sd.items() if k != "masked_spec_embed"}


def load_wavlm(path: str, device: str | torch.device = "cuda") -> tuple[WavLM, WavLMConfig]:
    """An HF checkpoint directory (config.json and model.safetensors or
    pytorch_model.bin) -> (frozen WavLM on `device`, its config). The
    reference keeps microsoft/wavlm-base-plus at ./slm/wavlm-base-plus
    (default_config.yml; losses.py:66)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = WavLMConfig.from_hf(json.load(f))
    st = os.path.join(path, "model.safetensors")
    pt = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(st):
        from safetensors.torch import load_file

        sd = load_file(st)
    elif os.path.isfile(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no WavLM weights under {path}")
    model = WavLM(cfg)
    model.load_state_dict(wavlm_state_dict(sd), strict=True)
    return model.requires_grad_(False).to(dev).eval(), cfg
