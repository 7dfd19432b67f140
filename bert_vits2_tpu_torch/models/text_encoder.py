"""Prior text encoder (reference: models.py:333-400).

Counterpart of `bert_vits2_tpu/models/text_encoder.py`: phone, tone and
language embeddings plus the BERT projections, scaled by sqrt(hidden), then
the relative-position encoder (speaker-conditioned at layer 2) and the
prior projection.

Version families (compat/versions.py): V1.0.x projects `bert` only
(oldVersion/V101/models.py:342), V1.1.x adds a 768-d `ja_bert`
(oldVersion/V110/models.py:343), and two families add one utterance-level
emotion vector to every position, under the reference's names:

- `vq210` (oldVersion/V210/models.py:347-393): `emo_proj` (Linear
  1024 -> 1024), `emo_quantizer` (10 codes of 1024), `emo_q_proj` (Linear
  1024 -> hidden). A [b] int input is a codebook index (direct lookup); a
  [b, 1024] wav2vec2 vector is projected and quantized.
- `clap220` (oldVersion/V220/models.py:322-424): a [b, 512] CLAP feature
  through `in_feature_net` (Linear 512 -> 1028, exact GELU, LayerNorm, one
  residual gated-MLP block, Linear 1028 -> 512), `emo_vq` (32 heads of 64
  codes of 32 dims behind 512 <-> 1024 projections) and `out_feature_net`
  (Linear 512 -> hidden).

The LayerNorms are torch's, with the reference's eps of 1e-5; the JAX
module's two are flax's default 1e-6 (ROADMAP §C, R.3).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from bert_vits2_tpu_torch.nn.attention import Encoder
from bert_vits2_tpu_torch.nn.conv import conv1d
from bert_vits2_tpu_torch.nn.vq import VectorQuantizer
from bert_vits2_tpu_torch.ops.masking import sequence_mask


class _MLP(nn.Module):
    """c_proj(silu(c_fc1 x) * c_fc2 x), no biases (oldVersion/V220/models.py:333-343)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.c_fc1 = nn.Linear(in_dim, hidden_dim, bias=False)
        self.c_fc2 = nn.Linear(in_dim, hidden_dim, bias=False)
        self.c_proj = nn.Linear(hidden_dim, in_dim, bias=False)

    def forward(self, x):
        return self.c_proj(F.silu(self.c_fc1(x)) * self.c_fc2(x))


class _Block(nn.Module):
    """x + mlp(norm x) (oldVersion/V220/models.py:322-331)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(in_dim)
        self.mlp = _MLP(in_dim, hidden_dim)

    def forward(self, x):
        return x + self.mlp(self.norm(x))


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 num_tones: int = 12, num_languages: int = 3,
                 bert_dim: int = 1024, gin_channels: int = 0,
                 use_ja_bert: bool = True, use_en_bert: bool = True,
                 ja_bert_dim: int = 1024, emotion: str = "none"):
        super().__init__()
        if emotion not in ("none", "vq210", "clap220"):
            raise ValueError(f"unknown emotion branch {emotion!r}")
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emotion = emotion
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.tone_emb = nn.Embedding(num_tones, hidden_channels)
        self.language_emb = nn.Embedding(num_languages, hidden_channels)
        for e in (self.emb, self.tone_emb, self.language_emb):
            nn.init.normal_(e.weight, 0.0, hidden_channels ** -0.5)
        self.bert_proj = conv1d(bert_dim, hidden_channels, 1)
        self.ja_bert_proj = (conv1d(ja_bert_dim, hidden_channels, 1)
                             if use_ja_bert else None)
        self.en_bert_proj = (conv1d(bert_dim, hidden_channels, 1)
                             if use_en_bert else None)
        if emotion == "vq210":
            self.emo_proj = nn.Linear(1024, 1024)
            self.emo_quantizer = VectorQuantizer(1024, 10)
            self.emo_q_proj = nn.Linear(1024, hidden_channels)
        elif emotion == "clap220":
            self.in_feature_net = nn.Sequential(
                nn.Linear(512, 1028, bias=False), nn.GELU(), nn.LayerNorm(1028),
                _Block(1028, 512), nn.Linear(1028, 512, bias=False))
            self.emo_vq = VectorQuantizer(512, 64, codebook_dim=32, heads=32)
            self.out_feature_net = nn.Linear(512, hidden_channels)
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size=kernel_size,
                               p_dropout=p_dropout, gin_channels=gin_channels)
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def emotion_embedding(self, emo: torch.Tensor) -> torch.Tensor:
        """The emotion input -> the [b, hidden] vector added at every position:
        vq210 takes [b] codebook indices or [b, 1024] vectors, clap220 [b, 512]."""
        if self.emotion == "vq210":
            if emo.dim() == 1:
                e = self.emo_quantizer.lookup(emo)
            else:
                e = self.emo_quantizer(self.emo_proj(emo))
            return self.emo_q_proj(e)
        return self.out_feature_net(self.emo_vq(self.in_feature_net(emo)))

    def forward(self, x, x_lengths, tone, language, bert, ja_bert, en_bert,
                emo=None, g=None):
        """x, tone, language: [b, t] int; bert/ja_bert/en_bert: [b, dim, t];
        emo: the emotion input of a vq210 / clap220 model (see
        `emotion_embedding`), None otherwise; g: [b, gin]
        -> (hidden [b, h, t], m, logs [b, out, t], x_mask [b, 1, t])."""
        xe = (self.emb(x) + self.tone_emb(tone)
              + self.language_emb(language)).transpose(1, 2)
        xe = xe + self.bert_proj(bert)
        if self.ja_bert_proj is not None:
            xe = xe + self.ja_bert_proj(ja_bert)
        if self.en_bert_proj is not None:
            xe = xe + self.en_bert_proj(en_bert)
        if self.emotion != "none":
            if emo is None:
                raise ValueError(f"the {self.emotion} text encoder takes an emotion input")
            xe = xe + self.emotion_embedding(emo)[:, :, None]
        xe = xe * math.sqrt(self.hidden_channels)
        x_mask = sequence_mask(x_lengths, xe.shape[2])[:, None, :].to(xe.dtype)
        xe = self.encoder(xe * x_mask, x_mask, g=g)
        stats = self.proj(xe) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return xe, m, logs, x_mask
