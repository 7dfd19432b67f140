"""Prior text encoder, V2.3 branch (reference: models.py:333-400).

Counterpart of `bert_vits2_tpu/models/text_encoder.py` with
`emotion="none"`: phone, tone and language embeddings plus three BERT
projections, scaled by sqrt(hidden), then the relative-position encoder
(speaker-conditioned at layer 2) and the prior projection. The V2.1/V2.2
emotion branches come with the old-version slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bert_vits2_tpu_torch.nn.attention import Encoder
from bert_vits2_tpu_torch.nn.conv import conv1d
from bert_vits2_tpu_torch.ops.masking import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 num_tones: int = 12, num_languages: int = 3,
                 bert_dim: int = 1024, gin_channels: int = 0,
                 use_ja_bert: bool = True, use_en_bert: bool = True,
                 ja_bert_dim: int = 1024):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
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
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size=kernel_size,
                               p_dropout=p_dropout, gin_channels=gin_channels)
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, x_lengths, tone, language, bert, ja_bert, en_bert,
                g=None):
        """x, tone, language: [b, t] int; bert/ja_bert/en_bert: [b, dim, t];
        g: [b, gin] -> (hidden [b, h, t], m, logs [b, out, t], x_mask [b, 1, t])."""
        xe = (self.emb(x) + self.tone_emb(tone)
              + self.language_emb(language)).transpose(1, 2)
        xe = xe + self.bert_proj(bert)
        if self.ja_bert_proj is not None:
            xe = xe + self.ja_bert_proj(ja_bert)
        if self.en_bert_proj is not None:
            xe = xe + self.en_bert_proj(en_bert)
        xe = xe * math.sqrt(self.hidden_channels)
        x_mask = sequence_mask(x_lengths, xe.shape[2])[:, None, :].to(xe.dtype)
        xe = self.encoder(xe * x_mask, x_mask, g=g)
        stats = self.proj(xe) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return xe, m, logs, x_mask
