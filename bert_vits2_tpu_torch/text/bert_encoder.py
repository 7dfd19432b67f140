"""BERT-family encoders for the linguistic conditioning features, on the card
(reference: text/chinese_bert.py:15-60 et al. run HF torch models).

Counterpart of `bert_vits2_tpu/text/bert_jax.py`. One module covers the
three production encoders:

- ZH `chinese-roberta-wwm-ext-large`: standard BERT;
- JA `deberta-v2-large-japanese-char-wwm`, EN `deberta-v3-large`:
  DeBERTa-v2 disentangled attention (relative embeddings with log-bucket
  positions, c2p and p2c bias terms, shared or separate position
  projections, an optional first-layer conv branch).

Behaviour follows transformers' modeling_deberta_v2.py and modeling_bert.py
at fp32, as the JAX module does; the products are `torch.matmul` and the
softmax plain PyTorch (the JAX encoder runs no Pallas kernel). Inference
only: dropout is off, the encoders are frozen feature extractors.

`load_hf_bert` maps an HF state dict onto this module (the counterpart of
`import_torch_bert`); `BertEncoderExtractor` serves phone-level features
from a local HF checkpoint directory (the counterpart of
`JaxBertExtractor`). Given a mesh with a model axis, the extractor splits
each layer Megatron-style over the axis's devices (`shard_bert`, the JAX
`bert_partition_specs`): query, key, value, the position projections and
`intermediate` column-parallel over whole heads, `attention_output` and
`output` row-parallel, the embeddings, relative table and LayerNorms
replicated on the first device, which adds the shards' partial sums in
rank order. Two departures from the JAX module, both towards
transformers: `from_hf` splits a `pos_att_type` string ("p2c|c2p", as
config.json files hold it) the way `DebertaV2Config` does, and the conv
branch's activation is transformers' `ACT2FN[conv_act]` (the JAX module
looks the name up in `jax.numpy` and falls back to tanh).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bert_vits2_tpu_torch.device import resolve_device
from bert_vits2_tpu_torch.parallel.sharding import Split, shard_tensor
from bert_vits2_tpu_torch.parallel.tensor import sum_partials

_CONV_ACT = {"tanh": torch.tanh, "gelu": F.gelu, "relu": F.relu}


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    embedding_size: int | None = None  # != hidden -> embed_proj (deberta-v3)
    position_biased_input: bool = True
    # deberta-v2 disentangled attention; all off -> plain BERT
    relative_attention: bool = False
    position_buckets: int = -1
    max_relative_positions: int = -1
    pos_att_type: Sequence[str] = ()
    share_att_key: bool = False
    norm_rel_ebd: str = "none"
    conv_kernel_size: int = 0
    conv_act: str = "tanh"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def pos_ebd_size(self) -> int:
        m = self.max_relative_positions
        if m < 1:
            m = self.max_position_embeddings
        return self.position_buckets if self.position_buckets > 0 else m

    @classmethod
    def from_hf(cls, hf) -> "EncoderConfig":
        """Build from a transformers Bert/DebertaV2 config object or dict."""
        g = (lambda k, d=None: getattr(hf, k, d)) if not isinstance(hf, dict) else (
            lambda k, d=None: hf.get(k, d)
        )
        emb = g("embedding_size")
        pos_att_type = g("pos_att_type") or ()
        if isinstance(pos_att_type, str):
            pos_att_type = [x.strip() for x in pos_att_type.lower().split("|")]
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            num_layers=g("num_hidden_layers"),
            num_heads=g("num_attention_heads"),
            intermediate_size=g("intermediate_size"),
            max_position_embeddings=g("max_position_embeddings", 512),
            type_vocab_size=g("type_vocab_size", 0) or 0,
            layer_norm_eps=g("layer_norm_eps", 1e-12),
            embedding_size=emb if emb and emb != g("hidden_size") else None,
            position_biased_input=g("position_biased_input", True),
            relative_attention=bool(g("relative_attention", False)),
            position_buckets=g("position_buckets", -1) or -1,
            max_relative_positions=g("max_relative_positions", -1) or -1,
            pos_att_type=tuple(pos_att_type),
            share_att_key=bool(g("share_att_key", False)),
            norm_rel_ebd=g("norm_rel_ebd", "none") or "none",
            conv_kernel_size=g("conv_kernel_size", 0) or 0,
            conv_act=g("conv_act", "tanh") or "tanh",
        )


def make_log_bucket_position(rel_pos: torch.Tensor, bucket_size: int,
                             max_position: int) -> torch.Tensor:
    """Log-bucketed relative positions (modeling_deberta_v2.py:58-71)."""
    sign = torch.sign(rel_pos)
    mid = bucket_size // 2
    abs_pos = torch.where((rel_pos < mid) & (rel_pos > -mid),
                          torch.full_like(rel_pos, mid - 1),
                          rel_pos.abs()).float()
    log_pos = torch.ceil(torch.log(abs_pos / mid)
                         / math.log((max_position - 1) / mid) * (mid - 1)) + mid
    return torch.where(abs_pos <= mid, rel_pos.float(), log_pos * sign).long()


def build_relative_position(t: int, cfg: EncoderConfig,
                            device: torch.device | None = None) -> torch.Tensor:
    """[t, t] bucketed q-k relative position ids."""
    ids = torch.arange(t, device=device)
    rel = ids[:, None] - ids[None, :]
    m = cfg.max_relative_positions
    if m < 1:
        m = cfg.max_position_embeddings
    if cfg.position_buckets > 0 and m > 0:
        rel = make_log_bucket_position(rel, cfg.position_buckets, m)
    return rel


class SelfAttention(nn.Module):
    """BERT scaled-dot attention, optionally with DeBERTa-v2 disentangled
    c2p/p2c relative bias (modeling_deberta_v2.py:195-351)."""

    def __init__(self, cfg: EncoderConfig, in_features: int | None = None):
        """in_features: the projections' input width where it is not
        cfg.hidden_size (a model rank's shard: cfg then holds its heads and
        their width)."""
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        i = h if in_features is None else in_features
        self.query, self.key, self.value = nn.Linear(i, h), nn.Linear(i, h), nn.Linear(i, h)
        if cfg.relative_attention and not cfg.share_att_key:
            if "c2p" in cfg.pos_att_type:
                self.pos_key_proj = nn.Linear(i, h)
            if "p2c" in cfg.pos_att_type:
                self.pos_query_proj = nn.Linear(i, h)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:  # [b, t, h] -> [b, nh, t, hd]
        cfg = self.cfg
        return t.reshape(t.shape[0], t.shape[1], cfg.num_heads, cfg.head_dim).transpose(1, 2)

    def forward(self, x, attn_bias, rel_embeddings, rel_pos):
        cfg = self.cfg
        q, k, v = (self._heads(proj(x)) for proj in (self.query, self.key, self.value))
        scale_factor = 1
        if cfg.relative_attention:
            scale_factor += ("c2p" in cfg.pos_att_type) + ("p2c" in cfg.pos_att_type)
        scale = math.sqrt(cfg.head_dim * scale_factor)
        scores = torch.matmul(q, k.transpose(-1, -2)) / scale

        if cfg.relative_attention and rel_embeddings is not None:
            span = cfg.pos_ebd_size
            rel_emb = rel_embeddings[: span * 2][None]  # [1, 2s, h]
            if cfg.share_att_key:
                pos_k, pos_q = self._heads(self.key(rel_emb)), self._heads(self.query(rel_emb))
            else:
                pos_k = (self._heads(self.pos_key_proj(rel_emb))
                         if "c2p" in cfg.pos_att_type else None)
                pos_q = (self._heads(self.pos_query_proj(rel_emb))
                         if "p2c" in cfg.pos_att_type else None)
            b, nh, t = q.shape[0], q.shape[1], q.shape[2]
            if "c2p" in cfg.pos_att_type:
                c2p = torch.matmul(q, pos_k.transpose(-1, -2))  # [b, nh, q, 2s]
                c2p_pos = torch.clamp(rel_pos + span, 0, span * 2 - 1)
                c2p = torch.gather(c2p, -1, c2p_pos.expand(b, nh, t, t))
                scores = scores + c2p / scale
            if "p2c" in cfg.pos_att_type:
                p2c = torch.matmul(k, pos_q.transpose(-1, -2))  # [b, nh, k, 2s]
                p2c_pos = torch.clamp(-rel_pos + span, 0, span * 2 - 1)
                p2c = torch.gather(p2c, -1, p2c_pos.expand(b, nh, t, t))
                scores = scores + p2c.transpose(-1, -2) / scale

        probs = torch.softmax(scores + attn_bias, dim=-1)  # [b, 1, 1, k] additive mask
        ctx = torch.matmul(probs, v)
        return ctx.transpose(1, 2).reshape(x.shape[0], x.shape[1], cfg.hidden_size)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = SelfAttention(cfg)
        self.attention_output = nn.Linear(h, h)
        self.attention_norm = nn.LayerNorm(h, eps=eps)
        self.intermediate = nn.Linear(h, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, h)
        self.output_norm = nn.LayerNorm(h, eps=eps)
        self.shards = None  # the model axis's `_LayerShard`s (`shard_bert`)

    def forward(self, x, attn_bias, rel_embeddings, rel_pos):
        if self.shards is not None:
            return self._sharded(x, attn_bias, rel_embeddings, rel_pos)
        attn = self.attention_output(self.attention(x, attn_bias, rel_embeddings, rel_pos))
        x = self.attention_norm(attn + x)
        out = self.output(F.gelu(self.intermediate(x)))
        return self.output_norm(out + x)

    def _sharded(self, x, attn_bias, rel_embeddings, rel_pos):
        """Each shard's heads and intermediate columns on its device, the
        row-parallel partial sums added here in rank order, then the bias."""
        def to(a, dev):
            return None if a is None else a.to(dev)

        parts = [s.attention_output(s.attention(*(to(a, s.device) for a in (
            x, attn_bias, rel_embeddings, rel_pos)))) for s in self.shards]
        attn = sum_partials(parts, x.device) + self.attention_output.bias
        x = self.attention_norm(attn + x)
        parts = [s.output(F.gelu(s.intermediate(x.to(s.device)))) for s in self.shards]
        out = sum_partials(parts, x.device) + self.output.bias
        return self.output_norm(out + x)


_COLUMN = ("attention.query", "attention.key", "attention.value",
           "attention.pos_key_proj", "attention.pos_query_proj", "intermediate")
_ROW = ("attention_output", "output")


def bert_tp_spec(name: str, n_model: int) -> Split | None:
    """The split of `BertEncoder` state_dict leaf `name` over n_model model
    ranks (the JAX `bert_partition_specs`): the projections of q, k, v and
    the positions and `intermediate` column-parallel (weight and bias, dim
    0 of the [out, in] weight), `attention_output` and `output` row-parallel
    (the weight's dim 1; the bias replicated), the rest replicated."""
    if n_model <= 1 or not name.startswith("layers."):
        return None
    layer_leaf = name.split(".", 2)[2]
    module, leaf = layer_leaf.rsplit(".", 1)
    if module in _COLUMN:
        return Split(0)
    if module in _ROW and leaf == "weight":
        return Split(1)
    return None


class _LayerShard(nn.Module):
    """One model rank's share of a `TransformerLayer` on its device: its
    heads (column-parallel projections, `SelfAttention` over them), its
    rows of `attention_output`, its columns of `intermediate` and its rows
    of `output` (the row-parallel layers without their bias)."""

    def __init__(self, layer: TransformerLayer, rank: int, n: int, device):
        super().__init__()
        cfg = layer.attention.cfg
        h = cfg.hidden_size
        local = dataclasses.replace(cfg, hidden_size=h // n, num_heads=cfg.num_heads // n)
        self.device = torch.device(device)
        self.attention = SelfAttention(local, in_features=h)
        self.attention_output = nn.Linear(h // n, h, bias=False)
        self.intermediate = nn.Linear(h, cfg.intermediate_size // n)
        self.output = nn.Linear(cfg.intermediate_size // n, h, bias=False)
        full = layer.state_dict()
        mine = {k: shard_tensor(full[k], split, rank, n)
                for k in self.state_dict()
                for split in [bert_tp_spec(f"layers.0.{k}", n)] if split is not None}
        self.load_state_dict(mine, strict=True)
        self.to(self.device)


def shard_bert(model: "BertEncoder", devices) -> "BertEncoder":
    """Split every layer of `model` (on devices[0]) over the model-axis
    `devices` in place (module note); a device may appear twice. The full
    projections leave the layers: their shards hold them. Refuses a width
    the heads or the intermediate size do not split into."""
    cfg, n = model.cfg, len(devices)
    if cfg.num_heads % n or cfg.intermediate_size % n:
        raise ValueError(f"a BERT of {cfg.num_heads} heads and intermediate size "
                         f"{cfg.intermediate_size} does not split over {n} model ranks")
    with torch.no_grad():
        for layer in model.layers:
            layer.shards = nn.ModuleList(_LayerShard(layer, r, n, devices[r])
                                         for r in range(n))
            del layer.attention, layer.intermediate
            layer.attention_output.weight = None
            layer.output.weight = None
    return model


class BertEncoder(nn.Module):
    """Returns all hidden states [(b, t, h)] * (num_layers + 1) in HF order
    (index 0 = embedding output), so hidden_states[-3] is the reference's
    feature tap (text/chinese_bert.py:45)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        emb = cfg.embedding_size or h
        self.word_embeddings = nn.Embedding(cfg.vocab_size, emb)
        if cfg.position_biased_input:
            self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, emb)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, emb)
        if cfg.embedding_size and cfg.embedding_size != h:
            self.embed_proj = nn.Linear(emb, h, bias=False)
        self.embeddings_norm = nn.LayerNorm(h, eps=eps)
        if cfg.relative_attention:
            self.rel_embeddings = nn.Parameter(torch.randn(cfg.pos_ebd_size * 2, h) * 0.02)
            if "layer_norm" in cfg.norm_rel_ebd:
                self.rel_embeddings_norm = nn.LayerNorm(h, eps=eps)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))
        if cfg.conv_kernel_size > 0:
            if cfg.conv_act not in _CONV_ACT:
                raise ValueError(f"conv_act {cfg.conv_act!r} is not one of {sorted(_CONV_ACT)}")
            k = cfg.conv_kernel_size
            self.conv = nn.Conv1d(h, h, k, padding=(k - 1) // 2)
            self.conv_norm = nn.LayerNorm(h, eps=eps)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None) -> list:
        cfg = self.cfg
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.word_embeddings(input_ids)
        if cfg.position_biased_input:
            x = x + self.position_embeddings(torch.arange(t, device=x.device))[None]
        if cfg.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        if cfg.embedding_size and cfg.embedding_size != cfg.hidden_size:
            x = self.embed_proj(x)
        x = self.embeddings_norm(x)
        mask = attention_mask[..., None].to(x.dtype)
        if cfg.relative_attention:  # deberta masks embeddings by input mask
            x = x * mask
        attn_bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min

        rel_embeddings, rel_pos = None, None
        if cfg.relative_attention:
            rel_embeddings = self.rel_embeddings
            if "layer_norm" in cfg.norm_rel_ebd:
                rel_embeddings = self.rel_embeddings_norm(rel_embeddings)
            rel_pos = build_relative_position(t, cfg, device=x.device)

        hidden_states = [x]
        for i, layer in enumerate(self.layers):
            y = layer(x, attn_bias, rel_embeddings, rel_pos)
            if i == 0 and cfg.conv_kernel_size > 0:
                # conv branch over the EMBEDDING output, added to layer-0 out
                # (modeling_deberta_v2.py:453-487)
                conv = self.conv(x.transpose(1, 2)).transpose(1, 2) * mask
                y = self.conv_norm(y + _CONV_ACT[cfg.conv_act](conv)) * mask
            hidden_states.append(y)
            x = y
        return hidden_states


# ---------------------------------------------------------------------------
# HF state dict -> this module
# ---------------------------------------------------------------------------


def load_hf_bert(state_dict: dict, cfg: EncoderConfig) -> dict[str, torch.Tensor]:
    """HF Bert/DebertaV2 state dict (torch tensors or numpy) -> the state_dict
    of `BertEncoder(cfg)` (float32 CPU tensors).

    Accepts the `bert.`/`deberta.`/`roberta.` prefixes of *ForMaskedLM
    checkpoints or bare base-model dicts; keys this module has no use for
    (the MLM head, pooler, position ids) are ignored. Separate position
    projections without a bias get a zero bias, as in the JAX import.
    """
    sd = {}
    for k, v in state_dict.items():
        for pre in ("bert.", "deberta.", "roberta."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        sd[k] = torch.as_tensor(np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32))

    out: dict[str, torch.Tensor] = {}
    emb = "embeddings."
    out["word_embeddings.weight"] = sd[emb + "word_embeddings.weight"]
    if cfg.position_biased_input:
        out["position_embeddings.weight"] = sd[emb + "position_embeddings.weight"]
    if cfg.type_vocab_size > 0:
        out["token_type_embeddings.weight"] = sd[emb + "token_type_embeddings.weight"]
    if cfg.embedding_size and cfg.embedding_size != cfg.hidden_size:
        out["embed_proj.weight"] = sd[emb + "embed_proj.weight"]
    out["embeddings_norm.weight"] = sd[emb + "LayerNorm.weight"]
    out["embeddings_norm.bias"] = sd[emb + "LayerNorm.bias"]
    if cfg.relative_attention:
        out["rel_embeddings"] = sd["encoder.rel_embeddings.weight"]
        if "layer_norm" in cfg.norm_rel_ebd:
            out["rel_embeddings_norm.weight"] = sd["encoder.LayerNorm.weight"]
            out["rel_embeddings_norm.bias"] = sd["encoder.LayerNorm.bias"]
    if cfg.conv_kernel_size > 0:
        for ours, theirs in (("conv", "conv.conv"), ("conv_norm", "conv.LayerNorm")):
            out[f"{ours}.weight"] = sd[f"encoder.{theirs}.weight"]
            out[f"{ours}.bias"] = sd[f"encoder.{theirs}.bias"]

    deberta = "encoder.layer.0.attention.self.query_proj.weight" in sd
    names = ({"query": "query_proj", "key": "key_proj", "value": "value_proj"}
             if deberta else {"query": "query", "key": "key", "value": "value"})
    for i in range(cfg.num_layers):
        hf, ours = f"encoder.layer.{i}.", f"layers.{i}."
        att = hf + "attention.self."
        pairs = [(f"attention.{a}", att + b) for a, b in names.items()]
        pairs += [("attention_output", hf + "attention.output.dense"),
                  ("attention_norm", hf + "attention.output.LayerNorm"),
                  ("intermediate", hf + "intermediate.dense"),
                  ("output", hf + "output.dense"),
                  ("output_norm", hf + "output.LayerNorm")]
        for a, b in pairs:
            out[f"{ours}{a}.weight"] = sd[b + ".weight"]
            out[f"{ours}{a}.bias"] = sd[b + ".bias"]
        for proj in ("pos_key_proj", "pos_query_proj"):
            if att + proj + ".weight" in sd:
                out[f"{ours}attention.{proj}.weight"] = sd[att + proj + ".weight"]
                out[f"{ours}attention.{proj}.bias"] = sd.get(
                    att + proj + ".bias", torch.zeros(cfg.hidden_size))
    return out


# ---------------------------------------------------------------------------
# production extractor (the BertExtractor protocol of text/bert.py)
# ---------------------------------------------------------------------------


class BertEncoderExtractor:
    """Phone-level BERT features computed on the extractor's device (the card
    by default). Loads HF-format local checkpoints (config.json +
    model.safetensors or pytorch_model.bin) into `BertEncoder` once per
    language and pads each text to a length bucket, as `JaxBertExtractor`
    does; the feature tap is hidden_states[-3].

    transformers (the tokenizer) and safetensors are imported only when a
    language's weights are loaded.

    mesh: a one-process `parallel.Mesh` whose model axis splits each
    encoder on load (`shard_bert`) over the first data coordinate's
    model-axis devices (the JAX extractor's `bert_partition_specs` on its
    mesh); the extractor's device is then the mesh's first, and `device`
    is not read.
    """

    def __init__(self, paths: dict | None = None,
                 length_buckets=(32, 64, 128, 256, 512),
                 device: str | torch.device = "cuda", mesh=None):
        from bert_vits2_tpu_torch.text.bert import DEFAULT_BERT_PATHS

        self.paths = dict(DEFAULT_BERT_PATHS)
        if paths:
            self.paths.update(paths)
        self.length_buckets = tuple(sorted(length_buckets))
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("the BERT extractor takes a one-process mesh "
                                 "(make_mesh(n_data, n_model, devices=...))")
            device = mesh.devices[0, 0]
        self.mesh = mesh
        self.device = resolve_device(device)
        self._loaded: dict = {}
        # server handler threads load concurrently: each language once
        self._lock = threading.Lock()

    def _load(self, language: str):
        if language in self._loaded:
            return self._loaded[language]
        with self._lock:
            if language not in self._loaded:
                self._loaded[language] = self._read(language)
        return self._loaded[language]

    def _read(self, language: str):
        """language -> (tokenizer, BertEncoder on the device) from disk."""
        import json

        path = self.paths[language]
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no local BERT weights for {language} at {path}")
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path)
        with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
            cfg = EncoderConfig.from_hf(json.load(f))
        st = os.path.join(path, "model.safetensors")
        pt = os.path.join(path, "pytorch_model.bin")
        if os.path.isfile(st):
            from safetensors.torch import load_file

            sd = load_file(st)
        elif os.path.isfile(pt):
            sd = torch.load(pt, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(f"no weights file under {path}")
        model = BertEncoder(cfg)
        model.load_state_dict(load_hf_bert(sd, cfg), strict=True)
        return (tok, self.place(model))

    def place(self, model: BertEncoder) -> BertEncoder:
        """The encoder on the extractor's device in eval mode, split over the
        mesh's model axis when it has one."""
        model = model.to(self.device).eval()
        if self.mesh is not None and self.mesh.n_model > 1:
            shard_bert(model, [resolve_device(d) for d in self.mesh.devices[0]])
        return model

    def _bucket(self, t: int) -> int:
        for b in self.length_buckets:
            if t <= b:
                return b
        return ((t + 127) // 128) * 128

    @torch.inference_mode()
    def _run(self, language: str, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        _tok, model = self._loaded[language]
        t = ids.shape[1]
        t_pad = self._bucket(t)
        ids_p = np.zeros((1, t_pad), np.int64)
        mask_p = np.zeros((1, t_pad), np.int64)
        ids_p[:, :t] = ids
        mask_p[:, :t] = mask
        out = model(torch.from_numpy(ids_p).to(self.device),
                    torch.from_numpy(mask_p).to(self.device))[-3]
        return out[0, :t].float().cpu().numpy()

    def _word_features(self, text: str, language: str) -> np.ndarray:
        tok, _model = self._load(language)
        enc = tok(text, return_tensors="np")
        ids = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc.get("attention_mask", np.ones_like(ids)), np.int64)
        return self._run(language, ids, mask)

    def __call__(self, norm_text, word2ph, language, style_text=None,
                 style_weight: float = 0.7):
        from bert_vits2_tpu_torch.text.bert import expand_word2ph

        feats = self._word_features(norm_text, language)
        assert feats.shape[0] == len(word2ph), (feats.shape, len(word2ph))
        if style_text:
            style = self._word_features(style_text, language).mean(0, keepdims=True)
            feats = feats * (1.0 - style_weight) + style * style_weight
        return expand_word2ph(feats, word2ph).astype(np.float32)
