"""PyTorch port, BERT conditioning: the port's `BertEncoder` against the JAX
package's `bert_jax.BertEncoder` with one HF state dict fed to both (the
port through `load_hf_bert`, JAX through `import_torch_bert`), the
extractor rules of `AutoBertExtractor`, and both packages' extractors on a
tiny random BERT checkpoint directory that the test writes itself.

Configs: the three tiny HF configs of tests/test_bert_jax.py (BERT, a
DeBERTa-v3-style and a DeBERTa-v2-style one), random-init by transformers
offline. Tolerance: every hidden state within 2e-5 (fp32, values O(1)),
padding invariance within 1e-5, as tests/test_bert_jax.py holds the JAX
encoder against transformers.
"""

import collections
import dataclasses
import json
import os
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from bert_vits2_tpu.text import bert_jax
from bert_vits2_tpu_torch.text import bert as port_bert
from bert_vits2_tpu_torch.text.bert_encoder import (
    BertEncoder,
    BertEncoderExtractor,
    EncoderConfig,
    load_hf_bert,
)
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

# transformers' torch classes only: skip its TensorFlow import (~6 s here)
os.environ.setdefault("USE_TF", "0")

ATOL = 2e-5
IDS = np.array([[2, 5, 7, 9, 11, 3], [2, 8, 4, 3, 0, 0]], np.int64)
MASK = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0]], np.int64)
SENTENCE = "你好，世界。"


def _hf_model(kind):
    from transformers import BertConfig, BertModel, DebertaV2Config, DebertaV2Model

    torch.manual_seed({"bert": 0, "deberta_v3": 1, "deberta_v2": 2}[kind])
    if kind == "bert":
        return BertModel(BertConfig(
            vocab_size=100, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40, type_vocab_size=2)).eval()
    if kind == "deberta_v3":  # share_att_key + buckets + norm_rel_ebd + conv
        return DebertaV2Model(DebertaV2Config(
            vocab_size=100, hidden_size=32, num_hidden_layers=3,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=0,
            relative_attention=True, position_buckets=8,
            pos_att_type=["p2c", "c2p"], share_att_key=True,
            norm_rel_ebd="layer_norm", conv_kernel_size=3,
            position_biased_input=False)).eval()
    # separate pos projections, no buckets, absolute pos biased input
    return DebertaV2Model(DebertaV2Config(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=0,
        relative_attention=True, position_buckets=-1,
        max_relative_positions=32, pos_att_type=["p2c", "c2p"],
        share_att_key=False, norm_rel_ebd="none", conv_kernel_size=0,
        position_biased_input=True)).eval()


def _port_encoder(hf):
    cfg = EncoderConfig.from_hf(hf.config)
    enc = BertEncoder(cfg).eval()
    enc.load_state_dict(load_hf_bert(hf.state_dict(), cfg), strict=True)
    return enc


def _port_hidden(enc, ids, mask):
    with torch.inference_mode():
        return [h.numpy() for h in enc(torch.from_numpy(ids), torch.from_numpy(mask))]


@pytest.mark.parametrize("kind", ["bert", "deberta_v3", "deberta_v2"])
def test_encoder_matches_jax(kind):
    """Every hidden state, on a full and a padded row, within 2e-5 of the
    JAX encoder fed the same HF state dict."""
    hf = _hf_model(kind)
    cfg = EncoderConfig.from_hf(hf.config)
    jcfg = bert_jax.EncoderConfig.from_hf(hf.config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = bert_jax.import_torch_bert(hf.state_dict(), jcfg)
    want = bert_jax.BertEncoder(jcfg).apply({"params": params}, IDS.astype(np.int32),
                                            MASK.astype(np.int32))
    got = _port_hidden(_port_encoder(hf), IDS, MASK)
    assert len(got) == len(want) == cfg.num_layers + 1
    for i, (g, w) in enumerate(zip(got, want)):
        valid = MASK.astype(bool)
        err = np.abs(g - np.asarray(w))[valid].max()
        assert err <= ATOL, (kind, i, err)


def test_config_from_json_string_pos_att_type():
    """config.json holds `pos_att_type` as "p2c|c2p"; from_hf splits it the
    way transformers' DebertaV2Config does."""
    from transformers import DebertaV2Config

    raw = dict(vocab_size=100, hidden_size=32, num_hidden_layers=1,
               num_attention_heads=4, intermediate_size=64,
               relative_attention=True, position_buckets=8,
               pos_att_type="p2c|c2p", share_att_key=True)
    assert EncoderConfig.from_hf(raw).pos_att_type == ("p2c", "c2p")
    assert (EncoderConfig.from_hf(raw).pos_att_type
            == tuple(DebertaV2Config(**raw).pos_att_type))


@pytest.mark.parametrize("kind", ["bert", "deberta_v3"])
def test_padding_mask_invariance(kind):
    """Padded positions do not change the unpadded outputs (bucketing)."""
    enc = _port_encoder(_hf_model(kind))
    ids, mask = IDS[:1], MASK[:1]
    out = _port_hidden(enc, ids, mask)
    out_p = _port_hidden(enc, np.pad(ids, ((0, 0), (0, 10))), np.pad(mask, ((0, 0), (0, 10))))
    for a, b in zip(out, out_p):
        np.testing.assert_allclose(a, b[:, : ids.shape[1]], atol=1e-5)


def test_auto_extractor_noise_rules(tmp_path):
    """Without weights: noise equal to RandomBertExtractor's, with one
    warning per language; describe() reports "noise"; allow_noise=False
    raises at construction."""
    paths = {lang: str(tmp_path / lang) for lang in ("ZH", "JP", "EN")}
    ext = port_bert.AutoBertExtractor(paths=paths, seed=3, device="cpu")
    assert ext.describe() == {"ZH": "noise", "JP": "noise", "EN": "noise"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = ext("abc", [1, 2, 1], "EN")
        b = ext("abc", [1, 2, 1], "EN")
        ext("abc", [2], "JP")
    assert [str(w.message).split(" (")[0] for w in caught] == [
        "NO BERT WEIGHTS for language EN", "NO BERT WEIGHTS for language JP"]
    want = port_bert.RandomBertExtractor(3)("abc", [1, 2, 1], "EN")
    assert a.shape == (4, port_bert.BERT_DIM) and np.array_equal(a, want)
    assert np.array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="allow_noise=False"):
        port_bert.AutoBertExtractor(paths=paths, allow_noise=False, device="cpu")


LANGS = ("ZH", "JP", "EN")


@pytest.mark.parametrize("case", ["auto, no weights", "auto, weights", "encoder"])
def test_lazy_loaders_load_each_language_once_under_threads(tmp_path, monkeypatch, case):
    """Eight threads ask one extractor for the three languages at once (a
    server's handler threads): `AutoBertExtractor._resolve` warns once per
    language without weights and, with weights, has the encoder read each
    language once; `BertEncoderExtractor._load` called directly reads each
    once. The warning and the read are counting stubs that sleep, so the
    threads overlap inside them."""
    counts, count_lock = collections.Counter(), threading.Lock()

    def count(key):
        with count_lock:
            counts[key] += 1
        time.sleep(0.05)

    def read(self, language):
        count(language)
        return ("tokenizer", "model")

    paths = {lang: str(tmp_path / lang) for lang in LANGS}
    monkeypatch.setattr(BertEncoderExtractor, "_read", read)
    if case == "auto, no weights":
        monkeypatch.setattr(port_bert.warnings, "warn",
                            lambda msg, stacklevel: count(msg.split(" (")[0]))
        want = {f"NO BERT WEIGHTS for language {lang}": 1 for lang in LANGS}
    else:
        monkeypatch.setattr(port_bert, "weights_present", lambda path: True)
        want = {lang: 1 for lang in LANGS}
    if case == "encoder":
        ext = BertEncoderExtractor(paths=paths, device="cpu")
        call = ext._load
    else:
        ext = port_bert.AutoBertExtractor(paths=paths, device="cpu")
        call = ext._resolve
    barrier, results = threading.Barrier(8), []

    def worker(i):
        barrier.wait()
        for lang in LANGS[i % 3:] + LANGS[:i % 3]:
            results.append(call(lang))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert dict(counts) == want and len(results) == 24
    if case == "auto, weights":
        assert ext.describe() == {lang: "torch" for lang in LANGS}
        assert {id(r[1]) for r in results} == {id(ext._shared)}


def test_shared_pieces_match_jax():
    """expand_word2ph, RandomBertExtractor (within one process) and
    weights_present agree with the JAX package's."""
    from bert_vits2_tpu.text import bert as jax_bert

    feats = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert np.array_equal(port_bert.expand_word2ph(feats, [2, 0, 3]),
                          jax_bert.expand_word2ph(feats, [2, 0, 3]))
    assert np.array_equal(port_bert.RandomBertExtractor(5)("x y", [3, 1], "ZH"),
                          jax_bert.RandomBertExtractor(5)("x y", [3, 1], "ZH"))
    assert port_bert.BERT_DIM == jax_bert.BERT_DIM
    assert {k: v.split("/bert/")[1] for k, v in port_bert.DEFAULT_BERT_PATHS.items()} == {
        k: v.split("/bert/")[1] for k, v in jax_bert.DEFAULT_BERT_PATHS.items()}


@pytest.fixture(scope="module")
def tiny_bert_dir(tmp_path_factory):
    """A local HF checkpoint: a random 2-layer BertForMaskedLM (keys under
    `bert.`) saved as model.safetensors, and a BertTokenizer whose vocab
    holds the test sentence's characters."""
    from transformers import BertConfig, BertForMaskedLM, BertTokenizer

    from bert_vits2_tpu_torch.text import clean_text

    d = tmp_path_factory.mktemp("tiny-bert")
    norm, _, _, word2ph = clean_text(SENTENCE, "ZH")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(norm))
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    torch.manual_seed(4)
    BertForMaskedLM(BertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2)).save_pretrained(str(d))
    assert port_bert.weights_present(str(d))
    return str(d), norm, word2ph


def test_extractors_on_local_checkpoint(tiny_bert_dir):
    """JaxBertExtractor and the port's BertEncoderExtractor read the same
    directory and give the same phone-level features, with and without a
    style text; AutoBertExtractor resolves the language to the port's
    encoder, and refuses a language whose weights vanished."""
    path, norm, word2ph = tiny_bert_dir
    paths = {"ZH": path, "JP": path, "EN": path}
    jax_ext = bert_jax.JaxBertExtractor(paths=paths)
    port_ext = BertEncoderExtractor(paths=paths, device="cpu")
    for style in (None, "世界"):
        want = jax_ext(norm, word2ph, "ZH", style_text=style)
        got = port_ext(norm, word2ph, "ZH", style_text=style)
        assert got.shape == want.shape == (sum(word2ph), 32)
        assert np.abs(got - want).max() <= ATOL
    auto = port_bert.AutoBertExtractor(paths=paths, allow_noise=False, device="cpu")
    assert auto.describe() == {"ZH": "torch", "JP": "torch", "EN": "torch"}
    assert np.array_equal(auto(norm, word2ph, "ZH"), port_ext(norm, word2ph, "ZH"))
    assert auto.describe()["ZH"] == "torch" and auto._shared.device.type == "cpu"
    auto.paths["EN"] = path + "-missing"
    with pytest.raises(FileNotFoundError, match="allow_noise_bert=False"):
        auto("hello", [1, 1, 1], "EN")
    cfg = json.load(open(f"{path}/config.json"))
    assert EncoderConfig.from_hf(cfg).num_layers == 2
