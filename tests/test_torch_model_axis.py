"""PyTorch port, the model axis in one process: the tensor-parallel specs
against the JAX package's, the Megatron split of the BERT encoder, the
engine's mesh; and the two satellites of the model-axis slice, device
traces (`utils/profiling.py`, `Trainer.run(profile_at_step=)`) and the
config.yml loader (`config.Config`). No JAX compile: the JAX specs are
computed on parameter trees (`to_jax_params` of the port's state_dict, the
JAX `import_torch_bert` of an HF-layout one).

- Specs: the port's `tp_specs` on the tiny V2.3 synthesizer of
  tests/conftest.py (n_heads 2) shard the leaves the JAX `tp_specs`
  shards on the converted tree, on the matching dimension (the port's
  [out, in, k] dim 0 is the JAX kernel's last, dim 1 its second to last),
  at n_model 2; at n_model 4 the attention stays replicated where JAX
  splits it (D.2). At least 8 leaves are sharded, as the JAX test asserts.
- BERT: the port's encoder split over ["cpu", "cpu"] against the unsharded
  encoder, every hidden state within 1e-5 of its largest entry (relative);
  the split leaves are those of JAX `bert_partition_specs`.
"""

import os

import pytest
import torch

from bert_vits2_tpu_torch.compat.params import to_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
from bert_vits2_tpu_torch.parallel import make_mesh
from bert_vits2_tpu_torch.parallel.sharding import shard_tensor, tp_gather, tp_shard, tp_specs
from bert_vits2_tpu_torch.text.bert_encoder import (
    BertEncoder,
    BertEncoderExtractor,
    EncoderConfig,
    bert_tp_spec,
)
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

BERT_REL = 1e-5
# tests/conftest.py's tiny_model
CONFTEST_TINY = dict(
    n_vocab=20, bert_dim=1024, spec_channels=33, segment_size=8,
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
    n_layers=1, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4), upsample_initial_channel=16, upsample_kernel_sizes=(8, 8),
    n_speakers=4, gin_channels=8, n_layers_trans_flow=2)


@pytest.fixture(scope="module")
def synth_state():
    torch.manual_seed(0)
    return Synthesizer(ModelConfig(**CONFTEST_TINY)).state_dict()


def _jax_leaf(key: str, value) -> tuple[tuple[str, ...], int]:
    """(the JAX tree path of port leaf `key`, its rank there)."""
    tree = to_jax_params({key: value})
    path = []
    while isinstance(tree, dict):
        (name, tree), = tree.items()
        path.append(name)
    return tuple(path), tree.ndim


def _jax_sharded(jax_specs, path):
    node = jax_specs
    for p in path:
        node = node[p]
    return [i for i, a in enumerate(tuple(node)) if a is not None]


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_specs_shard_the_leaves_jax_shards(synth_state, n_model):
    from bert_vits2_tpu.parallel.sharding import tp_specs as jax_tp_specs

    jax_specs = jax_tp_specs(to_jax_params(synth_state), n_model)
    ours = tp_specs(synth_state, n_model)
    port_set, jax_set = set(), set()
    for key, value in synth_state.items():
        path, ndim = _jax_leaf(key, value)
        split = ours[key]
        if split is not None:
            port_set.add((key, ndim - 1 - split.dim))  # [out, in, k] -> [.., in, out]
        for axis in _jax_sharded(jax_specs, path):
            jax_set.add((key, axis))
    heads = CONFTEST_TINY["n_heads"]
    d2 = {(k, a) for k, a in jax_set if ".attn_layers." in k} if heads % n_model else set()
    assert port_set == jax_set - d2
    assert len(port_set) >= 8
    if n_model == 4:  # D.2: 2 heads do not split four ways
        assert d2 and not any(".attn_layers." in k for k, _ in port_set)
    # tp_shard, then tp_gather, gives the reference layout back
    shards = [tp_shard(synth_state, n_model, r, ours) for r in range(n_model)]
    back = tp_gather(shards, ours)
    assert all(torch.equal(back[k], v) for k, v in synth_state.items())
    assert shards[0]["enc_q.enc.in_layers.0.weight_v"].shape[0] == 2 * 8 // n_model
    # D.3: rank 0's output channels of a WN in_layers conv pair the gates:
    # [0, h/n) of the tanh half and [h, h + h/n) of the sigmoid half
    key = "enc_q.enc.in_layers.0.weight_v"
    h = synth_state[key].shape[1]
    rows = torch.arange(2 * h, dtype=torch.float32)[:, None, None]
    got = shard_tensor(rows.expand(-1, 1, 1), ours[key], 0, n_model).flatten().tolist()
    assert got == list(range(h // n_model)) + list(range(h, h + h // n_model))


BERT = EncoderConfig(vocab_size=60, hidden_size=32, num_layers=2, num_heads=4,
                     intermediate_size=64, relative_attention=True, position_buckets=8,
                     max_relative_positions=16, pos_att_type=("c2p", "p2c"),
                     norm_rel_ebd="layer_norm", position_biased_input=False)


def _hf_state_dict(sd: dict) -> dict:
    """The port encoder's state_dict in a DeBERTa-v2 checkpoint's names (the
    inverse of `load_hf_bert`)."""
    out = {"embeddings.word_embeddings.weight": sd["word_embeddings.weight"],
           "embeddings.token_type_embeddings.weight": sd["token_type_embeddings.weight"],
           "embeddings.LayerNorm.weight": sd["embeddings_norm.weight"],
           "embeddings.LayerNorm.bias": sd["embeddings_norm.bias"],
           "encoder.rel_embeddings.weight": sd["rel_embeddings"],
           "encoder.LayerNorm.weight": sd["rel_embeddings_norm.weight"],
           "encoder.LayerNorm.bias": sd["rel_embeddings_norm.bias"]}
    for i in range(BERT.num_layers):
        ours, hf = f"layers.{i}.", f"encoder.layer.{i}."
        names = {"attention.query": "attention.self.query_proj",
                 "attention.key": "attention.self.key_proj",
                 "attention.value": "attention.self.value_proj",
                 "attention.pos_key_proj": "attention.self.pos_key_proj",
                 "attention.pos_query_proj": "attention.self.pos_query_proj",
                 "attention_output": "attention.output.dense",
                 "attention_norm": "attention.output.LayerNorm",
                 "intermediate": "intermediate.dense", "output": "output.dense",
                 "output_norm": "output.LayerNorm"}
        for a, b in names.items():
            for leaf in ("weight", "bias"):
                out[f"{hf}{b}.{leaf}"] = sd[f"{ours}{a}.{leaf}"]
    return {k: v.numpy() for k, v in out.items()}


def _jax_bert_path(key: str) -> list[str]:
    """The JAX encoder tree's path of port leaf `key`."""
    parts = key.split(".")
    if len(parts) == 1:
        return parts
    mod = [f"layer_{parts[1]}", *parts[2:-1]] if parts[0] == "layers" else parts[:-1]
    leaf = parts[-1]
    if leaf == "weight":
        leaf = ("scale" if mod[-1].endswith("norm") else
                "embedding" if mod[-1].endswith("embeddings") else "kernel")
    return [*mod, leaf]


def test_bert_split_matches_unsharded_and_jax_specs():
    from bert_vits2_tpu.text.bert_jax import EncoderConfig as JaxEncoderConfig
    from bert_vits2_tpu.text.bert_jax import bert_partition_specs, import_torch_bert

    torch.manual_seed(0)
    full = BertEncoder(BERT).eval()
    sd = {k: v.clone() for k, v in full.state_dict().items()}
    # the JAX rules on the JAX importer's tree, against the port's
    tree = import_torch_bert(_hf_state_dict(sd), JaxEncoderConfig(**{
        f: getattr(BERT, f) for f in BERT.__dataclass_fields__}))
    jax_specs = bert_partition_specs(tree)
    for key in sd:
        node = jax_specs
        for p in _jax_bert_path(key):
            node = node[p]
        jax_axes = [i for i, a in enumerate(tuple(node)) if a is not None]
        split = bert_tp_spec(key, 2)
        # torch Linear [out, in] is the flax kernel [in, out] transposed
        want = [] if split is None else [split.dim if sd[key].dim() == 1
                                         else 1 - split.dim]
        assert jax_axes == want, key

    mesh = make_mesh(n_data=1, n_model=2, devices=["cpu", "cpu"])
    ext = BertEncoderExtractor(device="cuda", mesh=mesh)  # the mesh's device wins
    assert ext.device == torch.device("cpu")
    split = BertEncoder(BERT)
    split.load_state_dict(sd)
    split = ext.place(split)
    assert all(layer.shards is not None and len(layer.shards) == 2
               for layer in split.layers)
    ids = torch.randint(0, BERT.vocab_size, (2, 13), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 10:] = 0
    with torch.no_grad():
        want, got = full(ids, mask), split(ids, mask)
    for w, g in zip(want, got):
        assert (g - w).abs().max() <= BERT_REL * w.abs().max()
    with pytest.raises(ValueError, match="does not split"):
        BertEncoderExtractor(mesh=make_mesh(1, 3, ["cpu"] * 3), device="cpu").place(
            BertEncoder(BERT))


def test_engine_hands_its_mesh_to_the_bert_extractor():
    """TTSEngine(mesh=[1, 2]): the synthesizer on the data axis's one device,
    the default extractor with the mesh (JAX infer/api.py:178)."""
    from bert_vits2_tpu_torch.infer import TTSEngine

    cfg = ModelConfig(**CONFTEST_TINY)
    mesh = make_mesh(n_data=1, n_model=2, devices=["cpu", "cpu"])
    engine = TTSEngine(Synthesizer(cfg), mesh=mesh)
    assert engine.device == torch.device("cpu") and len(engine.replicas) == 1
    assert engine.bert_extractor.mesh is mesh


def test_trainer_writes_a_device_trace(tmp_path):
    """Trainer.run(profile_at_step=1, profile_steps=1): the first step as
    usual, the second inside a trace under <model_dir>/logs/profile, the
    step count up by one across it; `annotate` names a region of a
    trace."""
    from bert_vits2_tpu_torch.train import trainer as trainer_mod
    from bert_vits2_tpu_torch.utils.profiling import annotate, trace
    from test_torch_distributed import _write_corpus
    from test_torch_trainer import _tiny_models

    cfg_path = _write_corpus(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "make_writer", lambda log_dir: None)
        trainer = trainer_mod.Trainer(cfg_path, str(tmp_path / "run"),
                                      models=_tiny_models(cfg_path), slm_path=None,
                                      device="cpu")
        trainer.run(max_steps=2, profile_at_step=1, profile_steps=1, keep_ckpts=1)
    assert trainer.global_step == 2
    traces = os.listdir(tmp_path / "run" / "logs" / "profile")
    assert any(f.endswith(".pt.trace.json") for f in traces)
    assert "G_2.pth" in os.listdir(tmp_path / "run" / "ckpt")
    with trace(str(tmp_path / "t")):
        with annotate("region"):
            torch.ones(4).sum()
    (name,) = os.listdir(tmp_path / "t")
    assert '"region"' in (tmp_path / "t" / name).read_text()


def _yml(tmp_path):
    import yaml

    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(dict(
        dataset_path=str(tmp_path),
        resample=dict(in_dir="raw", out_dir="wavs", sampling_rate=22050),
        preprocess_text=dict(val_per_lang=2),
        server=dict(port=9999, models=[]))))
    return str(path)


SECTIONS = ("resample_config", "preprocess_text_config", "bert_gen_config",
            "train_config", "webui_config", "server_config", "translate_config")


@pytest.mark.parametrize("case", ["yml", "missing"])
def test_config_yml_matches_jax(tmp_path, monkeypatch, case):
    """The port's `Config` equals the JAX `Config` field for field, on the
    yml of tests/test_tools.py::TestGlobalConfig and on a missing file (the
    defaults; the template is copied where it exists)."""
    import dataclasses

    from bert_vits2_tpu.config import Config as JaxConfig
    from bert_vits2_tpu_torch.config import Config

    monkeypatch.chdir(tmp_path)
    if case == "missing":
        path = "nonexistent.yml"
    else:
        path = _yml(tmp_path)
    ours, theirs = Config(path), JaxConfig(path)
    for attr in ("config_path", "dataset_path", "mirror", "openi_token"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    for name in SECTIONS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    if case == "yml":
        assert ours.resample_config.in_dir == os.path.join(str(tmp_path), "raw")
        assert ours.server_config.port == 9999
    else:
        (tmp_path / "default_config.yml").write_text("dataset_path: Data2/\n")
        again = Config("copied.yml")
        assert os.path.isfile("copied.yml") and again.dataset_path == "Data2/"
