"""PyTorch port, release tools: `compat/params.py:to_jax_params` and
`utils/model_tools.py` (`compress_params`, `save_release`, `mix_params`)
against the JAX package's importer and `utils/model_tools.py`, on random
trees of three families (V2.3 at the tiny config, V2.1 with the vits1 flow
and the vq210 emotion branch, V2.2 with the clap220 branch) and a model
without speakers (the reference encoder). Every tree, file and array is
held exactly: the conversions only rename, transpose and reshape, and the
mix is the same two float32 products and one sum per element."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_vits2_tpu.compat.torch_import import convert_state_dict, synthesizer_rename
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.models.reference_encoder import ReferenceEncoder as JaxReferenceEncoder
from bert_vits2_tpu.utils import model_tools as jax_tools
from bert_vits2_tpu_torch.compat.params import from_jax_params, to_jax_params
from bert_vits2_tpu_torch.infer import load_tts_engine
from bert_vits2_tpu_torch.text.bert import RandomBertExtractor
from bert_vits2_tpu_torch.utils import model_tools
from test_torch_infer_text import ENGINE_KW, SENTENCES
from test_torch_modules import TINY, random_synth_params, random_tree
from test_torch_versions import _jax_tree, _write_family
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ZERO = dict(noise_scale=0.0, noise_scale_w=0.0)


@functools.lru_cache(maxsize=None)
def _tree(name: str, seed: int) -> dict:
    """A random JAX Synthesizer tree of one family. Without speakers the
    tree is the V2.3 one with the reference encoder in place of `emb_g`
    (the only parameters that n_speakers = 0 changes), traced alone."""
    if name == "2.3":
        return random_synth_params(JaxSynthesizer(JaxModelConfig(**TINY)), seed=seed)
    if name == "no speakers":
        tree = dict(_tree("2.3", seed))
        del tree["emb_g"]
        enc = JaxReferenceEncoder(TINY["spec_channels"], TINY["gin_channels"])
        shapes = jax.eval_shape(lambda: enc.init(
            jax.random.key(0), jnp.zeros((1, 16, TINY["spec_channels"]))))["params"]
        return dict(tree, ref_enc=random_tree(shapes, seed))
    return _jax_tree(name, seed)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", ["2.3", "2.1 vits1 flow", "2.2", "no speakers"])
def test_to_jax_params_is_the_jax_importers_tree(name):
    """The port's state_dict -> the JAX tree, leaf for leaf (paths, shapes,
    dtypes, values) what the JAX package's own importer makes of it, and
    back through `from_jax_params` to the same state_dict."""
    tree = _tree(name, seed=70)
    sd = from_jax_params(tree)
    got = _leaves(to_jax_params(sd))
    want = _leaves(tree)
    if name != "no speakers":  # the importer maps no GRU; the tree is its own proof
        want, report = convert_state_dict({k: v.numpy() for k, v in sd.items()}, tree,
                                          rename=synthesizer_rename, strict=True)
        assert not report["unmatched"] and not report["unused_flax"]
        want = _leaves(want)
        assert want.keys() == _leaves(tree).keys()
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == np.float32 and np.array_equal(v, want[k]), k
    back = from_jax_params(to_jax_params(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_trained_gru_biases_fold_into_the_input_gates():
    """A port GRU whose hidden r and z biases moved in training converts to
    the JAX cell (which has none) with the same outputs."""
    sd = from_jax_params(_tree("no speakers", seed=71))
    gen = torch.Generator().manual_seed(0)
    sd["ref_enc.gru.bias_hh_l0"] = torch.randn(sd["ref_enc.gru.bias_hh_l0"].shape,
                                               generator=gen)
    back = from_jax_params(to_jax_params(sd))
    n_in, units = sd["ref_enc.gru.weight_ih_l0"].shape[1], sd["ref_enc.gru.weight_hh_l0"].shape[1]
    gru = [torch.nn.GRU(n_in, units, batch_first=True) for _ in range(2)]
    for g, d in zip(gru, (sd, back)):
        g.load_state_dict({k[len("ref_enc.gru."):]: v for k, v in d.items()
                           if k.startswith("ref_enc.gru.")})
    x = torch.randn(2, 5, n_in, generator=gen)
    with torch.no_grad():
        assert torch.allclose(gru[0](x)[0], gru[1](x)[0], atol=1e-6)
    assert not torch.equal(back["ref_enc.gru.bias_hh_l0"], sd["ref_enc.gru.bias_hh_l0"])


@pytest.mark.parametrize("half", [False, True])
def test_save_release_is_the_jax_file(tmp_path, half):
    """`save_release` of the port's state_dict: the keys, dtypes and values
    of the JAX `save_release` of the same weights, no `enc_q`; both
    packages' `load_release` read it back."""
    tree = _tree("2.2", seed=72)
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    model_tools.save_release(str(ours), from_jax_params(tree), half=half)
    jax_tools.save_release(str(theirs), tree, half=half)
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files and not any("enc_q" in k for k in a.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype == (np.float16 if half else np.float32), k
            assert np.array_equal(a[k], b[k]), k
    assert _leaves(jax_tools.load_release(str(ours))).keys() == _leaves(
        jax_tools.compress_params(tree)).keys()
    sd = from_jax_params(model_tools.load_release(str(ours)))
    want = model_tools.compress_params(from_jax_params(tree), half=half)
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k].float()) for k in sd)


def test_mix_params_is_the_jax_mix():
    """`mix_params` of two state_dicts (enc_p by tone_ratio, the rest by
    voice_ratio; keys only in one kept: `emb_g` in A, `ref_enc` in B)
    equals the JAX mix of the trees."""
    a, b = _tree("2.3", seed=73), _tree("no speakers", seed=74)
    ours = to_jax_params(model_tools.mix_params(
        from_jax_params(a), from_jax_params(b), voice_ratio=(0.3, 0.7),
        tone_ratio=(0.8, 0.2)))
    want = _leaves(jax_tools.mix_params(a, b, voice_ratio=(0.3, 0.7), tone_ratio=(0.8, 0.2)))
    got = _leaves(ours)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v.astype(np.float32)), k


def test_release_serves_the_source_voice(tmp_path):
    """`load_tts_engine` on the port's fp32 release synthesizes the zero-noise
    waves of the G_*.pth it came from; the half release loads the fp16
    values and synthesizes."""
    config, weights = _write_family(tmp_path, "v23", "2.3")
    kw = dict(bert_extractor=RandomBertExtractor(0), device="cpu", **ENGINE_KW)
    source = load_tts_engine(config, weights, **kw)
    sd = source.model.state_dict()
    want = source.infer(SENTENCES["JP"], "bob", language="JP", **ZERO)
    for half in (False, True):
        npz = tmp_path / f"release{int(half)}.npz"
        model_tools.save_release(str(npz), sd, half=half)
        engine = load_tts_engine(config, str(npz), **kw)
        got_sd = engine.model.state_dict()
        for k, v in model_tools.compress_params(sd, half=half).items():
            assert torch.equal(got_sd[k], v.float()), k
        wave = engine.infer(SENTENCES["JP"], "bob", language="JP", **ZERO)
        if half:
            assert np.isfinite(wave).all() and len(wave) > 0
        else:
            assert np.array_equal(wave, want)
    mixed = model_tools.mix_params(sd, dict(sd, **{"emb_g.weight": -sd["emb_g.weight"]}))
    assert torch.equal(mixed["emb_g.weight"], torch.zeros_like(sd["emb_g.weight"]))
