"""PyTorch port, old checkpoint versions: the version router, the V2.1/V2.2
emotion branches and the vits1 flow against the JAX package on the CPU.

- The version table (`compat/versions.py`) field for field against the
  JAX one, for every alias of the reference's router.
- `VectorQuantizer` (one head with its index lookup; V2.2's shape scaled
  down to 3 heads x 6 codes x 4 dims), `TextEncoder`'s `vq210` (index and
  vector) and `clap220` branches, and the vits1 `ResidualCouplingBlock`
  (forward and reverse) against the JAX modules run
  by un-jitted `apply` at a tiny width, with the same random weights. The
  quantizers' chosen indices are read from the JAX module's own `argmin`
  and must be equal.
- `get_text` with each family's spec against the JAX `get_text`, and
  `from_jax_params` strict round trips of a V1.0, a V2.1 (vits1 flow) and
  a V2.2 tree through the JAX package's own importer.
- The slice: a tiny V2.1 engine with `use_transformer_flow: false`, loaded
  from a config.json and a reference-layout `G_0.pth` that carries the
  quantizer's EMA buffers, synthesizes from text with `emotion=3` and with
  a stub extractor's 1024-d vector; the JAX package's synthesis of the
  same prepared requests, both in one jitted function (the file's one JAX
  compile), at zero noise. Port-only: tiny 1.0, 1.1, 2.0 and 2.2 engines
  from their config.json files, a V2.2 `.npz` release written by the JAX
  `save_release`, and one `/voice` round trip with `emotion` through the
  port's HTTP server.

Tolerances (fp32, JAX at matmul precision "highest"): modules 1e-5 max-abs
(ATOL of tests/test_torch_modules.py), waves WAVE_ATOL = 1e-4, `get_text`'s
arrays and the round trips exactly. The clap220 branch's pre-quantizer
feature carries R.3 (ROADMAP §C): the JAX module's two LayerNorms use
flax's eps 1e-6, the port's the reference's 1e-5; the test states that
share of the error (the port rerun at eps 1e-6) beside the rest.
"""

import functools
import json
import sys
import threading
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bert_vits2_tpu.nn.vq as jax_vq_module
from bert_vits2_tpu.compat import versions as jax_versions
from bert_vits2_tpu.compat.torch_import import convert_state_dict, synthesizer_rename
from bert_vits2_tpu.infer import api as jax_api
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.models.flow import ResidualCouplingBlock as JaxResidualCouplingBlock
from bert_vits2_tpu.models.text_encoder import TextEncoder as JaxTextEncoder
from bert_vits2_tpu.nn.vq import VectorQuantizer as JaxVectorQuantizer
from bert_vits2_tpu.ops.attention_pallas import force_lax_attention
from bert_vits2_tpu.utils.model_tools import save_release
import bert_vits2_tpu_torch.serve as port_serve
from bert_vits2_tpu_torch.compat import versions
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import get_text, load_tts_engine
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.models.flow import ResidualCouplingBlock
from bert_vits2_tpu_torch.models.text_encoder import TextEncoder
from bert_vits2_tpu_torch.nn.vq import VectorQuantizer
from bert_vits2_tpu_torch.serve import server as port_server
from bert_vits2_tpu_torch.text import emotion as port_emotion
from bert_vits2_tpu_torch.text.bert import RandomBertExtractor
from bert_vits2_tpu_torch.utils.audio import float_to_int16
from test_torch_infer_text import ENGINE_KW, SENTENCES, SPK2ID, _write_config
from test_torch_modules import ATOL, TINY, random_tree
from test_torch_serve import _get, _pcm
from test_torch_synthesis import WAVE_ATOL
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
ALIASES = sorted(versions.VERSION_TO_FAMILY) + [None, "", "2.3.1", "9.9", "1", "2.1.5"]
FAMILIES = ("1.0", "1.1", "2.0", "2.1", "2.2", "2.3")
ZERO = dict(noise_scale=0.0, noise_scale_w=0.0)


@pytest.fixture(scope="module", autouse=True)
def _dense_jax_attention():
    with force_lax_attention():
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class _ArgminTape:
    """The JAX quantizer's own `argmin` results, recorded (un-jitted apply)."""

    def __init__(self, monkeypatch):
        self.calls = []
        proxy = SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
        proxy.argmin = self._argmin
        monkeypatch.setattr(jax_vq_module, "jnp", proxy)

    def _argmin(self, *a, **k):
        idx = jnp.argmin(*a, **k)
        self.calls.append(idx)
        return idx


def _min_gap(y: np.ndarray, codebook: np.ndarray) -> float:
    """Smallest gap between the nearest and the second-nearest code's squared
    distance, over items and heads (float64). y [n, heads, cdim]."""
    d = ((y[:, :, None, :].astype(np.float64) - codebook[None]) ** 2).sum(-1)
    d.sort(axis=-1)
    return float((d[..., 1] - d[..., 0]).min())


# ---- the version table ----


@pytest.mark.parametrize("version", ALIASES)
def test_version_spec_matches_jax(version):
    """Every field, the derived tables and the id mapping, UNK included."""
    spec, want = versions.spec_for(version), jax_versions.spec_for(version)
    assert versions.family_for(version) == want.family
    for field in ("family", "symbols", "num_tones", "tone_start", "languages",
                  "use_ja_bert", "use_en_bert", "ja_bert_dim", "emotion",
                  "emo_dim", "inactive_fill", "n_vocab", "symbol_to_id"):
        assert getattr(spec, field) == getattr(want, field), field
    assert spec.model_overrides() == want.model_overrides()
    phones = ["a:", "b", "cl", "I", "sh", "ng", "?", "no-such-phone"]
    for lang in ("ZH", "JP", "EN"):
        tones = list(range(len(phones)))
        assert spec.cleaned_text_to_sequence(phones, tones, lang) == \
            want.cleaned_text_to_sequence(phones, tones, lang)


def test_version_constants_match_jax():
    assert versions.V101_SYMBOLS == jax_versions.V101_SYMBOLS
    assert len(versions.V101_SYMBOLS) == 108
    assert versions.VERSION_TO_FAMILY == jax_versions.VERSION_TO_FAMILY
    assert versions.LATEST_VERSION == jax_versions.LATEST_VERSION
    assert [versions.spec_for(f).family for f in FAMILIES] == list(FAMILIES)


# ---- modules, un-jitted JAX apply ----


def test_vector_quantizer_matches_jax(monkeypatch):
    """One head (8 dims, 5 codes; nearest code and index lookup) and V2.2's
    layout scaled down (16 dims -> project_in -> 3 heads x 6 codes x 4 dims
    -> project_out): equal indices, outputs within ATOL. Smallest gap
    between the nearest and the second-nearest code's squared distance on
    these inputs: 2.40 (one head), 0.026 (three heads)."""
    tape = _ArgminTape(monkeypatch)
    rng = np.random.default_rng(0)
    for dim, size, cdim, heads in ((8, 5, None, 1), (16, 6, 4, 3)):
        jvq = JaxVectorQuantizer(dim, size, codebook_dim=cdim, heads=heads)
        x = rng.normal(size=(6, dim)).astype(np.float32)
        p = random_tree(jax.eval_shape(lambda: jvq.init(jax.random.key(0), x)),
                        seed=dim)["params"]
        p["codebook"] = rng.normal(size=p["codebook"].shape).astype(np.float32)
        vq = VectorQuantizer(dim, size, codebook_dim=cdim, heads=heads)
        vq.load_state_dict(_sub(from_jax_params({"emo_vq": p}), "emo_vq."), strict=True)
        tape.calls.clear()
        want = np.asarray(jvq.apply({"params": p}, x))
        with torch.no_grad():
            got_idx = vq.indices(_t(x)).numpy()
            got = vq(_t(x)).numpy()
            y = vq.project_in(_t(x)) if vq.project_in is not None else _t(x)
        assert len(tape.calls) == 1
        assert np.array_equal(got_idx, np.asarray(tape.calls[0])), (dim, got_idx)
        assert np.abs(got - want).max() <= ATOL
        gap = _min_gap(y.numpy().reshape(6, heads, -1), p["codebook"])
        assert gap > 1e-2, gap
        if heads == 1:
            idx = np.asarray([3, 0, 4])
            want = np.asarray(jvq.apply({"params": p}, idx, method=JaxVectorQuantizer.lookup))
            with torch.no_grad():
                assert np.abs(vq.lookup(_t(idx)).numpy() - want).max() == 0.0
        else:
            with pytest.raises(ValueError, match="one head"):
                vq.lookup(_t([0]))


def _encoder_pair(emotion, emo, seed):
    """The JAX TextEncoder (tiny width, emotion branch) with random weights
    and the port's, loaded from them."""
    kw = dict(n_vocab=20, out_channels=8, hidden_channels=8, filter_channels=16,
              n_heads=2, n_layers=3, kernel_size=3, p_dropout=0.0, gin_channels=8,
              emotion=emotion)
    jenc = JaxTextEncoder(**kw)
    rng = np.random.default_rng(seed)
    t = 7
    args = (rng.integers(1, 20, (2, t)).astype(np.int32), np.asarray([t, t - 2], np.int32),
            rng.integers(0, 12, (2, t)).astype(np.int32),
            rng.integers(0, 3, (2, t)).astype(np.int32),
            *(0.2 * rng.normal(size=(2, t, 1024)).astype(np.float32) for _ in range(3)))
    g = rng.normal(size=(2, 8)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.key(0), *args, emo=emo, g=g))
    p = random_tree(shapes, seed)["params"]
    for name in ("emo_quantizer", "emo_vq"):
        if name in p:
            p[name]["codebook"] = rng.normal(size=p[name]["codebook"].shape).astype(np.float32)
    enc = TextEncoder(**kw)
    enc.load_state_dict(_sub(from_jax_params({"enc_p": p}), "enc_p."), strict=True)
    return jenc, p, enc, args, g


def _encoder_outputs(jenc, p, enc, args, emo, g):
    want = jenc.apply({"params": p}, *args, emo=emo, g=g)
    with torch.no_grad():
        got = enc(*(_t(a) for a in args[:4]), *(_t(a).transpose(1, 2) for a in args[4:]),
                  emo=_t(emo), g=_t(g))
    mask = np.asarray(want[3]).astype(bool)
    errs = [np.abs(o.numpy().transpose(0, 2, 1) - np.asarray(w))[mask].max()
            for o, w in zip(got[:3], want[:3])]
    return max(errs)


def test_text_encoder_vq210_matches_jax(monkeypatch):
    """V2.1: a [b] codebook index (direct lookup) and a [b, 1024] wav2vec2
    vector (emo_proj, then the 10-code quantizer); hidden, m and logs within
    ATOL, the vector's indices equal to the JAX module's (smallest gap to a
    second-nearest code on these inputs: above 1)."""
    tape = _ArgminTape(monkeypatch)
    rng = np.random.default_rng(3)
    vec = rng.normal(size=(2, 1024)).astype(np.float32)
    jenc, p, enc, args, g = _encoder_pair("vq210", vec, seed=3)
    for emo in (np.asarray([3, 7], np.int32), vec):
        tape.calls.clear()
        assert _encoder_outputs(jenc, p, enc, args, emo, g) <= ATOL
        if emo.ndim == 2:
            with torch.no_grad():
                y = enc.emo_proj(_t(emo))
                idx = enc.emo_quantizer.indices(y).numpy()
            assert np.array_equal(idx, np.asarray(tape.calls[0]))
            assert _min_gap(y.numpy()[:, None], p["emo_quantizer"]["codebook"]) > 1.0
    assert [k for k in enc.state_dict() if k.startswith("emo")] == [
        "emo_proj.weight", "emo_proj.bias", "emo_quantizer._codebook.embed",
        "emo_q_proj.weight", "emo_q_proj.bias"]


def test_text_encoder_clap220_matches_jax(monkeypatch):
    """V2.2: a [b, 512] CLAP feature through in_feature_net, the 32-head
    quantizer and out_feature_net. Outputs within ATOL with the 32 heads'
    indices equal (smallest gap to a second-nearest code 0.022). The
    pre-quantizer feature (in_feature_net's output) is held within 5e-5:
    1.07e-5 here, of which R.3 (LayerNorm eps 1e-5 against the JAX
    module's 1e-6) is all but 3.9e-7, the error with the port's eps set to
    the JAX module's (held within ATOL)."""
    tape = _ArgminTape(monkeypatch)
    emo = np.random.default_rng(4).normal(size=(2, 512)).astype(np.float32)
    jenc, p, enc, args, g = _encoder_pair("clap220", emo, seed=4)
    tape.calls.clear()
    assert _encoder_outputs(jenc, p, enc, args, emo, g) <= ATOL
    with torch.no_grad():
        feat = enc.in_feature_net(_t(emo))
        idx = enc.emo_vq.indices(feat).numpy()
    assert np.array_equal(idx, np.asarray(tape.calls[0]))
    _, state = jenc.apply({"params": p}, *args, emo=emo, g=g,
                          capture_intermediates=True, mutable=["intermediates"])
    want = np.asarray(state["intermediates"]["in_feature_net_4"]["__call__"][0])
    err = np.abs(feat.numpy() - want).max()
    norms = [m for m in enc.in_feature_net.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 and all(m.eps == 1e-5 for m in norms)
    for m in norms:
        m.eps = 1e-6
    with torch.no_grad():
        err_same_eps = np.abs(enc.in_feature_net(_t(emo)).numpy() - want).max()
    assert err <= 5e-5 and err_same_eps <= ATOL, (err, err_same_eps)
    with torch.no_grad():
        y = enc.emo_vq.project_in(feat).numpy().reshape(2, 32, 32)
    assert _min_gap(y, p["emo_vq"]["codebook"]) > 1e-3
    assert "in_feature_net.3.mlp.c_fc1.weight" in enc.state_dict()
    assert "in_feature_net.2.weight" in enc.state_dict()


def test_residual_coupling_block_matches_jax():
    """The vits1 flow (4 mean-only WN couplings of 4 layers, kernel 5,
    speaker conditioned) forward and reverse within ATOL; a coupling's
    forward logdet is zero (mean-only: volume-preserving)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 11, 8)).astype(np.float32)
    mask = (np.arange(11)[None] < np.asarray([11, 8])[:, None]).astype(np.float32)
    g = rng.normal(size=(2, 8)).astype(np.float32)
    tx, tm, tg = _t(x.transpose(0, 2, 1)), _t(mask[:, None]), _t(g)
    jblock = JaxResidualCouplingBlock(8, 8, gin_channels=8)
    p = random_tree(jax.eval_shape(lambda: jblock.init(jax.random.key(0), x, mask, g=g)),
                    seed=5)["params"]
    block = ResidualCouplingBlock(8, 8, gin_channels=8)
    block.load_state_dict(_sub(from_jax_params({"flow": p}), "flow."), strict=True)
    assert "flows.6.enc.in_layers.3.weight_v" in block.state_dict()
    with torch.no_grad():
        for reverse in (False, True):
            want = np.asarray(jblock.apply({"params": p}, x, mask, g=g, reverse=reverse))
            got = block(tx, tm, g=tg, reverse=reverse).numpy().transpose(0, 2, 1)
            assert np.abs((got - want) * mask[..., None]).max() <= ATOL, reverse
        _, logdet = block.flows[0](tx, tm, g=tg)
    assert not logdet.any()


def test_vits1_flow_takes_only_four_flow_layers():
    """n_flow_layer is read as the number of couplings by the JAX package
    and (as recalled) as the WN depth by the reference; the two agree only
    at 4, so the port refuses any other value with the vits1 flow (R.4)."""
    with pytest.raises(ValueError, match="R.4"):
        build_synthesizer(ModelConfig(**dict(V21, n_flow_layer=2)), device="cpu")
    cfg = ModelConfig(**dict(TINY, n_flow_layer=2))
    assert len(build_synthesizer(cfg, device="cpu").flow.flows) == 4


# ---- the host half ----


@pytest.mark.parametrize("family", FAMILIES)
def test_get_text_matches_jax_per_family(family):
    """Each family's spec, each language: the six arrays exactly equal (old
    symbol tables and tone offsets, zero fills before 2.3, the 768-d
    ja_bert of 1.1); a language the family lacks raises ValueError in both."""
    ext = RandomBertExtractor(0)
    spec, jspec = versions.spec_for(family), jax_versions.spec_for(family)
    for lang in ("ZH", "JP", "EN"):
        if lang not in spec.languages:
            for fn, s in ((get_text, spec), (jax_api.get_text, jspec)):
                with pytest.raises(ValueError, match=family):
                    fn(SENTENCES[lang], lang, ext, spec=s)
            continue
        got = get_text(SENTENCES[lang], lang, ext, noise_seed=2, spec=spec)
        want = jax_api.get_text(SENTENCES[lang], lang, ext, noise_seed=2, spec=jspec)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
        assert got[4].shape[1] == spec.ja_bert_dim
        if spec.inactive_fill == "zeros":
            assert not any(got[3 + j].any() for j, la in enumerate(("ZH", "JP", "EN"))
                           if la != lang)


# ---- whole trees ----


def _family_cfg(family, **kw):
    return dict(TINY, **versions.spec_for(family).model_overrides(), **kw)


V21 = _family_cfg("2.1", use_transformer_flow=False)
TREES = {"1.0": _family_cfg("1.0"), "2.1 vits1 flow": V21, "2.2": _family_cfg("2.2")}


@functools.lru_cache(maxsize=None)
def _jax_shapes(name: str):
    """The JAX Synthesizer's parameter shapes for TREES[name]. The V2.1
    vits1-flow config (with a vector input, which builds every parameter of
    the vq210 branch) is traced through each submodule once (the training
    forward's MAS, losses and slicing add no parameters, and cost a trace);
    the families differ only in `enc_p` and `flow`, so another family's
    tree is that one with these two traced for it. The strict round trip
    below proves each tree whole."""
    cfg = TREES[name]
    z = lambda *s, dt=jnp.float32: jnp.zeros(s, dt)  # noqa: E731
    emo = {"vq210": z(1, 1024), "clap220": z(1, 512)}.get(cfg["emotion"])
    text = (z(1, 8, dt=jnp.int32), jnp.asarray([8]), z(1, 8, dt=jnp.int32),
            z(1, 8, dt=jnp.int32), z(1, 8, 1024), z(1, 8, cfg["ja_bert_dim"]),
            z(1, 8, 1024))
    whole = name == "2.1 vits1 flow"

    def parts(m, x, lens, tone, lang, b, jb, eb):
        g = m._speaker(z(1, dt=jnp.int32), None)
        x_h, _, _, x_mask = m.enc_p(x, lens, tone, lang, b, jb, eb, emo=emo, g=g)
        m.flow(z(1, 16, cfg["inter_channels"]), z(1, 16), g=g)
        if whole:
            m.enc_q(z(1, 16, cfg["spec_channels"]), jnp.asarray([16]), g=g)
            m.sdp(x_h, x_mask, w=jnp.ones((1, 8, 1)), g=g)
            m.dp(x_h, x_mask, g=g)
            m.dec(z(1, 8, cfg["inter_channels"]), g=g)

    model = JaxSynthesizer(JaxModelConfig(**cfg))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, *text, method=parts))["params"]
    return shapes if whole else dict(_jax_shapes("2.1 vits1 flow"), **shapes)


def _jax_tree(name: str, seed: int):
    """Random values for the JAX tree of TREES[name]; the codebooks at unit
    scale (the emotion vectors' scale), every other leaf as random_tree."""
    tree = random_tree(_jax_shapes(name), seed)
    rng = np.random.default_rng(seed)
    for quantizer in ("emo_quantizer", "emo_vq"):
        if quantizer in tree["enc_p"]:
            cb = tree["enc_p"][quantizer]["codebook"]
            tree["enc_p"][quantizer]["codebook"] = rng.normal(size=cb.shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("name", sorted(TREES))
def test_from_jax_params_round_trip_per_family(name):
    """Every port parameter filled from the family's JAX tree, and back
    through the JAX importer (strict) to the same tree, bit for bit."""
    cfg = TREES[name]
    tree = _jax_tree(name, seed=40)
    sd = from_jax_params(tree)
    port = build_synthesizer(ModelConfig(**cfg), device="cpu")
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    back, report = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                      tree, rename=synthesizer_rename, strict=True)
    assert not report["unmatched"] and not report["unused_flax"]
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, leaf in got:
        assert np.array_equal(np.asarray(leaf), np.asarray(want[path])), path
    if name == "1.0":
        assert not any("ja_bert_proj" in k or "en_bert_proj" in k for k in sd)
        assert sd["enc_p.emb.weight"].shape[0] == 108
    if name.startswith("2.1"):
        assert "flow.flows.2.enc.res_skip_layers.3.weight_g" in sd
        assert "flow.flows.6.post.bias" in sd


# ---- the slice ----


class StubEmotionExtractor:
    """Seeded feature vectors in place of wav2vec2 / CLAP (no weights in the
    repository), one per (reference audio, prompt); records what it was
    asked."""

    def __init__(self, dim, seed):
        self.dim, self.seed = dim, seed
        self.calls = []

    def __call__(self, reference_audio=None, prompt=None):
        self.calls.append((reference_audio, prompt))
        key = zlib.crc32(repr((reference_audio, prompt)).encode())
        return np.random.default_rng((self.seed, key)).normal(size=self.dim).astype(np.float32)


def _write_family_config(root: Path, name: str, version: str, **model) -> str:
    """config.json of `version` with the tiny model section (+ `model`)."""
    config = Path(_write_config(root / f"{name}.json", version))
    hps = json.loads(config.read_text())
    hps["model"].update(model)
    config.write_text(json.dumps(hps))
    return str(config)


def _write_family(root: Path, name: str, version: str, sd=None, **model):
    """config.json (`_write_family_config`) and G_0.pth of `sd` (default:
    the port's seeded init with the zero-init couplings made random), the
    V2.1/V2.2 quantizers' EMA buffers added, under the DDP prefix."""
    config = _write_family_config(root, name, version, **model)
    if sd is None:
        cfg = _family_cfg(versions.family_for(version), **model)
        sd = build_synthesizer(ModelConfig(**cfg), device="cpu", seed=5).state_dict()
        gen = torch.Generator().manual_seed(5)
        for k in [k for k in sd if ".post." in k or (k.startswith("sdp.") and ".proj." in k)]:
            sd[k] = 0.05 * torch.randn(sd[k].shape, generator=gen)
    sd = dict(sd)
    for key in [k for k in sd if k.endswith("._codebook.embed")]:
        stem = key[: -len("embed")]
        heads, size = sd[key].shape[:2]
        sd[stem + "initted"] = torch.ones(1)
        sd[stem + "cluster_size"] = torch.ones(heads, size)
        sd[stem + "embed_avg"] = torch.randn(sd[key].shape)
    weights = root / f"{name}.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "iteration": 0}, weights)
    return config, str(weights)


@pytest.fixture(scope="module")
def v21(tmp_path_factory):
    """The V2.1 vits1-flow engine from files, the JAX model on the same
    tree, two prepared requests (emotion=3; a stub extractor's vector for
    reference audio) from both engines, and the JAX synthesis of both in
    one jitted function."""
    root = tmp_path_factory.mktemp("v21")
    tree = _jax_tree("2.1 vits1 flow", seed=50)
    config, weights = _write_family(root, "v21", "2.1", sd=from_jax_params(tree),
                                    use_transformer_flow=False)
    ext, stub = RandomBertExtractor(0), StubEmotionExtractor(1024, seed=9)
    engine = load_tts_engine(config, weights, bert_extractor=ext, emotion_extractor=stub,
                             device="cpu", **ENGINE_KW)
    jax_model = JaxSynthesizer(JaxModelConfig(**V21))
    jax_engine = jax_api.TTSEngine(jax_model, {"params": tree}, spk2id=SPK2ID,
                                   bert_extractor=ext, version_spec=jax_versions.spec_for("2.1"),
                                   emotion_extractor=stub, **ENGINE_KW)
    kws = [dict(emotion=3), dict(reference_audio="ref.wav")]
    reqs, jax_reqs = [], []
    for kw in kws:
        args = dict(text=SENTENCES["JP"], speaker="bob", language="JP", sdp_ratio=0.4,
                    **ZERO, **kw)
        reqs.append(engine.prepare(**args))
        jax_reqs.append(jax_engine.prepare(**args))
    t_x, max_frames = 64, engine._frame_cap(64, 1.0)

    def pad(r):
        n = len(r.inputs[0])
        out = [np.zeros((1, t_x) + np.asarray(a).shape[1:], np.asarray(a).dtype)
               for a in r.inputs]
        for o, a in zip(out, r.inputs):
            o[0, :n] = a
        x, tone, lang, *berts = out
        return (x, np.asarray([n], np.int32), np.asarray([r.sid], np.int32), tone, lang,
                *berts, r.emo)

    def both(p, a, b):
        return [jax_model.apply({"params": p}, *args[:8], max_frames, emo=args[8],
                                sdp_ratio=0.4, length_scale=1.0, **ZERO,
                                method=JaxSynthesizer.infer, rngs={"noise": jax.random.key(0)})
                for args in (a, b)]

    a, b = pad(jax_reqs[0]), pad(jax_reqs[1])
    # the compile dominates this fixture: skip LLVM's expensive passes
    run = jax.jit(both).lower(tree, a, b).compile(compiler_options={
        "xla_llvm_disable_expensive_passes": True,
        "xla_backend_optimization_level": 0})
    outs = jax.device_get(run(tree, a, b))
    want = [np.asarray(w)[0, : int(n[0]) * engine.hop_length] for w, _, _, n in outs]
    return SimpleNamespace(engine=engine, reqs=reqs, jax_reqs=jax_reqs, want=want,
                           stub=stub, root=root, config=config, weights=weights)


def test_v21_vits1_engine_matches_jax(v21):
    """load_tts_engine on a V2.1 config.json with use_transformer_flow false
    and a G_0.pth with the quantizer's EMA buffers (dropped, not loaded);
    prepare with emotion=3 and with reference audio through the stub: the
    same requests as the JAX engine's; infer at zero noise: the JAX waves
    within WAVE_ATOL."""
    engine = v21.engine
    cfg = engine.model.cfg
    assert (cfg.emotion, cfg.use_transformer_flow, cfg.n_vocab) == ("vq210", False, 112)
    assert type(engine.model.flow).__name__ == "ResidualCouplingBlock"
    assert engine.version_spec.family == "2.1"
    from bert_vits2_tpu_torch.infer.loader import _pth_state_dict, load_generator_params
    assert not any(k.endswith((".initted", ".cluster_size", ".embed_avg"))
                   for k in _pth_state_dict(v21.weights))
    res = load_generator_params(v21.weights, build_synthesizer(ModelConfig(**V21),
                                                                device="cpu"))
    assert not res.missing_keys and not res.unexpected_keys
    for got, want in zip(v21.reqs, v21.jax_reqs):
        for g, w in zip(got.inputs, want.inputs):
            assert np.array_equal(g, w)
        assert got.emo.dtype == want.emo.dtype and np.array_equal(got.emo, want.emo)
        assert got._replace(inputs=None, emo=None) == want._replace(inputs=None, emo=None)
    assert v21.reqs[0].emo.tolist() == [3] and v21.reqs[1].emo.shape == (1, 1024)
    assert v21.stub.calls[0] == ("ref.wav", None)
    assert engine.group_key(v21.reqs[0]) != engine.group_key(v21.reqs[1])
    with pytest.raises(ValueError, match="emotion input kinds"):
        engine.run_prepared(v21.reqs)
    got = [engine.infer(SENTENCES["JP"], "bob", language="JP", sdp_ratio=0.4, **ZERO, **kw)
           for kw in (dict(emotion=3), dict(reference_audio="ref.wav"))]
    for g, w in zip(got, v21.want):
        assert len(g) == len(w) > 0
        assert np.abs(g - w).max() <= WAVE_ATOL
    # the emotion input matters: other durations, or another wave
    assert len(got[0]) != len(got[1]) or np.abs(got[0] - got[1]).max() > 1e-3
    assert engine.warmup(batch_sizes=(2,), buckets=(16,)) == 1


def test_v21_voice_round_trip_with_emotion(v21):
    """GET /voice with emotion=3 on the V2.1 engine through the port's HTTP
    server: a WAV within 1 LSB of engine.infer with the same emotion."""
    engine = v21.engine
    registry = port_serve.ModelRegistry(loader=port_server.engine_loader("cpu"))
    registry.init_model(v21.weights, v21.config, engine=engine)
    srv = port_server.make_server(registry, "127.0.0.1", 0,
                                  models_dir=str(v21.root / "models"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        q = dict(text=SENTENCES["JP"], model_id=0, speaker_name="carol", language="JP",
                 noise=0, noisew=0, emotion=3)
        from urllib.parse import urlencode
        ctype, body = _get(f"http://127.0.0.1:{srv.server_address[1]}/voice?{urlencode(q)}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(10)
    assert ctype == "audio/wav"
    sr, pcm = _pcm(body)
    want = engine.infer(SENTENCES["JP"], "carol", language="JP", emotion=3, **ZERO)
    assert sr == 44100 and len(pcm) == len(want) > 0
    assert np.abs(pcm.astype(np.int32) - float_to_int16(want).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("version,lang", [("1.0.1", "ZH"), ("1.1.1-fix", "JP"),
                                          ("2.0.2-fix", "EN"), ("2.2", "EN")])
def test_old_family_engines_synthesize(version, lang, tmp_path):
    """Tiny engines from config.json + G_0.pth (1.0 ZH only; 1.1 with a
    768-d ja_bert; 2.0; 2.2 with zero CLAP features, a stub's 512-d vector
    and a CLAP text prompt): finite waves in [-1, 1] whose length is the
    duration pass's frames times the hop."""
    stub = StubEmotionExtractor(512, seed=8)
    config, weights = _write_family(tmp_path, "g", version)
    engine = load_tts_engine(config, weights, bert_extractor=RandomBertExtractor(0),
                             emotion_extractor=stub, device="cpu", **ENGINE_KW)
    spec = versions.spec_for(version)
    assert engine.version_spec == spec
    assert engine.model.cfg == ModelConfig(**_family_cfg(spec.family))
    kws = ([{}, dict(reference_audio="ref.wav"), dict(emotion="happy")]
           if spec.emotion == "clap220" else [{}])
    waves = []
    for kw in kws:
        req = engine.prepare(SENTENCES[lang], "alice", language=lang, **kw)
        assert (req.emo is None) == (spec.emotion == "none")
        frames = engine.predict_frames([req])
        wave = engine.run_prepared([req])[0]
        assert len(wave) == int(frames[0]) * engine.hop_length > 0
        assert np.isfinite(wave).all() and np.abs(wave).max() <= 1.0
        waves.append(wave)
    if spec.emotion == "clap220":
        assert engine.model.enc_p.emo_vq.heads == 32
        assert stub.calls == [("ref.wav", None), (None, "happy")]
        assert len({w.tobytes() for w in waves}) == 3


def test_v22_release_npz_loads(tmp_path):
    """A V2.2 .npz written by the JAX package's save_release: the port's
    load_tts_engine takes every parameter from it (enc_q, absent from
    releases, keeps its init) and synthesizes."""
    tree = _jax_tree("2.2", seed=60)
    npz = tmp_path / "v22.npz"
    save_release(str(npz), tree)
    config = _write_family_config(tmp_path, "v22", "2.2")
    engine = load_tts_engine(config, str(npz), bert_extractor=RandomBertExtractor(0),
                             device="cpu", **ENGINE_KW)
    want = from_jax_params(tree)
    got = engine.model.state_dict()
    for k, v in want.items():
        if not k.startswith("enc_q."):
            assert torch.equal(got[k], v), k
    wave = engine.infer(SENTENCES["EN"], "dave", language="EN", **ZERO)
    assert len(wave) > 0 and np.isfinite(wave).all()


# ---- text/emotion.py ----


def test_emotion_module_is_the_original():
    want = (REPO / "bert_vits2_tpu" / "text" / "emotion.py").read_text().replace(
        "bert_vits2_tpu.", "bert_vits2_tpu_torch.")
    assert (REPO / "bert_vits2_tpu_torch" / "text" / "emotion.py").read_text() == want


def test_emotion_extractors_need_their_weights(tmp_path, monkeypatch):
    """With no model directory the extractors raise a RuntimeError that says
    what to do, before importing transformers (hidden here); the default
    extractor follows the model's branch."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    for cls in (port_emotion.Wav2Vec2EmotionExtractor, port_emotion.ClapFeatureExtractor):
        with pytest.raises(RuntimeError, match="not found"):
            cls(model_dir=str(tmp_path / "missing"))(reference_audio=np.zeros(16, np.float32))
    assert isinstance(port_emotion.default_emotion_extractor("vq210"),
                      port_emotion.Wav2Vec2EmotionExtractor)
    assert isinstance(port_emotion.default_emotion_extractor("clap220"),
                      port_emotion.ClapFeatureExtractor)
    with pytest.raises(ValueError):
        port_emotion.default_emotion_extractor("none")


def test_default_emotion_extractor_is_built_once_under_threads(v21, monkeypatch):
    """16 threads preparing reference-audio requests at once on an engine
    without an extractor: the default one (a counting, slow stand-in for
    the wav2vec2 extractor) is built once on the engine's device and loads
    its weights once, before any thread calls it; every request gets its
    vector."""
    from bert_vits2_tpu_torch.infer import TTSEngine

    built, loads = [], []

    class SlowExtractor(StubEmotionExtractor):
        def __init__(self, device):
            built.append(device)
            super().__init__(1024, seed=9)
            self.loaded = False

        def _load(self):
            threading.Event().wait(0.05)  # widen the check-then-act window
            loads.append(1)
            self.loaded = True

        def __call__(self, reference_audio=None, prompt=None):
            assert self.loaded
            return super().__call__(reference_audio, prompt)

    monkeypatch.setattr(port_emotion, "Wav2Vec2EmotionExtractor", SlowExtractor)
    engine = TTSEngine(v21.engine.model, spk2id=SPK2ID, device="cpu",
                       bert_extractor=v21.engine.bert_extractor,
                       version_spec=v21.engine.version_spec)
    out = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: out.append(engine.prepare(
            SENTENCES["JP"], "bob", language="JP", reference_audio=f"ref{i}.wav").emo))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert built == [torch.device("cpu")] and loads == [1] and len(out) == 16
    assert all(e.shape == (1, 1024) for e in out)
