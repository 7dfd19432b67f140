"""PyTorch port, text in, wave out: `get_text`, the engine's text entry points
(`infer`, `infer_multilang`, `infer_batch`, `resolve_speaker`, `warmup`)
and `load_tts_engine` against the JAX package on the CPU.

One random parameter tree (tests/test_torch_modules.py) on the tiny config
with the full symbol table, converted into the port; one
`RandomBertExtractor(0)` feeds both engines, so the BERT features are
equal within this process (its seed mixes in `hash(norm_text)`).

The JAX reference: the JAX engine prepares every request that the port's
entry points make (two `infer`s by speaker name, one `infer_multilang`
with trims, the three items of one `infer_batch` with per-item knobs) and
synthesizes the pile in one `run_prepared` call. At zero noise a wave does
not depend on its batch company: both engines use one text bucket and a
frame multiple as large as the frame cap, so every call has the same
(bucket, cap), and the pile costs the JAX engine two compiles (the
duration pass and the synthesis) instead of two per pile and batch size. The JAX engine runs
under `force_lax_attention`: on the CPU its attention takes the dense
branch either way, and the context spares tracing the TPU-only Pallas
branch. Its loader's eager `Synthesizer.init` (the import template, ~35 s
on the CPU) is replaced by a random tree of the same shapes: every
parameter that synthesis reads comes from the file.

Tolerances: get_text's arrays exactly equal; waves at zero noise of equal
length and within WAVE_ATOL = 1e-4 (tests/test_torch_synthesis.py).
"""

import json

import numpy as np
import pytest
import torch

from bert_vits2_tpu.compat import versions as jax_versions
from bert_vits2_tpu.infer import api as jax_api
from bert_vits2_tpu.infer import loader as jax_loader
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.ops.attention_pallas import force_lax_attention
from bert_vits2_tpu.utils.model_tools import save_release
from bert_vits2_tpu_torch.compat import versions
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import TTSEngine, get_text, load_tts_engine
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.text.bert import RandomBertExtractor
from bert_vits2_tpu_torch.text.symbols import SYMBOLS
from test_torch_modules import TINY, random_synth_params
from test_torch_synthesis import WAVE_ATOL
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(TINY, n_vocab=len(SYMBOLS))
ENGINE_KW = dict(text_buckets=(64,), frames_per_token=4, frame_multiple=320)
SPK2ID = {"alice": 0, "bob": 1, "carol": 2, "dave": 3}
SENTENCES = {"JP": "こんにちは、世界。", "EN": "Hello world.", "ZH": "你好，世界。"}
ZERO = dict(noise_scale=0.0, noise_scale_w=0.0)


@pytest.fixture(scope="module", autouse=True)
def _dense_jax_attention():
    with force_lax_attention():
        yield


# (prepare kwargs, key): the requests of the port's entry-point calls below
BATCH = dict(texts=[SENTENCES[k] for k in ("JP", "EN", "ZH")], speakers=["alice", 1, "carol"],
             language=["JP", "EN", "ZH"], sdp_ratio=[0.2, 0.5, 0.0],
             length_scale=[1.0, 1.2, 0.9])
SEGMENTS = [(SENTENCES["JP"], "JP"), (SENTENCES["EN"], "EN")]
PILE = [
    ("infer JP", dict(text=SENTENCES["JP"], speaker="bob", language="JP", sdp_ratio=0.4)),
    ("infer EN", dict(text=SENTENCES["EN"], speaker="dave", language="EN", sdp_ratio=0.4)),
    ("multilang", dict(text=None, speaker="alice", segments=SEGMENTS, sdp_ratio=0.3)),
] + [(f"batch {i}", dict(text=BATCH["texts"][i], speaker=BATCH["speakers"][i],
                         language=BATCH["language"][i], sdp_ratio=BATCH["sdp_ratio"][i],
                         length_scale=BATCH["length_scale"][i])) for i in range(3)]


def _jax_waves(jax_engine) -> dict:
    reqs = [jax_engine.prepare(**kw, **ZERO) for _, kw in PILE]
    return dict(zip((k for k, _ in PILE), jax_engine.run_prepared(reqs)))


@pytest.fixture(scope="module")
def engines():
    jax_model = JaxSynthesizer(JaxModelConfig(**CFG))
    params = random_synth_params(jax_model, seed=1)
    port = build_synthesizer(ModelConfig(**CFG), device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    ext = RandomBertExtractor(0)
    jax_engine = jax_api.TTSEngine(jax_model, {"params": params}, spk2id=SPK2ID,
                                   bert_extractor=ext, **ENGINE_KW)
    engine = TTSEngine(port, spk2id=SPK2ID, bert_extractor=ext, device="cpu",
                       **ENGINE_KW)
    return jax_engine, engine, params, port, _jax_waves(jax_engine)


def _close(got, want):
    assert [len(w) for w in got] == [len(w) for w in want]
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert err <= WAVE_ATOL, err
    return err


@pytest.mark.parametrize("lang", ["JP", "EN", "ZH"])
def test_get_text_matches_jax(lang):
    """The six arrays, bit for bit, with and without the 2.3 spec, for two
    noise seeds, and with another family's spec (2.1: zero fills for the
    inactive languages, as the JAX get_text gives them; every family in
    tests/test_torch_versions.py)."""
    ext = RandomBertExtractor(0)
    spec, jax_spec = versions.spec_for("2.3"), jax_versions.spec_for("2.3")
    old, jax_old = versions.spec_for("2.1"), jax_versions.spec_for("2.1")
    for noise_seed, (s, js) in ((0, (None, None)), (5, (spec, jax_spec)),
                                (5, (old, jax_old))):
        got = get_text(SENTENCES[lang], lang, ext, noise_seed=noise_seed, spec=s)
        want = jax_api.get_text(SENTENCES[lang], lang, ext, noise_seed=noise_seed,
                                spec=js)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert not any(got[3 + j].any() for j, la in enumerate(("ZH", "JP", "EN"))
                   if la != lang)


def test_prepare_matches_jax(engines):
    """prepare of every request of the pile (speaker names, segments with the
    inner 3/2-token trims, knobs) and of two with the outer trims
    (skip_start, skip_end): the same arrays and fields as the JAX engine's.
    Emotion inputs condition V2.1/V2.2 engines only: this 2.3 engine
    ignores them, as the JAX one does."""
    jax_engine, engine, *_ = engines
    assert engine.resolve_speaker("carol") == jax_engine.resolve_speaker("carol") == 2
    assert engine.resolve_speaker(3) == jax_engine.resolve_speaker(3) == 3
    trims = dict(skip_start=True, skip_end=True)
    for key, kw in PILE + [("trimmed", dict(PILE[0][1], **trims)),
                           ("trimmed segments", dict(PILE[2][1], **trims))]:
        got, want = engine.prepare(**kw, **ZERO), jax_engine.prepare(**kw, **ZERO)
        for g, w in zip(got.inputs, want.inputs):
            assert np.array_equal(g, w), key
        assert got._replace(inputs=None) == want._replace(inputs=None), key
    for emo in (dict(emotion=1), dict(reference_audio="ref.wav")):
        got, want = engine.prepare(**PILE[0][1], **emo), jax_engine.prepare(**PILE[0][1], **emo)
        assert got.emo is None and want.emo is None
        assert got._replace(inputs=None) == want._replace(inputs=None)
    whole = [get_text(t, la, engine.bert_extractor) for t, la in SEGMENTS]
    n = [len(engine.prepare(**PILE[2][1], **t).inputs[0]) for t in ({}, trims)]
    assert n == [len(whole[0][0]) + len(whole[1][0]) - 5,
                 len(whole[0][0]) + len(whole[1][0]) - 10]


def test_infer_and_multilang_match_jax(engines):
    """infer by speaker name (JP, EN) and infer_multilang (JP + EN, the inner
    boundary and both outer ones trimmed) at zero noise."""
    _, engine, _, _, want = engines
    for key in ("infer JP", "infer EN"):
        kw = dict(PILE[[k for k, _ in PILE].index(key)][1])
        _close([engine.infer(kw.pop("text"), kw.pop("speaker"), **kw, **ZERO)], [want[key]])
    _close([engine.infer_multilang(SEGMENTS, "alice", sdp_ratio=0.3, **ZERO)],
           [want["multilang"]])


def test_infer_batch_packed_matches_jax(engines):
    """Three texts in three languages with per-item knobs and max_batch=2:
    the port's pile goes through run_packed (chunks of 2 and 1)."""
    _, engine, _, _, want = engines
    kw = {k: v for k, v in BATCH.items() if k not in ("texts", "speakers")}
    _close(engine.infer_batch(BATCH["texts"], BATCH["speakers"], max_batch=2, **kw, **ZERO),
           [want[f"batch {i}"] for i in range(3)])


def test_warmup_runs_the_grid(engines):
    engine = engines[1]
    assert engine.warmup(batch_sizes=(1, 2), buckets=(16, 32)) == 4


def _write_config(path, version="2.3"):
    model = {k: list(v) if isinstance(v, tuple) else v for k, v in CFG.items()
             if k not in ("n_vocab", "spec_channels", "n_speakers", "segment_size")}
    model["resblock_dilation_sizes"] = [list(d) for d in CFG["resblock_dilation_sizes"]]
    hps = dict(version=version, train=dict(segment_size=8 * 16),
               data=dict(sampling_rate=44100, filter_length=64, hop_length=16,
                         n_speakers=4, spk2id=SPK2ID),
               model=model)
    path.write_text(json.dumps(hps))
    return str(path)


def test_loader_matches_jax(engines, tmp_path, monkeypatch):
    """A config.json plus a G_0.pth (the port's state_dict, keys under the
    DDP `module.` prefix) and an .npz release (the JAX package's
    save_release): both packages' load_tts_engine give the same waves from
    each. A 2.1 config.json routes to the V2.1 family (this 2.3 file lacks
    its emotion keys, which keep their init); compute_dtype="bfloat16"
    loads the same parameters into a bf16 engine (tests/test_torch_bf16.py
    holds its synthesis); orbax directories raise."""
    jax_engine, _, params, port, want = engines
    config = _write_config(tmp_path / "config.json")
    pth = tmp_path / "G_0.pth"
    torch.save({"model": {f"module.{k}": v for k, v in port.state_dict().items()},
                "iteration": 0}, pth)
    npz = tmp_path / "release.npz"
    save_release(str(npz), params)
    template = random_synth_params(jax_engine.model, seed=7)
    monkeypatch.setattr(jax_loader, "_materialize", lambda seed, synth, mcfg: template)
    ext = RandomBertExtractor(0)
    for weights in (pth, npz):
        engine = load_tts_engine(config, str(weights), bert_extractor=ext,
                                 device="cpu", **ENGINE_KW)
        assert engine.model.cfg == ModelConfig(**CFG)
        assert engine.spk2id == SPK2ID and engine.sampling_rate == 44100
        loaded = jax_loader.load_tts_engine(config, str(weights), bert_extractor=ext,
                                     **ENGINE_KW)
        assert loaded.model.cfg == jax_engine.model.cfg
        loaded._jitted = jax_engine._jitted  # same graphs: no new compile
        loaded_waves = _jax_waves(loaded)
        _close([loaded_waves[k] for k in want], list(want.values()))
        _close([engine.infer(SENTENCES["EN"], "dave", language="EN", sdp_ratio=0.4,
                             **ZERO)], [loaded_waves["infer EN"]])
    old = load_tts_engine(_write_config(tmp_path / "old.json", "2.1"), str(pth),
                          bert_extractor=ext, device="cpu")
    assert old.version_spec == versions.spec_for("2.1")
    assert old.model.cfg == ModelConfig(**dict(CFG, emotion="vq210"))
    bf16 = load_tts_engine(config, str(pth), bert_extractor=ext,
                           compute_dtype="bfloat16", device="cpu")
    assert bf16.model.cfg == ModelConfig(**dict(CFG, infer_compute_dtype="bfloat16"))
    assert bf16.model.compute_dtype == torch.bfloat16
    sd = bf16.model.state_dict()
    assert sd.keys() == port.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in port.state_dict().items())
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        load_tts_engine(config, str(tmp_path / "orbax"), bert_extractor=ext,
                        device="cpu")


def test_version_table_matches_jax():
    assert versions.VERSION_TO_FAMILY == jax_versions.VERSION_TO_FAMILY
    assert versions.LATEST_VERSION == jax_versions.LATEST_VERSION
    for v in (None, "", "2.3", "2.3.1", "9.9", "2.1", "1.1.1-fix", "2.0.2-fix", "1"):
        assert versions.family_for(v) == jax_versions.spec_for(v).family, v
    spec, jax_spec = versions.spec_for("2.3"), jax_versions.spec_for("2.3")
    assert spec.model_overrides() == jax_spec.model_overrides()
    for field in ("family", "num_tones", "ja_bert_dim", "emotion", "n_vocab"):
        assert getattr(spec, field) == getattr(jax_spec, field), field
