"""PyTorch port, package level: the config copy, the weight conversion, the
import boundary and the device rule."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from bert_vits2_tpu.compat.torch_import import (
    convert_state_dict,
    dur_disc_rename,
    mpd_rename,
    synthesizer_rename,
)
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models import build_synthesizer
from test_torch_modules import TINY, random_synth_params

REPO = Path(__file__).resolve().parent.parent


def test_model_config_matches_jax():
    """The port's copy of ModelConfig has the JAX dataclass's fields and
    defaults, and reads a reference config.json the same way."""
    ours = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)]
    assert ours == theirs
    assert ModelConfig().hop_length == JaxModelConfig().hop_length == 512
    model = dict(inter_channels=8, resblock_kernel_sizes=[3, 7],
                 resblock_dilation_sizes=[[1, 3], [1, 3]],
                 upsample_rates=[4, 4], slm=dict(hidden=32, nlayers=2))
    data = dict(filter_length=64, hop_length=16, n_speakers=3)
    a = ModelConfig.from_json(model, data, segment_size=128)
    b = JaxModelConfig.from_json(model, data, segment_size=128)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_from_jax_params_round_trip():
    """Every port parameter is filled from the JAX tree, and the port's
    state_dict converts back through the JAX package's own importer
    (strict: no missing or extra key) to the same tree, bit for bit."""
    params = random_synth_params(JaxSynthesizer(JaxModelConfig(**TINY)), seed=3)
    sd = from_jax_params(params)
    port = build_synthesizer(ModelConfig(**TINY), device="cpu")
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    back, report = convert_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, params,
        rename=synthesizer_rename, strict=True)
    assert not report["unmatched"] and not report["unused_flax"]
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, leaf in got:
        assert np.array_equal(np.asarray(leaf), np.asarray(want[path])), path
    # reference key names (ROADMAP rules)
    for key in ("enc_q.pre.weight", "enc_q.enc.in_layers.15.weight_v",
                "enc_q.enc.res_skip_layers.0.weight_g",
                "enc_q.enc.cond_layer.weight_v", "enc_q.proj.bias",
                "enc_p.encoder.attn_layers.0.conv_q.weight", "dec.ups.0.weight_v",
                "dec.ups.0.weight_g", "flow.flows.4.post.weight",
                "sdp.flows.0.logs", "sdp.flows.7.proj.weight",
                "sdp.post_flows.1.pre.weight", "emb_g.weight"):
        assert key in sd, key
    # a transposed conv's gain is per IN channel
    assert tuple(sd["dec.ups.0.weight_g"].shape) == (16, 1, 1)


def test_discriminator_params_round_trip():
    """The discriminators' parameters convert into the port's modules
    (strictly: reference names `discriminators.N`, `LSTM`, `output_layer.0`)
    and back through the JAX package's own importers to the same trees."""
    from test_torch_train_modules import MPD, build_discriminators

    (_, p_d, mpd), (_, p_dd, dd) = build_discriminators(seed=5)
    assert "discriminators.0.convs.1.weight_v" in mpd.state_dict()
    assert tuple(mpd.state_dict()["discriminators.2.convs.0.weight_g"].shape) == (
        8, 1, 1, 1)
    assert {"LSTM.weight_ih_l0_reverse", "output_layer.0.weight"} <= set(dd.state_dict())
    for module, tree, kw in (
            (mpd, p_d, dict(rename=mpd_rename(MPD["periods"]))),
            (dd, p_dd, dict(rename=dur_disc_rename,
                            lstm_sites=(("LSTM", "lstm_fwd", "lstm_bwd"),)))):
        back, report = convert_state_dict(
            {k: v.numpy() for k, v in module.state_dict().items()}, tree,
            strict=True, **kw)
        assert not report["unmatched"] and not report["unused_flax"]
        want = dict(jax.tree_util.tree_leaves_with_path(tree))
        for path, leaf in jax.tree_util.tree_leaves_with_path(back):
            assert np.array_equal(np.asarray(leaf), np.asarray(want[path])), path


_PROBE = """
import json, sys
import bert_vits2_tpu_torch
import importlib, pkgutil
for info in pkgutil.walk_packages(bert_vits2_tpu_torch.__path__,
                                  "bert_vits2_tpu_torch."):
    importlib.import_module(info.name)
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import TTSEngine
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.train.trainer import Trainer, build_models
from bert_vits2_tpu_torch.train.__main__ import main as train_main
from bert_vits2_tpu_torch.infer import load_tts_engine
for name in ("text.cleaner", "text.mandarin", "text.japanese", "text.english",
             "text.bert", "text.bert_encoder", "infer.loader", "utils.model_tools",
             "serve", "serve.server", "serve.batcher", "serve.registry",
             "serve.textseg", "serve.markup", "serve.translate", "serve.webui",
             "utils.audio", "compat.versions", "nn.vq", "text.emotion",
             "models.text_encoder", "models.flow", "compat.stages",
             "compat.torch2onnx", "compat.onnx_export", "compat.onnx_pb",
             "compat.onnx_eval", "compat.onnx_check", "compat.onnx_infer",
             "utils.flops", "ops.library"):
    assert "bert_vits2_tpu_torch." + name in sys.modules, name
from bert_vits2_tpu_torch.text import clean_text
for text, lang in (("こんにちは", "JP"), ("Hello world.", "EN")):
    clean_text(text, lang)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                       "onnx", "onnxruntime", "bert_vits2_tpu"))
raised = []
try:
    build_synthesizer(ModelConfig(n_layers=1))
except RuntimeError:
    raised.append("build_synthesizer")
model = build_synthesizer(ModelConfig(n_layers=1), device="cpu")
try:
    TTSEngine(model)
except RuntimeError:
    raised.append("TTSEngine")
try:
    build_models(ModelConfig(n_layers=1))
except RuntimeError:
    raised.append("build_models")
try:
    Trainer("no-such-config.json", "no-such-dir")
except RuntimeError:
    raised.append("Trainer")
try:
    train_main(["-c", "no-such-config.json", "-m", "no-such-dir"])
except RuntimeError:
    raised.append("train CLI")
try:
    load_tts_engine("no-such-config.json")
except RuntimeError:
    raised.append("load_tts_engine")
from bert_vits2_tpu_torch.text.bert_encoder import BertEncoderExtractor
try:
    BertEncoderExtractor()
except RuntimeError:
    raised.append("BertEncoderExtractor")
from bert_vits2_tpu_torch.serve import server


def serve_from_the_cpu(*a, **k):
    raise SystemExit("the server CLI went on to serve without a card")


server.make_server = serve_from_the_cpu
sys.argv = ["server", "--host", "127.0.0.1", "--port", "0"]
try:
    server.main()
except RuntimeError:
    raised.append("server CLI")
assert "bert_vits2_tpu_torch.train.step" in sys.modules
assert "bert_vits2_tpu_torch.ops.align" in sys.modules
import numpy as np
import torch
from bert_vits2_tpu_torch.compat.versions import spec_for
from bert_vits2_tpu_torch.text import emotion
from bert_vits2_tpu_torch.text.bert import RandomBertExtractor
emotion_devices = []


def no_weights(extractor):
    emotion_devices.append(str(extractor.device))
    raise RuntimeError("no emotion weights here")


emotion.Wav2Vec2EmotionExtractor._load = no_weights
emotion.ClapFeatureExtractor._load = no_weights
for family in ("2.1", "2.2"):
    cfg = ModelConfig(n_layers=1, **spec_for(family).model_overrides())
    engine = TTSEngine(build_synthesizer(cfg, device="cpu"), device="cpu",
                       bert_extractor=RandomBertExtractor(0))
    engine.device = torch.device("cuda")  # the extractor follows the engine
    try:
        engine._resolve_emotion(None, np.zeros(16, np.float32), 1)
    except RuntimeError:
        pass
print(json.dumps({"loaded": loaded, "raised": raised,
                  "emotion_devices": emotion_devices}))
"""


def test_import_boundary_and_default_device():
    """In a fresh interpreter with no card visible: importing every module of
    the port (the training modules, the data pipeline, the CLI, the text
    frontend, the BERT encoder, the loader and the release reader included)
    and cleaning a JP and an EN sentence loads neither JAX, flax, optax nor
    the JAX package, and the entry points (the Trainer, the training CLI,
    the loader, the BERT encoder's extractor and the HTTP server's CLI
    included) default to CUDA and raise instead of falling back to the CPU;
    an engine on the card builds the default V2.1 and V2.2 emotion
    extractors on the card.
    The serving layer (`serve.*`, `utils.audio`), the stages and the ONNX
    export (`compat.stages`, `compat.torch2onnx`, ...) and the old-version
    modules (`compat.versions`, `nn.vq`, `text.emotion`) are among the
    modules imported."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"loaded": [], "raised": ["build_synthesizer", "TTSEngine",
                                            "build_models", "Trainer",
                                            "train CLI", "load_tts_engine",
                                            "BertEncoderExtractor", "server CLI"],
                   "emotion_devices": ["cuda", "cuda"]}


@pytest.mark.parametrize("path", ["bert_vits2_tpu_torch", "chip_smoke.py"])
def test_port_sources_name_no_jax(path):
    """No source file of the port or of chip_smoke.py imports JAX, flax,
    optax, orbax, the `onnx` package or the JAX package (its JAX-free
    modules too: the port keeps its own `compat/versions.py`, `nn/vq.py`,
    `text/emotion.py`, `utils/flops.py` and the ONNX codec, evaluator,
    checker and pipeline)."""
    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    if root.is_dir():
        names = {str(f.relative_to(root)) for f in files}
        assert {"compat/versions.py", "nn/vq.py", "text/emotion.py", "utils/flops.py",
                "compat/onnx_pb.py", "compat/onnx_eval.py", "compat/onnx_check.py",
                "compat/onnx_infer.py"} <= names
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0].rstrip(",")
                assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "onnx",
                                   "bert_vits2_tpu"), (f, line)
