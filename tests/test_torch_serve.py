"""PyTorch port, the serving layer: `bert_vits2_tpu_torch/serve/` and
`utils/audio.py` against the JAX package's `serve/` and `utils/audio.py`.

- Copies pinned: each module's source equals the JAX original with the
  imports renamed; `registry.py`, `server.py`, `webui.py` and `batcher.py`
  differ only in the lines listed here (the device in `info()` and
  `status()`, `--device` and its loader, the page's title and heading, and
  docstrings and help texts that named the TPU or XLA).
- Host logic, no JAX compile: `textseg` and `markup` give equal outputs on
  the sentences of tests/test_serve.py; the registry, batcher and
  batched-voice scenarios of tests/test_serve.py and tests/test_batcher.py
  run against both packages' classes with one fake engine; both
  `TTSService.voice`s make the same `prepare` calls (plain, AUTO, MIX,
  auto_split; batching on and off).
- The slice against JAX: one random parameter tree in both engines
  (tests/test_torch_infer_text.py's config and engine knobs: one text
  bucket and one frame cap, so the JAX side compiles its duration pass and
  its synthesis once); `TTSService.voice` on a three-sentence auto_split
  paragraph at zero noise, batching off, in both packages: equal lengths,
  waves within WAVE_ATOL = 1e-4 (fp32).
- One HTTP round trip over every endpoint on the port's tiny CPU engine;
  `/tools/translate` with `urlopen` replaced, so that a call out fails.
"""

import contextlib
import difflib
import io
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import bert_vits2_tpu.serve as jax_serve
from bert_vits2_tpu.infer import api as jax_api
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.ops.attention_pallas import force_lax_attention
from bert_vits2_tpu.serve import batcher as jax_batcher
from bert_vits2_tpu.serve import server as jax_server
from bert_vits2_tpu.utils import audio as jax_audio
import bert_vits2_tpu_torch.serve as port_serve
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import TTSEngine
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.serve import batcher as port_batcher
from bert_vits2_tpu_torch.serve import server as port_server
from bert_vits2_tpu_torch.serve import translate as port_translate
from bert_vits2_tpu_torch.text.bert import RandomBertExtractor
from bert_vits2_tpu_torch.utils import audio as port_audio
from bert_vits2_tpu_torch.utils.audio import float_to_int16
from test_batcher import FakeEngine, _req
from test_torch_infer_text import CFG, ENGINE_KW, SPK2ID, _write_config
from test_torch_modules import random_synth_params
from test_torch_synthesis import WAVE_ATOL
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
COPIED = ("serve/__init__", "serve/textseg", "serve/markup", "serve/translate",
          "utils/audio")
# the port's departures, in order: (JAX lines gone, port lines added);
# blank lines left out
DEPARTURES = {
    "batcher": (
        ["(hiyoriUI.py:320-339) — batch 1 per device call. On TPU that wastes the chip:",
         "batched synthesis throughput scales nearly linearly to batch ~16 (bench.py)."],
        ["(hiyoriUI.py:320-339) — batch 1 per device call. On the card that leaves it",
         "idle between a call's small launches: a batch shares them across its riders."]),
    "registry": (['"device": "tpu",'], ['"device": str(engine.device),']),
    "webui": (
        ["<title>Bert-VITS2 TPU</title>", "<h1>Bert-VITS2 TPU — 语音合成</h1>"],
        ["<title>Bert-VITS2 (PyTorch/CUDA)</title>",
         "<h1>Bert-VITS2 (PyTorch/CUDA) — 语音合成</h1>"]),
    "server": (
        ["paragraph's auto-split sentences share one batched XLA call.",
         '"""Host + device metrics (hiyoriUI.py:584-618, GPUtil -> jax.devices)."""',
         "try:", "import jax", "for d in jax.devices():", "devices.append(",
         '{"id": d.id, "platform": d.platform, "kind": d.device_kind}', ")",
         "except Exception:  # noqa: BLE001", "pass",
         'ap = argparse.ArgumentParser(description="Bert-VITS2 TPU HTTP API server")',
         'help="pre-compile the expected (batch, text-bucket) grid at model "',
         '"load so first requests skip XLA compiles",',
         "from bert_vits2_tpu_torch.infer.loader import load_tts_engine",
         "loader=lambda mp, cp: load_tts_engine(", "cp, checkpoint_path=mp,",
         "allow_noise_bert=not args.require_bert,", ")"],
        ["paragraph's auto-split sentences share one batched synthesis call on the card.",
         '"""Host + device metrics (hiyoriUI.py:584-618, GPUtil -> torch.cuda);',
         'no CUDA device gives an empty list."""', "import torch",
         "for i in range(torch.cuda.device_count()):",
         "devices.append(",
         '{"id": i, "platform": "cuda", "kind": torch.cuda.get_device_name(i),',
         '"memory_total": torch.cuda.get_device_properties(i).total_memory,',
         '"memory_allocated": torch.cuda.memory_allocated(i),',
         '"memory_reserved": torch.cuda.memory_reserved(i)}', ")",
         'def engine_loader(device="cuda", allow_noise_bert: bool = True):',
         '"""The registry\'s loader that main() builds: (checkpoint_path,',
         'config_path) -> a TTSEngine on `device` (load_tts_engine)."""',
         "from bert_vits2_tpu_torch.infer.loader import load_tts_engine",
         "return lambda mp, cp: load_tts_engine(", "cp, checkpoint_path=mp, device=device,",
         "allow_noise_bert=allow_noise_bert,", ")",
         'ap = argparse.ArgumentParser(description="Bert-VITS2 HTTP API server (PyTorch/CUDA)")',
         'help="run the expected (batch, text-bucket) grid at model load so "',
         '"cuDNN\'s algorithm choice and the allocator settle before the "',
         '"first requests",', "ap.add_argument(", '"--device", default="cuda",',
         'help="cuda (default) or cpu; cuda without a card raises",', ")",
         "from bert_vits2_tpu_torch.device import resolve_device",
         "loader=engine_loader(resolve_device(args.device),",
         "allow_noise_bert=not args.require_bert)"]),
}


def _jax_source(module: str) -> str:
    return (REPO / "bert_vits2_tpu" / f"{module}.py").read_text().replace(
        "bert_vits2_tpu.", "bert_vits2_tpu_torch.")


@pytest.mark.parametrize("module", COPIED)
def test_module_source_is_the_original(module):
    got = (REPO / "bert_vits2_tpu_torch" / f"{module}.py").read_text()
    assert got == _jax_source(module)


@pytest.mark.parametrize("module", sorted(DEPARTURES))
def test_module_departs_only_in_the_listed_lines(module):
    want = _jax_source(f"serve/{module}").splitlines()
    got = (REPO / "bert_vits2_tpu_torch" / "serve" / f"{module}.py").read_text().splitlines()
    diff = [line for line in difflib.ndiff(want, got)
            if line[:2] in ("- ", "+ ") and line[2:].strip()]
    gone = [line[2:].strip() for line in diff if line[0] == "-"]
    added = [line[2:].strip() for line in diff if line[0] == "+"]
    assert (gone, added) == DEPARTURES[module]


# ---- host logic: textseg and markup (the sentences of tests/test_serve.py) ----

TEXTS = ["今晚在院子里坐着乘凉", "こんにちは、世界", "hello world", "東京", "hello",
         "你好，这是一段文本。こんにちは,これはテストです.Hello, this is a test.",
         "vits和Bert是模型",
         "这几天心里颇不宁静。今晚在院子里坐着乘凉，忽然想起日日走过的荷塘。" * 3,
         "你好。今天天气不错！明天见？", "第一句。第二句。\n\n第三句？",
         "no markup at all"]
TARGETS = [None, ["ja"], ["zh", "ja"], ["zh", "en"], ["zh", "ja", "en"]]
MIX = ["[说话人1]<zh>你好吗？<jp>元気ですか？\n[说话人2]<zh>谢谢。", "no markup at all",
       "[a]<zh>", "[spk0]<JP>こんにちは。<EN>Hello world.[spk1]<EN>Good morning."]


def test_textseg_and_markup_match_jax():
    for text in TEXTS:
        for targets in TARGETS:
            for name in ("classify_language", "split_by_language", "markup_language"):
                assert getattr(port_serve, name)(text, targets) == getattr(
                    jax_serve, name)(text, targets), (name, text, targets)
        for max_len in (5, 50):
            assert port_serve.sentence_split(text, max_len) == jax_serve.sentence_split(
                text, max_len)
        assert port_serve.cut_sentences(text) == jax_serve.cut_sentences(text)
        assert port_serve.cut_paragraphs(text) == jax_serve.cut_paragraphs(text)
    for text in MIX:
        assert port_serve.parse_mix_text(text) == jax_serve.parse_mix_text(text)
        assert port_serve.validate_mix_text(text) == jax_serve.validate_mix_text(text)


def test_wav_bytes_match_jax():
    audio = np.random.default_rng(0).uniform(-1.2, 1.2, 999).astype(np.float32)
    assert np.array_equal(float_to_int16(audio), jax_audio.float_to_int16(audio))
    body = port_audio.wav_bytes(audio, 16000)
    assert body == jax_audio.wav_bytes(audio, 16000)
    sr, pcm = wavfile.read(io.BytesIO(body))
    assert sr == 16000 and np.array_equal(pcm, float_to_int16(audio))


# ---- host logic: both packages' registry, batcher and service, one fake engine ----

PACKAGES = {
    "jax": SimpleNamespace(MicroBatcher=jax_batcher.MicroBatcher,
                           ModelRegistry=jax_serve.ModelRegistry,
                           TTSService=jax_server.TTSService),
    "port": SimpleNamespace(MicroBatcher=port_batcher.MicroBatcher,
                            ModelRegistry=port_serve.ModelRegistry,
                            TTSService=port_server.TTSService),
}


class Engine(FakeEngine):
    """tests/test_batcher.py's fake engine, on the CPU, recording every
    prepare call (speakers may be digit strings: MIX blocks)."""

    device = torch.device("cpu")

    def __init__(self, **kw):
        super().__init__(**kw)
        self.prepared = []

    def prepare(self, text, speaker, language="ZH", segments=None, **kw):
        self.prepared.append((text, speaker, language, segments, sorted(kw.items())))
        return super().prepare(text, speaker, language=language, segments=segments, **kw)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _files(tmp_path):
    ckpt, cfg = tmp_path / "G_100.pth", tmp_path / "config.json"
    ckpt.write_bytes(b"x")
    cfg.write_text("{}")
    return str(ckpt), str(cfg)


def test_registry_refcount_alias_and_delete(pkg, tmp_path):
    ckpt, cfg = _files(tmp_path)
    reg = pkg.ModelRegistry(loader=lambda mp, cp: Engine())
    a = reg.init_model(ckpt, cfg)
    b = reg.init_model(ckpt, cfg)  # alias, no reload
    assert reg.get(a) is reg.get(b)
    assert len(reg.info()) == 2
    assert reg.del_model(a) == a
    assert b in reg and a not in reg
    assert reg.del_model(a) is None


def test_registry_release_reports_remaining_refs_atomically(pkg, tmp_path):
    ckpt, cfg = _files(tmp_path)
    reg = pkg.ModelRegistry(loader=lambda mp, cp: Engine())
    a = reg.init_model(ckpt, cfg)
    b = reg.init_model(ckpt, cfg)
    eng, still = reg.release(a)
    assert eng is reg.get(b) and still
    eng2, still2 = reg.release(b)
    assert eng2 is eng and not still2
    assert reg.release(b) == (None, False)


def test_registry_info_names_the_device(tmp_path):
    """The one departure of the registry: the port reports the engine's own
    device, the JAX registry "tpu"."""
    ckpt, cfg = _files(tmp_path)
    infos = []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        reg = pkg.ModelRegistry(loader=lambda mp, cp: Engine())
        reg.init_model(ckpt, cfg)
        infos.append(reg.info()["0"])
    assert infos[0].pop("device") == "tpu" and infos[1].pop("device") == "cpu"
    assert infos[0] == infos[1]


def test_batcher_submit_many_is_one_call_in_order(pkg):
    eng = Engine()
    mb = pkg.MicroBatcher(eng, max_batch=16, max_delay_s=0.05)
    try:
        waves = mb.submit([_req(8, sid=i) for i in range(5)])
        assert [int(w[0]) for w in waves] == list(range(5))
        assert len(eng.calls) == 1 and len(eng.calls[0]) == 5
        assert mb.batch_sizes == [5]
    finally:
        mb.close()


def test_batcher_concurrent_clients_share_a_batch(pkg):
    eng = Engine(call_delay_s=0.02)
    mb = pkg.MicroBatcher(eng, max_batch=16, max_delay_s=0.05)
    results = {}

    def client(i):
        results[i] = mb.submit([_req(8, sid=i)])[0]

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert all(int(results[i][0]) == i for i in range(6))
        assert max(len(c) for c in eng.calls) > 1
    finally:
        mb.close()


def test_batcher_groups_by_key_and_caps_the_batch(pkg):
    """max_batch respected; text buckets and emotion-input kinds never share
    a call; a burst above max_batch goes longest first."""
    eng = Engine(buckets=(32, 64))
    mb = pkg.MicroBatcher(eng, max_batch=4, max_delay_s=0.02)
    try:
        mb.submit([_req(8, sid=i) for i in range(10)])
        assert [len(c) for c in eng.calls] == [4, 4, 2]
        eng.calls.clear()
        idx = _req(8)._replace(emo=np.zeros(1, np.int32))
        vec = _req(8)._replace(emo=np.zeros((1, 1024), np.float32))
        mb.submit([_req(8), _req(50), idx, vec, _req(8), _req(50), idx, vec])
        assert sorted(len(c) for c in eng.calls) == [2, 2, 2, 2]
        for call in eng.calls:
            assert len({eng.group_key(r) for r in call}) == 1
        eng.calls.clear()
        mb.submit([_req(t, sid=t) for t in (3, 9, 5, 7, 4, 8)])
        assert [r.sid for r in eng.calls[0]] == [9, 8, 7, 5]
    finally:
        mb.close()


def test_batcher_error_reaches_every_waiter(pkg):
    eng = Engine()
    release = threading.Event()

    def boom(reqs):
        release.wait(5)
        raise RuntimeError("CUDA error: out of memory")

    eng.run_prepared = boom
    mb = pkg.MicroBatcher(eng, max_batch=4, max_delay_s=0.05)
    errors = []

    def client():
        try:
            mb.submit([_req(8)])
        except RuntimeError as e:
            errors.append(str(e))

    try:
        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        release.set()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert errors == ["CUDA error: out of memory"] * 3
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit([_req(8)])


def _service(pkg, eng, batching=True):
    reg = pkg.ModelRegistry()
    reg.init_model("dummy.ckpt", "dummy.json", engine=eng)
    return pkg.TTSService(reg, batching=batching, batch_delay_ms=5.0)


def test_voice_auto_split_rides_one_batch(pkg):
    eng = Engine()
    svc = _service(pkg, eng)
    audio, sr = svc.voice("第一句。第二句。第三句。", 0, speaker=1, language="ZH",
                          auto_split=True, silence_ms=10)
    assert sr == eng.sampling_rate
    assert len(eng.calls) == 1 and len(eng.calls[0]) == 3
    assert len(audio) == 3 * 1 + 2 * int(eng.sampling_rate * 10 / 1000)
    svc.models_delete(0)
    assert id(eng) not in svc._batchers


def test_voice_batching_off_is_one_run_prepared(pkg):
    eng = Engine()
    svc = _service(pkg, eng, batching=False)
    svc.voice("一句。二句。", 0, speaker=1, language="ZH", auto_split=True, silence_ms=0)
    assert len(eng.calls) == 1 and len(eng.calls[0]) == 2


VOICE_CASES = {
    "plain": dict(text="你好。", language="ZH", sdp_ratio=0.5, noise=0.1),
    "AUTO": dict(text="こんにちは、元気ですか。Hello world, this is a test.",
                 language="AUTO", style_text="ねえ", style_weight=0.3),
    "AUTO one language": dict(text="hello there", language="auto", length=1.2),
    "MIX": dict(text="[1]<JP>こんにちは。<EN>Hello.[2]<ZH>你好。", language="MIX"),
    "auto_split": dict(text="第一句。第二句！\n\n第三句？还有", language="JP",
                       auto_split=True, noisew=0.3),
}


@pytest.mark.parametrize("case", sorted(VOICE_CASES))
@pytest.mark.parametrize("batching", [True, False])
def test_voice_prepare_calls_match_jax(case, batching):
    """The JAX service and the port's make the same prepare calls (texts,
    speakers, languages, segments, knobs) and return the same audio."""
    calls, audios = [], []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        eng = Engine()
        svc = _service(pkg, eng, batching=batching)
        try:
            audios.append(svc.voice(model_id=0, speaker=3, silence_ms=5,
                                    **VOICE_CASES[case])[0])
        finally:
            svc.close()
        calls.append(eng.prepared)
    assert calls[0] == calls[1] and calls[0]
    assert np.array_equal(audios[0], audios[1])


# ---- the slice against JAX: one random tree in both engines ----

PARAGRAPH = "こんにちは、世界。今日はいい天気ですね。私は学生です。"


@pytest.fixture(scope="module")
def engines():
    jax_model = JaxSynthesizer(JaxModelConfig(**CFG))
    params = random_synth_params(jax_model, seed=2)
    port = build_synthesizer(ModelConfig(**CFG), device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    ext = RandomBertExtractor(0)
    jax_engine = jax_api.TTSEngine(jax_model, {"params": params}, spk2id=SPK2ID,
                                   bert_extractor=ext, **ENGINE_KW)
    engine = TTSEngine(port, spk2id=SPK2ID, bert_extractor=ext, device="cpu", **ENGINE_KW)
    return jax_engine, engine, port


def test_voice_matches_jax(engines):
    """A three-sentence auto_split paragraph at zero noise, batching off: one
    run_prepared of 3 in each package (one bucket, one frame cap); and the
    port's batched path (one micro-batch of 3) gives the same audio."""
    jax_engine, engine, _ = engines
    kw = dict(text=PARAGRAPH, model_id=0, speaker="bob", language="JP", sdp_ratio=0.3,
              noise=0.0, noisew=0.0, auto_split=True)
    pieces = port_serve.cut_sentences(PARAGRAPH)
    assert len(pieces) == 3
    assert len({engine.group_key(engine.prepare(p, 1, language="JP")) for p in pieces}) == 1
    audio, batch_sizes = {}, []
    for name, pkg, eng, batching in (("jax", PACKAGES["jax"], jax_engine, False),
                                     ("port", PACKAGES["port"], engine, False),
                                     ("port batched", PACKAGES["port"], engine, True)):
        svc = _service(pkg, eng, batching=batching)
        try:
            with force_lax_attention() if name == "jax" else contextlib.nullcontext():
                audio[name], sr = svc.voice(**kw)
            batch_sizes += [b.batch_sizes for b in svc._batchers.values()]
        finally:
            svc.close()
        assert sr == 44100
    assert batch_sizes == [[3]]
    assert len(audio["port"]) == len(audio["jax"]) == len(audio["port batched"])
    assert len(audio["port"]) > 2 * int(44100 * 0.2)
    assert float(np.abs(audio["jax"]).max()) > 0.01  # a wave, not silence
    assert float(np.abs(audio["port"] - audio["jax"]).max()) <= WAVE_ATOL
    assert float(np.abs(audio["port batched"] - audio["port"]).max()) <= WAVE_ATOL


# ---- one HTTP round trip on the port's tiny CPU engine ----


@pytest.fixture(scope="module")
def http(engines, tmp_path_factory):
    engine = engines[1]
    root = tmp_path_factory.mktemp("serve")
    registry = port_serve.ModelRegistry(loader=port_server.engine_loader("cpu"))
    registry.init_model(str(root / "tiny.pth"), str(root / "tiny.json"), engine=engine)
    srv = port_server.make_server(registry, "127.0.0.1", 0, models_dir=str(root / "models"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield SimpleNamespace(url=f"http://127.0.0.1:{srv.server_address[1]}",
                          service=srv.RequestHandlerClass.service, root=root,
                          engine=engine)
    srv.shutdown()
    srv.server_close()
    thread.join(10)


def _get(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers["Content-Type"], r.read()


def _json(url, **params):
    ctype, body = _get(f"{url}?{urllib.parse.urlencode(params)}")
    assert ctype.startswith("application/json")
    return json.loads(body)


def _pcm(body):
    assert body[:4] == b"RIFF"
    sr, pcm = wavfile.read(io.BytesIO(body))
    return sr, pcm


def test_http_voice_get_and_post(http):
    """GET with a query and POST with JSON: audio/wav within 1 LSB of the
    service's own audio for the same request."""
    q = dict(text="こんにちは、世界。", model_id=0, speaker_name="carol", language="JP",
             noise=0, noisew=0)
    ctype, body = _get(f"{http.url}/voice?{urllib.parse.urlencode(q)}")
    assert ctype == "audio/wav"
    sr, pcm = _pcm(body)
    want, want_sr = http.service.voice(q["text"], 0, "carol", language="JP", noise=0.0,
                                       noisew=0.0)
    assert sr == want_sr == 44100 and len(pcm) == len(want) > 0
    assert np.abs(pcm.astype(np.int32) - float_to_int16(want).astype(np.int32)).max() <= 1
    post = dict(text="Hello world.\nGood morning.", model_id=0, speaker_id=2,
                language="EN", noise=0, noisew=0, sdp_ratio=0.6, auto_split=True)
    ctype, body = _get(f"{http.url}/voice", data=json.dumps(post).encode(),
                       headers={"Content-Type": "application/json"})
    assert ctype == "audio/wav"
    _, pcm = _pcm(body)
    want, _ = http.service.voice(post["text"], 0, 2, language="EN", noise=0.0,
                                 noisew=0.0, sdp_ratio=0.6, auto_split=True)
    assert len(pcm) == len(want) and np.abs(
        pcm.astype(np.int32) - float_to_int16(want).astype(np.int32)).max() <= 1


def test_http_models_info_status_and_page(http):
    info = _json(f"{http.url}/models/info")
    assert info["0"]["device"] == "cpu" and info["0"]["speakers"] == SPK2ID
    st = _json(f"{http.url}/status")
    assert st["status"] == 0 and "memory_percent" in st["Data"]
    assert st["Data"]["devices"] == []  # no CUDA device on this host
    ctype, body = _get(http.url + "/")
    assert ctype.startswith("text/html") and "Bert-VITS2 (PyTorch/CUDA)" in body.decode()


def test_http_models_add_voice_and_delete(http):
    """/models/add from a config.json + G_0.pth through main()'s loader on the
    CPU, /models/get_local and /get_unloaded, one /voice on the new model,
    then /models/delete."""
    models = http.root / "models" / "tiny"
    models.mkdir(parents=True)
    config = _write_config(models / "config.json")
    weights = models / "G_0.pth"
    torch.save({"model": http.engine.model.state_dict(), "iteration": 0}, weights)
    assert _json(f"{http.url}/models/add", model_path=str(models / "nowhere" / "G_0.pth")
                 )["status"] == 15
    local = _json(f"{http.url}/models/get_local")["Data"]
    assert local == {str(models): {"config_path": config,
                                   "model_paths": [str(weights)]}}
    assert _json(f"{http.url}/models/get_unloaded")["Data"] == local
    with pytest.warns(UserWarning, match="NO BERT WEIGHTS"):  # the loader's noise BERT
        added = _json(f"{http.url}/models/add", model_path=str(weights))
        q = dict(text="Hello world.", model_id=1, speaker_name="alice", language="EN")
        ctype, body = _get(f"{http.url}/voice?{urllib.parse.urlencode(q)}")
    assert added == {"status": 0, "detail": "模型添加成功", "Data": {"model_id": 1}}
    engine = http.service.registry.get(1)
    assert engine is not http.engine and engine.device == torch.device("cpu")
    assert _json(f"{http.url}/models/info")["1"]["device"] == "cpu"
    assert _json(f"{http.url}/models/get_unloaded")["Data"] == {}
    sr, pcm = _pcm(body)
    assert ctype == "audio/wav" and sr == 44100 and len(pcm) > 0
    assert _json(f"{http.url}/models/delete", model_id=1)["status"] == 0
    assert _json(f"{http.url}/models/delete", model_id=1)["status"] == 14
    assert 1 not in http.service.registry


def test_http_tools(http, tmp_path, monkeypatch):
    """/tools/random_example from a filelist, /tools/get_audio, and
    /tools/translate with urlopen replaced (a call out fails the test)."""
    filelist = tmp_path / "train.list"
    filelist.write_text("a.wav|alice|JP|こんにちは\nb.wav|bob|EN|Hello\nbad row\n",
                        encoding="utf-8")
    http.service.filelists, http.service._examples = [str(filelist)], None
    got = _json(f"{http.url}/tools/random_example", language="EN")
    assert got == {"status": 0, "Data": {"text": "Hello", "speaker": "bob",
                                         "language": "EN"}}
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{http.url}/tools/random_example?language=ZH")
    assert e.value.code == 404
    wav = tmp_path / "a.wav"
    wavfile.write(wav, 16000, np.arange(100, dtype=np.int16))
    ctype, body = _get(f"{http.url}/tools/get_audio?{urllib.parse.urlencode({'path': wav})}")
    assert ctype == "audio/wav" and body == wav.read_bytes()
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{http.url}/tools/get_audio?path=none.wav")
    assert e.value.code == 404

    urls = []

    def no_call_out(url, timeout):
        raise AssertionError(f"translate called out: {url}")

    def fake_urlopen(url, timeout):
        urls.append(url)
        return io.BytesIO(json.dumps({"trans_result": [{"dst": "こんにちは"}]}).encode())

    def use(fn):
        monkeypatch.setattr(port_translate, "urllib", SimpleNamespace(
            parse=urllib.parse, request=SimpleNamespace(urlopen=fn)))

    use(no_call_out)
    got = _json(f"{http.url}/tools/translate", text="你好")
    assert got == {"status": 0, "Data": "请开发者在config.yml中配置app_key与secret_key"}
    use(fake_urlopen)
    got = _json(f"{http.url}/tools/translate", text="你好\n\n世界", app_key="k",
                secret_key="s", to_language="jp")
    assert got == {"status": 0, "Data": "こんにちは\nこんにちは"}
    assert len(urls) == 2 and all(u.startswith(port_translate._URL + "?") for u in urls)
    assert "to=jp" in urls[0] and "appid=k" in urls[0]


def test_http_errors(http):
    for path, code in (("/no/such/path", 404), ("/voice?text=hi&model_id=99&speaker_id=0", 400),
                       ("/voice?model_id=0", 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(http.url + path)
        assert e.value.code == code, path
        assert json.loads(e.value.read())["status"] == (404 if code == 404 else 10)
