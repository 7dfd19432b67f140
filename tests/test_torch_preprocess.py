"""PyTorch port, corpus preparation (`bert_vits2_tpu_torch/preprocess/`)
against the JAX package's (`bert_vits2_tpu/preprocess/`) on a raw corpus
this test writes: ZH, JP and EN rows, at 22.05 kHz stereo PCM16 and 48 kHz
mono float32, with a duplicate row and a row whose audio is missing.

Each package's wizard runs every step (`config`, `resample`, `text`,
`bert`, `spec`) in a data root of its own, and the two trees must agree:
the same files; wavs, lists and config.json equal once the roots' paths
are swapped; the `.bert.npy` caches (seeded noise, one process: the seed
mixes `hash(text)`) equal; the `.spec.npy` caches within 1e-6 (the JAX
package's own bound for its two STFTs)."""

import json
import os
import shutil
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from bert_vits2_tpu.preprocess import emo_gen as jax_emo_gen
from bert_vits2_tpu.preprocess import text as jax_text
from bert_vits2_tpu.preprocess import wizard as jax_wizard
from bert_vits2_tpu.text import emotion as jax_emotion
from bert_vits2_tpu_torch.preprocess import bert_gen, emo_gen, text, wizard
from bert_vits2_tpu_torch.preprocess._pool import map_jobs
from bert_vits2_tpu_torch.text import emotion
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ROWS = [
    ("zh0", "alice", "ZH", "你好，世界。"),
    ("zh1", "alice", "ZH", "今天天气不错。"),
    ("zh2", "bob", "ZH", "我们去公园吧。"),
    ("zh3", "bob", "ZH", "谢谢你的帮助。"),
    ("zh4", "alice", "ZH", "明天见。"),
    ("jp0", "carol", "JP", "こんにちは。"),
    ("jp1", "carol", "JP", "元気ですか。"),
    ("jp2", "dave", "JP", "ありがとう。"),
    ("jp3", "dave", "JP", "さようなら。"),
    ("jp4", "carol", "JP", "おはよう。"),
    ("en0", "erin", "EN", "Hello world."),
    ("en1", "erin", "EN", "How are you?"),
    ("en2", "frank", "EN", "Good morning."),
    ("en3", "frank", "EN", "See you later."),
    ("en4", "erin", "EN", "Thank you."),
]


def write_raw_corpus(root: Path, rows=ROWS, seed=0):
    """data/<name>/esd.list and raw/*.wav: even rows at 22.05 kHz stereo
    PCM16, odd rows at 48 kHz mono float32, 0.2-0.4 s each; esd.list holds
    one row twice and one row without audio."""
    raw = root / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i, (name, spk, lang, txt) in enumerate(rows):
        if i % 2 == 0:
            n = int(22050 * (0.2 + 0.2 * rng.random()))
            wav = (rng.normal(size=(n, 2)) * 3000).astype(np.int16)
            wavfile.write(raw / f"{name}.wav", 22050, wav)
        else:
            n = int(48000 * (0.2 + 0.2 * rng.random()))
            wavfile.write(raw / f"{name}.wav", 48000,
                          (0.1 * rng.normal(size=n)).astype(np.float32))
        lines.append(f"{name}.wav|{spk}|{lang}|{txt}")
    lines += [lines[0], "missing.wav|alice|ZH|没有音频。"]
    (root / "esd.list").write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The raw corpus prepared by each package's wizard, every step, in
    roots of their own -> (JAX data root, port data root, step messages)."""
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = tmp_path_factory.mktemp(pkg) / "data"
        write_raw_corpus(roots[pkg] / "demo")
    msgs = {}
    for pkg, wz in (("jax", jax_wizard), ("port", wizard)):
        root = str(roots[pkg])
        msgs[pkg] = [
            wz.generate_config("demo", batch_size=4, data_root=root),
            wz.resample("demo", processes=1, data_root=root),
            wz.preprocess_text_step("demo", data_root=root),
            wz.bert_gen_step("demo", data_root=root),
            wz.spec_gen_step("demo", data_root=root),
        ]
    return roots["jax"], roots["port"], msgs


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def test_wizard_steps_match_jax(prepared):
    jax_root, port_root, msgs = prepared
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"][1] == "resampled 15/15 files"
    assert msgs["port"][2] == "labels processed (6 speakers)"
    assert msgs["port"][3] == "cached 15 BERT feature files"
    want, got = _files(jax_root), _files(port_root)
    assert set(got) == set(want)
    kinds = {".wav": 0, ".bert.npy": 0, ".spec.npy": 0, "text": 0}
    for rel, path in got.items():
        if rel.endswith(".spec.npy"):
            a, b = np.load(path), np.load(want[rel])
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-6, rel
            kinds[".spec.npy"] += 1
        elif rel.endswith(".bert.npy"):
            assert np.array_equal(np.load(path), np.load(want[rel])), rel
            kinds[".bert.npy"] += 1
        elif rel.endswith(".wav"):
            assert path.read_bytes() == want[rel].read_bytes(), rel
            kinds[".wav"] += rel.startswith("demo/wavs/")
        else:  # esd.list, its .cleaned copy, train/val lists, config.json
            swapped = path.read_text(encoding="utf-8").replace(str(port_root), str(jax_root))
            assert swapped == want[rel].read_text(encoding="utf-8"), rel
            kinds["text"] += 1
    assert kinds == {".wav": 15, ".bert.npy": 15, ".spec.npy": 15, "text": 5}

    # what the steps made: 44.1 kHz mono PCM16, a config with six speakers,
    # a 12 / 3 split, and caches in the JAX package's layouts
    demo = port_root / "demo"
    sr, wav = wavfile.read(demo / "wavs" / "zh0.wav")
    assert sr == 44100 and wav.ndim == 1 and wav.dtype == np.int16
    cfg = json.loads((demo / "configs" / "config.json").read_text(encoding="utf-8"))
    assert cfg["train"]["batch_size"] == 4 and cfg["version"] == "2.3"
    assert cfg["data"]["spk2id"] == {"alice": 0, "bob": 1, "carol": 2, "dave": 3,
                                     "erin": 4, "frank": 5}
    train = (demo / "train.list").read_text(encoding="utf-8").splitlines()
    val = (demo / "val.list").read_text(encoding="utf-8").splitlines()
    assert (len(train), len(val)) == (3, 12) and not set(train) & set(val)
    row = train[0].split("|")
    n_ph = len(row[4].split(" "))
    assert np.load(row[0].replace(".wav", ".bert.npy")).shape == (2 * n_ph + 1, 1024)
    frames = 1 + (len(wavfile.read(row[0])[1]) + 2 * 768 - 2048) // 512
    assert np.load(row[0].replace(".wav", ".spec.npy")).shape == (frames, 1025)


def test_preprocess_text_split_matches_jax(prepared, tmp_path):
    """`preprocess_text` from an existing cleaned list (clean=False), at
    another split, into other paths: the same lists and config.json."""
    jax_root, port_root, _ = prepared
    cleaned = str(port_root / "demo" / "esd.list.cleaned")
    out = {}
    for name, fn in (("jax", jax_text.preprocess_text), ("port", text.preprocess_text)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(port_root / "demo" / "configs" / "config.json", d / "config.json")
        spk2id = fn(cleaned, cleaned, str(d / "tr.list"), str(d / "va.list"),
                    str(d / "config.json"), val_per_lang=2, max_val_total=5, clean=False)
        out[name] = [spk2id] + [(d / f).read_text(encoding="utf-8").replace(str(d), "D")
                                for f in ("tr.list", "va.list", "config.json")]
    assert out["port"] == out["jax"]
    assert len(out["port"][2].splitlines()) == 5


class StubExtractor:
    """A seeded vector per reference audio, in place of wav2vec2 / CLAP."""

    def __init__(self, device="cpu", dim=1024):
        self.dim = dim

    def __call__(self, reference_audio=None, prompt=None):
        seed = sum(Path(reference_audio).name.encode())
        return np.random.default_rng(seed).normal(size=self.dim).astype(np.float32)


@pytest.mark.parametrize("mode", ["wav2vec2", "clap"])
def test_emo_gen_matches_jax(prepared, monkeypatch, mode):
    """`emo_gen` writes the same `.emo.npy` caches as the JAX package's,
    both packages' extractors replaced by one stub."""
    jax_root, port_root, _ = prepared
    dim = 1024 if mode == "wav2vec2" else 512
    cls = "Wav2Vec2EmotionExtractor" if mode == "wav2vec2" else "ClapFeatureExtractor"
    for mod in (jax_emotion, emotion):
        monkeypatch.setattr(mod, cls, lambda device, dim=dim: StubExtractor(device, dim))
    jax_emo_gen.emo_gen(str(jax_root / "demo" / "train.list"), mode=mode)
    emo_gen.emo_gen(str(port_root / "demo" / "train.list"), mode=mode, device="cpu")
    caches = sorted((port_root / "demo" / "wavs").glob("*.emo.npy"))
    assert len(caches) == 3
    for path in caches:
        other = jax_root / "demo" / "wavs" / path.name
        got = np.load(path)
        assert got.shape == (dim,) and np.array_equal(got, np.load(other))
        path.unlink()
        other.unlink()


def test_map_jobs_fails_when_a_worker_dies():
    """The spawned pool maps in order, and a worker that dies raises
    instead of leaving the map waiting; one process maps in this one."""
    from concurrent.futures.process import BrokenProcessPool

    assert map_jobs(abs, [-3, 2, -1], 2) == map_jobs(abs, [-3, 2, -1], 1) == [3, 2, 1]
    with pytest.raises(BrokenProcessPool):
        map_jobs(os._exit, [3], 2)


def test_wizard_serve_page(tmp_path):
    """The `--serve` page answers one GET on a free port, and its step API
    runs a step."""
    server = wizard.make_server(0, str(tmp_path), host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            page = r.read().decode()
        assert r.status == 200 and "Dataset preprocessing" in page
        with urllib.request.urlopen(base + "/api/step?name=config&dataset=other"
                                    "&batch_size=2", timeout=10) as r:
            assert r.read().decode() == "config file written"
        cfg = json.loads((tmp_path / "other" / "configs" / "config.json").read_text())
        assert cfg["train"]["batch_size"] == 2
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def test_model_clis_default_to_the_card(prepared, monkeypatch):
    """`bert_gen` and `emo_gen` run their models on --device, the card
    unless told otherwise: without one they refuse, and so does the
    `emo_gen` function called without a device; `bert_gen` without
    `--random` and without local BERT weights refuses too."""
    config = str(prepared[1] / "demo" / "configs" / "config.json")
    for mod in (bert_gen, emo_gen):
        monkeypatch.setattr(sys, "argv", ["prog", "-c", config])
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main()
    with pytest.raises(RuntimeError, match="cuda"):
        emo_gen.emo_gen(str(prepared[1] / "demo" / "train.list"), mode="clap")
    monkeypatch.setattr(sys, "argv", ["prog", "-c", config, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="allow_noise=False"):
        bert_gen.main()
