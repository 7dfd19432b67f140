"""PyTorch port, native batch loader (`bert_vits2_tpu_torch/native/`) and
the fast batch path `data/dataset.py:load_collated_batch(loader=)`, held
against the JAX package's loader and batch path on files this test writes:
every array equal, bit for bit. The numpy fallback (no g++) gives the same
batch on the 44.1 kHz mono PCM16 files that `preprocess/resample.py`
writes; on multichannel files the native loader averages in its own order
(within 1e-6 of `load_wav`, as the JAX package's test bounds it)."""

import logging
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from bert_vits2_tpu import native as jax_native
from bert_vits2_tpu.data.dataset import FilelistDataset as JaxFilelistDataset
from bert_vits2_tpu.data.dataset import load_collated_batch as jax_load_collated_batch
from bert_vits2_tpu_torch import native
from bert_vits2_tpu_torch.data.dataset import (
    FilelistDataset,
    load_collated_batch,
    load_wav,
)
from bert_vits2_tpu_torch.train.trainer import Trainer
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
SPK2ID = {"spk0": 0, "spk1": 1}
DS_KW = dict(sampling_rate=44100, filter_length=512, hop_length=128, win_length=512)


@pytest.fixture(scope="module")
def loaders():
    """The port's and the JAX package's loaders (both built with g++)."""
    assert native.available() and jax_native.available()
    ours, theirs = native.BatchLoader(2), jax_native.BatchLoader(2)
    yield ours, theirs
    ours.close()
    theirs.close()


def _both(loaders, method, paths, shape):
    """The method on both loaders into fresh buffers (filled with garbage
    first: every element must be written) -> ((dst, *meta) ours, theirs)."""
    out = []
    for ld in loaders:
        dst = np.full(shape, np.nan, np.float32)
        meta = getattr(ld, method)(paths, dst)
        out.append((dst, *meta))
    for a, b in zip(*out):
        assert np.array_equal(a, b, equal_nan=True)
    return out[0]


def test_source_is_the_original_and_builds_by_hash():
    """Everything from the first #include on is the JAX package's source;
    the library lands in build/ under a hash of the source."""
    ours = native.SRC.read_text()
    theirs = (REPO / "bert_vits2_tpu" / "native" / "dataloader.cc").read_text()
    cut = "#include <atomic>"
    assert ours[ours.index(cut):] == theirs[theirs.index(cut):]
    assert native.available()
    path = native.lib_path()
    assert path.parent == REPO / "build" and path.name.startswith("dataloader-")
    assert path.is_file()


@pytest.mark.parametrize("case", ["round_trip", "truncate_and_pad", "missing", "dtype"])
def test_npy(loaders, tmp_path, case):
    rng = np.random.default_rng(1)
    a = [rng.normal(size=(3 + i, 2)).astype(np.float32) for i in range(3)]
    paths = []
    for i, x in enumerate(a):
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], x)
    if case == "round_trip":
        dst, rows, cols = _both(loaders, "load_npy_into", paths, (3, 5, 2))
        assert list(rows) == [3, 4, 5] and list(cols) == [2, 2, 2]
        for i, x in enumerate(a):
            assert np.array_equal(dst[i, :len(x)], x) and (dst[i, len(x):] == 0).all()
    elif case == "truncate_and_pad":
        dst, rows, _ = _both(loaders, "load_npy_into", paths[2:], (1, 2, 2))
        assert rows[0] == 5 and np.array_equal(dst[0], a[2][:2])
        dst, rows, _ = _both(loaders, "load_npy_into", paths[:1], (1, 8, 2))
        assert np.array_equal(dst[0, :3], a[0]) and (dst[0, 3:] == 0).all()
    elif case == "missing":
        dst, rows, cols = _both(loaders, "load_npy_into",
                                [str(tmp_path / "nope.npy"), paths[0]], (2, 3, 2))
        assert list(rows) == [-1, 3] and cols[0] == -1 and (dst[0] == 0).all()
    else:
        np.save(paths[0], a[0].astype(np.float64))
        dst, rows, _ = _both(loaders, "load_npy_into", paths[:1], (1, 3, 2))
        assert rows[0] == -1 and (dst[0] == 0).all()


@pytest.mark.parametrize("kind", ["pcm16_stereo", "pcm16_mono", "pcm32", "float32_mono"])
def test_wav(loaders, tmp_path, kind):
    rng = np.random.default_rng(2)
    sr = 22050 if kind == "float32_mono" else 44100
    sig = {"pcm16_stereo": (rng.normal(size=(64, 2)) * 8000).astype(np.int16),
           "pcm16_mono": (rng.normal(size=64) * 8000).astype(np.int16),
           "pcm32": (rng.normal(size=64) * 2e8).astype(np.int32),
           "float32_mono": np.linspace(-1, 1, 64).astype(np.float32)}[kind]
    p = str(tmp_path / "s.wav")
    wavfile.write(p, sr, sig)
    dst, lens, srs = _both(loaders, "load_wav_into", [p, str(tmp_path / "no.wav")],
                           (2, 80))
    assert list(lens) == [64, -1] and list(srs) == [sr, -1]
    ref, ref_sr = load_wav(p)
    assert ref_sr == sr and (dst[0, 64:] == 0).all() and (dst[1] == 0).all()
    if kind == "pcm16_stereo":
        assert np.abs(dst[0, :64] - ref).max() <= 1e-6
    else:
        assert np.array_equal(dst[0, :64], ref)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five 44.1 kHz mono PCM16 utterances (two longer than the batch's
    frames), ZH / JP / EN, with spec and BERT caches; item 3's BERT cache
    is in the reference's [1024, t] layout (the loader's rows do not match:
    reread itemwise), and item 4 has no spec cache (listed in a filelist of
    its own)."""
    root = tmp_path_factory.mktemp("native_corpus")
    rng = np.random.default_rng(0)
    rows = []
    langs = ("ZH", "JP", "EN", "ZH", "EN")
    phones = {"ZH": "a i", "JP": "k a", "EN": "ah b"}
    for i, lang in enumerate(langs):
        p = str(root / f"u{i}.wav")
        wavfile.write(p, 44100, (rng.normal(size=9000 + 4000 * i) * 6000).astype(np.int16))
        audio, _ = load_wav(p)
        if i != 4:
            from bert_vits2_tpu_torch.data.dataset import compute_spec

            np.save(p.replace(".wav", ".spec.npy"), compute_spec(audio, 512, 128, 512))
        bert = rng.normal(size=(5, 1024)).astype(np.float32)
        np.save(p.replace(".wav", ".bert.npy"), bert.T.copy() if i == 3 else bert)
        rows.append(f"{p}|spk{i % 2}|{lang}|text|{phones[lang]}|0 1|1 1")
    (root / "train.list").write_text("\n".join(rows[:4]) + "\n", encoding="utf-8")
    (root / "nospec.list").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return root


@pytest.mark.parametrize("filelist", ["train.list", "nospec.list"])
def test_load_collated_batch_matches_jax(loaders, corpus, filelist):
    """The port's batch with its loader and with numpy, and the JAX
    package's with its loader: every array equal (caches never written:
    use_cache off)."""
    path = str(corpus / filelist)
    ours = FilelistDataset(path, SPK2ID, use_cache=False, **DS_KW)
    theirs = JaxFilelistDataset(path, SPK2ID, use_cache=False, **DS_KW)
    ids = list(range(len(ours)))[::-1]
    want = jax_load_collated_batch(theirs, ids, 128, loader=loaders[1])
    for loader in (loaders[0], None):
        got = load_collated_batch(ours, ids, 128, loader=loader)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # truncated and padded rows both
    assert want["spec_lengths"].min() < 128 == want["spec_lengths"].max()


def test_sample_rate_check(loaders, corpus, tmp_path):
    """A wav at another rate than the config's raises on both paths."""
    ds = FilelistDataset(str(corpus / "train.list"), SPK2ID,
                         **dict(DS_KW, sampling_rate=22050))
    for loader in (loaders[0], None):
        with pytest.raises(ValueError, match="resample first"):
            load_collated_batch(ds, [0], 64, loader=loader)


def test_numpy_fallback_when_unavailable(monkeypatch, corpus, caplog):
    """With no library (no g++ or a failed build), `available()` is false,
    `BatchLoader` raises, the Trainer's `native_loader` is None and says
    so, and the batch loads with numpy; with it, the Trainer holds one
    loader until `close`."""
    trainer = type("T", (), {"logger": logging.getLogger("bert_vits2_tpu_torch")})()
    with caplog.at_level(logging.INFO, logger="bert_vits2_tpu_torch"):
        assert isinstance(Trainer.native_loader.fget(trainer), native.BatchLoader)
        assert Trainer.native_loader.fget(trainer) is trainer._native_loader
        Trainer.close(trainer)
        assert not hasattr(trainer, "_native_loader")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        assert not native.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            native.BatchLoader()
        assert Trainer.native_loader.fget(trainer) is None
    assert [r.getMessage() for r in caplog.records] == [
        "native batch loader active",
        "native batch loader unavailable (no g++?): batches load with numpy"]
    ds = FilelistDataset(str(corpus / "train.list"), SPK2ID, use_cache=False, **DS_KW)
    batch = load_collated_batch(ds, [0, 1], 64, loader=Trainer.native_loader.fget(trainer))
    assert batch["spec"].shape == (2, 64, 257) and batch["spec_lengths"].min() > 0
