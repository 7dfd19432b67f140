"""PyTorch port, the training entry point: the data pipeline, the config
reader and the checkpoints against the JAX package, and the port's
`Trainer` and CLI on the CPU.

Corpus: 4 synthetic utterances (int16 wavs at 1.6 kHz from a numpy seed,
cached BERT features, a cleaned filelist in the format of
tests/test_trainer.py) in three languages, and the tiny training config of
tests/test_torch_train_modules.py (hop 16, 16-d BERT features, 3 encoder
layers and 2 flow couplings of 3: the speaker conditioning before layer 2
then runs, so a strict import finds its parameters on both sides), with
the multi-period discriminator at its test size. Integer arrays must match
the JAX package exactly; spectrograms to 1e-5 (the same numpy DFT with a
float32 window; values O(1)).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from bert_vits2_tpu.compat import hparams as jax_hparams
from bert_vits2_tpu.compat.torch_import import (
    import_dur_disc_checkpoint,
    import_generator_checkpoint,
    import_mpd_checkpoint,
)
from bert_vits2_tpu.data import BucketSampler as JaxBucketSampler
from bert_vits2_tpu.data import FilelistDataset as JaxFilelistDataset
from bert_vits2_tpu.data import collate_batch as jax_collate_batch
from bert_vits2_tpu.data.dataset import load_collated_batch as jax_load_collated_batch
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.text import cleaned_text_to_sequence as jax_text_to_sequence
from bert_vits2_tpu.text import symbols as jax_symbols
from bert_vits2_tpu.train.trainer import (
    train_config_from_hparams as jax_train_config_from_hparams,
)
from bert_vits2_tpu_torch.compat import hparams
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.compat.params import (
    from_jax_dur_disc_params,
    from_jax_mpd_params,
    from_jax_params,
)
from bert_vits2_tpu_torch.data import (
    BucketSampler,
    FilelistDataset,
    collate_batch,
    load_collated_batch,
)
from bert_vits2_tpu_torch.models.discriminators import (
    DurationDiscriminator,
    MultiPeriodDiscriminator,
    WavLMDiscriminator,
)
from bert_vits2_tpu_torch.models.slm import WavLM, WavLMConfig
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
from bert_vits2_tpu_torch.text import cleaned_text_to_sequence
from bert_vits2_tpu_torch.text import symbols
from bert_vits2_tpu_torch.train import Models
from bert_vits2_tpu_torch.train.__main__ import main
from bert_vits2_tpu_torch.train.step import expand_bert
from bert_vits2_tpu_torch.train import trainer as trainer_mod
from bert_vits2_tpu_torch.train.trainer import Trainer, train_config_from_hparams
from test_torch_modules import random_synth_params
from test_torch_train_modules import DD, MPD, TINY, build_discriminators
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SR, HOP, N_FFT, BERT_DIM = 1600, 16, 64, 16
LANGS = ("ZH", "JP", "EN", "ZH")
PHONES = ["a", "ai", "an", "ao", "b", "E"]  # symbol ids below TINY's n_vocab
# the model section: the training modules' tiny config (its spectrogram
# width, segment and speaker count come from the data and train sections)
TINY_MODEL_JSON = {k: json.loads(json.dumps(v)) for k, v in TINY.items()
                   if k not in ("spec_channels", "segment_size", "n_speakers")}


class _Writer:
    """Stands in for TensorBoard's SummaryWriter (importing it also imports
    TensorFlow where that is installed, ~10 s) and records what the
    trainer logs."""

    def __init__(self, log_dir):
        self.log_dir, self.logged = log_dir, []

    def add_scalar(self, tag, value, step):
        self.logged.append(("scalar", tag, step))

    def add_image(self, tag, image, step, dataformats):
        self.logged.append(("image", tag, step))

    def add_audio(self, tag, audio, step, sampling_rate):
        self.logged.append(("audio", tag, step))


@pytest.fixture(scope="module", autouse=True)
def _writer():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "make_writer", _Writer)
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, config path): 4 utterances, a filelist, a tiny config.json."""
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    rows = []
    for i, lang in enumerate(LANGS):
        wav_path = str(root / f"utt{i}.wav")
        phones = PHONES[: 4 + i % 3]
        audio = (rng.uniform(-0.3, 0.3, SR + 256 * i) * 32767).astype(np.int16)
        wavfile.write(wav_path, SR, audio)
        np.save(wav_path.replace(".wav", ".bert.npy"),
                rng.normal(size=(2 * len(phones) + 1, BERT_DIM)).astype(np.float32))
        tones = " ".join(str(t % 2) for t in range(len(phones)))
        rows.append(f"{wav_path}|spk{i % 2}|{lang}|text|{' '.join(phones)}|"
                    f"{tones}|{len(phones)}")
    filelist = root / "train.list"
    filelist.write_text("\n".join(rows), encoding="utf-8")
    config = dict(
        version="2.3",
        train=dict(log_interval=1, eval_interval=1000, seed=7, epochs=2,
                   learning_rate=1e-4, betas=[0.8, 0.99], eps=1e-9,
                   batch_size=2, bf16_run=False, lr_decay=0.999,
                   segment_size=8 * HOP, c_mel=45, c_kl=1.0),
        data=dict(training_files=str(filelist), validation_files=str(filelist),
                  sampling_rate=SR, filter_length=N_FFT, hop_length=HOP,
                  win_length=N_FFT, n_mel_channels=16, mel_fmin=0.0,
                  mel_fmax=None, add_blank=True, n_speakers=4,
                  spk2id=dict(spk0=0, spk1=1)),
        model=TINY_MODEL_JSON,
    )
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(config), encoding="utf-8")
    return root, str(cfg_path)


def _datasets(cfg_path):
    hps = jax_hparams.get_hparams_from_file(cfg_path)
    d = hps.data
    kw = dict(spk2id=d.spk2id.to_dict(), sampling_rate=SR, filter_length=N_FFT,
              hop_length=HOP, win_length=N_FFT, bert_dim=BERT_DIM,
              use_cache=False)
    return (FilelistDataset(d.training_files, **kw),
            JaxFilelistDataset(d.training_files, **kw))


def _assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        if key == "spec":
            assert np.abs(got[key] - want[key]).max() <= 1e-5
        else:
            assert np.array_equal(got[key], want[key]), key


def test_symbols_and_sequences_match_jax():
    """The port's copy of the symbol inventory and the phone/tone/language
    mapping equal the JAX package's."""
    for name in ("SYMBOLS", "SYMBOL_TO_ID", "PUNCTUATION", "NUM_TONES",
                 "NUM_LANGUAGES", "LANGUAGE_ID_MAP", "LANGUAGE_TONE_START_MAP"):
        assert getattr(symbols, name) == getattr(jax_symbols, name), name
    for lang in ("ZH", "JP", "EN"):
        args = (["n", "i", "SP", "a", "UNK"], [0, 1, 0, 1, 0], lang)
        assert cleaned_text_to_sequence(*args) == jax_text_to_sequence(*args)


def test_dataset_items_match_jax(corpus):
    ours, theirs = _datasets(corpus[1])
    assert len(ours) == len(theirs) == 4
    assert ours.lengths() == theirs.lengths()
    for i in range(len(ours)):
        _assert_batches_equal(ours[i], theirs[i])


@pytest.mark.parametrize("batch_size,num_replicas,rank", [(2, 1, 0), (3, 2, 1)])
def test_bucket_sampler_matches_jax(batch_size, num_replicas, rank):
    lengths = [20, 350, 310, 480, 45, 999, 1500, 5, 320, 410, 33]
    kw = dict(batch_size=batch_size, num_replicas=num_replicas, rank=rank, seed=3)
    ours, theirs = BucketSampler(lengths, **kw), JaxBucketSampler(lengths, **kw)
    assert len(ours) == len(theirs) and ours.boundaries == theirs.boundaries
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)
    assert ours.bucket_max_frames(0) == theirs.bucket_max_frames(0)


def test_collate_and_fast_batch_match_jax(corpus):
    """collate_batch of dataset items, and load_collated_batch (the active
    language's BERT and utt_lang), equal the JAX package's."""
    ours, theirs = _datasets(corpus[1])
    ids = [2, 0, 3]
    _assert_batches_equal(collate_batch([ours[i] for i in ids], 128, hop_length=HOP),
                          jax_collate_batch([theirs[i] for i in ids], 128,
                                            hop_length=HOP))
    _assert_batches_equal(load_collated_batch(ours, ids, 128),
                          jax_load_collated_batch(theirs, ids, 128))


def test_expand_bert_places_the_active_language():
    """Fast batches: each item's active language keeps its features, the
    other two get N(0,1) draws of the step's generator."""
    bert = torch.randn(3, 5, 4)
    batch = {"bert": bert, "utt_lang": torch.tensor([0, 1, 2])}
    out = expand_bert(batch, torch.Generator().manual_seed(1))
    again = expand_bert(batch, torch.Generator().manual_seed(1))
    for lang, key in enumerate(("bert", "ja_bert", "en_bert")):
        assert torch.equal(out[key][lang], bert[lang])
        others = [i for i in range(3) if i != lang]
        assert not torch.equal(out[key][others], bert[others])
        assert torch.equal(out[key], again[key])
    assert expand_bert({"bert": bert}, None) == {"bert": bert}


def test_hparams_match_jax(corpus):
    path = corpus[1]
    ours, theirs = hparams.get_hparams_from_file(path), \
        jax_hparams.get_hparams_from_file(path)
    assert ours.to_dict() == theirs.to_dict()
    assert hparams.model_config_from_hparams(ours) == ModelConfig(**TINY)
    for fn in ("model_config_from_hparams", "data_config_from_hparams"):
        a, b = getattr(hparams, fn)(ours), getattr(jax_hparams, fn)(theirs)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), fn
    a = dataclasses.asdict(train_config_from_hparams(ours))
    b = dataclasses.asdict(jax_train_config_from_hparams(theirs))
    assert a == b


def _tiny_models(cfg_path, seed=0):
    mcfg = hparams.model_config_from_hparams(hparams.get_hparams_from_file(cfg_path))
    torch.manual_seed(seed)
    return Models(Synthesizer(mcfg), MultiPeriodDiscriminator(**MPD),
                  DurationDiscriminator(**DD), None)


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """A Trainer on the CPU that ran 2 steps (and saved at step 2)."""
    model_dir = str(tmp_path_factory.mktemp("run"))
    trainer = Trainer(corpus[1], model_dir, models=_tiny_models(corpus[1]),
                      slm_path=None, device="cpu")
    before = {k: v.clone() for k, v in trainer.models.synthesizer.state_dict().items()}
    trainer.run(epochs=10, max_steps=2, log_interval=1, eval_interval=1000)
    return trainer, before


def test_trainer_runs_and_saves_reference_layout(trained):
    trainer, before = trained
    assert trainer.global_step == trainer.state.step == 2
    assert sorted(os.listdir(trainer.ckpt_dir)) == ["DUR_2.pth", "D_2.pth", "G_2.pth"]
    ck = torch.load(os.path.join(trainer.ckpt_dir, "G_2.pth"), weights_only=True)
    assert set(ck) == {"model", "iteration", "optimizer", "learning_rate"}
    assert ck["iteration"] == 2 and ck["learning_rate"] == pytest.approx(1e-4)
    after = trainer.models.synthesizer.state_dict()
    moved = sum(not torch.equal(before[k], after[k]) for k in before)
    assert moved > 0.9 * len(before)
    for k, v in after.items():
        assert torch.equal(ck["model"][k], v), k
    assert {("scalar", "loss/g/total", 1), ("scalar", "loss/g/total", 2),
            ("scalar", "steps_per_sec", 2)} <= set(trainer.writer.logged)


def test_second_trainer_resumes(trained, corpus):
    trainer, _ = trained
    again = Trainer(corpus[1], trainer.model_dir, models=_tiny_models(corpus[1], 5),
                    slm_path=None, device="cpu")
    assert again.global_step == again.state.step == 2
    for module, other in zip(trainer.models[:3], again.models[:3]):
        for (k, a), b in zip(module.state_dict().items(), other.state_dict().values()):
            assert torch.equal(a, b), k
    s0, s1 = trainer.state.opt_g.state_dict(), again.state.opt_g.state_dict()
    for i, st in s0["state"].items():
        assert torch.equal(st["exp_avg"], s1["state"][i]["exp_avg"])
    again.run(epochs=10, max_steps=3, log_interval=1, eval_interval=1000)
    assert again.global_step == 3


def test_checkpoint_loads_into_the_jax_importers(trained, corpus):
    """G_/D_/DUR_2.pth, written by the port, load into the JAX package's
    importers with strict=True and give the port's parameters back (the
    duration discriminator's LSTM biases as their sum: the JAX cell keeps
    one bias where torch keeps two)."""
    trainer, _ = trained
    hps = jax_hparams.get_hparams_from_file(corpus[1])
    template = random_synth_params(
        JaxSynthesizer(jax_hparams.model_config_from_hparams(hps)), seed=0,
        bert_dim=BERT_DIM)
    (_, p_d, _), (_, p_dd, _) = build_discriminators(seed=1)
    ck = trainer.ckpt_dir
    g, it, _ = import_generator_checkpoint(os.path.join(ck, "G_2.pth"), template,
                                           strict=True)
    d, _, _ = import_mpd_checkpoint(os.path.join(ck, "D_2.pth"), p_d,
                                    periods=MPD["periods"], strict=True)
    dd, _, _ = import_dur_disc_checkpoint(os.path.join(ck, "DUR_2.pth"), p_dd,
                                          strict=True)
    assert it == 2
    for module, sd in zip(trainer.models[:3], (
            from_jax_params(g), from_jax_mpd_params(d, MPD["periods"]),
            from_jax_dur_disc_params(dd))):
        own = module.state_dict()
        assert set(sd) == set(own)
        for k, v in sd.items():
            if ".bias_ih_" in k:  # the JAX LSTM cell keeps one bias: the sum
                hh = k.replace("_ih_", "_hh_")
                assert torch.allclose(v + sd[hh], own[k] + own[hh], atol=1e-6), k
            elif ".bias_hh_" not in k:
                assert torch.equal(v, own[k]), k


def test_bootstrap_from_reference_files(trained, corpus, tmp_path):
    """Reference-layout files in the model directory (here the port's own,
    with DDP's `module.` prefix added) initialize a fresh run's parameters;
    the run starts at step 0."""
    trainer, _ = trained
    model_dir = tmp_path / "bootstrap"
    model_dir.mkdir()
    for name in ("D_2.pth", "DUR_2.pth"):
        shutil.copy(os.path.join(trainer.ckpt_dir, name), model_dir / name)
    g = torch.load(os.path.join(trainer.ckpt_dir, "G_2.pth"), weights_only=True)
    g["model"] = {f"module.{k}": v for k, v in g["model"].items()}
    torch.save(g, model_dir / "G_2.pth")
    fresh = Trainer(corpus[1], str(model_dir), models=_tiny_models(corpus[1], 9),
                    slm_path=None, device="cpu")
    assert fresh.global_step == 0
    for module, other in zip(trainer.models[:3], fresh.models[:3]):
        for (k, a), b in zip(module.state_dict().items(), other.state_dict().values()):
            assert torch.equal(a, b), k


def test_keep_prunes_old_checkpoints_and_evaluate_runs(corpus, tmp_path):
    trainer = Trainer(corpus[1], str(tmp_path / "keep"),
                      models=_tiny_models(corpus[1]), slm_path=None, device="cpu")
    trainer.run(epochs=10, max_steps=3, log_interval=1, eval_interval=1,
                keep_ckpts=2)
    assert sorted(os.listdir(trainer.ckpt_dir)) == [
        "DUR_2.pth", "DUR_3.pth", "D_2.pth", "D_3.pth", "G_2.pth", "G_3.pth"]
    # evaluate(): each validation item with the SDP and the DP, at each step
    logged = set(trainer.eval_writer.logged)
    assert {("audio", "gen/audio_1_sdp", 3), ("image", "gen/attn_0_dp", 3),
            ("audio", "gt/audio_0", 1)} <= logged


def test_non_finite_metric_raises_before_any_save(corpus, tmp_path):
    trainer = Trainer(corpus[1], str(tmp_path / "nan"),
                      models=_tiny_models(corpus[1]), slm_path=None, device="cpu")
    step = trainer.step_fn

    def poisoned(state, batch, generator, lr):
        state, metrics = step(state, batch, generator, lr)
        return state, {**metrics, "loss/g/total": torch.tensor(float("nan"))}

    trainer.step_fn = poisoned
    with pytest.raises(FloatingPointError, match="loss/g/total"):
        trainer.run(epochs=10, max_steps=5, log_interval=1, eval_interval=1)
    assert not os.path.isdir(trainer.ckpt_dir)


def _slm_config(corpus, tmp_path, write_wavlm=True):
    """The corpus config with a model.slm section whose model directory
    holds a tiny random WavLM in the HF layout (config.json in HF keys,
    pytorch_model.bin), written by the port's own WavLM."""
    _, cfg_path = corpus
    cfg = json.loads(open(cfg_path, encoding="utf-8").read())
    wavlm_dir = tmp_path / "wavlm"
    wl_cfg = WavLMConfig(hidden_size=16, num_layers=2, num_heads=2,
                         intermediate_size=32, conv_dim=(8, 8),
                         conv_kernel=(10, 3), conv_stride=(5, 2),
                         num_conv_pos_embeddings=8,
                         num_conv_pos_embedding_groups=2, num_buckets=16,
                         max_bucket_distance=40)
    cfg["model"]["slm"] = dict(model=str(wavlm_dir), sr=16000, hidden=16,
                               nlayers=3, initial_channel=4)
    if write_wavlm:
        wavlm_dir.mkdir()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            wavlm = WavLM(wl_cfg)
        (wavlm_dir / "config.json").write_text(json.dumps(wl_cfg.to_hf()))
        torch.save(wavlm.state_dict(), wavlm_dir / "pytorch_model.bin")
    path = tmp_path / "config_slm.json"
    path.write_text(json.dumps(cfg), encoding="utf-8")
    return str(path)


def test_slm_and_parallel_rules(corpus, tmp_path):
    """A declared but missing WavLM dir raises FileNotFoundError, a present
    one loads and turns the SLM losses on (the WavLM discriminator at
    model.slm's widths beside the other models, the frozen WavLM on the
    Trainer); model parallelism raises, through the CLI with --multihost
    too (that flag joins torchrun's process group, a no-op in one process;
    ROADMAP §A.9)."""
    _, cfg_path = corpus
    cfg_slm = _slm_config(corpus, tmp_path, write_wavlm=False)
    with pytest.raises(FileNotFoundError, match="slm"):
        Trainer(cfg_slm, str(tmp_path / "a"), device="cpu")
    cfg_slm = _slm_config(corpus, tmp_path)
    trainer = Trainer(cfg_slm, str(tmp_path / "b"), device="cpu")
    assert isinstance(trainer.models.wavlm_disc, WavLMDiscriminator)
    assert trainer.slm.wavlm.cfg.num_layers == 2 and not trainer.slm.training
    assert trainer.state.opt_wd is not None
    assert Trainer(cfg_slm, str(tmp_path / "c"), slm_path=None,
                   device="cpu").models.wavlm_disc is None
    with pytest.raises(ValueError, match="WavLM"):
        Trainer(cfg_path, str(tmp_path / "d"), use_wavlm_disc=True,
                slm_path=None, device="cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        Trainer(cfg_path, str(tmp_path / "e"), n_model=2, slm_path=None,
                device="cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        main(["-c", cfg_path, "-m", str(tmp_path / "f"), "--multihost",
              "--n-model", "2", "--device", "cpu"])


def test_cli_trains_with_the_slm_and_resumes(corpus, tmp_path):
    """`python -m bert_vits2_tpu_torch.train` on a config that declares
    model.slm, with no flag: one step with the SLM losses writes WD_1.pth
    beside G_/D_/DUR_1.pth (never the frozen WavLM), and a second run
    resumes from it, the WavLM discriminator and its optimizer included."""
    cfg_slm = _slm_config(corpus, tmp_path)
    model_dir = str(tmp_path / "cli_slm")
    trainer = main(["-c", cfg_slm, "-m", model_dir, "--max-steps", "1",
                    "--device", "cpu"])
    assert trainer.global_step == 1
    assert sorted(os.listdir(trainer.ckpt_dir)) == [
        "DUR_1.pth", "D_1.pth", "G_1.pth", "WD_1.pth"]
    wd = torch.load(os.path.join(trainer.ckpt_dir, "WD_1.pth"), weights_only=True)
    assert set(wd) == {"model", "iteration", "optimizer", "learning_rate"}
    assert wd["model"].keys() == trainer.models.wavlm_disc.state_dict().keys()
    again = main(["-c", cfg_slm, "-m", model_dir, "--max-steps", "2",
                  "--keep-ckpts", "1", "--device", "cpu"])
    assert again.global_step == 2
    assert sorted(os.listdir(again.ckpt_dir)) == [
        "DUR_2.pth", "D_2.pth", "G_2.pth", "WD_2.pth"]
    for k, v in wd["optimizer"]["state"].items():  # resumed, then stepped
        assert again.state.opt_wd.state_dict()["state"][k]["step"] == v["step"] + 1


def test_cli_trains_the_config_models(corpus, tmp_path):
    """`python -m bert_vits2_tpu_torch.train` with the config's full
    discriminators: one step, then G_/D_/DUR_1.pth."""
    trainer = main(["-c", corpus[1], "-m", str(tmp_path / "cli"), "--no-slm",
                    "--max-steps", "1", "--device", "cpu"])
    assert trainer.global_step == 1
    assert sorted(os.listdir(trainer.ckpt_dir)) == ["DUR_1.pth", "D_1.pth", "G_1.pth"]
    assert len(trainer.models.mpd.discriminators) == 6
