"""PyTorch port, data parallelism over two processes (gloo on the CPU),
mirroring tests/test_distributed.py: the process group from torchrun's
variables, disjoint and complete sampler shards, ranks that agree, the
two-rank step against the one-process step, and checkpoints across
topologies.

Two ranks of tests/torch_distributed_worker.py are spawned once per file,
with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set as
torchrun sets them. Before them, a one-process Trainer of the corpus's
config saves a step-1 checkpoint with a nonzero Adam state; the ranks resume it with the CLI's
--multihost (rank 1 from a model directory without checkpoints, so that it
must take the lead's) and train one step; this process then resumes theirs.

The step parity: the tiny models of tests/test_torch_train_modules.py, a 4-row
batch whose two ranks' rows differ in text and frame lengths (so the global
denominators of the KL and duration losses differ from the local ones) with
the inactive languages' BERT drawn in the step, the module dropouts at 0 and
the attention's hash dropout on (p 0.1, fused training), torch's global
generator seeded per rank (as the Trainer seeds it, so the hash dropout's
shared seeds matter). The one-process side is the port's own step, which
tests/test_torch_train_step.py holds against the JAX step. Bounds: losses and
grad norms within 1e-5 relative, each module's reduced gradient within 1e-5 of
its norm (the ranks sum their halves in another order, and the MAS noise's std
comes from all-reduced sums); between the ranks, equal bits.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert_vits2_tpu_torch.train import trainer as trainer_mod
from bert_vits2_tpu_torch.train.trainer import Trainer
from test_torch_train_modules import DD, MPD, TINY
from test_torch_train_step import DATA
from test_torch_trainer import BERT_DIM, HOP, LANGS, N_FFT, PHONES, SR, TINY_MODEL_JSON
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from torch_distributed_worker import digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")
REL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_corpus(root) -> str:
    """tests/test_torch_trainer.py's corpus (4 utterances, batch 2): the
    config.json path."""
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    rows = []
    for i, lang in enumerate(LANGS):
        wav_path = str(root / f"utt{i}.wav")
        phones = PHONES[: 4 + i % 3]
        wavfile.write(wav_path, SR,
                      (rng.uniform(-0.3, 0.3, SR + 256 * i) * 32767).astype(np.int16))
        np.save(wav_path.replace(".wav", ".bert.npy"),
                rng.normal(size=(2 * len(phones) + 1, BERT_DIM)).astype(np.float32))
        tones = " ".join(str(t % 2) for t in range(len(phones)))
        rows.append(f"{wav_path}|spk{i % 2}|{lang}|text|{' '.join(phones)}|"
                    f"{tones}|{len(phones)}")
    (root / "train.list").write_text("\n".join(rows), encoding="utf-8")
    config = dict(
        version="2.3",
        train=dict(log_interval=1, eval_interval=1000, seed=7, epochs=3,
                   learning_rate=1e-4, batch_size=2, lr_decay=0.999,
                   segment_size=8 * HOP),
        data=dict(training_files=str(root / "train.list"), sampling_rate=SR,
                  filter_length=N_FFT, hop_length=HOP, win_length=N_FFT,
                  n_mel_channels=16, mel_fmin=0.0, mel_fmax=None, add_blank=True,
                  n_speakers=4, spk2id=dict(spk0=0, spk1=1)),
        model=TINY_MODEL_JSON)
    path = root / "config.json"
    path.write_text(json.dumps(config), encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(spec, {rank: (json, npz)})."""
    root = tmp_path_factory.mktemp("dist")
    cfg = _write_corpus(root)
    model_dir = str(root / "run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "make_writer", lambda log_dir: None)
        lead = Trainer(cfg, model_dir, slm_path=None, device="cpu")
        # a resumable step-1 state whose Adam moments are nonzero, set by
        # hand (a step would cost seconds): the ranks must carry it over.
        # The tiny generator's and duration discriminator's only: the MPD
        # has its full width (47 M parameters), and its state stays empty
        gen = torch.Generator().manual_seed(3)
        for opt in (lead.state.opt_g, lead.state.opt_dd):
            for group in opt.param_groups:
                for p in group["params"]:
                    opt.state[p] = {
                        "step": torch.tensor(1.0),
                        "exp_avg": 1e-3 * torch.randn(p.shape, generator=gen),
                        "exp_avg_sq": 1e-6 * torch.rand(p.shape, generator=gen)}
        lead.global_step = lead.state.step = 1
        lead.save()
    spec = dict(config=cfg, model_dir=model_dir, follower_dir=str(root / "follower"),
                tiny=TINY, mpd=MPD, dd=DD, data=DATA)
    spec_path = root / "spec.json"
    spec_path.write_text(json.dumps(spec), encoding="utf-8")
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(spec_path), str(root)],
                                      env=env, cwd=REPO))
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0, "a distributed worker failed"
    finally:
        for p in procs:
            p.kill()
    out = {}
    for rank in range(2):
        with open(root / f"rank{rank}.json") as f:
            out[rank] = (json.load(f), dict(np.load(root / f"rank{rank}.npz")))
    return spec, out


def test_process_group_from_torchruns_variables(ranks):
    """--multihost joined a gloo group of two; each Trainer built a 2-way
    data mesh at its own rank, rank 0 the lead, resumed step 1 and took
    one step."""
    _, out = ranks
    for rank in (0, 1):
        res = out[rank][0]
        assert (res["world"], res["rank"], res["backend"]) == (2, rank, "gloo")
        assert res["trainer"] == [2, rank, rank == 0, 2]


def test_follower_takes_the_leads_resume(ranks):
    """Rank 1 found no checkpoint in its own model directory: it resumed
    the lead's step, parameters and Adam state all the same, so both ranks
    hold one optimizer state after the step, and only the lead saved."""
    spec, out = ranks
    (a, _), (b, _) = out[0], out[1]
    assert a["optimizer_digest"] == b["optimizer_digest"]
    assert a["trainer"][3] == b["trainer"][3] == 2
    follower_ckpt = os.path.join(spec["follower_dir"], "ckpt")
    assert not os.path.isdir(follower_ckpt) or not os.listdir(follower_ckpt)


def test_sampler_shards_disjoint_and_complete(ranks):
    _, out = ranks
    (a, _), (b, _) = out[0], out[1]
    assert a["sampler_batches"] == b["sampler_batches"] > 0
    assert set(a["sampler_ids"]) | set(b["sampler_ids"]) == set(range(50))
    overlap = len([i for i in a["sampler_ids"] if i in set(b["sampler_ids"])])
    assert overlap <= 6  # only the buckets' wrap-around padding repeats


def test_ranks_agree(ranks):
    """Both ranks report the same metrics, gradients and parameters after
    the step, and after the CLI's step."""
    _, out = ranks
    (a, ga), (b, gb) = out[0], out[1]
    assert a["metrics"] == b["metrics"]
    assert a["digest"] == b["digest"]
    assert a["trainer_digest"] == b["trainer_digest"]
    for key in ("dp_g", "dp_d", "dp_dd"):
        assert np.array_equal(ga[key], gb[key])


def test_two_rank_step_equals_one_process_step(ranks):
    """The 2-rank step on halves of unequal lengths equals the one-process
    step on the concatenated batch: losses, grad norms, reduced gradients."""
    _, out = ranks
    res, grads = out[0]
    dp, one = res["metrics"], res["metrics_one"]
    assert set(dp) == set(one)
    for k in dp:
        assert np.isfinite(dp[k])
        assert abs(dp[k] - one[k]) <= REL * max(abs(one[k]), 1e-12), (k, dp[k], one[k])
    for name in ("g", "d", "dd"):
        got, want = grads[f"dp_{name}"], grads[f"one_{name}"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= REL * np.linalg.norm(want), name


def test_checkpoints_cross_topologies(ranks, tmp_path):
    """Step 1 was written by one process and resumed by two ranks; their
    step 2, written by the lead, resumes in one process with the lead's
    parameters."""
    spec, out = ranks
    ckpt = os.path.join(spec["model_dir"], "ckpt")
    assert {"G_1.pth", "G_2.pth", "D_2.pth", "DUR_2.pth"} <= set(os.listdir(ckpt))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "make_writer", lambda log_dir: None)
        again = Trainer(spec["config"], spec["model_dir"], slm_path=None, device="cpu")
    assert again.global_step == 2 and again.n_data == 1
    assert digest([again.models.synthesizer]) == out[0][0]["trainer_digest"]
