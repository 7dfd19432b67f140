"""PyTorch port, the model axis over four processes (gloo on the CPU): a
[2, 2] mesh of data x model ranks, mirroring the JAX package's sharded step
(tests/test_train.py::test_tp_sharded_step_matches, (data=4, model=2)) and
its resume across topologies (::test_resume_across_topology_change).

Four ranks of tests/torch_model_parallel_worker.py are spawned once per
file, with torchrun's variables. Before them, the corpus config's models
(the multi-period discriminator at the tests' small widths, here, in the
ranks' CLI and in the resume) are saved as a one-process step-1 checkpoint
with a nonzero Adam state; the ranks resume it with the CLI's --multihost --n-model 2 (ranks 1-3 from
model directories without checkpoints) and train one step, and this
process resumes their step 2.

The step parity: the tiny models of tests/test_torch_train_modules.py with
every module dropout at 0.1 and the attention's hash dropout on (fused
training), a 4-row batch whose data coordinates' rows differ in lengths,
torch's global generator seeded per rank (no mask may come from it). The
one-process side is the port's own step, which tests/test_torch_train_step.py
holds against the JAX step. Bounds: losses and grad norms within 1e-5
relative; each full gradient within 1e-5 of its module's gradient norm;
the parameters after the step within 1e-5 of each tensor's largest entry
(the attention's key biases, whose gradient is zero up to rounding, within
2 lr: Adam's first update normalizes it).
The units (D.3, D.4, the relative tables) within 1e-6 of the unsharded
module's outputs and gradients (relative to the gradient's largest entry).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert_vits2_tpu_torch.compat.hparams import (
    get_hparams_from_file,
    model_config_from_hparams,
)
from bert_vits2_tpu_torch.train import TrainConfig, init_train_state
from bert_vits2_tpu_torch.train import trainer as trainer_mod
from bert_vits2_tpu_torch.train.checkpoint import save_train_state
from bert_vits2_tpu_torch.train.trainer import Trainer, build_models
from test_torch_distributed import _write_corpus
from test_torch_train_modules import DD, MPD, TINY
from test_torch_train_step import DATA
from torch_model_parallel_worker import opt_digest, sd_digest, tiny_mpd
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_model_parallel_worker.py")
REL = 1e-5
UNIT = 1e-6
LR = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(spec, {rank: (json, npz)})."""
    root = tmp_path_factory.mktemp("model_axis")
    cfg = _write_corpus(root)
    model_dir = str(root / "run")
    # the config's models and a resumable step-1 state with nonzero Adam
    # moments for the generator (set by hand: a step would cost seconds)
    torch.manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "MultiPeriodDiscriminator", tiny_mpd(dict(mpd=MPD)))
        models = build_models(model_config_from_hparams(get_hparams_from_file(cfg)),
                              device="cpu")
    state = init_train_state(models, TrainConfig())
    gen = torch.Generator().manual_seed(3)
    for group in state.opt_g.param_groups:
        for p in group["params"]:
            state.opt_g.state[p] = {"step": torch.tensor(1.0),
                                    "exp_avg": 1e-3 * torch.randn(p.shape, generator=gen),
                                    "exp_avg_sq": 1e-6 * torch.rand(p.shape, generator=gen)}
    save_train_state(os.path.join(model_dir, "ckpt"), 1, models, state, 1e-4)
    spec = dict(config=cfg, model_dir=model_dir, follower_root=str(root / "followers"),
                tiny=TINY, mpd=MPD, dd=DD, data=DATA, lr=LR)
    spec_path = root / "spec.json"
    spec_path.write_text(json.dumps(spec), encoding="utf-8")
    port = str(_free_port())
    procs = []
    for rank in range(4):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(spec_path), str(root)],
                                      env=env, cwd=REPO))
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0, "a model-axis worker failed"
    finally:
        for p in procs:
            p.kill()
    out = {}
    for rank in range(4):
        with open(root / f"rank{rank}.json") as f:
            out[rank] = (json.load(f), dict(np.load(root / f"rank{rank}.npz")))
    return spec, out


def test_cli_trains_on_a_two_by_two_mesh(ranks):
    """--multihost --n-model 2 joined a gloo group of four; each Trainer
    built the [2, 2] mesh at its own coordinate, resumed step 1 and took one
    step."""
    _, out = ranks
    for rank in range(4):
        res = out[rank][0]
        assert (res["world"], res["backend"], res["shape"]) == (4, "gloo", [2, 2])
        assert res["coord"] == [rank // 2, rank % 2]
        assert res["trainer"] == [2, rank // 2, rank == 0, 2]


def test_every_rank_starts_from_its_shard_of_the_leads_resume(ranks):
    """One process -> 2 x 2: every rank, ranks 1-3 without a checkpoint of
    their own, started from its model coordinate's shard of the
    one-process step-1 file; after the step the ranks of a model coordinate
    hold one shard and one optimizer state, and the two coordinates differ."""
    _, out = ranks
    for rank in range(4):
        assert out[rank][0]["started"] == out[rank][0]["start_want"]
    for m in (0, 1):
        assert out[m][0]["shard_opt"] == out[2 + m][0]["shard_opt"]
    assert out[0][0]["shard_opt"] != out[1][0]["shard_opt"]
    for rank in range(4):  # every rank gathers the same full state
        assert out[rank][0]["gathered"] == out[0][0]["gathered"]


def test_two_by_two_checkpoint_resumes_in_one_process(ranks):
    """2 x 2 -> one process: the lead's model group gathered step 2 and rank
    0 alone wrote it; a one-process Trainer resumes it with the parameters
    and Adam moments the ranks held, gathered."""
    spec, out = ranks
    ckpt = os.path.join(spec["model_dir"], "ckpt")
    assert {"G_1.pth", "G_2.pth", "D_2.pth", "DUR_2.pth"} <= set(os.listdir(ckpt))
    follower_ckpts = [os.path.join(spec["follower_root"], str(r), "ckpt") for r in (1, 2, 3)]
    assert not any(os.path.isdir(d) and os.listdir(d) for d in follower_ckpts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "make_writer", lambda log_dir: None)
        mp.setattr(trainer_mod, "MultiPeriodDiscriminator", tiny_mpd(spec))
        again = Trainer(spec["config"], spec["model_dir"], slm_path=None, device="cpu")
    assert again.global_step == 2 and again.n_data == 1
    assert sd_digest(again.models.synthesizer.state_dict()) == out[0][0]["gathered"]
    assert opt_digest(again.state.opt_g.state_dict()) == out[0][0]["gathered_opt"]


def test_sharded_step_equals_one_process_step(ranks):
    """The 2 x 2 step (dropouts on) equals the one-process step on the
    concatenated batch: losses, grad norms, full gradients, parameters; the
    four ranks report one set of metrics and one full state, bit for bit."""
    _, out = ranks
    res, arrays = out[0]
    dp, one = res["metrics"], res["metrics_one"]
    assert set(dp) == set(one)
    for k in dp:
        assert np.isfinite(dp[k])
        assert abs(dp[k] - one[k]) <= REL * max(abs(one[k]), 1e-12), (k, dp[k], one[k])
    for rank in (1, 2, 3):
        assert out[rank][0]["metrics"] == dp
    for tag in ("g", "d", "dd"):
        keys = [k for k in arrays if k.startswith(f"grad/{tag}/")]
        norm = np.sqrt(sum(np.sum(arrays[f"one/{k}"].astype(np.float64) ** 2) for k in keys))
        for k in keys:
            got, want = arrays[k], arrays[f"one/{k}"]
            assert got.shape == want.shape, k
            assert np.abs(got - want).max() <= REL * norm, k
            for rank in (1, 2, 3):
                assert np.array_equal(out[rank][1][k], got), (rank, k)
        for k in (k for k in arrays if k.startswith(f"param/{tag}/")):
            got, want = arrays[k], arrays[f"one/{k}"]
            for rank in (1, 2, 3):  # one value of every parameter on every rank
                assert np.array_equal(out[rank][1][k], got), (rank, k)
            bound = REL * max(np.abs(want).max(), 1e-12)
            if k.endswith("conv_k.bias"):
                # zero in exact arithmetic (a softmax ignores a shift of a
                # row's scores): Adam's first update, lr * g / (|g| + eps),
                # moves it by up to lr on rounding noise either way
                bound = 2 * LR
            assert np.abs(got - want).max() <= bound, k


@pytest.mark.parametrize("module", ["wn", "mha"])
def test_sharded_module_equals_unsharded(ranks, module):
    """D.3 and D.4 (WN, gin_channels > 0: the gate halves' interleave and
    weight norm over every rank's input channels) and the relative tables
    of MultiHeadAttention (their gradients summed over the model group):
    outputs and every parameter's gradient, on each rank."""
    _, out = ranks
    sharded = {"wn": {"in_layers.0.weight_v", "cond_layer.weight_v",
                      "res_skip_layers.0.weight_v"},
               "mha": {"conv_q.weight", "conv_o.weight"}}[module]
    for rank in range(4):
        units = out[rank][0]["units"]
        assert sharded <= set(units[f"{module}/sharded"])
        assert units[f"{module}/out"] <= UNIT
        grads = [k for k in units if k.startswith(f"{module}/grad/")]
        assert any(k.endswith(("weight_g", "emb_rel_k")) for k in grads)
        for k in grads:
            scale = max(units[k.replace("/grad/", "/gradmax/")], 1.0)
            assert units[k] <= UNIT * scale, (rank, k, units[k])
