"""One rank of tests/test_torch_model_parallel.py (not collected by pytest).

Four of these run as CPU processes over gloo, given torchrun's variables
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), as a [2, 2] mesh
(data x model; rank = data * 2 + model), and write what they saw as
rank<r>.json / rank<r>.npz:

1. units on each data coordinate's model group of two: a WN with
   gin_channels > 0 (D.3, D.4) and a MultiHeadAttention (the relative
   tables' gradients), each sharded against the same module unsharded:
   outputs and every parameter's gradient, the sharded ones gathered;
2. the training CLI with --multihost --n-model 2 (its multi-period
   discriminator at the tests' small widths) resumes the one-process
   step-1 checkpoint the test wrote (ranks 1-3 in model directories of
   their own, without checkpoints: they take the lead's start), trains one
   step, and the lead's model group saves step 2 (gathered, rank 0 writes);
   each rank's shards right after the start, and the full state gathered
   after the run, are digested;
3. one step of the tiny models (every module dropout at 0.1, the hash
   dropout on) on the mesh, each data coordinate on its rows of a 4-row
   batch: metrics and the full gradients and parameters after it; rank 0
   also runs the one-process step on the whole batch from the same weights.

    python tests/torch_model_parallel_worker.py SPEC.json OUT_DIR
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from torch_distributed_worker import global_batch  # noqa: E402


def sd_digest(state_dict: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(state_dict):
        h.update(k.encode() + state_dict[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def opt_digest(opt_sd: dict) -> str:
    h = hashlib.sha1()
    for i in sorted(opt_sd["state"]):
        for k, t in sorted(opt_sd["state"][i].items()):
            h.update(f"{i}{k}".encode() + t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gathered(module, axis, opt=None):
    from bert_vits2_tpu_torch.parallel.sharding import gather_state

    if getattr(module, "tp_specs", None) is None:
        return module.state_dict(), None if opt is None else opt.state_dict()
    return gather_state(module, opt, axis)


def full_grads(module, axis) -> dict:
    """name -> the full gradient (sharded ones gathered)."""
    from bert_vits2_tpu_torch.parallel.sharding import gather_from_model

    out = {}
    for name, p in module.named_parameters():
        split = getattr(module, "tp_specs", {}).get(name)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[name] = g if split is None else gather_from_model(g, split, axis)
    return out


def units(axis) -> dict:
    """Sharded WN and MultiHeadAttention against the unsharded modules:
    max-abs errors of the output and of each parameter's gradient."""
    from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
    from bert_vits2_tpu_torch.nn.wavenet import WN
    from bert_vits2_tpu_torch.parallel.sharding import shard_module

    rng = np.random.default_rng(5)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    mask = torch.ones(2, 1, 11)
    mask[1, :, 8:] = 0
    x, g, gout = t(2, 8, 11), t(2, 4), t(2, 8, 11)
    out = {}
    cases = (("wn", lambda: WN(8, 3, 2, 3, gin_channels=4), lambda m: m(x, mask, g)),
                ("mha", lambda: MultiHeadAttention(8, 8, 2, window_size=3).train(),
                 lambda m: m(x, mask)))
    for name, build, run in cases:
        full, part = build(), build()
        with torch.no_grad():  # nonzero everywhere, weight_g away from the norm
            for p in full.parameters():
                p.copy_(torch.as_tensor(rng.normal(size=p.shape).astype(np.float32)) * 0.5)
        part.load_state_dict(full.state_dict())
        shard_module(part, axis)
        want, got = run(full), run(part)
        (want * gout).sum().backward()
        (got * gout).sum().backward()
        out[f"{name}/out"] = float((got - want).abs().max())
        gf, gp = full_grads(full, axis), full_grads(part, axis)
        for k in gf:
            out[f"{name}/grad/{k}"] = float((gp[k] - gf[k]).abs().max())
            out[f"{name}/gradmax/{k}"] = float(gf[k].abs().max())
        out[f"{name}/sharded"] = sorted(k for k, v in part.tp_specs.items() if v)
    return out


def tiny_mpd(spec):
    """The MultiPeriodDiscriminator class at the tests' small widths, for
    `train.trainer.build_models` (the CLI's models)."""
    import functools

    from bert_vits2_tpu_torch.models.discriminators import MultiPeriodDiscriminator

    return functools.partial(MultiPeriodDiscriminator, **spec["mpd"])


def tiny_models(spec, seed):
    """The training modules' tiny models, module dropouts as configured."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models.discriminators import (
        DurationDiscriminator,
        MultiPeriodDiscriminator,
    )
    from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
    from bert_vits2_tpu_torch.train import Models

    torch.manual_seed(seed)
    return Models(Synthesizer(ModelConfig(**spec["tiny"])),
                  MultiPeriodDiscriminator(**spec["mpd"]),
                  DurationDiscriminator(**spec["dd"]), None)


def one_step(spec, mesh, batch):
    """-> (metrics, {name: full array}) of the gradients and parameters
    after one step (the synthesizer's gathered)."""
    from bert_vits2_tpu_torch.train import (
        DataConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )
    from bert_vits2_tpu_torch.train.step import shard_train_state

    models = tiny_models(spec, seed=0)
    # torch's global generator differs per rank: no mask may come from it
    torch.manual_seed(1000 + (0 if mesh is None else dist.get_rank()))
    cfg = TrainConfig(learning_rate=spec["lr"])
    state = init_train_state(models, cfg)
    axis = None
    if mesh is not None and mesh.n_model > 1:
        shard_train_state(models, state, mesh)
        axis = mesh.model_axis
    step = make_train_step(models, cfg, DataConfig(**spec["data"]),
                           spec["tiny"]["segment_size"], mesh=mesh)
    _, metrics = step(state, batch, torch.Generator().manual_seed(11), spec["lr"])
    arrays = {}
    for tag, m in zip(("g", "d", "dd"), models[:3]):
        for k, v in full_grads(m, axis).items():
            arrays[f"grad/{tag}/{k}"] = v.numpy()
        for k, v in (gathered(m, axis)[0] if axis is not None else m.state_dict()).items():
            arrays[f"param/{tag}/{k}"] = v.numpy()
    return {k: float(v) for k, v in metrics.items()}, arrays


def main() -> None:
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    rank = int(os.environ["RANK"])

    from bert_vits2_tpu_torch.parallel import shard_batch
    from bert_vits2_tpu_torch.parallel.sharding import tp_shard
    from bert_vits2_tpu_torch.train import trainer as trainer_mod
    from bert_vits2_tpu_torch.train.__main__ import main as train_main

    trainer_mod.make_writer = lambda log_dir: None  # TensorBoard's import: ~10 s
    trainer_mod.MultiPeriodDiscriminator = tiny_mpd(spec)  # as the test's checkpoint
    started = {}

    class Recorded(trainer_mod.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            started["shards"] = sd_digest(self.models.synthesizer.state_dict())

    trainer_mod.Trainer = Recorded
    model_dir = spec["model_dir"] if rank == 0 else os.path.join(spec["follower_root"],
                                                                 str(rank))
    trainer = train_main(["-c", spec["config"], "-m", model_dir, "--multihost",
                          "--n-model", "2", "--no-slm", "--max-steps", "2",
                          "--device", "cpu"])
    mesh = trainer.mesh
    out = {"world": dist.get_world_size(), "backend": dist.get_backend(),
           "coord": [mesh.data_rank, mesh.model_rank], "shape": [mesh.n_data, mesh.n_model],
           "trainer": [trainer.n_data, trainer.data_rank, trainer.is_lead,
                       trainer.global_step],
           "started": started["shards"]}
    # the reverse direction: the one-process step-1 file, sharded here
    g1 = torch.load(os.path.join(spec["model_dir"], "ckpt", "G_1.pth"),
                       map_location="cpu", weights_only=True)["model"]
    out["start_want"] = sd_digest(tp_shard(g1, mesh.n_model, mesh.model_rank))
    sd, opt_sd = gathered(trainer.models.synthesizer, mesh.model_axis, trainer.state.opt_g)
    out["gathered"], out["gathered_opt"] = sd_digest(sd), opt_digest(opt_sd)
    out["shard_opt"] = opt_digest(trainer.state.opt_g.state_dict())

    out["units"] = units(mesh.model_axis)

    batch = global_batch()
    out["metrics"], arrays = one_step(spec, mesh, shard_batch(mesh, batch))
    if rank == 0:
        full = {k: torch.as_tensor(v) for k, v in batch.items()}
        out["metrics_one"], one = one_step(spec, None, full)
        arrays.update({f"one/{k}": v for k, v in one.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
