"""One rank of tests/test_torch_distributed.py (not collected by pytest).

Two of these run as CPU processes over gloo, given torchrun's variables
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) in their
environment, and write what they saw as rank<r>.json / rank<r>.npz for the
test to check:

1. the training CLI with --multihost (it joins the process group from those
   variables) resumes the one-process step-1 checkpoint the test wrote and
   trains one step on two ranks; rank 1 runs in a model directory of its
   own, which holds no checkpoint (a node without a shared one), and takes
   the lead's resume; rank 0 saves;
2. the two ranks' sampler shards of 50 items;
3. one data-parallel step (`make_train_step(mesh=make_mesh())`) of the tiny
   models on this rank's rows of a 4-row batch whose two halves have
   different lengths, module dropouts at 0 and the attention's hash
   dropout on (BV2_FUSED_ATTENTION_TRAIN=1): its metrics, the reduced
   gradients and a digest of the parameters after it; rank 0 also runs the
   one-process step on the whole batch from the same weights and seed.

    python tests/torch_distributed_worker.py SPEC.json OUT_DIR
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def digest(modules) -> str:
    h = hashlib.sha1()
    for m in modules:
        for p in m.parameters():
            h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def optimizer_digest(state) -> str:
    """Every optimizer's state tensors, in parameter order."""
    h = hashlib.sha1()
    for opt in (state.opt_g, state.opt_d, state.opt_dd):
        for group in opt.param_groups:
            for p in group["params"]:
                for key, t in sorted(opt.state.get(p, {}).items()):
                    h.update(key.encode() + t.detach().numpy().tobytes())
    return h.hexdigest()


def tiny_models(spec, seed):
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models.discriminators import (
        DurationDiscriminator,
        MultiPeriodDiscriminator,
    )
    from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
    from bert_vits2_tpu_torch.train import Models

    torch.manual_seed(seed)
    models = Models(Synthesizer(ModelConfig(**spec["tiny"])),
                    MultiPeriodDiscriminator(**spec["mpd"]),
                    DurationDiscriminator(**spec["dd"]), None)
    for m in models[:3]:  # module dropouts off; the attention's hash dropout stays
        for sub in m.modules():
            if isinstance(sub, torch.nn.Dropout):
                sub.p = 0.0
    return models


def global_batch():
    """4 rows; rows 0-1 (rank 0) and 2-3 (rank 1) differ in text and frame
    lengths, so the global denominators differ from the local ones."""
    rng = np.random.default_rng(2)
    b, t_x, t_y = 4, 9, 24
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        x=rng.integers(1, 20, (b, t_x)), x_lengths=np.asarray([9, 8, 6, 5]),
        spec=f32(0.3 * rng.normal(size=(b, t_y, 33))),
        spec_lengths=np.asarray([24, 22, 16, 13]),
        wave=f32(rng.uniform(-0.5, 0.5, size=(b, t_y * 16))),
        sid=rng.integers(0, 4, (b,)), tone=rng.integers(0, 12, (b, t_x)),
        language=rng.integers(0, 3, (b, t_x)),
        bert=f32(0.3 * rng.normal(size=(b, t_x, 16))), utt_lang=np.asarray([0, 1, 2, 1]))


def one_step(spec, mesh, batch):
    """-> (metrics, {module: flat reduced gradients}, parameter digest)."""
    from bert_vits2_tpu_torch.train import (
        DataConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    models = tiny_models(spec, seed=0)
    # torch's global generator differs per rank, as the Trainer seeds it:
    # the hash dropout's seeds must not come from it
    torch.manual_seed(1000 + (0 if mesh is None else mesh.data_rank))
    cfg = TrainConfig(learning_rate=1e-3)
    state = init_train_state(models, cfg)
    step = make_train_step(models, cfg, DataConfig(**spec["data"]),
                           spec["tiny"]["segment_size"], mesh=mesh)
    _, metrics = step(state, batch, torch.Generator().manual_seed(11), 1e-3)
    grads = {name: torch.cat([p.grad.reshape(-1) for p in m.parameters()
                              if p.grad is not None]).double().numpy()
             for name, m in zip(("g", "d", "dd"), models[:3])}
    return {k: float(v) for k, v in metrics.items()}, grads, digest(models[:3])


def main() -> None:
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    rank = int(os.environ["RANK"])

    from bert_vits2_tpu_torch.data import BucketSampler
    from bert_vits2_tpu_torch.parallel import make_mesh, shard_batch
    from bert_vits2_tpu_torch.train import trainer as trainer_mod
    from bert_vits2_tpu_torch.train.__main__ import main as train_main

    trainer_mod.make_writer = lambda log_dir: None  # TensorBoard's import: ~10 s
    model_dir = spec["model_dir"] if rank == 0 else spec["follower_dir"]
    trainer = train_main(["-c", spec["config"], "-m", model_dir, "--multihost",
                          "--no-slm", "--max-steps", "2", "--device", "cpu"])
    out = {"world": dist.get_world_size(), "rank": dist.get_rank(),
           "backend": dist.get_backend(),
           "trainer": [trainer.n_data, trainer.data_rank, trainer.is_lead,
                       trainer.global_step],
           "trainer_digest": digest([trainer.models.synthesizer]),
           "optimizer_digest": optimizer_digest(trainer.state)}

    lengths = [40 + (i * 37) % 500 for i in range(50)]
    sampler = BucketSampler(lengths, batch_size=2, num_replicas=2, rank=rank, seed=5)
    sampler.set_epoch(0)
    batches = list(sampler)
    out["sampler_batches"] = len(batches)
    out["sampler_ids"] = [i for _, ids in batches for i in ids]

    mesh = make_mesh()
    batch = global_batch()
    out["metrics"], grads, out["digest"] = one_step(spec, mesh, shard_batch(mesh, batch))
    arrays = {f"dp_{k}": v for k, v in grads.items()}
    if rank == 0:
        full = {k: torch.as_tensor(v) for k, v in batch.items()}
        out["metrics_one"], grads_one, _ = one_step(spec, None, full)
        arrays.update({f"one_{k}": v for k, v in grads_one.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
