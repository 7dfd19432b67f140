"""Command-line training entry (reference: `torchrun train_ms.py`; here

    python -m bert_vits2_tpu_torch.train -c config.json -m model_dir

with the JAX package's flags, `bert_vits2_tpu/train/__main__.py`). One
device: the card unless `--device cpu`. On N ranks, under torchrun:

    python -m torch.distributed.run --nproc_per_node=N \
        -m bert_vits2_tpu_torch.train --multihost -c config.json -m model_dir

`--multihost` joins the process group from torchrun's variables (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) before
the Trainer builds its data mesh: NCCL when every rank of the host has a
card of its own, else gloo (on the CPU, or ranks sharing a card); each rank
trains on cuda:LOCAL_RANK, modulo the visible cards. Set BV2_FUSED_ATTENTION_TRAIN=1 to train the attention on
the hand-written forward and backward kernels; config.json's
`"bf16_run": true` (its `train` section) trains in bf16.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None):
    """Parse the flags, train, and return the Trainer."""
    p = argparse.ArgumentParser(description="Train Bert-VITS2 on one GPU or on N ranks")
    p.add_argument("-c", "--config", required=True, help="config.json path")
    p.add_argument("-m", "--model", required=True, help="model/log directory")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--keep-ckpts", type=int, default=8)
    p.add_argument("--n-model", type=int, default=1,
                   help="model-parallel axis size of the mesh (only 1 is ported)")
    p.add_argument("--no-dur-disc", action="store_true")
    p.add_argument("--slm-path", default="auto",
                   help="WavLM weights dir for the SLM adversarial losses "
                        "(train_ms.py:344-356); default resolves config.json "
                        "model.slm.model")
    p.add_argument("--no-slm", action="store_true",
                   help="train WITHOUT the SLM/WavLM losses (diverges from "
                        "reference v2.3 training)")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group (init_distributed) before "
                        "anything else")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.multihost:
        from bert_vits2_tpu_torch.parallel import init_distributed

        init_distributed(backend="gloo" if args.device == "cpu" else None)

    from bert_vits2_tpu_torch.train.trainer import Trainer

    trainer = Trainer(
        args.config,
        args.model,
        use_dur_disc=not args.no_dur_disc,
        n_model=args.n_model,
        slm_path=None if args.no_slm else args.slm_path,
        device=args.device,
    )
    trainer.run(epochs=args.epochs, max_steps=args.max_steps,
                keep_ckpts=args.keep_ckpts)
    return trainer


if __name__ == "__main__":
    main()
