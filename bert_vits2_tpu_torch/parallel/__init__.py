"""The mesh and its data axis over torch.distributed (counterpart of
`bert_vits2_tpu/parallel/`; the model axis, `sharding.py`, is not ported
yet)."""

from bert_vits2_tpu_torch.parallel.data import data_shard, global_count, global_std
from bert_vits2_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    rank_device,
    replicate,
    replicate_optimizer,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "batch_sharding",
    "data_shard",
    "global_count",
    "global_std",
    "init_distributed",
    "make_mesh",
    "rank_device",
    "replicate",
    "replicate_optimizer",
    "replicated",
    "shard_batch",
]
