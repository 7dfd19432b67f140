"""The mesh, its data axis and its model axis over torch.distributed
(counterpart of `bert_vits2_tpu/parallel/`: `mesh.py`, `data.py`, and the
model axis's `sharding.py` with its collectives in `tensor.py`)."""

from bert_vits2_tpu_torch.parallel.data import data_shard, global_count, global_std
from bert_vits2_tpu_torch.parallel.sharding import (
    gather_state,
    shard_module,
    shard_optimizer,
    tp_gather,
    tp_shard,
    tp_specs,
)
from bert_vits2_tpu_torch.parallel.tensor import ModelAxis
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
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "ModelAxis",
    "batch_sharding",
    "data_shard",
    "gather_state",
    "global_count",
    "global_std",
    "init_distributed",
    "make_mesh",
    "rank_device",
    "replicate",
    "replicate_optimizer",
    "shard_batch",
    "shard_module",
    "shard_optimizer",
    "tp_gather",
    "tp_shard",
    "tp_specs",
]
