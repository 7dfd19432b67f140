"""Host-side data pipeline: filelist dataset, bucketed sampler, static-shape
collation (reference: data_utils.py). Everything here is numpy on the host;
the trainer moves batches to the device."""

from bert_vits2_tpu_torch.data.collate import bucket_shape, collate_batch
from bert_vits2_tpu_torch.data.dataset import (
    FilelistDataset,
    Utterance,
    load_collated_batch,
)
from bert_vits2_tpu_torch.data.sampler import BucketSampler

__all__ = [
    "FilelistDataset",
    "Utterance",
    "BucketSampler",
    "collate_batch",
    "bucket_shape",
    "load_collated_batch",
]
