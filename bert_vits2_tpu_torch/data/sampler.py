"""Deterministic bucketed batch sampler (reference: data_utils.py:277-404
DistributedBucketSampler).

Buckets items by spec-frame length between boundaries, pads each bucket with
wrapped repeats so every host gets the same number of fixed-size batches, and
subsamples rank-strided. Epoch-seeded shuffle makes every host's view a pure
function of (seed, epoch) — no coordination traffic (sampler state never
touches the device).

A copy of `bert_vits2_tpu/data/sampler.py`; a test pins the two together.
"""

from __future__ import annotations

import bisect

import numpy as np

DEFAULT_BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000)


class BucketSampler:
    def __init__(
        self,
        lengths: list[int],
        batch_size: int,
        boundaries=DEFAULT_BOUNDARIES,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 1234,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} is not in [0, {num_replicas})")
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        self.buckets = [[] for _ in range(len(self.boundaries) - 1)]
        dropped = 0
        for i, ln in enumerate(lengths):
            b = self._bucket_of(ln)
            if b is None:
                dropped += 1
            else:
                self.buckets[b].append(i)
        # drop empty buckets (and their boundaries) like data_utils.py:303-309
        for b in range(len(self.buckets) - 1, -1, -1):
            if not self.buckets[b]:
                self.buckets.pop(b)
                self.boundaries.pop(b + 1)
        self.dropped = dropped

        world_batch = self.batch_size * self.num_replicas
        self.num_samples_per_bucket = [
            len(bucket) + (world_batch - len(bucket) % world_batch) % world_batch
            for bucket in self.buckets
        ]
        self.total_size = sum(self.num_samples_per_bucket)
        self.num_batches = self.total_size // world_batch

    def _bucket_of(self, length: int):
        if length < self.boundaries[0] or length > self.boundaries[-1]:
            return None
        return bisect.bisect_left(self.boundaries, length, lo=1) - 1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def bucket_max_frames(self, bucket_idx: int) -> int:
        """Static spec-frame cap of a bucket (its upper boundary)."""
        return self.boundaries[bucket_idx + 1]

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        """Yields (bucket_idx, [item indices]) with len == batch_size."""
        g = np.random.default_rng((self.seed, self.epoch))
        batches = []
        for b, bucket in enumerate(self.buckets):
            ids = (
                g.permutation(len(bucket)).tolist()
                if self.shuffle
                else list(range(len(bucket)))
            )
            need = self.num_samples_per_bucket[b] - len(ids)
            # wrap-around padding (data_utils.py:342-346)
            ids = ids + (ids * (need // max(len(ids), 1)) + ids[: need % max(len(ids), 1)])
            ids = ids[self.rank :: self.num_replicas]
            for k in range(len(ids) // self.batch_size):
                chunk = ids[k * self.batch_size : (k + 1) * self.batch_size]
                batches.append((b, [bucket[i] for i in chunk]))
        if self.shuffle:
            order = g.permutation(len(batches))
            batches = [batches[i] for i in order]
        return iter(batches)
