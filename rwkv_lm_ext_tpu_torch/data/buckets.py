"""Length-bucketed datasets and the seeded bucket batch sampler.

A jax-free copy of rwkv_lm_ext_tpu/data/buckets.py (LengthBucketedDataset,
BucketBatchSampler): the JAX module cannot be imported without JAX. Same
buckets, same per-bucket batch sizes, the same seeded permutation
(``np.random.default_rng(seed + bucket)``) and the same round-robin order
and offset-strided rank sharding, so a seed gives the JAX package's batches.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048)
DEFAULT_BATCH_SIZES = {64: 32, 128: 16, 256: 8, 512: 4, 1024: 2, 2048: 1}


@dataclasses.dataclass
class Bucket:
    fixed_len: int
    examples: List


class LengthBucketedDataset:
    """Examples partitioned by the smallest bucket >= their length."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.lens = sorted(buckets)
        self.buckets = [Bucket(n, []) for n in self.lens]

    def add(self, example, length: int) -> bool:
        """Place into the smallest bucket that fits; False if too long."""
        i = bisect.bisect_left(self.lens, length)
        if i >= len(self.lens):
            return False
        self.buckets[i].examples.append(example)
        return True

    def __len__(self) -> int:
        return sum(len(b.examples) for b in self.buckets)


class BucketBatchSampler:
    """Round-robin over buckets; yields (bucket index, example indices)."""

    def __init__(
        self,
        dataset: LengthBucketedDataset,
        batch_sizes: Optional[Dict[int, int]] = None,
        *,
        world_size: int = 1,
        rank: int = 0,
        skipped_batches: int = 0,
        seed: Optional[int] = None,
    ):
        self.ds = dataset
        self.batch_sizes = dict(batch_sizes or DEFAULT_BATCH_SIZES)
        self.world_size = world_size
        self.rank = rank
        self.skipped_batches = skipped_batches
        self.seed = seed

    def _bucket_bs(self, bucket: Bucket) -> int:
        return self.batch_sizes.get(bucket.fixed_len, 1)

    def __len__(self) -> int:
        total = sum(len(b.examples) // (self._bucket_bs(b) * self.world_size)
                    for b in self.ds.buckets)
        return max(total - self.skipped_batches, 0)

    def __iter__(self) -> Iterator[Tuple[int, List[int]]]:
        remaining, perms = [], {}
        for bi, b in enumerate(self.ds.buckets):
            remaining.append(len(b.examples) // (self._bucket_bs(b) * self.world_size))
            if self.seed is not None:
                perms[bi] = np.random.default_rng(self.seed + bi).permutation(len(b.examples))
        consumed = [0] * len(self.ds.buckets)
        skipped, bi = 0, 0
        while sum(remaining) > 0:
            while remaining[bi] == 0:
                bi = (bi + 1) % len(remaining)
            cur = bi
            bs = self._bucket_bs(self.ds.buckets[cur])
            start = consumed[cur] * bs * self.world_size + self.rank * bs
            idxs = list(range(start, start + bs))
            if cur in perms:
                idxs = [int(perms[cur][i]) for i in idxs]
            consumed[cur] += 1
            remaining[cur] -= 1
            bi = (cur + 1) % len(remaining)
            if skipped < self.skipped_batches:
                skipped += 1
                continue
            yield cur, idxs

    def batches(self):
        """Yield (fixed_len, [examples])."""
        for bi, idxs in self:
            b = self.ds.buckets[bi]
            yield b.fixed_len, [b.examples[i] for i in idxs]
