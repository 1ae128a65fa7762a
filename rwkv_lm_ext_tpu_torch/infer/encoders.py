"""Serving bi-encoder: text -> L2-normalised embedding.

Counterpart of rwkv_lm_ext_tpu/infer/encoders.py:24-94 (_bucketize,
_pad_batch, BiEncoder). Batches are padded to a bucket length, as in the
JAX package, so the kernels see a handful of shapes.
"""
from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.config import EMB_ID, PAD_ID
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def bucketize(ids: List[List[int]], buckets=BUCKETS) -> int:
    longest = max(len(x) for x in ids)
    i = bisect.bisect_left(buckets, longest)
    return buckets[min(i, len(buckets) - 1)]


def pad_batch(ids: List[List[int]], length: int, pad: int = PAD_ID) -> np.ndarray:
    out = np.full((len(ids), length), pad, np.int64)
    for i, row in enumerate(ids):
        row = row[:length]
        out[i, : len(row)] = row
    return out


class BiEncoder:
    """Append emb_id to each text, run the model, pool at the first emb_id
    (weightedmean by default) and L2-normalise."""

    def __init__(self, model, tokenizer, *, pooling_type: str = "weightedmean"):
        self.model = model
        self.tokenizer = tokenizer
        self.pooling_type = pooling_type
        self.device = model.emb.weight.device

    def token_batches(self, texts: Sequence[str], *, batch_size: int = 32):
        """Padded (B, L) int64 arrays, one per forward encode_texts runs."""
        ids = [self.tokenizer.encode(t)[:2047] + [EMB_ID] for t in texts]
        for s in range(0, len(ids), batch_size):
            batch = ids[s: s + batch_size]
            yield pad_batch(batch, bucketize(batch))

    def encode_texts(self, texts: Sequence[str], *, batch_size: int = 32) -> np.ndarray:
        chunks = []
        with torch.inference_mode():
            for arr in self.token_batches(texts, batch_size=batch_size):
                emb = embed_sequences(
                    self.model, torch.from_numpy(arr).to(self.device),
                    pooling_type=self.pooling_type, normalize=True,
                )
                chunks.append(emb.cpu().numpy())
        return np.concatenate(chunks, axis=0)
