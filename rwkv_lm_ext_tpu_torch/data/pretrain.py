"""Pretraining sampling over a flat binidx token stream.

A jax-free copy of rwkv_lm_ext_tpu/data/pretrain.py:19-160
(fermat_prime_test, miller_rabin, maybe_is_prime, pick_magic_prime,
PretrainSampler, QAMaskedSampler), the reference's MyDataset binidx path
(src/dataset.py:104-160): the golden-ratio cubic permutation over
magic_prime chunks (``i = ((factor * ii^3) % magic_prime) * ctx_len``) with
rank / world / epoch arithmetic, and the Fermat + Miller-Rabin magic_prime
check of src/utils.py (MaybeIsPrime). For the same (epoch, idx) both
packages give the same arrays; the port refuses a bad magic_prime with a
ValueError where the JAX package asserts.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional

import numpy as np

from rwkv_lm_ext_tpu_torch.data.binidx import IndexedDataset


def fermat_prime_test(n: int, k: int = 8) -> bool:
    if n <= 3:
        return n >= 2
    rng = np.random.default_rng(0)
    for _ in range(k):
        a = int(rng.integers(2, n - 1))
        if pow(a, n - 1, n) != 1:
            return False
    return True


def miller_rabin(n: int, k: int = 16) -> bool:
    if n < 2 or n % 2 == 0:
        return n == 2
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    rng = np.random.default_rng(1)
    for _ in range(k):
        a = int(rng.integers(2, n - 1))
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def maybe_is_prime(n: int) -> bool:
    return fermat_prime_test(n) and miller_rabin(n)


def pick_magic_prime(data_tokens: int, ctx_len: int) -> int:
    """Largest prime p ≡ 2 (mod 3) with p*ctx_len <= usable tokens — the
    recipe for the reference's --magic_prime flag. p ≡ 2 (mod 3) makes
    x -> x^3 a bijection mod p, so the sampler is a full permutation."""
    n = (data_tokens - 1) // ctx_len
    p = n - ((n - 2) % 3)  # largest p <= n with p ≡ 2 (mod 3)
    while p >= 2:
        if maybe_is_prime(p):
            return p
        p -= 3
    raise ValueError("no magic prime found")


class PretrainSampler:
    """Deterministic full-coverage sampler: sample s visits chunk
    ((factor * ii^3) % magic_prime) with ii striding by world_size."""

    def __init__(
        self,
        data: IndexedDataset,
        ctx_len: int,
        *,
        magic_prime: Optional[int] = None,
        world_size: int = 1,
        rank: int = 0,
        epoch_steps: int = 1000,
        micro_bsz: int = 1,
    ):
        self.data = data
        self.ctx_len = ctx_len
        self.magic_prime = magic_prime or pick_magic_prime(
            data.total_tokens, ctx_len
        )
        if not maybe_is_prime(self.magic_prime):
            raise ValueError(f"magic_prime {self.magic_prime} is not prime")
        if self.magic_prime % 3 != 2:
            raise ValueError(f"magic_prime {self.magic_prime} must be ≡2 (mod 3)")
        if self.magic_prime * ctx_len + 1 > data.total_tokens:
            raise ValueError(f"magic_prime * ctx_len + 1 = {self.magic_prime * ctx_len + 1} "
                             f"exceeds the {data.total_tokens} tokens of the data")
        self.world_size = world_size
        self.rank = rank
        self.epoch_steps = epoch_steps
        self.micro_bsz = micro_bsz
        self.samples_per_epoch = epoch_steps * world_size * micro_bsz
        self.factor = int(self.magic_prime * ((math.sqrt(5) - 1) / 2))

    def sample_offset(self, epoch: int, idx: int) -> int:
        ii = 1 + epoch * self.samples_per_epoch + idx * self.world_size + self.rank
        return ((self.factor * ii * ii * ii) % self.magic_prime) * self.ctx_len

    def __call__(self, epoch: int, idx: int) -> Dict[str, np.ndarray]:
        i = self.sample_offset(epoch, idx)
        dix = np.asarray(
            self.data.slice_tokens(i, self.ctx_len + 1), np.int32
        )
        return {"input_ids": dix[:-1], "labels": dix[1:].astype(np.int32)}

    def batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(self.epoch_steps):
            rows = [
                self(epoch, step * self.micro_bsz + j)
                for j in range(self.micro_bsz)
            ]
            yield {
                "input_ids": np.stack([r["input_ids"] for r in rows]),
                "labels": np.stack([r["labels"] for r in rows]),
            }


class QAMaskedSampler:
    """my_qa_mask pretraining (src/dataset.py:123-191): interleave a pile
    stream with a QA dataset; QA samples carry a loss mask that supervises
    only the answer region (labels -100 elsewhere). Even global sample
    indices draw from the pile, odd from QA."""

    def __init__(
        self,
        pile: PretrainSampler,
        qa_docs,                     # IndexedDataset of QA documents
        ctx_len: int,
        *,
        answer_marker: int = 1,      # token separating prompt from answer
        seed: int = 0,
    ):
        self.pile = pile
        self.qa = qa_docs
        self.ctx_len = ctx_len
        self.answer_marker = answer_marker
        self.rng = np.random.default_rng(seed)

    def __call__(self, epoch: int, idx: int) -> Dict[str, np.ndarray]:
        if idx % 2 == 0:
            return self.pile(epoch, idx // 2)
        doc = np.asarray(
            self.qa[int(self.rng.integers(len(self.qa)))], np.int32
        )
        doc = doc[: self.ctx_len + 1]
        pad = self.ctx_len + 1 - len(doc)
        if pad:
            doc = np.concatenate([doc, np.zeros(pad, np.int32)])
        x, y = doc[:-1], doc[1:].copy()
        # mask the prompt: supervise only after the first answer marker
        marker = np.nonzero(x == self.answer_marker)[0]
        cut = int(marker[0]) + 1 if len(marker) else 0
        y[:cut] = -100
        if pad:
            y[-pad:] = -100
        return {"input_ids": x, "labels": y}
