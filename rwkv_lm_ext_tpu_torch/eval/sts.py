"""STS correlation evaluator (train_scripts/evaluators.py:33-240).

A copy of rwkv_lm_ext_tpu/eval/sts.py:16-104 (``SimilarityEvaluator``, its
CSV, Pearson and Spearman), which imports no JAX; the port keeps its own so
that it imports nothing of the JAX package.

Given sentence pairs with gold similarity scores, computes Pearson and
Spearman correlations of four similarity functions (cosine, -euclidean,
-manhattan, dot) against gold, and appends a CSV row per evaluation —
matching the reference's EmbeddingSimilarityEvaluator output schema.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Sequence

import numpy as np

CSV_HEADERS = [
    "epoch", "steps",
    "cosine_pearson", "cosine_spearman",
    "euclidean_pearson", "euclidean_spearman",
    "manhattan_pearson", "manhattan_spearman",
    "dot_pearson", "dot_spearman",
]


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def _rank(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties averaged), for Spearman without scipy."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    return _pearson(_rank(a), _rank(b))


def similarity_scores(e1: np.ndarray, e2: np.ndarray) -> Dict[str, np.ndarray]:
    n1 = e1 / np.clip(np.linalg.norm(e1, axis=1, keepdims=True), 1e-12, None)
    n2 = e2 / np.clip(np.linalg.norm(e2, axis=1, keepdims=True), 1e-12, None)
    return {
        "cosine": np.sum(n1 * n2, axis=1),
        "euclidean": -np.linalg.norm(e1 - e2, axis=1),
        "manhattan": -np.abs(e1 - e2).sum(axis=1),
        "dot": np.sum(e1 * e2, axis=1),
    }


class SimilarityEvaluator:
    def __init__(
        self,
        sentences1: Sequence[str],
        sentences2: Sequence[str],
        gold_scores: Sequence[float],
        *,
        csv_dir: Optional[str] = None,
        name: str = "sts",
    ):
        assert len(sentences1) == len(sentences2) == len(gold_scores)
        self.s1 = list(sentences1)
        self.s2 = list(sentences2)
        self.gold = np.asarray(gold_scores, np.float64)
        self.csv_path = (
            os.path.join(csv_dir, f"similarity_evaluation_{name}_results.csv")
            if csv_dir
            else None
        )

    def __call__(
        self, encode_fn, *, epoch: int = -1, steps: int = -1
    ) -> Dict[str, float]:
        """encode_fn: list[str] -> (N, D) embeddings."""
        e1 = np.asarray(encode_fn(self.s1), np.float64)
        e2 = np.asarray(encode_fn(self.s2), np.float64)
        sims = similarity_scores(e1, e2)
        out: Dict[str, float] = {}
        for key, s in sims.items():
            out[f"{key}_pearson"] = _pearson(s, self.gold)
            out[f"{key}_spearman"] = _spearman(s, self.gold)
        if self.csv_path:
            new = not os.path.exists(self.csv_path)
            with open(self.csv_path, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(CSV_HEADERS)
                w.writerow(
                    [epoch, steps] + [out[h] for h in CSV_HEADERS[2:]]
                )
        return out
