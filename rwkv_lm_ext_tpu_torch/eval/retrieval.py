"""Retrieval / reranking metrics.

A jax-free copy of rwkv_lm_ext_tpu/eval/retrieval.py:16-92 (numpy only, so
its outputs equal the JAX module's):
- rerank_metrics: MAP and P@1 over per-query candidate lists — the
  AskUbuntu protocol (train_scripts/eval_askubuntu_simcse.py).
- retrieval_metrics: recall@k, MRR@10, nDCG@10 over a corpus — the
  C-MTEB MMarcoRetrieval/T2Retrieval protocol (tests/test_cmteb.py,
  tests/TestBiEncoder.py) without the mteb dependency.
- metrics_from_sims: the same metrics from a score matrix.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def rerank_metrics(
    scores: Sequence[Sequence[float]],
    labels: Sequence[Sequence[int]],
) -> Dict[str, float]:
    """scores[i]/labels[i]: candidates for query i (label 1 = relevant)."""
    aps, p1s = [], []
    for s, l in zip(scores, labels):
        s = np.asarray(s, np.float64)
        l = np.asarray(l, np.int64)
        if l.sum() == 0:
            continue
        order = np.argsort(-s)
        rel = l[order]
        hits = np.cumsum(rel)
        prec = hits / (np.arange(len(rel)) + 1)
        aps.append(float((prec * rel).sum() / rel.sum()))
        p1s.append(float(rel[0]))
    return {"MAP": float(np.mean(aps)), "P@1": float(np.mean(p1s))}


def retrieval_metrics(
    query_emb: np.ndarray,
    corpus_emb: np.ndarray,
    qrels: Sequence[Sequence[int]],
    *,
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """qrels[i]: list of relevant corpus indices for query i. Embeddings
    are cosine-normalized internally."""
    q = query_emb / np.clip(
        np.linalg.norm(query_emb, axis=1, keepdims=True), 1e-12, None
    )
    c = corpus_emb / np.clip(
        np.linalg.norm(corpus_emb, axis=1, keepdims=True), 1e-12, None
    )
    return metrics_from_sims(q @ c.T, qrels, ks=ks)


def metrics_from_sims(
    sims: np.ndarray,
    qrels: Sequence[Sequence[int]],
    *,
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """Same metrics from a precomputed (n_queries, n_docs) score matrix
    (used by the task runner's cross-encoder reranking stage)."""
    kmax = max(max(ks), 10)
    top = np.argsort(-sims, axis=1)[:, :kmax]
    out: Dict[str, float] = {}
    recalls = {k: [] for k in ks}
    mrr, ndcg = [], []
    for i, rel in enumerate(qrels):
        rel = set(rel)
        if not rel:
            continue
        ranked = top[i]
        for k in ks:
            got = len(rel & set(ranked[:k].tolist()))
            recalls[k].append(got / len(rel))
        rr = 0.0
        for rank, doc in enumerate(ranked[:10]):
            if int(doc) in rel:
                rr = 1.0 / (rank + 1)
                break
        mrr.append(rr)
        dcg = sum(
            1.0 / np.log2(rank + 2)
            for rank, doc in enumerate(ranked[:10])
            if int(doc) in rel
        )
        idcg = sum(1.0 / np.log2(r + 2) for r in range(min(len(rel), 10)))
        ndcg.append(dcg / idcg if idcg > 0 else 0.0)
    for k in ks:
        out[f"recall@{k}"] = float(np.mean(recalls[k]))
    out["MRR@10"] = float(np.mean(mrr))
    out["nDCG@10"] = float(np.mean(ndcg))
    return out
