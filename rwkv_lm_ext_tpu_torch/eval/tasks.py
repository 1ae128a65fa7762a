"""C-MTEB-style retrieval task runner.

A jax-free copy of rwkv_lm_ext_tpu/eval/tasks.py:32-158 (RetrievalTask,
run_retrieval_task). The reference evaluates its bi-encoders by handing them
to the `mteb` package (tests/test_cmteb.py:92-94 `MMarcoRetrieval`,
tests/TestBiEncoder.py:60-63 `T2Retrieval`). This runner reads the file
format of an MTEB/BEIR task dump —

    task_dir/
      corpus.jsonl    {"_id": "d1", "title": "...", "text": "..."}
      queries.jsonl   {"_id": "q1", "text": "..."}
      qrels.tsv       query-id \t corpus-id \t score   (optional header;
                      or qrels/<split>.tsv)

— runs it through any encoder (and optionally a cross-encoder reranking
stage, the two-tower + rerank serving pipeline), and reports the headline
metrics mteb reports for retrieval tasks (nDCG@10, MRR@10, recall@k). A
directory exported from a HF BEIR/C-MTEB dataset loads unchanged; `id` is
accepted as an alias of `_id`.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rwkv_lm_ext_tpu_torch.eval.retrieval import metrics_from_sims, retrieval_metrics


class RetrievalTask:
    """An MTEB/BEIR-format retrieval task loaded from disk."""

    def __init__(
        self,
        corpus: Dict[str, str],
        queries: Dict[str, str],
        qrels: Dict[str, Dict[str, int]],
    ):
        self.corpus = corpus
        self.queries = queries
        self.qrels = qrels

    @staticmethod
    def _read_jsonl(path: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                rid = str(row.get("_id", row.get("id")))
                text = row.get("text", "")
                title = row.get("title") or ""
                out[rid] = f"{title} {text}".strip() if title else text
        return out

    @staticmethod
    def _read_qrels(path: str) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 2:
                    continue
                if parts[0] in ("query-id", "qid"):  # header
                    continue
                qid, did = parts[0], parts[1]
                score = int(float(parts[2])) if len(parts) > 2 else 1
                out.setdefault(qid, {})[did] = score
        return out

    @classmethod
    def load(cls, task_dir: str, split: str = "test") -> "RetrievalTask":
        corpus = cls._read_jsonl(os.path.join(task_dir, "corpus.jsonl"))
        queries = cls._read_jsonl(os.path.join(task_dir, "queries.jsonl"))
        qrels_path = os.path.join(task_dir, "qrels.tsv")
        if not os.path.exists(qrels_path):
            qrels_path = os.path.join(task_dir, "qrels", f"{split}.tsv")
        qrels = cls._read_qrels(qrels_path)
        missing = [q for q in qrels if q not in queries]
        if missing:
            raise ValueError(f"qrels reference unknown query ids: {missing[:5]}")
        # a truncated corpus dump would otherwise silently deflate metrics
        missing_docs = sorted(
            {d for rel in qrels.values() for d in rel if d not in corpus}
        )
        if missing_docs:
            raise ValueError(
                f"qrels reference {len(missing_docs)} corpus ids missing "
                f"from corpus.jsonl: {missing_docs[:5]}"
            )
        return cls(corpus, queries, qrels)


def run_retrieval_task(
    task: RetrievalTask,
    encode_fn: Callable[[List[str]], np.ndarray],
    *,
    ks: Sequence[int] = (1, 5, 10),
    rerank_fn: Optional[
        Callable[[List[Tuple[str, str]]], Sequence[float]]
    ] = None,
    rerank_top_k: int = 10,
) -> Dict[str, float]:
    """Embed corpus + queries with ``encode_fn``, optionally rerank each
    query's dense top-``rerank_top_k`` with ``rerank_fn`` (scores for
    (query, doc) pairs), and return recall@k / MRR@10 / nDCG@10.

    Only queries that appear in qrels are scored (mteb semantics).
    """
    doc_ids = list(task.corpus.keys())
    doc_pos = {d: i for i, d in enumerate(doc_ids)}
    qids = [q for q in task.queries if q in task.qrels]
    corpus_emb = encode_fn([task.corpus[d] for d in doc_ids])
    query_emb = encode_fn([task.queries[q] for q in qids])
    qrels_idx = [
        [doc_pos[d] for d, s in task.qrels[q].items() if s > 0 and d in doc_pos]
        for q in qids
    ]

    if rerank_fn is None:
        return retrieval_metrics(query_emb, corpus_emb, qrels_idx, ks=ks)

    # dense retrieval -> cross-encoder rerank of the top candidates;
    # rerank scores order the head, dense similarity orders the tail.
    q = query_emb / np.clip(
        np.linalg.norm(query_emb, axis=1, keepdims=True), 1e-12, None
    )
    c = corpus_emb / np.clip(
        np.linalg.norm(corpus_emb, axis=1, keepdims=True), 1e-12, None
    )
    sims = q @ c.T
    n_docs = len(doc_ids)
    k_head = min(rerank_top_k, n_docs)
    pairs: List[Tuple[str, str]] = []
    heads = []
    for i, qid in enumerate(qids):
        head = np.argsort(-sims[i])[:k_head]
        heads.append(head)
        pairs.extend(
            (task.queries[qid], task.corpus[doc_ids[j]]) for j in head
        )
    scores = np.asarray(rerank_fn(pairs), np.float64).reshape(
        len(qids), k_head
    )
    # rebuild a full score matrix: the reranked head is lifted above the
    # dense tail by RANK (cross-encoder scores are arbitrary reals, so
    # raw score + offset could still dip below the tail).
    reranked = sims.astype(np.float64).copy()
    lift = float(np.abs(sims).max()) + 1.0
    for i in range(len(qids)):
        order = np.argsort(-scores[i])  # best candidate first
        for rank, j in enumerate(order):
            reranked[i, heads[i][j]] = lift + (k_head - rank)
    return metrics_from_sims(reranked, qrels_idx, ks=ks)
