"""The port's evaluation library against the JAX package's (numpy only on
both sides, so outputs are compared for equality): the retrieval and
reranking metrics, ``metrics_from_sims``, the BEIR task loader and
``run_retrieval_task`` with and without its rerank-by-rank lift (seeded
encoders and a seeded reranker), the mteb adapter's protocol and its
``run_mteb`` gate, ``eval``'s exports, and ``BiEncoder(reference=True)``,
the plain-route switch that ``eval.cli parity`` builds (held to the JAX
``wkv_backend="reference"`` bi-encoder within 1e-5 of max in
tests/test_torch_eval_cli.py).
"""
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import rwkv_lm_ext_tpu.eval as jeval
from rwkv_lm_ext_tpu.eval import mteb_adapter as jmteb
from rwkv_lm_ext_tpu.eval import retrieval as jretrieval
from rwkv_lm_ext_tpu.eval import tasks as jtasks
import rwkv_lm_ext_tpu_torch.eval as peval
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.eval import mteb_adapter, retrieval, tasks
from rwkv_lm_ext_tpu_torch.infer import encoders
from torch_stack_setup import jax_params, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

TASK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mini_task")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rerank_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    scores, labels = [], []
    for _ in range(12):
        n = int(rng.integers(1, 9))
        scores.append(rng.normal(size=n).round(1).tolist())     # ties included
        labels.append(rng.integers(0, 2, size=n).tolist())
    labels[0] = [0] * len(labels[0])                             # skipped: nothing relevant
    assert retrieval.rerank_metrics(scores, labels) == jretrieval.rerank_metrics(scores, labels)


@pytest.mark.parametrize("seed,ks", [(0, (1, 5, 10)), (1, (1, 3)), (2, (2, 20))])
def test_retrieval_metrics_match_jax(seed, ks):
    rng = np.random.default_rng(seed)
    q, c = rng.normal(size=(9, 16)), rng.normal(size=(30, 16))
    c[3] = 0.0                                                   # a zero row: the norm clip
    qrels = [rng.choice(30, size=int(rng.integers(0, 4)), replace=False).tolist()
             for _ in range(9)]
    qrels[0] = [3, 4]
    assert retrieval.retrieval_metrics(q, c, qrels, ks=ks) == jretrieval.retrieval_metrics(
        q, c, qrels, ks=ks)
    sims = rng.normal(size=(9, 30)).round(2)
    assert retrieval.metrics_from_sims(sims, qrels, ks=ks) == jretrieval.metrics_from_sims(
        sims, qrels, ks=ks)


def _dump(d, *, id_key="_id", qrels_dir=False, header=True, extra_qrel=None, drop_doc=False):
    d.mkdir()
    rows = [{id_key: f"d{i}", "title": ("T" if i % 2 else ""), "text": f"doc {i}"}
            for i in range(6) if not (drop_doc and i == 5)]
    (d / "corpus.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    (d / "queries.jsonl").write_text("\n".join(
        json.dumps({id_key: f"q{i}", "text": f"query {i}"}) for i in range(4)))
    lines = (["query-id\tcorpus-id\tscore"] if header else []) + [
        "q0\td1\t1", "q0\td2\t2", "q1\td5\t1.0", "q2\td0", "q3\td4\t0", "bad"]
    if extra_qrel:
        lines.append(extra_qrel)
    path = d / "qrels" / "test.tsv" if qrels_dir else d / "qrels.tsv"
    path.parent.mkdir(exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return str(d)


@pytest.mark.parametrize("kw", [{}, {"id_key": "id"}, {"qrels_dir": True, "header": False}])
def test_task_loader_matches_jax(tmp_path, kw):
    path = _dump(tmp_path / "task", **kw)
    got, want = tasks.RetrievalTask.load(path), jtasks.RetrievalTask.load(path)
    assert (got.corpus, got.queries, got.qrels) == (want.corpus, want.queries, want.qrels)
    assert got.corpus["d1"] == "T doc 1" and got.qrels["q0"] == {"d1": 1, "d2": 2}
    mini = tasks.RetrievalTask.load(TASK_DIR)
    assert mini.corpus == jtasks.RetrievalTask.load(TASK_DIR).corpus and len(mini.corpus) == 12


@pytest.mark.parametrize("kw,match", [({"extra_qrel": "q9\td1\t1"}, "unknown query"),
                                      ({"drop_doc": True}, "missing from corpus")])
def test_task_loader_refuses_what_jax_refuses(tmp_path, kw, match):
    path = _dump(tmp_path / "task", **kw)
    for module in (tasks, jtasks):
        with pytest.raises(ValueError, match=match):
            module.RetrievalTask.load(path)


def _seeded_encoder(seed):
    """A deterministic text -> vector map (the same in both calls)."""
    def encode(texts):
        return np.stack([np.random.default_rng([seed, sum(map(ord, t)), len(t)]).normal(size=8)
                         for t in texts]).astype(np.float32)
    return encode


def _seeded_reranker(pairs):
    return [float(np.random.default_rng([7, sum(map(ord, q + d))]).normal()) * 100
            for q, d in pairs]


@pytest.mark.parametrize("rerank,top_k", [(False, 10), (True, 3), (True, 10), (True, 50)])
def test_run_retrieval_task_matches_jax(rerank, top_k):
    got_task, want_task = tasks.RetrievalTask.load(TASK_DIR), jtasks.RetrievalTask.load(TASK_DIR)
    kw = dict(rerank_fn=_seeded_reranker if rerank else None, rerank_top_k=top_k, ks=(1, 3, 10))
    got = tasks.run_retrieval_task(got_task, _seeded_encoder(3), **kw)
    want = jtasks.run_retrieval_task(want_task, _seeded_encoder(3), **kw)
    assert got == want
    if rerank:
        dense = tasks.run_retrieval_task(got_task, _seeded_encoder(3), ks=(1, 3, 10))
        assert got != dense          # the reranked head moved


class FakeBi:
    """An encode_texts-shaped encoder that records its calls."""

    def __init__(self):
        self.seen = []

    def encode_texts(self, texts, *, batch_size=32):
        self.seen.append((tuple(texts), batch_size))
        return np.stack([np.full(4, float(len(t))) for t in texts])


def test_mteb_adapter_protocol_matches_jax():
    """The protocol of tests/test_eval_tasks.py::test_mteb_adapter_protocol,
    call for call against the JAX adapter."""
    calls = []
    for module in (mteb_adapter, jmteb):
        bi = FakeBi()
        m = module.MtebBiEncoder(bi, batch_size=7, query_instruction="Q: ",
                                 corpus_instruction="P: ")
        outs = [m.encode(["ab", "cdef"]), m.encode_queries(["x"], batch_size=3),
                m.encode_corpus([{"title": "T", "text": "body"}, "plain",
                                 {"title": None, "text": "only"}])]
        calls.append((bi.seen, [o.tolist() for o in outs]))
    assert calls[0] == calls[1]
    assert calls[0][0][2] == (("P: T body", "P: plain", "P: only"), 7)


def test_run_mteb_raises_import_error_without_mteb():
    try:
        import mteb  # noqa: F401

        pytest.skip("mteb is installed: the gate cannot be asserted")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="rwkv_lm_ext_tpu_torch.eval.tasks.RetrievalTask"):
        mteb_adapter.run_mteb(mteb_adapter.MtebBiEncoder(FakeBi()), ["MMarcoRetrieval"])


def test_eval_exports_match_jax():
    names = {"SimilarityEvaluator", "rerank_metrics", "retrieval_metrics"}
    assert names <= set(vars(peval)) and names <= set(vars(jeval))
    assert peval.rerank_metrics is retrieval.rerank_metrics


def test_bi_encoder_reference_switch_reaches_embed_sequences():
    """BiEncoder(reference=True) passes reference=True to embed_sequences
    (the kernels' plain versions on any device); the default passes False."""
    params, cfg = jax_params(seed=5, n_layer=1, n_embd=64, vocab_size=65536, head_size=16)
    model, tok = torch_model(params, cfg), WorldTokenizer()
    seen = []
    real = encoders.embed_sequences

    def spy(*a, **kw):
        seen.append(kw["reference"])
        return real(*a, **kw)

    with mock.patch.object(encoders, "embed_sequences", spy):
        plain = encoders.BiEncoder(model, tok, reference=True).encode_texts(["a b", "c"])
        kern = encoders.BiEncoder(model, tok).encode_texts(["a b", "c"])
    assert seen == [True, False]
    np.testing.assert_array_equal(plain, kern)     # on the CPU both run the plain versions
