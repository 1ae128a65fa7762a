"""Evaluation runners.

Counterpart of rwkv_lm_ext_tpu/eval/cli.py:22-437, the runnable equivalents
of the reference's eval entry points, with the JAX CLI's subcommands, flags
and JSON outputs:
- sts:            train_scripts/evaluators.py EmbeddingSimilarityEvaluator
                  (STS-b style tsv/jsonl: sentence1, sentence2, score)
- retrieval:      tests/test_cmteb.py / TestBiEncoder.py protocol without the
                  mteb dependency (queries + corpus + qrels)
- rerank:         train_scripts/eval_askubuntu_simcse.py MAP / P@1
- retrieval-task: an MTEB/BEIR task dump through the bi-encoder, the dense
                  top-k optionally reranked by the cross-encoder
- ppl:            token perplexity of the causal model
- parity:         the acceptance runbook: embedding cosine drift of the
                  checkpoint's own dtype on the kernel route against fp32 on
                  the kernels' plain versions (target <= 1e-3, BASELINE.md),
                  the first layer's WKV against the reference repo's torch
                  op where that repo is present, and retrieval score deltas

Usage:
  python -m rwkv_lm_ext_tpu_torch.eval.cli sts --model m.pth --data stsb.jsonl
  python -m rwkv_lm_ext_tpu_torch.eval.cli retrieval --model m.pth \\
      --queries q.jsonl --corpus docs.jsonl --qrels qrels.tsv
  python -m rwkv_lm_ext_tpu_torch.eval.cli retrieval-task --model m.pth \\
      --task-dir task/ [--score-head score.pth --rerank-top-k 10]
  python -m rwkv_lm_ext_tpu_torch.eval.cli ppl --model m.pth --data corpus.jsonl
  python -m rwkv_lm_ext_tpu_torch.eval.cli parity --model m.pth --task-dir task/

``--platform`` is the torch device: ``cuda`` by default (the command exits
when there is none), ``cpu`` only when asked, where every kernel runs its
plain version. ``--lora`` merges a LoRA adapter into the checkpoint's
weights. A ``rerank`` file holds rows of one kind: ``{"scores", "labels"}``
(metrics only) or ``{"query", "documents", "labels"}`` (scored by the
cross-encoder under ``--score-head``). The JAX CLI stops with a KeyError on
a file that mixes the two, at the first scores row it tries to score
(ROADMAP C.23); the port refuses such a file by name.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    lora_state_dict_to_tree,
    merge_lora,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_rwkv_checkpoint,
    score_head_from_state_dict,
)
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.eval.retrieval import rerank_metrics, retrieval_metrics
from rwkv_lm_ext_tpu_torch.eval.sts import SimilarityEvaluator
from rwkv_lm_ext_tpu_torch.eval.tasks import RetrievalTask, run_retrieval_task
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder, CrossEncoder
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_reference
from rwkv_lm_ext_tpu_torch.utils.device import resolve_device


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _model(args, **overrides):
    """The checkpoint on the --platform device, --lora merged in."""
    model, _ = load_rwkv_checkpoint(args.model, device=resolve_device(args.platform), **overrides)
    if args.lora:
        lc = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
        merge_lora(apply_lora(model, lc, lora_state_dict_to_tree(_load(args.lora))))
    return model


def _load_model(args):
    """(BiEncoder, model, tokenizer) on the kernel route."""
    model = _model(args)
    tok = WorldTokenizer(args.vocab)
    return BiEncoder(model, tok, pooling_type=args.pooling), model, tok


def _score_head(args, model):
    head = score_head_from_state_dict(_load(args.score_head), device=model.emb.weight.device)
    if head is None:
        raise SystemExit(f"--score-head {args.score_head} holds no score.weight")
    return head


def _rows(path):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                yield json.loads(line)
            else:
                yield line.split("\t")


def _texts(path):
    return [r["text"] if isinstance(r, dict) else r[0] for r in _rows(path)]


def cmd_sts(args):
    s1, s2, gold = [], [], []
    for row in _rows(args.data):
        if isinstance(row, dict):
            s1.append(row["sentence1"])
            s2.append(row["sentence2"])
            gold.append(float(row["score"]))
        else:
            s1.append(row[0])
            s2.append(row[1])
            gold.append(float(row[2]))
    be, *_ = _load_model(args)
    ev = SimilarityEvaluator(s1, s2, gold, csv_dir=args.output_dir)
    out = ev(lambda texts: be.encode_texts(texts, batch_size=args.batch_size))
    print(json.dumps(out, indent=2))


def cmd_retrieval(args):
    queries, corpus = _texts(args.queries), _texts(args.corpus)
    qrels = [[] for _ in queries]
    for row in _rows(args.qrels):  # qid \t docid
        if isinstance(row, dict):
            qrels[int(row["qid"])].append(int(row["docid"]))
        else:
            qrels[int(row[0])].append(int(row[1]))
    be, *_ = _load_model(args)
    q_emb = be.encode_texts(queries, batch_size=args.batch_size)
    c_emb = be.encode_texts(corpus, batch_size=args.batch_size)
    print(json.dumps(retrieval_metrics(q_emb, c_emb, qrels), indent=2))


def cmd_rerank(args):
    """jsonl rows {"scores": [...], "labels": [...]}, or {"query",
    "documents", "labels"} scored by the cross-encoder (--score-head)."""
    rows = list(_rows(args.data))
    scored = ["scores" in row for row in rows]
    if any(scored) and not all(scored):
        raise SystemExit(
            f"{args.data} mixes rows with 'scores' and rows to score ({{'query', 'documents', "
            "'labels'}}): give one kind a file")
    if all(scored):
        scores = [row["scores"] for row in rows]
    else:
        if not args.score_head:
            raise SystemExit("--score-head required to score pairs")
        _, model, tok = _load_model(args)
        ce = CrossEncoder(model, tok, _score_head(args, model))
        scores = [list(map(float, ce.score_pairs([(row["query"], d) for d in row["documents"]])))
                  for row in rows]
    labels = [row["labels"] for row in rows]
    print(json.dumps(rerank_metrics(scores, labels), indent=2))


def cmd_retrieval_task(args):
    """Run an MTEB/BEIR-format task dump (corpus.jsonl + queries.jsonl +
    qrels) through the bi-encoder, optionally reranking the dense top-k
    with the cross-encoder (tests/test_cmteb.py:92-94 protocol)."""
    task = RetrievalTask.load(args.task_dir, split=args.split)
    be, model, tok = _load_model(args)
    rerank_fn = None
    if args.score_head:
        ce = CrossEncoder(model, tok, _score_head(args, model))
        rerank_fn = ce.score_pairs
    out = run_retrieval_task(
        task,
        lambda texts: be.encode_texts(texts, batch_size=args.batch_size),
        rerank_fn=rerank_fn,
        rerank_top_k=args.rerank_top_k,
    )
    print(json.dumps(out, indent=2))


def cmd_parity(args):
    """Real-checkpoint acceptance runbook: one command that takes a .pth
    (+ optional LoRA + optional retrieval task dump) and reports, on its
    weights:

    1. embedding cosine drift: the checkpoint's own dtype on the kernel
       route against fp32 weights and compute on the kernels' plain
       versions, per text; acceptance target <= 1e-3 (BASELINE.md).
    2. the first layer's WKV on the checkpoint's activations against the
       reference repo's own torch CPU op (src/model_encoder_run.py
       run_rwkv6_forward under NO_CUDA=1), where $RWKV_REFERENCE_DIR names
       a checkout of that repo.
    3. retrieval score deltas (--task-dir): the C-MTEB-style metrics from
       both embedding sets.
    """
    tok = WorldTokenizer(args.vocab)
    be_fast = BiEncoder(_model(args), tok, pooling_type=args.pooling)
    gold_model = _model(args, dtype="float32", param_dtype="float32")
    be_gold = BiEncoder(gold_model, tok, pooling_type=args.pooling, reference=True)

    if args.task_dir:
        task = RetrievalTask.load(args.task_dir, split=args.split)
        texts = (list(task.queries.values()) + list(task.corpus.values()))[: args.max_texts]
    elif args.data:
        texts = _texts(args.data)[: args.max_texts]
    else:
        raise SystemExit("parity needs --data or --task-dir")

    e_fast = np.asarray(be_fast.encode_texts(texts, batch_size=args.batch_size), np.float32)
    e_gold = np.asarray(be_gold.encode_texts(texts, batch_size=args.batch_size), np.float32)
    cos = np.sum(e_fast * e_gold, axis=-1) / np.maximum(
        np.linalg.norm(e_fast, axis=-1) * np.linalg.norm(e_gold, axis=-1), 1e-12)
    drift = 1.0 - cos
    out = {
        "n_texts": len(texts),
        "cosine_drift_mean": float(drift.mean()),
        "cosine_drift_max": float(drift.max()),
        "target": 1e-3,
        "pass": bool(drift.max() <= 1e-3),
    }
    out["reference_wkv_op"] = _reference_wkv_crosscheck(gold_model, tok, texts[0])

    if args.task_dir:
        m_fast = run_retrieval_task(
            task, lambda t: be_fast.encode_texts(t, batch_size=args.batch_size))
        m_gold = run_retrieval_task(
            task, lambda t: be_gold.encode_texts(t, batch_size=args.batch_size))
        out["scores_fast"] = m_fast
        out["scores_gold"] = m_gold
        out["score_delta"] = {
            k: round(float(m_fast[k]) - float(m_gold[k]), 6)
            for k in m_fast
            if isinstance(m_fast.get(k), (int, float))
        }
    print(json.dumps(out, indent=2))


# what the reference's model_encoder_run reads at import, where unset
_REFERENCE_DEFAULTS = {"RWKV_MY_TESTING": "x060", "RWKV_TRAIN_TYPE": "", "RWKV_JIT_ON": "0",
                       "RWKV_FLOAT_MODE": "fp32"}


def _reference_wkv_crosscheck(model, tok, text):
    """The first layer's r, k, v, w, u on the checkpoint's activations (the
    fp32 model, plain projections) through ops.wkv_reference and through
    the reference repo's torch CPU WKV (model_encoder_run.run_rwkv6_forward,
    imported from the checkout that $RWKV_REFERENCE_DIR names); the max abs
    error, or {"skipped": ...} without that checkout. The environment variables and sys.path entry that the
    reference's import needs are restored afterwards."""
    ref = os.environ.get("RWKV_REFERENCE_DIR", "")
    if not (ref and os.path.isdir(ref)):
        return {"skipped": "reference repo not mounted"}
    cfg = model.cfg
    if cfg.version < 6:
        return {"skipped": f"v{cfg.version} checkpoint (op is v6)"}
    ids = tok.encode(text)[:64]
    with torch.inference_mode():
        toks = torch.tensor([ids], dtype=torch.int64, device=model.emb.weight.device)
        x = model.embed(toks).float()
        b0 = model.blocks[0]
        if b0.ln0 is not None:
            x = layer_norm_plain(x, b0.ln0.weight, b0.ln0.bias)
        xln = layer_norm_plain(x, b0.ln1.weight, b0.ln1.bias)
        B, T, C = xln.shape
        H, N = cfg.n_head, cfg.head_size
        r, k, v, _g, w = b0.att.projections(xln, torch.zeros(B, C, device=x.device))
        u = b0.att.time_faaaa.detach().float()
        heads = (B, T, H, N)
        y_ours, _ = wkv_reference(r.view(heads), k.view(heads), v.view(heads), w.view(heads), u)
        cpu = [t.float().cpu().contiguous().view(B, T, C) for t in (r, k, v, w)]
        u_cpu = u.cpu().contiguous().view(H, N)
    y_ours = y_ours.reshape(B, T, C).cpu().numpy()

    env = {key: os.environ.get(key, value) for key, value in _REFERENCE_DEFAULTS.items()}
    env.update(NO_CUDA="1", RWKV_HEAD_SIZE_A=str(N))
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    sys.path.insert(0, ref)
    try:
        mer = importlib.import_module("src.model_encoder_run")
        y_ref = mer.run_rwkv6_forward(*cpu, u_cpu).numpy()
    finally:
        sys.path.remove(ref)
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    err = float(np.abs(y_ours - y_ref).max())
    scale = float(np.abs(y_ref).max())
    return {"max_abs_err": err, "y_scale": scale, "rel_err": err / max(scale, 1e-12),
            "tokens": T}


def cmd_ppl(args):
    """Token perplexity over a corpus (jsonl {"text"} or plain lines): each
    piece of --ctx-len + 1 tokens padded with 0, one forward a piece, the
    NLL of its n_valid targets from an fp32 log-softmax."""
    _, model, tok = _load_model(args)
    device = model.emb.weight.device
    total_nll, total_tokens = 0.0, 0
    L = args.ctx_len
    with torch.inference_mode():
        for text in _texts(args.data):
            ids = tok.encode(text)
            for s in range(0, max(len(ids) - 1, 1), L):
                piece = ids[s: s + L + 1]
                if len(piece) < 2:
                    continue
                n_valid = len(piece) - 1
                piece = torch.tensor(piece + [0] * (L + 1 - len(piece)), device=device)
                logits, _ = model(piece[None, :-1])
                logp = torch.log_softmax(logits[0].float(), dim=-1)
                gold = logp.gather(-1, piece[1:, None])[:n_valid, 0]
                total_nll += -float(gold.sum())
                total_tokens += n_valid
    nll = total_nll / max(total_tokens, 1)
    print(json.dumps({"tokens": total_tokens, "nll_per_token": nll,
                      "perplexity": math.exp(nll)}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="rwkv_lm_ext_tpu_torch.eval")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--model", required=True)
        sp.add_argument("--vocab", default=None)
        sp.add_argument("--lora", default=None)
        sp.add_argument("--lora-r", type=int, default=8)
        sp.add_argument("--lora-alpha", type=float, default=32.0)
        sp.add_argument("--pooling", default="weightedmean")
        sp.add_argument("--batch-size", type=int, default=32)
        sp.add_argument("--output-dir", default=None)
        sp.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                        help="torch device to run on")

    s = sub.add_parser("sts"); common(s)
    s.add_argument("--data", required=True)
    s.set_defaults(fn=cmd_sts)
    s = sub.add_parser("retrieval"); common(s)
    s.add_argument("--queries", required=True)
    s.add_argument("--corpus", required=True)
    s.add_argument("--qrels", required=True)
    s.set_defaults(fn=cmd_retrieval)
    s = sub.add_parser("rerank"); common(s)
    s.add_argument("--data", required=True)
    s.add_argument("--score-head", default=None)
    s.set_defaults(fn=cmd_rerank)
    s = sub.add_parser("retrieval-task"); common(s)
    s.add_argument("--task-dir", required=True)
    s.add_argument("--split", default="test")
    s.add_argument("--score-head", default=None)
    s.add_argument("--rerank-top-k", type=int, default=10)
    s.set_defaults(fn=cmd_retrieval_task)
    s = sub.add_parser("ppl"); common(s)
    s.add_argument("--data", required=True)
    s.add_argument("--ctx-len", type=int, default=512)
    s.set_defaults(fn=cmd_ppl)

    s = sub.add_parser("parity"); common(s)
    s.add_argument("--data", default=None,
                   help="jsonl of {'text': ...} rows to embed both ways")
    s.add_argument("--task-dir", default=None,
                   help="MTEB/BEIR-format dump: also reports retrieval "
                        "score deltas between the two paths")
    s.add_argument("--split", default="test")
    s.add_argument("--max-texts", type=int, default=256)
    s.set_defaults(fn=cmd_parity)

    args = p.parse_args(argv)
    resolve_device(args.platform)
    args.fn(args)


if __name__ == "__main__":
    main()
