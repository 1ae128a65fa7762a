"""AllNLI / STS-benchmark TSV loaders for the NLI contrastive trainer.

A copy of rwkv_lm_ext_tpu/data/nli.py:20-71 (``load_allnli_triplets``,
``load_stsb_pairs``), which imports no JAX; the port keeps its own so that
it imports nothing of the JAX package. The reference NLI trainer's data
preparation (train_scripts/train_nli.py:218-289): AllNLI rows are
grouped by anchor sentence, anchors with at least one entailment AND one
contradiction hypothesis become {"query", "positive", "negative"}
triplets (one of each, chosen pseudo-randomly), deduplicated; the
STS-benchmark dev split provides (sentence1, sentence2, score/5.0) for
per-evaluation Spearman/Pearson validation.
"""
from __future__ import annotations

import csv
import json
import random
from typing import Dict, List, Tuple

_LABELS = ("contradiction", "entailment", "neutral")


def load_allnli_triplets(
    path: str, *, seed: int = 0, split: str = "train"
) -> List[Dict[str, str]]:
    """AllNLI.tsv (columns split/sentence1/sentence2/label) -> triplets."""
    data: Dict[str, Dict[str, List[str]]] = {}
    with open(path, encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        for row in reader:
            if row["split"] != split:
                continue
            s1 = row["sentence1"].strip()
            s2 = row["sentence2"].strip()
            label = row["label"].strip()
            if label not in _LABELS:
                continue
            group = data.setdefault(s1, {k: [] for k in _LABELS})
            if s2 not in group[label]:
                group[label].append(s2)
    rng = random.Random(seed)
    out: List[Dict[str, str]] = []
    seen = set()
    for s1, group in data.items():
        if group["entailment"] and group["contradiction"]:
            triplet = {
                "query": s1,
                "positive": rng.choice(group["entailment"]),
                "negative": rng.choice(group["contradiction"]),
            }
            key = json.dumps(triplet, sort_keys=True)
            if key not in seen:
                seen.add(key)
                out.append(triplet)
    return out


def load_stsb_pairs(
    path: str, *, split: str = "dev"
) -> Tuple[List[str], List[str], List[float]]:
    """stsbenchmark.tsv -> (sentences1, sentences2, gold scores in [0,1])."""
    s1: List[str] = []
    s2: List[str] = []
    gold: List[float] = []
    with open(path, encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        for row in reader:
            if row["split"] != split:
                continue
            s1.append(row["sentence1"])
            s2.append(row["sentence2"])
            gold.append(float(row["score"]) / 5.0)
    return s1, s2, gold
