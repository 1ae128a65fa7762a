"""Corpus preprocessing for pretraining / MAE.

A jax-free copy of rwkv_lm_ext_tpu/data/preprocess.py:26-129 (the host-side
equivalents of the reference's data prep scripts):
- sentence splitting with zh/en punctuation rules + per-word segment ids
  for whole-word masking (data/preprocess_mae_data.py, which uses
  HarvestText/nltk; here a dependency-free splitter)
- jsonl/text/parquet corpus -> binidx files (the role of data/wikipedia.py
  + convert_2_parquet.py feeding MyDataset); parquet needs pyarrow, imported
  when such a file is read.

The binidx pair it writes is byte for byte the JAX package's on the same
corpus and tokenizer.

CLI: python -m rwkv_lm_ext_tpu_torch.data.preprocess build-binidx \
        --input corpus.jsonl --output corpus --append-eos
"""
from __future__ import annotations

import argparse
import json
import re
from typing import Iterator, List, Tuple

import numpy as np

from rwkv_lm_ext_tpu_torch.data.binidx import IndexedDatasetWriter
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer

_SENT_SPLIT = re.compile(r"(?<=[。！？!?\.;；])\s*")
_WORD = re.compile(r"[A-Za-z0-9_']+|[一-鿿]|[^\sA-Za-z0-9_']")


def split_sentences(text: str) -> List[str]:
    """Sentence split on zh/en terminal punctuation."""
    parts = [s.strip() for s in _SENT_SPLIT.split(text)]
    return [s for s in parts if s]


def word_segments(text: str) -> List[Tuple[str, int]]:
    """(piece, word_id) pairs: latin words whole, CJK per character —
    the segmentation granularity whole_word_mask expects."""
    out = []
    for wid, m in enumerate(_WORD.finditer(text)):
        out.append((m.group(0), wid))
    return out


def tokenize_with_segments(
    tokenizer, text: str
) -> Tuple[List[int], List[int]]:
    """Token ids + parallel segment ids (word membership per token) for
    whole-word masking (data/mae_dataset.py:5-22 consumers)."""
    ids: List[int] = []
    segs: List[int] = []
    for piece, wid in word_segments(text):
        piece_ids = tokenizer.encode(piece)
        ids.extend(piece_ids)
        segs.extend([wid] * len(piece_ids))
    return ids, segs


def iter_corpus(path: str, text_column: str = "text") -> Iterator[str]:
    """Yield documents from .jsonl ({"text": ...} or raw strings), .parquet
    (the reference's data/preprocess/read_parquet.py role; gated on
    pyarrow), or plain text (one doc per line)."""
    if path.endswith(".parquet"):
        import pyarrow.parquet as pq

        table = pq.read_table(path, columns=[text_column])
        for v in table.column(text_column):
            yield str(v)
        return
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                try:
                    row = json.loads(line)
                    yield row["text"] if isinstance(row, dict) else str(row)
                    continue
                except (json.JSONDecodeError, KeyError):
                    pass
            yield line


def build_binidx(
    input_path: str,
    output_prefix: str,
    tokenizer=None,
    *,
    append_eos: bool = True,
    eos_id: int = 0,
    dtype=np.uint16,
) -> int:
    """Tokenize a corpus into a binidx pair; returns total tokens."""
    if tokenizer is None:
        tokenizer = WorldTokenizer()
    total = 0
    with IndexedDatasetWriter(output_prefix, dtype=dtype) as w:
        for doc in iter_corpus(input_path):
            ids = tokenizer.encode(doc)
            if append_eos:
                ids = ids + [eos_id]
            w.add_document(ids)
            total += len(ids)
    return total


def main(argv=None):
    p = argparse.ArgumentParser(prog="rwkv_lm_ext_tpu_torch.data.preprocess")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build-binidx")
    b.add_argument("--input", required=True)
    b.add_argument("--output", required=True)
    b.add_argument("--vocab", default=None)
    b.add_argument("--append-eos", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "build-binidx":
        n = build_binidx(
            args.input, args.output,
            WorldTokenizer(args.vocab),
            append_eos=args.append_eos,
        )
        print(f"wrote {n} tokens to {args.output}.bin/.idx")


if __name__ == "__main__":
    main()
