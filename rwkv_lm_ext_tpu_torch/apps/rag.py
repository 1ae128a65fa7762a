"""Retrieval-augmented chat over a local corpus.

Counterpart of rwkv_lm_ext_tpu/apps/rag.py:16-102 (LocalRetriever, RagChat,
main), the reference's gui/ demo (PySimpleGUI window + selenium Baidu-Baike
scraping, gui/main.py + retreiver.py + browser.py) without a browser: a
local document corpus embedded by the port's ``BiEncoder``, cosine
retrieval, and the retrieved passages prepended to the chat prompt, which
the port's ``GenerationEngine.generate`` answers. Runs as a terminal chat:

  python -m rwkv_lm_ext_tpu_torch.apps.rag --model m.pth --corpus docs.txt \\
      [--platform cuda|cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np

from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.utils.device import resolve_device


class LocalRetriever:
    """Embed a corpus once; retrieve top-k passages by cosine similarity
    (the retreiver.py role, with a corpus instead of a scraper)."""

    def __init__(self, bi_encoder, documents: Sequence[str]):
        self.bi = bi_encoder
        self.documents = list(documents)
        self._emb = (
            bi_encoder.encode_texts(self.documents)
            if self.documents
            else np.zeros((0, 1), np.float32)
        )

    def add(self, documents: Sequence[str]) -> None:
        new = self.bi.encode_texts(list(documents))
        self.documents.extend(documents)
        self._emb = (
            np.concatenate([self._emb, new], axis=0)
            if self._emb.size
            else new
        )

    def retrieve(self, query: str, k: int = 3) -> List[Tuple[float, str]]:
        if not self.documents:
            return []
        q = self.bi.encode_texts([query])[0]
        sims = self._emb @ q
        order = np.argsort(-sims)[:k]
        return [(float(sims[i]), self.documents[i]) for i in order]


RAG_TEMPLATE = (
    "🐱:According to the following information:\n{context}\n"
    "Answer the question: {question}\n🤖:"
)


class RagChat:
    """Retrieve-then-generate QA (gui/main.py's QA window flow)."""

    def __init__(self, engine, retriever: LocalRetriever, *, top_k: int = 3):
        self.engine = engine
        self.retriever = retriever
        self.top_k = top_k

    def answer(self, question: str, **gen_kw) -> Tuple[str, List[str]]:
        hits = self.retriever.retrieve(question, self.top_k)
        context = "\n".join(doc for _score, doc in hits)
        prompt = RAG_TEMPLATE.format(context=context, question=question)
        out = self.engine.generate(prompt, **gen_kw)
        return out, [doc for _s, doc in hits]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="rwkv_lm_ext_tpu_torch.apps.rag")
    p.add_argument("--model", required=True)
    p.add_argument("--corpus", required=True, help="one document per line")
    p.add_argument("--max-tokens", type=int, default=200)
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="torch device to run on")
    args = p.parse_args(argv)
    model, _ = load_rwkv_checkpoint(args.model, device=resolve_device(args.platform))
    tok = WorldTokenizer()
    with open(args.corpus, encoding="utf-8") as f:
        docs = [line.strip() for line in f if line.strip()]
    chat = RagChat(GenerationEngine(model, tok), LocalRetriever(BiEncoder(model, tok), docs))
    print("RAG chat ready. Empty line to exit.")
    while True:
        q = input("you> ").strip()
        if not q:
            break
        answer, sources = chat.answer(q, max_tokens=args.max_tokens)
        print(f"bot> {answer}")
        for s in sources:
            print(f"  [src] {s[:80]}")


if __name__ == "__main__":
    main()
