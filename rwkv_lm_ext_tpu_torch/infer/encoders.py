"""Serving encoders: bi-encoder, cross-encoder, multi-adapter fusion.

Counterpart of rwkv_lm_ext_tpu/infer/encoders.py:24-236 (_bucketize,
_pad_batch, BiEncoder, CrossEncoder, BiCrossFusionEncoder). Batches are
padded to a bucket length, as in the JAX package, so the kernels see a
handful of shapes. ``BiCrossFusionEncoder`` serves embedding, reranking and
chat off one base model with a LoRA adapter each: every adapter merges into
its own copy of the base (adapters.registry), so the three interleave
without switching module state.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import Adapter, LoraConfig
from rwkv_lm_ext_tpu_torch.adapters.registry import AdapterRegistry
from rwkv_lm_ext_tpu_torch.config import CLS_ID, EMB_ID, PAD_ID, SEP_ID
from rwkv_lm_ext_tpu_torch.models.heads import (
    DenseHead,
    ScoreHead,
    classify_sequences,
    embed_sequences,
)

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
# the longest q + d a pair keeps, with [SEP] and [CLS] the largest bucket
PAIR_BUDGET = 2046


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


def _batches(ids: List[List[int]], batch_size: int):
    """(B, bucket) int64 arrays of `ids`, batch_size rows each."""
    for s in range(0, len(ids), batch_size):
        batch = ids[s: s + batch_size]
        yield pad_batch(batch, bucketize(batch))


class BiEncoder:
    """Append emb_id to each text, run the model, pool at the first emb_id
    (weightedmean by default), apply the optional dense+tanh ``head`` and
    L2-normalise. ``reference=True`` runs the kernels' plain versions, the
    counterpart of the JAX ``BiEncoder(wkv_backend="reference")`` that
    ``eval.cli parity`` builds for its fp32 side."""

    def __init__(self, model, tokenizer, *, head: Optional[DenseHead] = None,
                 pooling_type: str = "weightedmean", reference: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.head = head
        self.pooling_type = pooling_type
        self.reference = reference
        self.device = model.emb.weight.device

    def token_batches(self, texts: Sequence[str], *, batch_size: int = 32):
        """Padded (B, L) int64 arrays, one per forward encode_texts runs."""
        return _batches([self.tokenizer.encode(t)[:2047] + [EMB_ID] for t in texts], batch_size)

    def encode_texts(self, texts: Sequence[str], *, batch_size: int = 32) -> np.ndarray:
        chunks = []
        with torch.inference_mode():
            for arr in self.token_batches(texts, batch_size=batch_size):
                emb = embed_sequences(
                    self.model, torch.from_numpy(arr).to(self.device), head=self.head,
                    pooling_type=self.pooling_type, normalize=True, reference=self.reference,
                )
                chunks.append(emb.cpu().numpy())
        return np.concatenate(chunks, axis=0)


def pair_ids(tokenizer, query: str, document: str) -> List[int]:
    """``q [SEP] d [CLS]``, the document cut first (then the query) to keep
    q + d within PAIR_BUDGET tokens."""
    qi, di = tokenizer.encode(query), tokenizer.encode(document)
    if len(qi) + len(di) > PAIR_BUDGET:
        di = di[: max(PAIR_BUDGET - len(qi), 0)]
        qi = qi[: PAIR_BUDGET - len(di)]
    return qi + [SEP_ID] + di + [CLS_ID]


class CrossEncoder:
    """(query, document) -> relevance score: ``q [SEP] d [CLS]``, the score
    head at the cls position, fp32."""

    def __init__(self, model, tokenizer, score: ScoreHead):
        self.model = model
        self.tokenizer = tokenizer
        self.score = score
        self.device = model.emb.weight.device

    def token_batches(self, pairs: Sequence[Tuple[str, str]], *, batch_size: int = 32):
        """Padded (B, L) int64 arrays, one per forward score_pairs runs."""
        return _batches([pair_ids(self.tokenizer, q, d) for q, d in pairs], batch_size)

    def score_pairs(self, pairs: Sequence[Tuple[str, str]], *, batch_size: int = 32) -> np.ndarray:
        outs = []
        with torch.inference_mode():
            for arr in self.token_batches(pairs, batch_size=batch_size):
                sc = classify_sequences(self.model, torch.from_numpy(arr).to(self.device),
                                        self.score)
                outs.append(sc.cpu().numpy())
        return np.concatenate(outs, axis=0)


class BiCrossFusionEncoder:
    """One base model and named adapters for embedding, reranking and chat:
    ``bi_embedding_lora``, ``cross_encoder_lora`` and ``chat_lora`` in an
    AdapterRegistry, each served from its merged copy ("default", the bare
    base, where an adapter is not given). The cross-encoder exists when a
    score head is given; the chat engine is built on first use."""

    def __init__(
        self,
        base_model,
        tokenizer,
        *,
        bi_adapter: Optional[Adapter] = None,
        bi_lora_cfg: Optional[LoraConfig] = None,
        bi_head: Optional[DenseHead] = None,
        cross_adapter: Optional[Adapter] = None,
        cross_lora_cfg: Optional[LoraConfig] = None,
        score: Optional[ScoreHead] = None,
        chat_adapter: Optional[Adapter] = None,
        chat_lora_cfg: Optional[LoraConfig] = None,
        pooling_type: str = "weightedmean",
    ):
        self.tokenizer = tokenizer
        self.registry = AdapterRegistry(base_model)
        names: Dict[str, str] = {}
        for role, name, adapter, lc in (
            ("bi", "bi_embedding_lora", bi_adapter, bi_lora_cfg),
            ("cross", "cross_encoder_lora", cross_adapter, cross_lora_cfg),
            ("chat", "chat_lora", chat_adapter, chat_lora_cfg),
        ):
            if adapter is not None:
                self.registry.register(name, adapter, lc or LoraConfig())
            names[role] = name if adapter is not None else "default"
        self._bi = BiEncoder(self.registry.materialize(names["bi"]), tokenizer, head=bi_head,
                             pooling_type=pooling_type)
        self._cross = (CrossEncoder(self.registry.materialize(names["cross"]), tokenizer, score)
                       if score is not None else None)
        self._chat_model = self.registry.materialize(names["chat"])
        self._engine = None

    def encode_texts(self, texts, **kw) -> np.ndarray:
        return self._bi.encode_texts(texts, **kw)

    def cross_encode_texts(self, pairs, **kw) -> np.ndarray:
        if self._cross is None:
            raise ValueError("no cross-encoder score head loaded")
        return self._cross.score_pairs(pairs, **kw)

    def _chat_engine(self):
        if self._engine is None:
            from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine

            self._engine = GenerationEngine(self._chat_model, self.tokenizer)
        return self._engine

    def sampling_generate(self, prompt: str, **kw) -> str:
        return self._chat_engine().generate(prompt, **kw)

    def beam_generate(self, prompt: str, **kw):
        """[(score, text), ...] of infer.beam.generate_beamsearch, best
        first; ``beam_params`` (a BeamParams) among the keywords."""
        from rwkv_lm_ext_tpu_torch.infer.beam import BeamParams, generate_beamsearch

        bp = kw.pop("beam_params", BeamParams())
        out = generate_beamsearch(self._chat_engine(), prompt, bp, **kw)
        return [(score, self.tokenizer.decode(ids)) for score, ids in out]
