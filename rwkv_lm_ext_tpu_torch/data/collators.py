"""Batch collators (host-side numpy -> fixed-shape arrays).

Jax-free copies of collators of rwkv_lm_ext_tpu/data/collators.py:
``sft_collate`` (:25-53, without the slot-LoRA adapter ids),
``whole_word_mask`` (:115), ``mlm_collate`` (:130) and ``mae_collate``
(:171). The masking collators make the same ``np.random.default_rng(seed)``
draws in the same order as the originals, so both packages mask the same
tokens for a seed. The triplet and cross-encoder collators wait for their
trainers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rwkv_lm_ext_tpu_torch.config import EOS_ID, MASK_ID, PAD_ID

IGNORE = -100


def _pad_to(ids: Sequence[int], length: int, pad: int) -> np.ndarray:
    out = np.full(length, pad, np.int32)
    n = min(len(ids), length)
    out[:n] = np.asarray(ids[:n], np.int32)
    return out


def sft_collate(examples: List[Dict], fixed_len: int, *, pad_id: int = PAD_ID) -> Dict[str, np.ndarray]:
    """examples: {"input_ids", "labels"} (labels -100 over the prompt) ->
    {"input_ids", "labels"} (B, fixed_len) int32, labels shifted so that
    labels[t] is the target of the logits at t."""
    input_ids = np.stack([_pad_to(e["input_ids"], fixed_len, pad_id) for e in examples])
    labels_raw = np.stack([_pad_to(e["labels"], fixed_len, IGNORE) for e in examples])
    labels = np.full_like(labels_raw, IGNORE)
    labels[:, :-1] = labels_raw[:, 1:]
    return {"input_ids": input_ids, "labels": labels}


def whole_word_mask(
    lengths_ok: int, segment_ids: Sequence[int], mask_prob: float, rng: np.random.Generator
) -> np.ndarray:
    """Mask whole words: segment_ids give each token's word (negative = no
    word). Returns a bool mask over the sequence."""
    seg = np.asarray(segment_ids)
    words = np.unique(seg[seg >= 0])
    n_mask = max(1, int(round(len(words) * mask_prob)))
    chosen = rng.choice(words, size=min(n_mask, len(words)), replace=False)
    return np.isin(seg, chosen)


def mlm_collate(
    examples: List[Dict], fixed_len: int, *, mask_prob: float = 0.15, mask_id: int = MASK_ID,
    pad_id: int = PAD_ID, emb_id: Optional[int] = None, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """{"input_ids", optional "segment_ids"} -> {"input_ids" with mask_id on
    the masked positions, "labels" with -100 on the others}, (B, fixed_len)
    int32; whole-word masking when segments are given. With emb_id every row
    ends in it, and it is never masked."""
    rng = np.random.default_rng(seed)
    ids_rows, label_rows = [], []
    for e in examples:
        ids = list(e["input_ids"])[:fixed_len]
        if emb_id is not None and (not ids or ids[-1] != emb_id):
            ids = ids[: fixed_len - 1] + [emb_id]
        ids_arr = _pad_to(ids, fixed_len, pad_id)
        n = len(ids)
        mask = np.zeros(fixed_len, bool)
        if "segment_ids" in e:
            mask[:n] = whole_word_mask(n, list(e["segment_ids"])[:n], mask_prob, rng)
        else:
            mask[:n] = rng.random(n) < mask_prob
            if not mask[:n].any():
                mask[int(rng.integers(n))] = True
        if emb_id is not None:
            mask &= ids_arr != emb_id
        label_rows.append(np.where(mask, ids_arr, IGNORE).astype(np.int32))
        ids_rows.append(np.where(mask, mask_id, ids_arr).astype(np.int32))
    return {"input_ids": np.stack(ids_rows), "labels": np.stack(label_rows)}


def mae_collate(
    examples: List[Dict], fixed_len: int, *, encoder_mask_prob: float = 0.3,
    decoder_mask_prob: float = 0.5, mask_id: int = MASK_ID, pad_id: int = PAD_ID,
    emb_id: int = EOS_ID, bag_of_words: bool = False, vocab_size: Optional[int] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """RetroMAE's two views: an encoder view (``mlm_collate`` at
    encoder_mask_prob, labels on the masked positions) and a decoder view
    masked at a higher rate with labels on every real token. bag_of_words adds
    the DupMAE target, each row's token distribution over the vocabulary. The
    two views draw from two generators seeded alike, as in the original."""
    rng = np.random.default_rng(seed)
    enc = mlm_collate(examples, fixed_len, mask_prob=encoder_mask_prob, mask_id=mask_id,
                      pad_id=pad_id, emb_id=emb_id, seed=seed)
    dec_rows, dec_labels, bow = [], [], []
    for e in examples:
        ids = list(e["input_ids"])[: fixed_len - 1] + [emb_id]
        arr = _pad_to(ids, fixed_len, pad_id)
        n = len(ids)
        mask = np.zeros(fixed_len, bool)
        mask[:n] = rng.random(n) < decoder_mask_prob
        mask &= arr != emb_id
        dec_rows.append(np.where(mask, mask_id, arr).astype(np.int32))
        dec_labels.append(np.where(arr != pad_id, arr, IGNORE).astype(np.int32))
        if bag_of_words:
            if vocab_size is None:
                raise ValueError("bag_of_words needs vocab_size")
            weights = np.zeros(vocab_size, np.float32)
            uniq, cnt = np.unique([t for t in ids if t not in (pad_id, emb_id)],
                                  return_counts=True)
            if cnt.sum() > 0:
                weights[uniq.astype(np.int64)] = cnt / cnt.sum()
            bow.append(weights)
    out = {
        "encoder_input_ids": enc["input_ids"], "encoder_labels": enc["labels"],
        "decoder_input_ids": np.stack(dec_rows), "decoder_labels": np.stack(dec_labels),
    }
    if bag_of_words:
        out["bag_word_weight"] = np.stack(bow)
    return out
