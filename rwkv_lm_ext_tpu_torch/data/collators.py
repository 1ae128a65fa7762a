"""Batch collators (host-side numpy -> fixed-shape arrays).

A jax-free copy of the SFT collator of rwkv_lm_ext_tpu/data/collators.py
(``sft_collate``, :25-53, without the slot-LoRA adapter ids). The triplet,
cross-encoder, MLM and MAE collators wait for their trainers.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from rwkv_lm_ext_tpu_torch.config import PAD_ID

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
