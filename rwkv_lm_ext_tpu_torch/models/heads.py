"""Sequence-embedding and MLM heads.

Counterpart of rwkv_lm_ext_tpu/models/heads.py:26-102
(first_token_position, pool_hidden, embed_sequences) and :134-147
(mlm_logits).
"""
from __future__ import annotations

from typing import Optional

import torch

from rwkv_lm_ext_tpu_torch.config import EMB_ID


def first_token_position(tokens: torch.Tensor, token_id: int) -> torch.Tensor:
    """Index of the first occurrence of token_id per row (0 if absent)."""
    return torch.argmax((tokens == token_id).to(torch.int32), dim=-1)


def pool_hidden(
    x: torch.Tensor, actual_len: torch.Tensor, pooling_type: str = "weightedmean"
) -> torch.Tensor:
    """Pool (B, T, C) hidden states to (B, C) fp32.

    `actual_len` is the first-emb_id position. "weightedmean" is the
    training-side pooling (the default everywhere); "weightedmean_runtime"
    the streaming runtime's off-by-one variant (actual_len + 1 in the mask,
    the weight denominator and the divisor); "lasttoken" takes the row at
    actual_len; "avg" averages the rows before it.
    """
    B, T, C = x.shape
    xf = x.float()
    pos = torch.arange(T, device=x.device)[None, :]
    ramp = torch.arange(1, T + 1, device=x.device, dtype=torch.float32)[None, :]
    L = actual_len[:, None].float()
    if pooling_type == "weightedmean":
        mask = (pos <= actual_len[:, None]).float()
        return torch.sum(xf * ((ramp / L) * mask)[..., None], dim=1) / L
    if pooling_type == "weightedmean_runtime":
        L1 = L + 1.0
        mask = (pos <= actual_len[:, None] + 1).float()
        return torch.sum(xf * ((ramp / L1) * mask)[..., None], dim=1) / L1
    if pooling_type == "lasttoken":
        return xf[torch.arange(B, device=x.device), actual_len]
    if pooling_type == "avg":
        mask = (pos < actual_len[:, None]).float()
        return torch.sum(xf * mask[..., None], dim=1) / L
    raise ValueError(f"unknown pooling_type {pooling_type!r}")


def embed_sequences(
    model,
    tokens: torch.Tensor,
    *,
    pooling_type: str = "weightedmean",
    embedding_id: int = EMB_ID,
    normalize: bool = False,
    reference: bool = False,
) -> torch.Tensor:
    """(B, T) token ids (emb_id-terminated, pad-padded) -> (B, C) fp32
    embeddings, L2-normalised when `normalize`. `reference` is passed to
    the model (plain versions of the kernels)."""
    hidden, _ = model(
        tokens, return_hidden=True, return_logits=False, reference=reference
    )
    emb = pool_hidden(hidden, first_token_position(tokens, embedding_id), pooling_type)
    if normalize:
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return emb


def mlm_logits(
    model, hidden: torch.Tensor, *, share_emb: bool = True,
    lm_head: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MLM prediction head in fp32: tied to the embedding matrix
    (hidden @ emb.T), or a separate (C, V) projection ``lm_head``."""
    if share_emb:
        return hidden.float() @ model.emb.weight.float().T
    if lm_head is None:
        raise ValueError("share_emb=False needs lm_head")
    return hidden.float() @ lm_head.float()
