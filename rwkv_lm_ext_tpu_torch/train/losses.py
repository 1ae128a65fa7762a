"""Causal-LM and MLM losses.

Counterpart of rwkv_lm_ext_tpu/train/losses.py:21-55 (``_ce_with_ignore``,
``l2_wrap_penalty``, ``causal_lm_loss``, ``mlm_loss``): mean cross entropy
over the labels that are not -100, in fp32; the causal loss adds the L2Wrap
penalty 1e-4 * 0.5 * mean(max_logit^2). The contrastive losses wait for
their trainers.
"""
from __future__ import annotations

import torch

IGNORE_INDEX = -100


def _ce_with_ignore(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp_min(1)


def l2_wrap_penalty(logits: torch.Tensor) -> torch.Tensor:
    """Pushes down the per-position max logit (the reference's L2Wrap);
    ties share the gradient, as jnp.max's does."""
    mx = logits.float().amax(dim=-1)
    return 1e-4 * 0.5 * (mx ** 2).mean()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, l2_wrap: bool = True) -> torch.Tensor:
    """logits (B, T, V), labels (B, T) already shifted by the collator."""
    loss = _ce_with_ignore(logits, labels)
    if l2_wrap:
        loss = loss + l2_wrap_penalty(logits)
    return loss


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, T, V), labels (B, T) with -100 on the unmasked positions;
    no L2Wrap."""
    return _ce_with_ignore(logits, labels)
