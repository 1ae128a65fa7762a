"""Causal-LM, MLM, contrastive and classification losses.

Counterpart of rwkv_lm_ext_tpu/train/losses.py:21-55 (``_ce_with_ignore``,
``l2_wrap_penalty``, ``causal_lm_loss``, ``mlm_loss``): mean cross entropy
over the labels that are not -100, in fp32; the causal loss adds the L2Wrap
penalty 1e-4 * 0.5 * mean(max_logit^2). And of :58-162, the sequence-level
losses of the contrastive and reranking trainers: ``_cos_sim_matrix``,
``_cos_sim_pairwise``, ``in_batch_infonce``, ``cosent_loss`` (in its exact
form: the -1e12 mask, a zero prepended to the flattened differences, the
division by n^2 + 1), ``symmetric_infonce``, ``group_softmax_loss``,
``simcse_loss`` and ``classification_loss``.

The means over tokens or rows take an optional global denominator
(``count``, ``positions``, ``rows``): a data-parallel rank's share of the
global batch's mean (train/loop.py). The losses that couple the rows take the
global batch's embeddings instead (train/loop.py gathers them).
"""
from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def _ce_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cross entropy summed over the labels that are not -100, over
    their count, or over ``count`` when given (a data-parallel rank: the
    global batch's count, so that the ranks' terms sum to the global mean)."""
    logits = logits.float()
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / (valid.sum() if count is None else count).clamp_min(1)


def l2_wrap_penalty(logits: torch.Tensor, positions: Optional[int] = None) -> torch.Tensor:
    """Pushes down the per-position max logit (the reference's L2Wrap);
    ties share the gradient, as jnp.max's does. The mean is over the
    positions of ``logits``, or over ``positions`` (the global batch's B * T
    on a data-parallel rank)."""
    mx = logits.float().amax(dim=-1)
    if positions is None:
        return 1e-4 * 0.5 * (mx ** 2).mean()
    return 1e-4 * 0.5 * (mx ** 2).sum() / positions


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, l2_wrap: bool = True,
                   count: Optional[torch.Tensor] = None,
                   positions: Optional[int] = None) -> torch.Tensor:
    """logits (B, T, V), labels (B, T) already shifted by the collator;
    ``count`` / ``positions``: a data-parallel rank's global denominators
    (``_ce_with_ignore``, ``l2_wrap_penalty``)."""
    loss = _ce_with_ignore(logits, labels, count)
    if l2_wrap:
        loss = loss + l2_wrap_penalty(logits, positions)
    return loss


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, T, V), labels (B, T) with -100 on the unmasked positions;
    no L2Wrap; ``count``: a data-parallel rank's global count of targets."""
    return _ce_with_ignore(logits, labels, count)


def _cos_sim_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / a.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    b = b / b.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return a @ b.T


def _cos_sim_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / a.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    b = b / b.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return (a * b).sum(-1)


def _diagonal(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def in_batch_infonce(query: torch.Tensor, positive: torch.Tensor,
                     negative: Optional[torch.Tensor] = None, *, scale: float = 20.0) -> torch.Tensor:
    """Cross entropy over cos_sim(query, positives) * scale with diagonal
    targets; explicit negatives appended as one pairwise column."""
    scores = _cos_sim_matrix(query, positive) * scale
    if negative is not None:
        scores = torch.cat([scores, _cos_sim_pairwise(query, negative)[:, None] * scale], dim=1)
    return _ce_with_ignore(scores, _diagonal(scores.shape[0], scores.device))


def cosent_loss(query: torch.Tensor, positive: torch.Tensor,
                negative: Optional[torch.Tensor] = None, *, scale: float = 20.0) -> torch.Tensor:
    """CoSENT: logsumexp over the score differences of label-ordered pairs
    (positives labelled 1, negatives -1), divided by the pair count + 1."""
    scores = _cos_sim_pairwise(query, positive)
    labels = torch.ones(scores.shape[0], device=scores.device)
    if negative is not None:
        scores = torch.cat([scores, _cos_sim_pairwise(query, negative)])
        labels = torch.cat([labels, -torch.ones(negative.shape[0], device=scores.device)])
    scores = scores * scale
    diff = scores[:, None] - scores[None, :]
    order = (labels[:, None] < labels[None, :]).float()
    diff = diff - (1.0 - order) * 1e12
    flat = torch.cat([torch.zeros(1, device=diff.device, dtype=diff.dtype), diff.reshape(-1)])
    return torch.logsumexp(flat, dim=0) / flat.shape[0]


def symmetric_infonce(query: torch.Tensor, positive: torch.Tensor,
                      negative: Optional[torch.Tensor] = None, *,
                      temperature: float = 0.05) -> torch.Tensor:
    """The bi-encoder's symmetric InfoNCE: query -> candidates (positives,
    then negatives) and positive -> queries, averaged."""
    cands = positive if negative is None else torch.cat([positive, negative], dim=0)
    labels = _diagonal(query.shape[0], query.device)
    s_qc = _cos_sim_matrix(query, cands) / temperature
    s_pq = _cos_sim_matrix(positive, query) / temperature
    return 0.5 * (_ce_with_ignore(s_qc, labels) + _ce_with_ignore(s_pq, labels))


def group_softmax_loss(scores: torch.Tensor, count: Optional[int] = None) -> torch.Tensor:
    """scores (B, G), column 0 each group's positive: cross entropy with
    target 0; ``count``: a data-parallel rank's global count of groups."""
    labels = torch.zeros(scores.shape[0], dtype=torch.long, device=scores.device)
    return _ce_with_ignore(scores.float(), labels,
                           None if count is None else torch.tensor(count, device=scores.device))


def simcse_loss(emb_a: torch.Tensor, emb_b: torch.Tensor, *,
                temperature: float = 0.05) -> torch.Tensor:
    """In-batch cross entropy on cos_sim(a, b) / temperature, diagonal
    targets."""
    scores = _cos_sim_matrix(emb_a, emb_b) / temperature
    return _ce_with_ignore(scores, _diagonal(scores.shape[0], scores.device))


def classification_loss(scores: torch.Tensor, labels: torch.Tensor,
                        rows: Optional[int] = None) -> torch.Tensor:
    """MSE on the labels for (B,) scores, else cross entropy; ``rows``: a
    data-parallel rank's global row count (its share of the mean)."""
    if scores.dim() == 1:
        sq = (scores - labels.float()) ** 2
        return sq.mean() if rows is None else sq.sum() / rows
    return _ce_with_ignore(scores, labels,
                           None if rows is None else torch.tensor(rows, device=scores.device))
