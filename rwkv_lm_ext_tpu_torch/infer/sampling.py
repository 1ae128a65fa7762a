"""Sampling on device: penalties, filters and the categorical draw.

Counterpart of rwkv_lm_ext_tpu/infer/sampling.py:18-128 and 248-272
(SamplingParams, apply_top_k, apply_top_p, apply_top_p_bisect,
apply_repetition_penalty, penalize_and_filter, sample_inverse_cdf,
sample_token) on (V,) or (B, V) tensors. Nothing here reads a value back to
the host, so a decode loop runs without a sync per token. The per-row
(per-slot) variants wait for the continuous batcher.

Randomness comes from an explicit ``torch.Generator``. Each draw is split
into drawing the noise (``draw_noise``: one uniform per row for "invcdf",
V Gumbel values per row for "gumbel") and picking the token given it
(``pick_token``), so tests can feed JAX's own noise to the pick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 0.85
    top_k: int = 0                 # 0 = disabled
    alpha_presence: float = 0.25   # occurrence presence penalty
    alpha_frequency: float = 0.25  # occurrence frequency penalty
    alpha_decay: float = 0.996     # per-step decay of occurrence counts
    repetition_penalty: float = 1.0
    token_ban: Tuple[int, ...] = ()
    token_stop: Tuple[int, ...] = (0,)
    top_p_impl: str = "sort"       # "sort" (exact) | "bisect"
    categorical_impl: str = "gumbel"   # "gumbel" | "invcdf"


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the tokens whose probability is at least the
    one at which the descending cumulative mass first reaches p."""
    if p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cdf = torch.cumsum(sorted_probs, dim=-1)
    idx = torch.argmax((cdf >= p).to(torch.int32), dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_probs, -1, idx)
    return torch.where(probs < cutoff, NEG_INF, logits)


def apply_top_p_bisect(logits: torch.Tensor, p: float, *, iters: int = 24) -> torch.Tensor:
    """Sort-free nucleus filtering: bisect the probability cutoff."""
    if p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    lo = torch.zeros(probs.shape[:-1] + (1,), dtype=probs.dtype, device=probs.device)
    hi = probs.amax(-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid, probs, 0.0).sum(-1, keepdim=True)
        up = mass >= p
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return torch.where(probs >= lo, logits, NEG_INF)


def apply_repetition_penalty(
    logits: torch.Tensor, occurrences: torch.Tensor, penalty: float
) -> torch.Tensor:
    """Seen tokens' positive logits divided by penalty, negative multiplied."""
    if penalty == 1.0:
        return logits
    scaled = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(occurrences > 0, scaled, logits)


def penalize_and_filter(
    logits: torch.Tensor, occurrences: torch.Tensor, sp: SamplingParams
) -> torch.Tensor:
    logits = logits.float()
    if sp.token_ban:
        logits = logits.clone()
        logits[..., list(sp.token_ban)] = NEG_INF
    logits = (
        logits
        - sp.alpha_presence * (occurrences > 0).float()
        - sp.alpha_frequency * occurrences
    )
    logits = apply_repetition_penalty(logits, occurrences, sp.repetition_penalty)
    logits = apply_top_k(logits, sp.top_k)
    if sp.top_p_impl == "bisect":
        return apply_top_p_bisect(logits, sp.top_p)
    return apply_top_p(logits, sp.top_p)


def inverse_cdf_pick(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The token whose cumulative probability first exceeds u (..., 1) in
    [0, 1), renormalised against the cumsum's rounding."""
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    u = u * cdf[..., -1:]
    token = (cdf < u).sum(-1)
    return token.clamp_max(logits.shape[-1] - 1)


def sample_inverse_cdf(
    logits: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """Categorical draw with one uniform per row."""
    u = torch.rand(logits.shape[:-1] + (1,), generator=generator, device=logits.device)
    return inverse_cdf_pick(logits, u)


def draw_noise(
    sp: SamplingParams, shape, generator: torch.Generator, device
) -> Optional[torch.Tensor]:
    """The random numbers one sample_token draw consumes for logits of
    ``shape``: None for greedy (temperature 0), one uniform per row for
    "invcdf", a Gumbel value per logit for "gumbel"."""
    if sp.temperature == 0.0:
        return None
    if sp.categorical_impl == "invcdf":
        return torch.rand(tuple(shape[:-1]) + (1,), generator=generator, device=device)
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def pick_token(
    filtered: torch.Tensor, noise: Optional[torch.Tensor], sp: SamplingParams
) -> torch.Tensor:
    """The sampled token given the filtered logits and draw_noise's noise."""
    if sp.temperature != 1.0:
        filtered = filtered / max(sp.temperature, 1e-6)
    if sp.temperature == 0.0:
        return torch.argmax(filtered, dim=-1)
    if sp.categorical_impl == "invcdf":
        return inverse_cdf_pick(filtered, noise)
    return torch.argmax(filtered + noise, dim=-1)


def sample_token(
    logits: torch.Tensor,
    occurrences: torch.Tensor,
    sp: SamplingParams,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One penalize -> filter -> sample step on (V,) or (B, V) logits.
    Returns (token () or (B,) int64, new occurrences); all on the device."""
    filtered = penalize_and_filter(logits, occurrences, sp)
    noise = draw_noise(sp, filtered.shape, generator, filtered.device)
    token = pick_token(filtered, noise, sp)
    occ = occurrences * sp.alpha_decay
    occ.scatter_add_(-1, token.unsqueeze(-1), torch.ones_like(occ[..., :1]))
    return token, occ
