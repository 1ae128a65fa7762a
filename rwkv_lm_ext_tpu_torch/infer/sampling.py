"""Sampling on device: penalties, filters and the categorical draw.

Counterpart of rwkv_lm_ext_tpu/infer/sampling.py:131-245, the per-row
variants (SLOT_PARAM_FIELDS, slot_params, apply_top_p_rows,
apply_top_p_bisect_rows, sample_token_rows) on (B, V) tensors, whose
per-request knobs live in (B,) device rows, with SamplingParams, apply_top_k
and the inverse-CDF pick of :18-128. The port's engine and batcher both
sample per row, so the whole-batch functions of :18-128 and 248-272
(penalize_and_filter, sample_token, ...) have no counterpart: a batch that
shares its knobs fills every row with them. Nothing here reads a value back
to the host, so a decode loop runs without a sync per token and can be
captured in a CUDA graph.

Randomness comes from an explicit ``torch.Generator``. Each draw is split
into drawing the noise (``draw_noise_rows``: one uniform per row for
"invcdf", V Gumbel values per row for "gumbel") and picking the token given
it (``pick_token_rows``), so tests can feed JAX's own noise to the pick.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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


def _ban(logits: torch.Tensor, ban) -> torch.Tensor:
    """-inf at the banned ids, one fill each: indexing by a list would copy
    the ids to the device, which a CUDA graph capture refuses."""
    logits = logits.clone()
    for t in ban:
        logits[..., t] = NEG_INF
    return logits


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def inverse_cdf_pick(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The token whose cumulative probability first exceeds u (..., 1) in
    [0, 1), renormalised against the cumsum's rounding."""
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    u = u * cdf[..., -1:]
    token = (cdf < u).sum(-1)
    return token.clamp_max(logits.shape[-1] - 1)


# -- per-row (per-slot) sampling --------------------------------------------
#
# The continuous batcher decodes every slot through one step, so the scalar
# knobs of each request live in (B,) device rows, written at admission.
# Batcher-global knobs: top_k, token_ban, top_p_impl, categorical_impl (they
# shape the step); token_stop and max_tokens are per request on the host.

SLOT_PARAM_FIELDS = (
    "temperature", "top_p", "alpha_presence", "alpha_frequency",
    "alpha_decay", "repetition_penalty",
)
GLOBAL_KNOBS = ("top_k", "token_ban", "top_p_impl", "categorical_impl")


def global_knobs(sp: SamplingParams) -> tuple:
    """The knobs that shape a batched step: requests that share them share
    its code (a CUDA graph), whatever their per-row knobs."""
    return tuple(getattr(sp, f) for f in GLOBAL_KNOBS)

Rows = Dict[str, torch.Tensor]


def slot_params(n: int, sp: SamplingParams, *, device) -> Rows:
    """(n,) fp32 rows of the per-row knobs, filled from sp."""
    return {f: torch.full((n,), float(getattr(sp, f)), dtype=torch.float32, device=device)
            for f in SLOT_PARAM_FIELDS}


def apply_top_p_rows(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """apply_top_p with a per-row nucleus mass p (B,). A row with p >= 1, or
    whose fp32 cumulative mass never reaches p, keeps every token."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cdf = torch.cumsum(sorted_probs, dim=-1)
    pc = p[:, None]
    idx = torch.argmax((cdf >= pc).to(torch.int32), dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_probs, -1, idx)
    keep_all = (pc >= 1.0) | (cdf[..., -1:] < pc)
    cutoff = torch.where(keep_all, 0.0, cutoff)
    return torch.where(probs < cutoff, NEG_INF, logits)


def apply_top_p_bisect_rows(logits: torch.Tensor, p: torch.Tensor, *, iters: int = 24
                            ) -> torch.Tensor:
    """apply_top_p_bisect with a per-row p (B,); rows with p >= 1 converge
    to the cutoff 0 and keep every token."""
    probs = torch.softmax(logits, dim=-1)
    pc = p[:, None]
    lo = torch.zeros(probs.shape[:-1] + (1,), dtype=probs.dtype, device=probs.device)
    hi = probs.amax(-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid, probs, 0.0).sum(-1, keepdim=True)
        up = mass >= pc
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return torch.where(probs >= lo, logits, NEG_INF)


def penalize_and_filter_rows(
    logits: torch.Tensor, occurrences: torch.Tensor, rows: Rows, sp: SamplingParams
) -> torch.Tensor:
    """The penalties and filters of sample_token_rows: (B, V) fp32."""
    logits = logits.float()
    if sp.token_ban:
        logits = _ban(logits, sp.token_ban)
    seen = occurrences > 0
    logits = (
        logits
        - rows["alpha_presence"][:, None] * seen.float()
        - rows["alpha_frequency"][:, None] * occurrences
    )
    rp = rows["repetition_penalty"][:, None]
    scaled = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen, scaled, logits)
    logits = apply_top_k(logits, sp.top_k)
    if sp.top_p_impl == "bisect":
        return apply_top_p_bisect_rows(logits, rows["top_p"])
    return apply_top_p_rows(logits, rows["top_p"])


def draw_noise_rows(sp: SamplingParams, shape, generator: torch.Generator, device) -> torch.Tensor:
    """The noise of one sample_token_rows draw: always drawn, since any row
    may sample (one uniform per row for "invcdf", a Gumbel value per logit
    for "gumbel")."""
    if sp.categorical_impl == "invcdf":
        return torch.rand(tuple(shape[:-1]) + (1,), generator=generator, device=device)
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def pick_token_rows(filtered: torch.Tensor, noise: torch.Tensor, rows: Rows,
                    sp: SamplingParams) -> torch.Tensor:
    """Per-row tokens given the filtered logits and draw_noise_rows' noise:
    rows at temperature 0 take the argmax of the filtered logits, the others
    sample from them at their temperature."""
    t = rows["temperature"][:, None]
    tempered = filtered / t.clamp_min(1e-6)
    if sp.categorical_impl == "invcdf":
        sampled = inverse_cdf_pick(tempered, noise)
    else:
        sampled = torch.argmax(tempered + noise, dim=-1)
    greedy = torch.argmax(filtered, dim=-1)
    return torch.where(rows["temperature"] == 0.0, greedy, sampled)


def sample_token_rows(
    logits: torch.Tensor,
    occurrences: torch.Tensor,
    rows: Rows,
    sp: SamplingParams,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched penalize -> filter -> sample with per-row knobs: logits and
    occurrences (B, V), rows from slot_params(B, ...); sp gives the global
    knobs. Returns (tokens (B,) int64, new occurrences). The nucleus filter
    always runs, since top_p is per row."""
    filtered = penalize_and_filter_rows(logits, occurrences, rows, sp)
    noise = draw_noise_rows(sp, filtered.shape, generator, filtered.device)
    token = pick_token_rows(filtered, noise, rows, sp)
    occ = occurrences * rows["alpha_decay"][:, None]
    occ.scatter_add_(-1, token.unsqueeze(-1), torch.ones_like(occ[..., :1]))
    return token, occ
