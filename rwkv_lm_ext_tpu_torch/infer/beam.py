"""Diverse-group beam search over the recurrent state.

Counterpart of rwkv_lm_ext_tpu/infer/beam.py:38-325 (BeamParams,
_Hypotheses, _select_candidates, generate_beamsearch). All beams decode
together on the batch axis through ``rwkv_decode_step`` at B = num_beams,
and a beam's fork is a gather of the batch axis (models.state.gather_beams)
of the state and of the (num_beams, V) occurrence counts. The repetition
penalty, the top-k / top-p warp, the Gumbel perturbation and the per-beam
top-``reserve`` candidates run on the device; the host sees one (num_beams,
2 * reserve) fetch a step and keeps the hypothesis lists: eos completion,
n-best lists with length-penalty scores, beam groups, early stopping.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.state import ModelState, gather_beams


@dataclasses.dataclass(frozen=True)
class BeamParams:
    num_beams: int = 10
    num_groups: int = 5
    return_num_sequences: int = 5
    max_tokens: int = 100
    eos_ids: Tuple[int, ...] = (0, 1)
    length_penalty: float = 0.5
    repetition_penalty: float = 1.5
    do_sample: bool = True
    top_p: float = 0.96
    top_k: int = 30
    is_sum_logprobs: bool = False
    early_stopping: bool = False


class _Hypotheses:
    """n-best list with length-penalty scores."""

    def __init__(self, num_beams: int, length_penalty: float):
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.beams: List[Tuple[float, List[int]]] = []
        self.worst = math.inf

    def add(self, ids: List[int], sum_logprobs: float, gen_len: int) -> None:
        score = sum_logprobs / max(gen_len, 1) ** self.length_penalty
        if len(self.beams) < self.num_beams or score > -self.worst:
            self.beams.append((score, ids))
            self.beams.sort(key=lambda x: -x[0])
            self.beams = self.beams[: self.num_beams]
            self.worst = -self.beams[-1][0]

    def is_done(self, best_sum_logprobs: float, cur_len: int) -> bool:
        if len(self.beams) < self.num_beams:
            return False
        best_possible = best_sum_logprobs / max(cur_len, 1) ** self.length_penalty
        return -self.worst >= best_possible


def _select_candidates(logp, scores, occ, generator, *, reserve: int, do_sample: bool,
                       top_k: int, top_p: float, rep_penalty: float):
    """logp (NB, V) fp32 log-probabilities, scores (NB,) accumulated, occ
    (NB, V) occurrence counts. Returns (ids (NB, reserve), accumulated scores
    of those candidates (NB, reserve), -inf where the warp removed one)."""
    if rep_penalty != 1.0:
        pen = torch.where(logp > 0, logp / rep_penalty, logp * rep_penalty)
        logp = torch.where(occ > 0, pen, logp)
    acc = logp + scores[:, None]
    if do_sample:
        warped = logp
        if top_k > 0:
            kth = torch.topk(warped, top_k, dim=-1).values[:, -1:]
            warped = torch.where(warped < kth, -math.inf, warped)
        if top_p < 1.0:
            srt = torch.sort(warped, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
            cut = torch.argmax((cum >= top_p).to(torch.int32), dim=-1, keepdim=True)
            warped = torch.where(warped < torch.gather(srt, -1, cut), -math.inf, warped)
        # Gumbel top-k: sampling without replacement from the warped law
        u = torch.rand(warped.shape, generator=generator, device=warped.device)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        rank_by = torch.where(torch.isfinite(warped), warped + g, -math.inf)
    else:
        rank_by = acc
    top_ids = torch.topk(rank_by, reserve, dim=-1).indices
    top_acc = torch.gather(acc, -1, top_ids)
    ok = torch.isfinite(torch.gather(rank_by, -1, top_ids))
    return top_ids, torch.where(ok, top_acc, -math.inf)


def generate_beamsearch(
    engine,
    prompt,
    params: BeamParams = BeamParams(),
    *,
    state: Optional[ModelState] = None,
    seed: int = 0,
) -> List[Tuple[float, List[int]]]:
    """Returns up to return_num_sequences (score, token ids), best first."""
    bp = params
    group_size = bp.num_beams // bp.num_groups
    if group_size * bp.num_groups != bp.num_beams:
        raise ValueError(f"num_beams {bp.num_beams} is not a multiple of num_groups {bp.num_groups}")
    prompt_ids = engine._ids(prompt)
    dev = engine.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    eos = frozenset(int(e) for e in bp.eos_ids)
    reserve = max(2, 1 + len(bp.eos_ids)) * group_size

    seqs: List[List[int]] = [[] for _ in range(bp.num_beams)]
    scores_h = np.zeros(bp.num_beams, dtype=np.float64)
    live = np.ones(bp.num_beams, dtype=bool)
    hyps = [_Hypotheses(bp.num_beams, bp.length_penalty) for _ in range(bp.num_groups)]
    group_done = [False] * bp.num_groups
    last_tokens = np.zeros(bp.num_beams, dtype=np.int64)

    with engine.lock, torch.inference_mode():
        logits0, state = engine.prefill(prompt_ids, state)
        engine.select_rows(bp.num_beams)
        state = {k: v.repeat_interleave(bp.num_beams, dim=1) for k, v in state.items()}
        occ = torch.zeros(bp.num_beams, engine.cfg.vocab_size, dtype=torch.int32, device=dev)
        scores_d = torch.zeros(bp.num_beams, device=dev)
        logp = torch.log_softmax(logits0.float(), -1)[None].repeat(bp.num_beams, 1)
        for step in range(bp.max_tokens):
            if step > 0:
                tokens = torch.as_tensor(last_tokens, device=dev)
                logits, state = rwkv_decode_step(engine.model, tokens, state, out=state,
                                                 fused_prep=engine.fused_prep)
                logp = torch.log_softmax(logits.float(), -1)
            ids_d, acc_d = _select_candidates(
                logp, scores_d, occ, gen, reserve=reserve, do_sample=bp.do_sample,
                top_k=bp.top_k, top_p=bp.top_p, rep_penalty=bp.repetition_penalty)
            # the one fetch a step: ids (exact in fp32 below 2**24) and scores
            packed = torch.cat([ids_d.float(), acc_d], -1).cpu().numpy().astype(np.float64)
            top_ids = packed[:, :reserve].astype(np.int64)
            top_acc = packed[:, reserve:]

            next_seqs: List[List[int]] = [None] * bp.num_beams  # type: ignore[list-item]
            next_scores = np.full(bp.num_beams, -np.inf)
            parents = np.zeros(bp.num_beams, dtype=np.int64)
            next_tokens = np.zeros(bp.num_beams, dtype=np.int64)
            for gidx in range(bp.num_groups):
                beams = range(gidx * group_size, (gidx + 1) * group_size)
                if group_done[gidx]:
                    # frozen beams: scores -inf, so they never win later
                    for b in beams:
                        next_seqs[b], parents[b], next_tokens[b] = seqs[b], b, last_tokens[b]
                    continue
                pool = [(float(sc), b, int(tok)) for b in beams if live[b]
                        for sc, tok in zip(top_acc[b], top_ids[b]) if np.isfinite(sc)]
                pool.sort(key=lambda x: -x[0])
                if step == 0:
                    # every beam starts from the same state: distinct tokens
                    # from one row diversify the group
                    seen, dedup = set(), []
                    for cand in pool:
                        if cand[2] not in seen:
                            dedup.append(cand)
                            seen.add(cand[2])
                    pool = dedup
                filled, slot = 0, gidx * group_size
                for sc, b, tok in pool:
                    if filled >= group_size:
                        break
                    if tok in eos:
                        hyps[gidx].add(seqs[b], sc, step + 1)
                        continue
                    next_seqs[slot + filled] = seqs[b] + [tok]
                    next_scores[slot + filled] = sc
                    parents[slot + filled] = b
                    next_tokens[slot + filled] = tok
                    filled += 1
                while filled < group_size:   # degenerate pool: pad with a frozen beam
                    src = gidx * group_size
                    next_seqs[slot + filled] = seqs[src]
                    parents[slot + filled] = src
                    next_tokens[slot + filled] = last_tokens[src]
                    filled += 1
                best = pool[0][0] if pool else -np.inf
                if hyps[gidx].is_done(best, step + 1):
                    group_done[gidx] = True
            seqs, scores_h, last_tokens = next_seqs, next_scores, next_tokens
            parents_d = torch.as_tensor(parents, device=dev)
            state = gather_beams(state, parents_d)
            occ = occ.index_select(0, parents_d)
            occ[torch.arange(bp.num_beams, device=dev), torch.as_tensor(next_tokens, device=dev)] += 1
            # dead and frozen beams carry -inf: their candidates stay -inf
            scores_d = torch.as_tensor(np.where(np.isfinite(scores_h), scores_h, -np.inf),
                                       dtype=torch.float32, device=dev)
            if all(group_done):
                break

    outputs: List[Tuple[float, List[int]]] = []
    for b in range(bp.num_beams):
        if np.isfinite(scores_h[b]) and seqs[b]:
            outputs.append((scores_h[b] / max(len(seqs[b]), 1) ** bp.length_penalty, seqs[b]))
    for h in hyps:
        outputs.extend(h.beams)
    outputs.sort(key=lambda x: -x[0])
    return outputs[: bp.return_num_sequences]
