"""Speculative decoding: a draft model's lookahead verified by the target.

Counterpart of rwkv_lm_ext_tpu/infer/speculative.py:51-470 (_filtered_probs,
speculative_accept, truncated_draft, SpecStats, SpeculativeEngine). A draft
RWKV proposes ``gamma`` tokens one decode step at a time; the target scores
all of them in ONE verify pass of T = gamma + 1 (models/collect.py: the
collect forward, K2, K3 and kernel B.15), which emits the target's state
after every fed position. A partial acceptance of j tokens is then one select
into the target's state stack and one into the draft's per-step stack:

  full accept:    one verify pass (gamma + 1 tokens)  -> gamma + 1 tokens out
  partial accept: one verify pass + state selects     -> j + 1 tokens out

Greedy mode accepts a draft token when it equals the target's argmax, so its
output is the target's own penalty-free greedy decode; sampled mode is the
Leviathan et al. accept / resample rule (``speculative_accept``), whose
output is distributed as target-only sampling with the same knobs.
Occurrence and repetition penalties depend on the history token by token
and are refused in either mode, ``token_ban`` in greedy mode, and a draft
of another vocabulary size. A target that ``collect_supported`` refuses (in
the port an RWKV-4 model) takes JAX's re-prefill rollback (:437-451): its
verify pass is the plain forward, whose final state serves a full
acceptance, and a partial one runs the accepted prefix again from the
round's start state.

On a card a round is ONE CUDA-graph replay (the gamma draft steps, each
writing its state into a static stack; the verify pass; the acceptance
rule), then one packed host fetch of [candidates | j | next token]; the
rollback is a second replay holding both state selects, the full-accept
draft step (run always, kept where j == gamma: a graph has no branch) and
the next token's copy, so one graph of each serves every j. The sampled
rounds are captured per set of batch-shaping knobs (``global_knobs``) with
the generator registered, as ``infer/engine.py capture_graph`` does, and the
per-request knobs are device rows. Each mode's buffers and graphs hold the
verify pass's state stack (113 MB at 1B6, gamma 8), so at most
``MAX_ROUNDS`` modes are kept, the least recently used evicted first. A
replayed round is bit-equal to the eager round; a capture or replay that
fails raises, and nothing falls back to the eager round on a card. On the
CPU the rounds run eagerly.

Numerics: greedy output equals the engine's under matched forward
numerics. In bf16 the verify pass (B.15 over T = gamma + 1) and the engine's
T = 1 decode step (B.9) sum in another order, so a near-tie argmax can
resolve differently; in fp32 they agree (tests).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from rwkv_lm_ext_tpu_torch.adapters.slot_lora import has_slot_lora, set_slot_idx
from rwkv_lm_ext_tpu_torch.infer.engine import (
    _chunk_plan,
    capture_graph,
    refuse_chunk_dependent,
    warm_step,
)
from rwkv_lm_ext_tpu_torch.infer.sampling import (
    SLOT_PARAM_FIELDS,
    SamplingParams,
    global_knobs,
    inverse_cdf_pick,
    penalize_and_filter_rows,
    slot_params,
)
from rwkv_lm_ext_tpu_torch.models.collect import (
    collect_supported,
    rwkv_forward_collect,
    select_state,
)
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.models.state import ModelState, init_model_state

# the round modes a SpeculativeEngine keeps (greedy and sampled knob sets);
# fewer than the engine's MAX_DECODERS, as each holds a verify pass's stack
MAX_ROUNDS = 4


def _filtered_probs(logits: torch.Tensor, sp: SamplingParams,
                    rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The engine's filter -> temper pipeline as probabilities (penalties
    excluded: speculative mode refuses them), on (n, V) logits with the
    per-row knobs ``rows`` (sampling.slot_params)."""
    occ = torch.zeros(logits.shape, dtype=torch.float32, device=logits.device)
    filtered = penalize_and_filter_rows(logits, occ, rows, sp)
    return torch.softmax(filtered / rows["temperature"].clamp_min(1e-6)[:, None], dim=-1)


def _categorical(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw from each row of probs (..., V): the inverse CDF of one
    uniform a row (JAX draws ``categorical(log(p + 1e-30))``)."""
    u = torch.rand(probs.shape[:-1] + (1,), generator=generator, device=probs.device)
    return inverse_cdf_pick(torch.log(probs + 1e-30), u)


def speculative_accept(p: torch.Tensor, qrows: torch.Tensor, cand: torch.Tensor,
                       generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Leviathan et al. rule (JAX :63-91): accept cand[i] ~ q_i with
    probability min(1, p_i(cand[i]) / q_i(cand[i])); at the first rejection
    j resample from norm(relu(p_j - q_j)); on full acceptance draw the bonus
    token from p[gamma]. The emitted sequence is distributed as sampling
    from p. p (..., gamma+1, V), qrows (..., gamma, V), cand (..., gamma)
    int64; leading axes are independent draws. Returns (j, next), int64
    (...). Nothing is read back to the host."""
    gm, V = cand.shape[-1], p.shape[-1]
    pr = p[..., :gm, :].gather(-1, cand[..., None])[..., 0]
    qr = qrows.gather(-1, cand[..., None])[..., 0]
    u = torch.rand(cand.shape, generator=generator, device=p.device)
    acc = u * qr < pr                       # u < p / q without the division
    all_acc = acc.all(-1)
    j = torch.where(all_acc, gm, acc.int().argmin(-1))
    at = j.clamp(max=gm - 1)[..., None, None].expand(*j.shape, 1, V)
    pj, qj = p.gather(-2, at)[..., 0, :], qrows.gather(-2, at)[..., 0, :]
    resid = (pj - qj).clamp_min(0.0)
    total = resid.sum(-1, keepdim=True)
    # a numerically empty residual can only mean p == q: fall back to p
    resid = torch.where(total > 1e-12, resid, pj)
    dist = torch.where(all_acc[..., None], p[..., gm, :], resid / resid.sum(-1, keepdim=True))
    return j, _categorical(dist, generator)


def truncated_draft(model: RWKV, n_layer: int) -> RWKV:
    """Early-exit self-draft (JAX :94-102): the target's first ``n_layer``
    blocks with its embedding, ln_out and head, no weight copied (the
    modules are the target's own)."""
    if not 1 <= n_layer <= model.cfg.n_layer:
        raise ValueError(f"--draft-layers must be in [1, {model.cfg.n_layer}], not {n_layer}")
    draft = RWKV.__new__(RWKV)
    nn.Module.__init__(draft)
    draft.cfg = dataclasses.replace(model.cfg, n_layer=n_layer)
    draft.emb, draft.ln_out, draft.head = model.emb, model.ln_out, model.head
    draft.blocks = nn.ModuleList(list(model.blocks)[:n_layer])
    for name in ("head_q", "head_k"):
        if hasattr(model, name):
            setattr(draft, name, getattr(model, name))
    draft.register_module("onelayer_decoder", None)
    return draft


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    target_passes: int = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_target_pass(self) -> float:
        emitted = self.accepted + self.rounds  # +1 corrected / extended each
        return emitted / self.target_passes if self.target_passes else 0.0


class _Rounds:
    """Static buffers and graphs of the rounds of one mode: greedy
    (``sampling`` None) or sampled with one set of batch-shaping knobs. The
    round reads ``cur``, ``t_state``, ``d_state`` (and the knob rows) and
    writes the draft's per-step state stack, the candidates, ``j`` and
    ``packed``; the rollback reads those and writes ``t_state``, ``d_state``
    and ``cur``. ``_round`` and ``_rollback`` are the eager bodies; on a card
    ``run`` and ``rollback`` replay them as graphs captured at first use.
    Holds the models, not the engine, so that no reference cycle keeps a
    graph for a garbage collection to destroy mid-capture."""

    def __init__(self, target, draft, gamma: int, sampling: Optional[SamplingParams]):
        dev = target.emb.weight.device
        self.target, self.draft, self.gamma, self.sampling = target, draft, gamma, sampling
        self.collect = collect_supported(target.cfg)
        self.cur = torch.zeros(1, dtype=torch.int64, device=dev)
        self.t_state = init_model_state(target.cfg, 1, device=dev)
        self.d_state = init_model_state(draft.cfg, 1, device=dev)
        self.d_stack = {k: torch.zeros((gamma,) + v.shape, dtype=v.dtype, device=dev)
                        for k, v in self.d_state.items()}
        self.d_scratch = {k: torch.empty_like(v) for k, v in self.d_state.items()}
        self.cand = torch.zeros(gamma, dtype=torch.int64, device=dev)
        self.j = torch.zeros(1, dtype=torch.int64, device=dev)
        self.packed = torch.zeros(gamma + 2, dtype=torch.int64, device=dev)
        self.t_states: Optional[ModelState] = None      # the last verify pass's
        if sampling is not None:
            self.q_rows = slot_params(1, sampling, device=dev)
            self.p_rows = slot_params(gamma + 1, sampling, device=dev)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}

    def load(self, t_state: ModelState, d_state: ModelState,
             sampling: Optional[SamplingParams]) -> None:
        """A new generation: both prefilled states and the request's knobs
        (the first token goes into ``cur`` after)."""
        for dst, src in ((self.t_state, t_state), (self.d_state, d_state)):
            for key, value in dst.items():
                value.copy_(src[key])
        if sampling is not None:
            for f in SLOT_PARAM_FIELDS:
                self.q_rows[f].fill_(float(getattr(sampling, f)))
                self.p_rows[f].fill_(float(getattr(sampling, f)))

    def _round(self, gen: torch.Generator) -> None:
        gm, sp = self.gamma, self.sampling
        tok, st, cands, qrows = self.cur, self.d_state, [], []
        for i in range(gm):
            out = {key: value[i] for key, value in self.d_stack.items()}
            logits, _ = rwkv_decode_step(self.draft, tok, st, out=out)
            if sp is None:
                tok = logits.argmax(-1)
            else:
                q = _filtered_probs(logits, sp, self.q_rows)
                qrows.append(q[0])
                tok = _categorical(q, gen)
            cands.append(tok)
            st = out
        cand = torch.cat(cands)
        feed = torch.cat([self.cur, cand])[None]
        if self.collect:
            logits, self.t_states = rwkv_forward_collect(self.target, feed, self.t_state)
        else:
            logits, self.t_states = self.target(feed, self.t_state)
        if sp is None:
            best = logits[0].argmax(-1)
            acc = cand == best[:gm]
            j = torch.where(acc.all(), gm, acc.int().argmin())
            nxt = best.gather(0, j.reshape(1))
        else:
            p = _filtered_probs(logits[0], sp, self.p_rows)
            j, nxt = speculative_accept(p, torch.stack(qrows), cand, gen)
        self.cand.copy_(cand)
        self.j.copy_(j.reshape(1))
        self.packed.copy_(torch.cat([cand, j.reshape(1), nxt.reshape(1)]))

    def _rollback(self) -> None:
        gm = self.gamma
        if self.collect:
            for key, value in select_state(self.t_states, self.j).items():
                self.t_state[key].copy_(value)
        d_sel = select_state(self.d_stack, self.j.clamp(max=gm - 1))
        rwkv_decode_step(self.draft, self.cand[gm - 1:], d_sel, out=self.d_scratch)
        full = self.j == gm
        for key, value in self.d_state.items():
            keep = full.view((1,) * value.dim())
            torch.where(keep, self.d_scratch[key], d_sel[key], out=value)
        self.cur.copy_(self.packed[gm + 1:])

    def run(self, gen: torch.Generator) -> List[int]:
        """One round; returns [candidates | j | next token] (one fetch)."""
        if self.cur.device.type == "cuda":
            self._replay("round", lambda: self._round(gen), lambda: self._round(self._scratch()),
                         gen)
        else:
            self._round(gen)
        return self.packed.tolist()

    def rollback(self, gen: torch.Generator) -> None:
        if self.cur.device.type == "cuda":
            self._replay("rollback", self._rollback,
                         lambda: warm_step(self.draft, 1, lambda logits: None, None),
                         gen)
        else:
            self._rollback()

    def _replay(self, name: str, body: Callable[[], None], warmup: Callable[[], None],
                gen: torch.Generator) -> None:
        graph = self.graphs.get(name)
        if graph is None:
            graph = self.graphs[name] = capture_graph(body, warmup, gen, self.cur.device)
        graph.replay()

    def _scratch(self) -> torch.Generator:
        # the warm-up draws from its own generator: the request's must give
        # the replay what it gives the eager round
        return torch.Generator(device=self.cur.device).manual_seed(0)


class SpeculativeEngine:
    """Speculative decoding over a (target, draft) pair of ``RWKV`` modules
    on one device (any RWKV-4/5/6 draft with the target's vocabulary size,
    typically 10-20x smaller, or ``truncated_draft``). ``gamma`` tokens are
    drafted a round and verified in one target pass; prompts are prefilled
    in ``_chunk_plan`` pieces of at most ``chunk_len``. The draft steps take
    the engine's default T=1 route (models/decode.py). A target with
    slot-LoRA projections runs its base weights."""

    def __init__(self, target: RWKV, draft: RWKV, tokenizer=None, *, gamma: int = 8,
                 chunk_len: int = 256):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError(f"draft and target must share a vocabulary: the draft has "
                             f"{draft.cfg.vocab_size} ids, the target {target.cfg.vocab_size}")
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        refuse_chunk_dependent(target.cfg, "SpeculativeEngine")
        refuse_chunk_dependent(draft.cfg, "SpeculativeEngine (draft)")
        self.target, self.draft, self.tokenizer = target, draft, tokenizer
        self.gamma, self.chunk_len = int(gamma), chunk_len
        self.device = target.emb.weight.device
        self.collect = collect_supported(target.cfg)
        self.lock = threading.RLock()
        self._gen = torch.Generator(device=self.device)
        self._base_idx = (torch.zeros(1, dtype=torch.int64, device=self.device)
                          if has_slot_lora(target) or has_slot_lora(draft) else None)
        self._rounds: "collections.OrderedDict[tuple, _Rounds]" = collections.OrderedDict()

    def _rounds_for(self, sampling: Optional[SamplingParams]) -> _Rounds:
        """The mode's rounds, made at first use; the least recently used
        mode beyond ``MAX_ROUNDS`` is dropped with its buffers and graphs."""
        key = ("greedy",) if sampling is None else ("sampled", global_knobs(sampling))
        rounds = self._rounds.pop(key, None) or _Rounds(self.target, self.draft, self.gamma,
                                                        sampling)
        self._rounds[key] = rounds
        while len(self._rounds) > MAX_ROUNDS:
            self._rounds.popitem(last=False)
        return rounds

    def _prefill(self, model, ids: List[int], state: Optional[ModelState] = None
                 ) -> Tuple[torch.Tensor, ModelState]:
        tok = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        logits, off = None, 0
        for size in _chunk_plan(len(ids), self.chunk_len):
            logits, state = model(tok[off: off + size][None], state)
            off += size
        if logits is None:
            raise ValueError("empty prompt")
        return logits[0, -1], state

    def generate(
        self,
        prompt,
        *,
        max_tokens: int = 128,
        token_stop: Tuple[int, ...] = (0,),
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        return_stats: bool = False,
        callback: Optional[Callable[[int], None]] = None,
    ):
        """Speculative generation (JAX :336-470). ``sampling`` None or at
        temperature 0: greedy, the target's own penalty-free greedy output;
        above 0: rejection sampling over the filtered, tempered
        distributions. A given ``sampling`` decides ``token_stop`` in either
        mode. ``callback(token_id)`` sees each emitted id in order. Returns
        the text (ids without a tokenizer), and the SpecStats with
        ``return_stats``."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("a str prompt needs a tokenizer")
            ids = self.tokenizer.encode(prompt)
        else:
            ids = [int(t) for t in prompt]
        sampled = sampling is not None and sampling.temperature > 0.0
        if sampling is not None:
            if (sampling.alpha_presence != 0.0 or sampling.alpha_frequency != 0.0
                    or sampling.repetition_penalty != 1.0):
                raise ValueError(
                    "speculative decoding cannot honor occurrence/repetition penalties "
                    "(history-dependent); set them to 0/1 or use GenerationEngine.generate")
            token_stop = sampling.token_stop
            if not sampled and sampling.token_ban:
                raise ValueError("greedy speculative mode verifies by raw argmax and cannot "
                                 "honor token_ban; use temperature > 0")
        gm, stats, out = self.gamma, SpecStats(), []
        stop = set(token_stop)

        def emit(t: int) -> None:
            out.append(t)
            if callback is not None:
                callback(t)

        with self.lock, torch.inference_mode():
            if self._base_idx is not None:
                set_slot_idx(self.target, self._base_idx)
            rounds = self._rounds_for(sampling if sampled else None)
            gen = self._gen.manual_seed(seed)
            t_logits, t_state = self._prefill(self.target, ids)
            stats.target_passes += 1
            _, d_state = self._prefill(self.draft, ids)
            rounds.load(t_state, d_state, sampling if sampled else None)
            if sampled:
                cur = _categorical(_filtered_probs(t_logits[None], sampling, rounds.q_rows), gen)
            else:
                cur = t_logits.argmax()
            rounds.cur.copy_(cur.reshape(1))
            c = int(cur)
            while c not in stop and len(out) < max_tokens:
                # c is the next token to emit (the engine's rule: the token
                # drawn from the prefill's logits is out[0])
                emit(c)
                if len(out) >= max_tokens:
                    break
                packed = rounds.run(gen)
                cand, j, nxt = packed[:gm], packed[gm], packed[gm + 1]
                stats.rounds += 1
                stats.target_passes += 1
                stats.proposed += gm
                stats.accepted += j
                consumed = [c] + cand[:j]
                rounds.rollback(gen)
                if not rounds.collect:
                    if j == gm:     # the verify pass fed exactly the consumed tokens
                        for key, value in rounds.t_state.items():
                            value.copy_(rounds.t_states[key])
                    else:
                        _, t_state = self._prefill(self.target, consumed, rounds.t_state)
                        for key, value in rounds.t_state.items():
                            value.copy_(t_state[key])
                        stats.target_passes += 1
                stopped = False
                for t in consumed[1:]:
                    if t in stop or len(out) >= max_tokens:
                        stopped = True
                        break
                    emit(t)
                if stopped:
                    break
                c = nxt
        text = self.tokenizer.decode(out) if self.tokenizer else out
        return (text, stats) if return_stats else text
