"""Continuous batching for streaming decode serving.

Counterpart of rwkv_lm_ext_tpu/infer/continuous.py:59-757
(ContinuousBatcher), :761-887 (BatcherDriver) and :888-1193
(``_sampling_to_wire`` / ``_sampling_from_wire``, LockstepBatcherDriver). A
fixed pool of decode
SLOTS shares one batched decode+sample step; requests wait in a queue, a
free slot admits one by prefilling its prompt and writing the state into
its row of the batched state, and finished rows retire and reopen while the
others run: new work joins without waiting for the longest request. An RWKV
request's whole cache is its O(1) recurrent state, so a slot is a fixed
budget and admission is a row write on the batch axis. Idle slots decode
garbage that admission overwrites.

Two modes. ``block_size=1``: per-token ticks; admission prefills the whole
prompt and samples the first token on the host's side of a fetch.
``block_size=K``: K-step blocks with the stop rule, the budgets and the
active row on the device ((B,) active and budget rows and a (B,
max_stop_tokens) stop matrix, written at admission); one fetch of the
block's packed tokens, emit flags and active row a block, double-buffered
(the next block is dispatched right after the fetch, before the host's
bookkeeping). Admission is grouped and needs no fetch: it prefills each
prompt's prefix (all but the last token), one batched prefill padded to
``n_slots`` rows for the requests whose remaining prefix has the same length
and adapter, writes the rows into the static buffers, and feeds the last
prompt token as the row's token, so the next block's first step samples the
first output token on the device.

On a CUDA device the tick and each block length are CUDA graphs captured
once over static buffers (``n_slots`` is fixed), with the batcher's
generator registered, so a replay is one launch; on the CPU the same bodies
run eagerly. Per-request sampling knobs (temperature, top_p, the occurrence
penalties, repetition_penalty) live in (B,) device rows; the knobs that
shape the step (top_k, token_ban, the top_p and categorical
implementations) are the batcher's and ``submit`` refuses a request that
differs. A slot-LoRA model decodes each slot under its request's adapter:
admission writes the slot's element of the shared slot index.

Two faults of the JAX batcher are left behind: ``_pick_block_size`` counts a
slot re-admitted since the in-flight block's dispatch with its full budget
(the JAX code skips it, :464), and ``_step_block`` keeps the block length
apart from its loop index (the JAX code shadows ``k``, :532).

``LockstepBatcherDriver`` serves a batcher whose engine is one rank of a
tensor-parallel group (multi-process serving): process 0 turns the batcher's
inputs into one op stream and every process replays it (see the class). It
leaves behind ADVICE r5's fault of the JAX driver, whose whole loop died on a
payload over broadcast_obj's 64 KB buffer: each ticket and call is measured
where it is submitted and one over ``MAX_REQUEST_BYTES`` fails alone
(``PayloadTooLarge``, a 400 at the server); broadcast_obj itself has no cap.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.slot_lora import set_slot_idx
from rwkv_lm_ext_tpu_torch.infer.engine import (
    _chunk_plan,
    capture_graph,
    refuse_chunk_dependent,
    warm_step,
)
from rwkv_lm_ext_tpu_torch.infer.sampling import (
    GLOBAL_KNOBS,
    SLOT_PARAM_FIELDS,
    SamplingParams,
    sample_token_rows,
    slot_params,
)
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.state import ModelState, scatter_rows


@dataclasses.dataclass
class _Request:
    rid: int
    prompt_ids: List[int]
    max_tokens: int
    sampling: SamplingParams
    out_ids: List[int] = dataclasses.field(default_factory=list)
    callback: Optional[Callable[[int], None]] = None
    initial_state: Optional[ModelState] = None    # e.g. a named tuned state
    adapter: Optional[str] = None                 # slot-LoRA adapter name
    adapter_id: int = 0                           # 0 = base
    finished: bool = False                        # result already delivered


_TICK = 0       # graph key of the per-token step


class ContinuousBatcher:
    """Slot-pool batcher over a GenerationEngine's model (see the module
    docstring). ``adaptive_block`` (opt-in; measured net-negative on the
    JAX package's mixed serving load) picks the largest power of two >= 8
    up to ``block_size`` that fits the smallest remaining budget of the
    live slots."""

    def __init__(
        self,
        engine,
        *,
        n_slots: int = 8,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        block_size: int = 1,
        max_stop_tokens: int = 8,
        adaptive_block: bool = False,
    ):
        refuse_chunk_dependent(engine.cfg, "ContinuousBatcher")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.engine = engine
        self.cfg = engine.cfg
        self.n_slots = n_slots
        self.sampling = sampling
        self.block_size = block_size
        self.max_stop_tokens = max_stop_tokens
        self._queue: Deque[_Request] = deque()
        self._slots: List[Optional[_Request]] = [None] * n_slots
        self._next_rid = 0
        self._finished: Dict[int, List[int]] = {}
        # rids to cancel: any thread adds (set.add holds the GIL), the
        # stepping thread processes
        self._cancelled: set = set()
        dev = engine.device
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        # static buffers: captured graphs read and write these tensors, so
        # they are only ever updated in place
        self._tokens = torch.zeros(n_slots, dtype=torch.int64, device=dev)
        self._occ = torch.zeros(n_slots, self.cfg.vocab_size, device=dev)
        self._rows = slot_params(n_slots, sampling, device=dev)
        self._state = engine.init_state(n_slots)
        self._slot_lora = engine._slot_lora
        self._slot_idx = torch.zeros(n_slots, dtype=torch.int64, device=dev)
        self._graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self._packed: Dict[int, torch.Tensor] = {}
        self._stats = {"blocks": 0, "steps": 0, "emitted": 0}
        self._inflight = None
        if adaptive_block:
            self._block_sizes = sorted({k for k in (8, 16, 32, 64, 128) if k < block_size}
                                       | {block_size})
        else:
            self._block_sizes = [block_size]
        self._active = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self._budget = torch.zeros(n_slots, dtype=torch.int64, device=dev)
        self._stops = torch.full((n_slots, max_stop_tokens), -1, dtype=torch.int64, device=dev)

    # -- public API ------------------------------------------------------

    def submit(self, prompt, *, max_tokens: int = 128,
               sampling: Optional[SamplingParams] = None,
               callback: Optional[Callable[[int], None]] = None,
               initial_state: Optional[ModelState] = None,
               adapter: Optional[str] = None) -> int:
        """Queue a request; returns its id. ``prompt``: text (needs the
        engine's tokenizer) or token ids. ``sampling`` overrides the
        batcher's per request (the global knobs must match);
        ``initial_state`` (B=1, e.g. StatesRegistry.initial_state(name))
        conditions the request; ``adapter`` names a slot-LoRA adapter."""
        if sampling is None:
            sampling = self.sampling
        else:
            for knob in GLOBAL_KNOBS:
                if getattr(sampling, knob) != getattr(self.sampling, knob):
                    raise ValueError(
                        f"{knob} shapes the batched step (batcher-global): request has "
                        f"{getattr(sampling, knob)!r}, batcher has {getattr(self.sampling, knob)!r}")
        if self.block_size > 1 and len(sampling.token_stop) > self.max_stop_tokens:
            raise ValueError(
                f"token_stop has {len(sampling.token_stop)} entries; the block-mode stop matrix "
                f"holds {self.max_stop_tokens} (raise max_stop_tokens at construction)")
        aid = self.engine.adapter_id(adapter)
        ids = (self.engine.tokenizer.encode(prompt) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, ids, max_tokens, sampling, callback=callback,
                                    initial_state=initial_state,
                                    adapter=adapter if aid else None, adapter_id=aid))
        return rid

    @property
    def busy(self) -> bool:
        return (any(s is not None for s in self._slots) or bool(self._queue)
                or self._inflight is not None)

    def cancel(self, rid: int) -> bool:
        """Cancel a request: a queued one leaves the queue, an active one
        retires its slot on the next tick with what it produced so far as
        its result. Safe from any thread. Returns whether rid is queued or
        active."""
        self._cancelled.add(rid)
        return (any(r.rid == rid for r in self._queue)
                or any(r is not None and r.rid == rid for r in self._slots))

    def stats(self) -> dict:
        """Occupancy and counts: slots in use, queued requests, blocks (or
        ticks) dispatched, decode steps and emitted tokens."""
        return {"n_slots": self.n_slots, "active": sum(s is not None for s in self._slots),
                "queued": len(self._queue), **self._stats}

    def warmup(self) -> None:
        """Build everything from the calling thread: one dummy request
        through the public path (a chunk_len prefill and the admission),
        every graph (each block length, or the tick) captured and run once;
        then the pool is reset in place and the counts cleared."""
        eng = self.engine
        rid = self.submit([1] * (eng.chunk_len + 1), max_tokens=sum(self._block_sizes),
                          sampling=dataclasses.replace(self.sampling, token_stop=()))
        while self.busy:
            self.step()
        self._finished.pop(rid, None)
        with eng.lock, torch.inference_mode():
            for key in ([_TICK] if self.block_size == 1 else self._block_sizes):
                self._run(key)
            self._tokens.zero_()
            self._occ.zero_()
            for f in SLOT_PARAM_FIELDS:
                self._rows[f].fill_(float(getattr(self.sampling, f)))
            for value in self._state.values():
                value.zero_()
            self._slot_idx.zero_()
            self._active.zero_()
            self._budget.zero_()
            self._stops.fill_(-1)
        self._stats = {"blocks": 0, "steps": 0, "emitted": 0}

    def step(self) -> Dict[int, List[int]]:
        """Admit queued requests into free slots, run one tick (a block of
        block_size tokens a slot in block mode), retire finished rows.
        Returns {rid: token ids} finished on this tick, including requests
        that finished at admission and cancelled ones (partial output)."""
        with self.engine.lock, torch.inference_mode():
            done = self._step_block() if self.block_size > 1 else self._step_tick()
        self._finished.update(done)
        return done

    def run(self) -> Dict[int, List[int]]:
        """Step until the queue and the slots are empty; returns every
        finished {rid: token ids}."""
        while self.busy:
            self.step()
        out, self._finished = self._finished, {}
        return out

    # -- the device side ------------------------------------------------

    def _tick(self) -> None:
        """One decode+sample step of every slot, in the static buffers."""
        logits, _ = rwkv_decode_step(self.engine.model, self._tokens, self._state,
                                     out=self._state, fused_prep=self.engine.fused_prep)
        nxt, occ = sample_token_rows(logits, self._occ, self._rows, self.sampling, self._gen)
        self._tokens.copy_(nxt)
        self._occ.copy_(occ)

    def _block(self, k: int) -> None:
        """K steps of every slot with the stop rule and the budgets on the
        device; the block's [(K, B) tokens | (K, B) emit flags | (1, B)
        active row] into packed[k]. Inactive rows keep their fed token (their
        state and occurrences advance on garbage; admission overwrites)."""
        tokens, occ, active, budget = self._tokens, self._occ, self._active, self._budget
        toks, emits = [], []
        for _ in range(k):
            logits, _ = rwkv_decode_step(self.engine.model, tokens, self._state,
                                         out=self._state, fused_prep=self.engine.fused_prep)
            nxt, occ = sample_token_rows(logits, occ, self._rows, self.sampling, self._gen)
            emit = active & ~(nxt[:, None] == self._stops).any(-1)
            budget = budget - emit.long()
            active = emit & (budget > 0)
            tokens = torch.where(emit, nxt, tokens)
            toks.append(nxt)
            emits.append(emit.long())
        self._packed[k].copy_(torch.cat([torch.stack(toks), torch.stack(emits),
                                         active[None].long()]))
        self._tokens.copy_(tokens)
        self._occ.copy_(occ)
        self._active.copy_(active)
        self._budget.copy_(budget)

    def _run(self, key: int) -> None:
        """The tick (key 0) or a block of ``key`` steps: one graph replay
        where the engine's blocks are graphs (a card, and no gloo group),
        else eagerly."""
        if self._slot_lora:
            set_slot_idx(self.engine.model, self._slot_idx)
        if key != _TICK and key not in self._packed:
            self._packed[key] = torch.zeros(2 * key + 1, self.n_slots, dtype=torch.int64,
                                            device=self._tokens.device)
        body = self._tick if key == _TICK else (lambda: self._block(key))
        if self.engine.graph_blocks:
            self._replay(key, body)
        else:
            body()

    def _replay(self, key: int, body: Callable[[], None]) -> None:
        """``body`` as a CUDA graph, captured at the key's first use."""
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = capture_graph(body, self._warm, self._gen,
                                                      self._tokens.device)
        graph.replay()

    def _warm(self) -> None:
        scratch = torch.Generator(device=self._tokens.device).manual_seed(0)
        warm_step(self.engine.model, self.n_slots,
                  lambda logits: sample_token_rows(logits, torch.zeros_like(self._occ),
                                                   self._rows, self.sampling, scratch),
                  self.engine.fused_prep)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a sync (pinned,
        asynchronous): admission must not wait for the block in flight."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self._tokens.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self._tokens.device, non_blocking=True)

    # -- per-token ticks -------------------------------------------------

    def _step_tick(self) -> Dict[int, List[int]]:
        done: Dict[int, List[int]] = {}
        self._process_cancellations(done)
        done.update(self._admit_pending())
        if not any(s is not None for s in self._slots):
            return done
        self._run(_TICK)
        self._stats["blocks"] += 1
        self._stats["steps"] += 1
        toks = self._tokens.tolist()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            # the token fed was already emitted; toks[i] is the new one
            t = toks[i]
            if t in req.sampling.token_stop:
                done[req.rid] = req.out_ids
                self._retire(i)
                continue
            self._emit(req, t)
            if len(req.out_ids) >= req.max_tokens:
                done[req.rid] = req.out_ids
                self._retire(i)
        return done

    def _admit_pending(self) -> Dict[int, List[int]]:
        """Tick-mode admission: the whole prompt's prefill, the first token
        sampled and fetched, the row written."""
        done: Dict[int, List[int]] = {}
        dev = self._tokens.device
        for i in range(self.n_slots):
            if self._slots[i] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            if not req.prompt_ids:
                done[req.rid] = req.out_ids
                continue
            logits, single = self.engine.prefill(req.prompt_ids, req.initial_state,
                                                 cache_salt=req.adapter)
            row1 = slot_params(1, req.sampling, device=dev)
            tok0, occ0 = sample_token_rows(logits[None], torch.zeros_like(self._occ[:1]), row1,
                                           self.sampling, self._gen)
            t0 = int(tok0)
            if t0 in req.sampling.token_stop or req.max_tokens < 1:
                done[req.rid] = req.out_ids
                continue
            self._emit(req, t0)
            if req.max_tokens == 1:
                done[req.rid] = req.out_ids
                continue
            slot = torch.tensor([i], device=dev)
            scatter_rows(self._state, slot, single)
            for f in SLOT_PARAM_FIELDS:
                self._rows[f][i] = row1[f][0]
            self._tokens[i] = tok0[0]
            self._occ[i] = occ0[0]
            self._slot_idx[i] = req.adapter_id
            self._slots[i] = req
        return done

    # -- K-step blocks ---------------------------------------------------

    def _pick_block_size(self, emitted=None, live=None, snapshot=None) -> int:
        """The largest block length <= the smallest remaining budget of the
        live slots (at least the smallest length). ``emitted`` / ``live`` /
        ``snapshot`` describe a block just fetched whose bookkeeping has not
        run: its emissions per slot, its active row and the requests it ran.
        A slot re-admitted since that block's dispatch was not in it: it
        counts with its whole remaining budget."""
        sizes = self._block_sizes
        rem = []
        for i, r in enumerate(self._slots):
            if r is None or r.finished:
                continue
            readmitted = snapshot is not None and snapshot[i] is not r
            if live is not None and not live[i] and not readmitted:
                continue    # finished in the fetched block
            n = r.max_tokens - len(r.out_ids)
            if emitted is not None and not readmitted:
                n -= emitted[i]
            if n > 0:
                rem.append(n)
        if not rem:
            return sizes[0]
        return max([k for k in sizes if k <= min(rem)], default=sizes[0])

    def _dispatch_block(self, emitted=None, live=None, snapshot=None) -> None:
        """Enqueue one block; the next step fetches it (double-buffering)."""
        kblk = self._pick_block_size(emitted, live, snapshot)
        self._run(kblk)
        self._stats["blocks"] += 1
        self._stats["steps"] += kblk
        # packed[kblk] holds this block's outputs and its active row until
        # the next block of that length, which is dispatched after the fetch
        self._inflight = (kblk, list(self._slots))

    def _step_block(self) -> Dict[int, List[int]]:
        """One pipelined block tick: fetch the block in flight and dispatch
        the next one at once (rows it freed idle one block, admissions join
        the block after next); then the fetched block's emissions and
        retirements, attributed through the dispatch-time snapshot; then
        cancellations and admissions (no fetch), and a dispatch if nothing is
        in flight. A row finished iff its block-final active flag is off."""
        done: Dict[int, List[int]] = {}
        if self._inflight is not None:
            kblk, snapshot = self._inflight
            self._inflight = None
            packed = self._packed[kblk].tolist()     # waits for the device
            toks, emits, active = packed[:kblk], packed[kblk:2 * kblk], packed[-1]
            if any(active):
                emitted = [sum(col) for col in zip(*emits)]
                self._dispatch_block(emitted, active, snapshot)
            for i, req in enumerate(snapshot):
                if req is None or req.finished:
                    continue
                for step in range(kblk):
                    if emits[step][i]:
                        self._emit(req, toks[step][i])
                if not active[i]:
                    req.finished = True
                    done[req.rid] = req.out_ids
                    self._retire(i)
        self._process_cancellations(done)
        done.update(self._admit_pending_block())
        if self._inflight is None and any(s is not None for s in self._slots):
            self._dispatch_block()
        return done

    def _admit_pending_block(self) -> Dict[int, List[int]]:
        """Admit queued requests into free slots without a fetch, grouped by
        (remaining prefix length after the prefix cache, adapter)."""
        done: Dict[int, List[int]] = {}
        free = [i for i in range(self.n_slots) if self._slots[i] is None]
        picked: List[_Request] = []
        while self._queue and len(picked) < len(free):
            req = self._queue.popleft()
            if req.max_tokens < 1 or not req.prompt_ids:
                done[req.rid] = req.out_ids
                req.finished = True
                continue
            picked.append(req)
        cache = self.engine.state_cache
        groups: Dict[tuple, list] = {}
        for req in picked:
            prefix = req.prompt_ids[:-1]
            cached, consumed = None, 0
            use_cache = req.initial_state is None and cache is not None
            if use_cache and prefix:
                cached, consumed = cache.lookup(prefix, salt=req.adapter)
            key = (len(prefix) - consumed, req.adapter_id)
            groups.setdefault(key, []).append((req, prefix, consumed, cached, use_cache))
        for (rem, aid), grp in groups.items():
            self._admit_group(grp, [free.pop(0) for _ in grp], rem, aid)
        return done

    def _admit_group(self, grp, slots: List[int], rem: int, aid: int) -> None:
        """One admission wave: a batched prefill of the prefixes padded to
        n_slots rows (pad rows repeat row 0), then one write of every
        admitted row into the static buffers. Nothing is fetched."""
        eng = self.engine
        G, g = self.n_slots, len(grp)
        starts = [cached if cached is not None else req.initial_state
                  for req, _, _, cached, _ in grp]
        if all(s is None for s in starts):
            state = eng.init_state(G)
        else:
            fresh = eng.init_state(1)
            starts = [fresh if s is None else s for s in starts]
            starts += [starts[0]] * (G - g)
            state = {key: torch.cat([s[key] for s in starts], 1) for key in self._state}
        if rem > 0:
            toks = np.zeros((G, rem), np.int64)
            for j, (_, prefix, consumed, _, _) in enumerate(grp):
                toks[j] = prefix[consumed:]
            toks[g:] = toks[0]
            toks = self._to_device(toks)
            eng.select_rows(G, aid)
            off = 0
            # the prefix's states only: skip the head (an RWKV-4 model, which
            # returns logits only, computes it)
            skip_head = dict(return_hidden=True, return_logits=False) if eng.cfg.version >= 5 else {}
            for size in _chunk_plan(rem, eng.chunk_len):
                _, state = eng.model(toks[:, off: off + size], state, **skip_head)
                off += size
                for j, (req, prefix, consumed, _, use_cache) in enumerate(grp):
                    if use_cache:
                        eng.state_cache.insert(prefix[: consumed + off],
                                               {k: v[:, j: j + 1] for k, v in state.items()},
                                               salt=req.adapter)
        stop_rows = np.full((g, self.max_stop_tokens), -1, np.int64)
        for j, (req, *_rest) in enumerate(grp):
            stop_rows[j, : len(req.sampling.token_stop)] = req.sampling.token_stop
        meta = self._to_device(np.concatenate([
            np.array(slots, np.int64),
            np.array([req.prompt_ids[-1] for req, *_rest in grp], np.int64),
            np.array([req.max_tokens for req, *_rest in grp], np.int64),
            stop_rows.reshape(-1),
        ]))
        rows = self._to_device(np.array([[getattr(req.sampling, f) for f in SLOT_PARAM_FIELDS]
                                         for req, *_rest in grp], np.float32))
        at = meta[:g]
        scatter_rows(self._state, at, {k: v[:, :g] for k, v in state.items()})
        self._tokens.index_copy_(0, at, meta[g: 2 * g])
        self._budget.index_copy_(0, at, meta[2 * g: 3 * g])
        self._stops.index_copy_(0, at, meta[3 * g:].view(g, self.max_stop_tokens))
        for c, f in enumerate(SLOT_PARAM_FIELDS):
            self._rows[f].index_copy_(0, at, rows[:, c])
        self._occ.index_fill_(0, at, 0.0)
        self._active.index_fill_(0, at, True)
        self._slot_idx.index_fill_(0, at, aid)
        for j, (req, *_rest) in enumerate(grp):
            self._slots[slots[j]] = req

    # -- host bookkeeping ------------------------------------------------

    def _emit(self, req: _Request, t: int) -> None:
        req.out_ids.append(t)
        self._stats["emitted"] += 1
        if req.callback is not None:
            req.callback(t)

    def _process_cancellations(self, done: Dict[int, List[int]]) -> None:
        snap = set(self._cancelled)
        if not snap:
            return
        # removed in place: another thread may be appending to the queue
        for r in [r for r in self._queue if r.rid in snap]:
            self._queue.remove(r)
            done[r.rid] = r.out_ids
            r.finished = True
        for i, r in enumerate(self._slots):
            if r is not None and r.rid in snap:
                done[r.rid] = r.out_ids
                r.finished = True
                self._retire(i)
                # the device-side liveness too: a still-active row would keep
                # the pipelined loop dispatching blocks with nothing to serve
                self._active[i] = False
        # ids not found were already finished; adds that raced stay queued
        self._cancelled -= snap

    def _retire(self, slot: int) -> None:
        self._slots[slot] = None


class BatcherDriver:
    """A background thread stepping a ContinuousBatcher, so that concurrent
    callers (HTTP handler threads) share its batched decode.
    ``submit_and_wait`` blocks the caller until its request finishes. Call
    ``batcher.warmup()`` from the main thread first (serve_http does)."""

    def __init__(self, batcher: ContinuousBatcher):
        self.batcher = batcher
        self._cv = threading.Condition()
        self._results: Dict[int, List[int]] = {}
        self._stop = False
        self._error: Optional[BaseException] = None
        # rids whose waiter gave up: their results are dropped on arrival
        self._abandoned: set = set()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self.batcher.busy and not self._stop:
                    self._cv.wait(timeout=0.05)
                if self._stop:
                    return
            try:
                done = self.batcher.step()
            except BaseException as e:
                # the pool's buffers are in an unknown state: record the error,
                # stop, wake the waiters so that they raise, and re-raise
                with self._cv:
                    self._error = e
                    self._stop = True
                    self._cv.notify_all()
                raise
            if done:
                with self._cv:
                    self._results.update(done)
                    for rid in self._abandoned & set(self._results):
                        self._results.pop(rid)
                        self._abandoned.discard(rid)
                    self._cv.notify_all()

    def submit_and_wait(
        self, prompt, *, max_tokens: int = 128,
        sampling: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
        callback: Optional[Callable[[int], None]] = None,
        initial_state: Optional[ModelState] = None, adapter: Optional[str] = None,
        cancel: Optional[threading.Event] = None,
    ) -> List[int]:
        """Block until the request finishes. ``timeout`` raises TimeoutError
        and cancels the request; ``cancel``, an Event another thread may set
        (a client that went away), cancels it and returns its partial
        output."""
        with self._cv:
            if self._error is not None:
                raise RuntimeError("batcher decode loop died") from self._error
            rid = self.batcher.submit(prompt, max_tokens=max_tokens, sampling=sampling,
                                      callback=callback, initial_state=initial_state,
                                      adapter=adapter)
            self._cv.notify_all()

            def ready():
                return rid in self._results or self._stop

            if cancel is None:
                ok = self._cv.wait_for(ready, timeout=timeout)
            else:
                # setting the event does not notify the condition: poll
                deadline = None if timeout is None else time.monotonic() + timeout
                while not ready() and not cancel.is_set():
                    wait = 0.05
                    if deadline is not None:
                        wait = min(wait, deadline - time.monotonic())
                        if wait <= 0:
                            break
                    self._cv.wait(timeout=wait)
                ok = ready()
                if not ok and cancel.is_set():
                    self.batcher.cancel(rid)
                    # the next tick delivers the partial output
                    self._cv.wait_for(ready, timeout=5.0)
                    return self._results.pop(rid, [])
            if not ok:
                self.batcher.cancel(rid)
                self._abandoned.add(rid)
                raise TimeoutError(f"request {rid} timed out")
            if rid not in self._results and self._error is not None:
                raise RuntimeError("batcher decode loop died") from self._error
            return self._results.pop(rid, [])

    def cancel(self, rid: int) -> None:
        """Cancel a request submitted through this driver; its result is
        dropped when it arrives."""
        with self._cv:
            if self._results.pop(rid, None) is not None:
                return
            self.batcher.cancel(rid)
            self._abandoned.add(rid)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


# bytes of one ticket or call on the lockstep op stream (its JSON): larger
# ones are refused where they are submitted
MAX_REQUEST_BYTES = 1 << 17


class PayloadTooLarge(ValueError):
    """A lockstep ticket or call over MAX_REQUEST_BYTES: refused alone."""


def _sampling_to_wire(sp: Optional[SamplingParams]):
    """SamplingParams -> a JSON value (broadcast_obj carries JSON)."""
    if sp is None:
        return None
    d = dataclasses.asdict(sp)
    d["token_ban"] = list(d["token_ban"])
    d["token_stop"] = list(d["token_stop"])
    return d


def _sampling_from_wire(d) -> Optional[SamplingParams]:
    if d is None:
        return None
    d = dict(d)
    d["token_ban"] = tuple(d["token_ban"])
    d["token_stop"] = tuple(d["token_stop"])
    return SamplingParams(**d)


def _measured(message: dict) -> dict:
    n = len(json.dumps(message).encode())
    if n > MAX_REQUEST_BYTES:
        raise PayloadTooLarge(f"request of {n} bytes: the lockstep server carries at most "
                              f"{MAX_REQUEST_BYTES} bytes a request to its other processes")
    return message


class LockstepBatcherDriver:
    """Continuous batching across the processes of a tensor-parallel group
    (JAX continuous.py:907-1193).

    Every process holds an identical ContinuousBatcher over its rank of the
    engine; the model's collectives make every rank issue the same calls in
    the same order. Requests arrive on process 0 only, so process 0 turns
    the batcher's inputs into an op stream: before every tick it broadcasts
    {submits, cancels, calls} (``parallel.distributed.broadcast_obj``),
    applies it and steps; the other processes replay the stream
    (``worker_loop``). Request ids, admissions and blocks are then the same
    everywhere, and so are the sampled tokens (the same logits on every
    rank, the same seeded generator). ``calls`` carries the other endpoints
    (/embed, /similarity, /rerank, /process_text, and every request of the
    plain engine mode): process 0's HTTP threads enqueue (route, payload) and
    the loop runs ``svc_handle`` inside the stream on every process. At most
    ``_MAX_SUBMITS_PER_TICK`` submits join a tick. A per-request
    ``initial_state`` is refused (tensors do not go on the stream).

    With ``batcher=None`` the stream carries calls only: the plain engine
    mode of the multi-process server. While process 0 is idle it broadcasts
    an empty tick every ``HEARTBEAT_S``, so a worker's wait never reaches the
    group's collective timeout while process 0 lives, and ends in an error
    once it is gone.

    Process 0: construct with ``svc_handle`` and serve; the others:
    construct and call ``worker_loop()``, which returns at shutdown.
    """

    _MAX_SUBMITS_PER_TICK = 8
    HEARTBEAT_S = 1.0

    def __init__(self, batcher: Optional[ContinuousBatcher], svc_handle=None,
                 poll: float = 0.01):
        from rwkv_lm_ext_tpu_torch.parallel.distributed import is_main_process

        self.batcher = batcher
        self.svc_handle = svc_handle
        self.poll = poll
        self._cv = threading.Condition()
        self._stop = False
        self._error: Optional[BaseException] = None
        self._is_main = is_main_process()
        if self._is_main:
            self._pending: List[dict] = []         # tickets awaiting a tick
            self._pending_cancels: List[int] = []
            self._pending_calls: List[dict] = []   # {"cid", "route", "payload"}
            self._results: Dict[int, List[int]] = {}
            self._call_results: Dict[int, object] = {}
            self._abandoned: set = set()
            self._next_cid = 0
            self._thread = threading.Thread(target=self._main_loop, daemon=True)
            self._thread.start()

    @property
    def _busy(self) -> bool:
        return self.batcher is not None and self.batcher.busy

    def _raise_if_dead(self) -> None:
        if self._error is not None:
            raise RuntimeError("lockstep serving loop died") from self._error

    # -- process 0 (HTTP handler threads) ------------------------------

    def submit_and_wait(
        self, prompt, *, max_tokens: int = 128,
        sampling: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
        callback: Optional[Callable[[int], None]] = None,
        initial_state: Optional[ModelState] = None, adapter: Optional[str] = None,
        cancel: Optional[threading.Event] = None,
    ) -> List[int]:
        """BatcherDriver.submit_and_wait through the op stream."""
        if not self._is_main or self.batcher is None:
            raise RuntimeError("submit on process 0 of a lockstep batcher only")
        if initial_state is not None:
            raise ValueError("a per-request initial_state is not supported in lockstep serving "
                             "(named states go through /process_text)")
        if isinstance(prompt, str):
            prompt = self.batcher.engine.tokenizer.encode(prompt)
        wire = _measured({"ids": [int(t) for t in prompt], "max_tokens": max_tokens,
                          "sampling": _sampling_to_wire(sampling), "adapter": adapter})
        ticket = {"wire": wire, "callback": callback, "rid": None, "error": None}
        with self._cv:
            self._raise_if_dead()
            self._pending.append(ticket)
            self._cv.notify_all()

            def ready():
                return (ticket["error"] is not None or self._stop
                        or (ticket["rid"] is not None and ticket["rid"] in self._results))

            if cancel is None:
                ok = self._cv.wait_for(ready, timeout=timeout)
            else:
                deadline = None if timeout is None else time.monotonic() + timeout
                while not ready() and not cancel.is_set():
                    step = self.poll
                    if deadline is not None:
                        step = min(step, deadline - time.monotonic())
                        if step <= 0:
                            break
                    self._cv.wait(timeout=step)
                ok = ready()
                if not ok and cancel.is_set():
                    self._cancel_ticket(ticket)
                    self._cv.wait_for(ready, timeout=10.0)
                    if ticket["rid"] is not None:
                        return self._results.pop(ticket["rid"], [])
                    return []
            if ticket["error"] is not None:
                raise ticket["error"]
            if not ok:
                self._cancel_ticket(ticket)
                if ticket["rid"] is not None:
                    self._abandoned.add(ticket["rid"])
                raise TimeoutError("lockstep request timed out")
            if ticket["rid"] not in self._results:
                self._raise_if_dead()
            return self._results.pop(ticket["rid"], [])

    def _cancel_ticket(self, ticket) -> None:
        """Caller holds _cv. A ticket not yet on the stream is dropped here;
        an admitted one is cancelled through the stream."""
        if ticket in self._pending:
            self._pending.remove(ticket)
            ticket["error"] = TimeoutError("cancelled before admission")
        elif ticket["rid"] is not None:
            self._pending_cancels.append(ticket["rid"])

    def call(self, route: str, payload):
        """Run ``svc_handle(route, payload)`` inside the stream on every
        process; returns process 0's answer (its exception re-raises
        here)."""
        if not self._is_main:
            raise RuntimeError("call on process 0 only")
        message = _measured({"route": route, "payload": payload})
        with self._cv:
            self._raise_if_dead()
            cid = self._next_cid
            self._next_cid += 1
            self._pending_calls.append(dict(message, cid=cid))
            self._cv.notify_all()
            self._cv.wait_for(lambda: cid in self._call_results or self._stop)
            res = self._call_results.pop(cid, None)
            if res is None:
                self._raise_if_dead()
        if isinstance(res, BaseException):
            raise res
        return res

    def cancel(self, rid: int) -> None:
        with self._cv:
            if self._results.pop(rid, None) is not None:
                return
            self._pending_cancels.append(rid)
            self._abandoned.add(rid)
            self._cv.notify_all()

    # -- the loops -------------------------------------------------------

    def _drain(self):
        """Caller holds _cv: the pending work as one message, and the
        tickets it carries."""
        tickets = self._pending[: self._MAX_SUBMITS_PER_TICK]
        self._pending = self._pending[self._MAX_SUBMITS_PER_TICK:]
        cancels, self._pending_cancels = self._pending_cancels, []
        calls, self._pending_calls = self._pending_calls, []
        msg = {"submits": [t["wire"] for t in tickets], "cancels": cancels, "calls": calls,
               "stop": False}
        return msg, tickets

    def _apply(self, msg, tickets=None) -> None:
        """One message into the local batcher (every process). A submit's
        error is the same on every process (same inputs, same batcher), so
        each raises and drops the same ones."""
        for i, s in enumerate(msg["submits"]):
            try:
                rid = self.batcher.submit(
                    s["ids"], max_tokens=s["max_tokens"],
                    sampling=_sampling_from_wire(s["sampling"]), adapter=s["adapter"],
                    callback=tickets[i]["callback"] if tickets else None)
                if tickets:
                    tickets[i]["rid"] = rid
            except Exception as e:  # noqa: BLE001 - the same on every process
                if tickets:
                    tickets[i]["error"] = e
        for rid in msg["cancels"]:
            self.batcher.cancel(rid)

    def _main_loop(self) -> None:
        from rwkv_lm_ext_tpu_torch.parallel.distributed import broadcast_obj

        while True:
            with self._cv:
                idle_since = time.monotonic()
                while (not self._pending and not self._pending_calls
                       and not self._pending_cancels and not self._busy and not self._stop
                       and time.monotonic() - idle_since < self.HEARTBEAT_S):
                    self._cv.wait(timeout=self.poll)
                stop = self._stop
                if not stop:
                    msg, tickets = self._drain()
            try:
                if stop:
                    broadcast_obj({"stop": True})
                    return
                broadcast_obj(msg)
                if msg["submits"] or msg["cancels"]:
                    with self._cv:
                        self._apply(msg, tickets)
                        self._cv.notify_all()
                for c in msg["calls"]:
                    try:
                        res = self.svc_handle(c["route"], c["payload"])
                    except BaseException as e:  # noqa: BLE001 - to the caller
                        res = e
                    with self._cv:
                        self._call_results[c["cid"]] = res
                        self._cv.notify_all()
                done = self.batcher.step() if self._busy else {}
            except BaseException as e:  # noqa: BLE001 - surfaced to the waiters
                with self._cv:
                    self._error = e
                    self._stop = True
                    self._cv.notify_all()
                return
            if done:
                with self._cv:
                    self._results.update(done)
                    for rid in self._abandoned & set(self._results):
                        self._results.pop(rid)
                        self._abandoned.discard(rid)
                    self._cv.notify_all()

    def worker_loop(self) -> None:
        """The other processes: replay the stream until process 0 stops it.
        A call's error is process 0's too, and is its to report."""
        from rwkv_lm_ext_tpu_torch.parallel.distributed import broadcast_obj

        if self._is_main:
            raise RuntimeError("worker_loop is for the processes other than 0")
        while True:
            msg = broadcast_obj()
            if msg.get("stop"):
                return
            if msg["submits"] or msg["cancels"]:
                self._apply(msg)
            for c in msg["calls"]:
                try:
                    self.svc_handle(c["route"], c["payload"])
                except Exception:  # noqa: BLE001 - mirrors process 0
                    pass
            if self._busy:
                self.batcher.step()

    def close(self) -> None:
        """Process 0: stop the stream (the workers' loops return)."""
        if not self._is_main:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
