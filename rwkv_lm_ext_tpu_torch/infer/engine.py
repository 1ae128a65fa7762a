"""Generation engine: chunked prefill, then K-step decode blocks.

Counterpart of rwkv_lm_ext_tpu/infer/engine.py:24-40 (_chunk_plan) and
43-480 (GenerationEngine: init_state, prefill with ``state_cache`` and
``cache_salt`` :190-234, the K-step block ``_block_decode_fn`` :121-180,
generate_batch, generate with ``adapter=`` :375-425, ``adapter_ids``) and
its ``mesh`` (:57-77, 183-188). Left out: ``wkv_backend`` (the port has one
WKV route) and ``generate_on_device`` (a TPU dispatch workaround that the
graph blocks cover).

``mesh`` (parallel.mesh.make_mesh) makes the engine one rank of a
head-parallel tensor-parallel group: the model is cut into the rank's part
(parallel.tp.shard_model) and the state holds the rank's heads, as JAX places
the parameters and the state under its shardings. Every rank runs the same
calls in the same order (the lockstep server, infer/continuous.py). Decode
blocks are CUDA graphs only where the group's collectives can be captured
(NCCL); under gloo, whose collectives are staged through host memory, the
engine runs eager blocks on the card: an explicit route, ``route()``, which
the serving CLI prints and /stats reports. ``fused_prep`` is refused under
tp: B.10 writes the decay over all n_embd channels, and a rank's decay is
its dim_att / tp slice.

Decode runs in blocks of K decode+sample steps between host fetches. Within
a block nothing is read back: the stop rule and the token budget run on the
device (once a stop token is sampled or the budget is spent, the state, the
occurrences and the token freeze), and one packed fetch of the block's
tokens, emit flags and done flags follows it. On a CUDA device a block is
ONE CUDA graph replay, the counterpart of the JAX engine's single jitted
``lax.scan`` dispatch: the K steps are captured once per (K, rows, stop
width, batch-shaping sampling knobs, route) over static token, state,
occurrence, knob, stop, budget and flag buffers, which each request's
values are copied into and never rebound, and the sampling generator is
registered with the graph, so a replay draws what the eager block draws.
The per-request knobs (temperature, top_p, the penalties) are (rows,)
device rows, as in the continuous batcher, so new knobs or a new length
reuse the graphs; the last block of a generation is a whole block whose
steps past the budget are frozen (the JAX engine compiles a block of the
remainder's length instead). On the CPU the same block runs eagerly. A
capture or a replay that fails raises; nothing falls back to the eager
block on a card. Outputs and the final state do not depend on the block
size; the streaming callback fires once a block (``block_size=1`` streams
every token as it is made).

``fused_prep`` passes the fused T=1 route (models/decode.py) down to every
decode step; None (the default) is the unfused route.

A model with slot-LoRA projections (adapters/slot_lora.py) decodes each
generation under the adapter ``generate(adapter=)`` names; ``adapter_ids``
maps names to stack rows. ``state_cache`` (infer/state_cache.py) resumes a
prompt from its longest cached prefix. One re-entrant lock serialises the
engine's users (the continuous batcher's thread takes it too), since the
static buffers and the model's slot index are shared.
"""
from __future__ import annotations

import gc
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.slot_lora import has_slot_lora, set_slot_idx
from rwkv_lm_ext_tpu_torch.infer.sampling import (
    SLOT_PARAM_FIELDS,
    SamplingParams,
    global_knobs,
    sample_token_rows,
    slot_params,
)
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.state import ModelState, clone_state, init_model_state

# decode steps a block of generate_batch (one fetch at its end)
BATCH_BLOCK = 16
# stop tokens a generate decoder's stop matrix holds (a request with more gets
# a decoder of its own width)
STOP_CAPACITY = 8
# decoders (static buffers and their graphs) an engine keeps, least recently
# used first out: one per row count, stop width and set of batch-shaping
# sampling knobs
MAX_DECODERS = 8


def _chunk_plan(n: int, chunk_len: int) -> List[int]:
    """n as [chunk_len] * k + descending powers of two: the prefill piece
    lengths."""
    plan = []
    while n >= chunk_len:
        plan.append(chunk_len)
        n -= chunk_len
    size = min(1 << (chunk_len - 1).bit_length() - 1 if chunk_len > 1 else 1, chunk_len)
    while n > 0 and size >= 1:
        if n >= size:
            plan.append(size)
            n -= size
        else:
            size //= 2
    return plan


def capture_graph(body: Callable[[], None], warmup: Callable[[], None],
                  generator: torch.Generator, device) -> torch.cuda.CUDAGraph:
    """``warmup()`` once on a side stream, then ``body()`` captured into a
    CUDA graph that draws from ``generator``. The warm-up runs every kernel
    wrapper's lazy set-up (the library build, occupancy queries, kernel
    attributes, tensor maps) outside the capture; it must leave the buffers
    that ``body`` reads as they were. The garbage collector runs before the
    capture and not during it: garbage that holds a CUDA graph (an engine
    dropped in a reference cycle) would destroy that graph mid-capture, a
    call the capture refuses, which invalidates it. Raises if the capture
    fails."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        warmup()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            body()
    finally:
        if collecting:
            gc.enable()
    return graph


def refuse_chunk_dependent(cfg, what: str) -> None:
    """Raise, by name, for a model whose answers depend on how a prompt is
    cut into calls (``cfg.chunk_dependent_options``, ROADMAP C.21): a server
    cuts prompts into prefill chunks and decode steps."""
    if cfg.chunk_dependent_options:
        raise ValueError(
            f"{what} refuses a model with {', '.join(cfg.chunk_dependent_options)}: these options "
            "see only the tokens of one call, so chunked prefill and decode steps would answer "
            "otherwise than one call over the whole text (ROADMAP C.21)")


def warm_step(model, rows: int, sampling_fn, fused_prep) -> None:
    """One decode step and one sampling draw on zero scratch buffers (the
    warm-up before a capture): nothing the caller holds changes."""
    device = model.emb.weight.device
    state = init_model_state(model.cfg, rows, device=device)
    token = torch.zeros(rows, dtype=torch.int64, device=device)
    logits, _ = rwkv_decode_step(model, token, state, out=state, fused_prep=fused_prep)
    sampling_fn(logits)


class _Decoder:
    """Static buffers of decode blocks over ``rows`` streams: the token
    (rows,), the state (decoded in place), the occurrences (rows, V), the
    per-row sampling knobs (slot_params) and one packed (2K + 1, rows)
    output a block length. With ``stop_cap`` > 0 (generate) it also holds a
    (rows, stop_cap) stop matrix (-1 pads it), a budget and done flags
    (rows,) and a scratch state: a stream is done once its token is a stop
    token or its budget is spent, and from then on its steps are dropped
    (state, occurrences and token keep their values). With ``stop_cap`` 0
    (generate_batch) every step runs through. The knobs, the stops and the
    budget are data, so one graph a block length serves every request with
    the decoder's batch-shaping knobs (sampling.global_knobs) and a request
    shorter than a block runs a whole block, its last steps frozen.
    ``_block(k)`` is the eager block; on a CUDA device ``run`` replays it
    as a graph captured at the length's first use. It holds the model, not
    the engine, so that an engine and its decoders form no reference cycle:
    their graphs are freed when the engine is, never by a garbage collection
    that could fall in a capture."""

    def __init__(self, model, fused_prep, sampling: SamplingParams, rows: int, stop_cap: int,
                 use_graphs: bool):
        dev = model.emb.weight.device
        self.model, self.fused_prep, self.sampling, self.rows = model, fused_prep, sampling, rows
        self.use_graphs = use_graphs
        self.token = torch.zeros(rows, dtype=torch.int64, device=dev)
        self.state = init_model_state(model.cfg, rows, device=dev)
        self.occ = torch.zeros(rows, model.cfg.vocab_size, device=dev)
        self.knobs = slot_params(rows, sampling, device=dev)
        self.stops = self.budget = self.done = self.scratch = None
        if stop_cap:
            self.stops = torch.full((rows, stop_cap), -1, dtype=torch.int64, device=dev)
            self.budget = torch.zeros(rows, dtype=torch.int64, device=dev)
            self.done = torch.zeros(rows, dtype=torch.bool, device=dev)
            self.scratch = {k: torch.empty_like(v) for k, v in self.state.items()}
        self.packed: Dict[int, torch.Tensor] = {}
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}

    def load(self, logits: torch.Tensor, state: ModelState, sampling: SamplingParams,
             budget: int, gen: torch.Generator) -> None:
        """A new generation in every row: the request's knobs, stop tokens
        and budget, its state, and its first token sampled from the
        prefill's last logits (rows, V)."""
        for f in SLOT_PARAM_FIELDS:
            self.knobs[f].fill_(float(getattr(sampling, f)))
        for key, value in self.state.items():
            value.copy_(state[key])
        token, occ = sample_token_rows(logits, torch.zeros_like(self.occ), self.knobs,
                                       self.sampling, gen)
        self.token.copy_(token)
        self.occ.copy_(occ)
        if self.stops is not None:
            self.stops.fill_(-1)
            for j, t in enumerate(sampling.token_stop):
                self.stops[:, j].fill_(t)
            self.budget.fill_(budget)
            self.done.zero_()

    def _block(self, k: int, gen: torch.Generator) -> None:
        """K decode+sample steps from the buffers back into them; the
        block's [tokens | emit flags | done] into packed[k]."""
        model, fused_prep, sp, knobs = self.model, self.fused_prep, self.sampling, self.knobs
        token, occ, done, budget = self.token, self.occ, self.done, self.budget
        toks, emits = [], []
        for _ in range(k):
            if self.stops is None:
                toks.append(token)
                logits, _ = rwkv_decode_step(model, token, self.state, out=self.state,
                                             fused_prep=fused_prep)
                token, occ = sample_token_rows(logits, occ, knobs, sp, gen)
                continue
            done = done | (token[:, None] == self.stops).any(-1) | (budget <= 0)
            emits.append(~done)
            toks.append(token)
            budget = budget - (~done).long()
            out = self.scratch
            logits, _ = rwkv_decode_step(model, token, self.state, out=out, fused_prep=fused_prep)
            new_token, new_occ = sample_token_rows(logits, occ, knobs, sp, gen)
            # once done, a stream's step is dropped: its state, occurrences
            # and token keep their values
            for key, value in self.state.items():
                keep = done.view(1, -1, *[1] * (value.dim() - 2))
                torch.where(keep, value, out[key], out=value)
            occ = torch.where(done[:, None], occ, new_occ)
            token = torch.where(done, token, new_token)
        if self.stops is None:
            self.packed[k][:k].copy_(torch.stack(toks))
        else:
            self.packed[k].copy_(torch.stack(toks + [e.long() for e in emits] + [done.long()]))
            self.done.copy_(done)
            self.budget.copy_(budget)
        self.token.copy_(token)
        self.occ.copy_(occ)

    def run(self, k: int, gen: torch.Generator) -> torch.Tensor:
        """One block of k steps: one graph replay on a card (``use_graphs``),
        else eagerly. Returns packed[k] (overwritten by the next block of
        that length)."""
        if k not in self.packed:
            self.packed[k] = torch.zeros(2 * k + 1, self.rows, dtype=torch.int64,
                                         device=self.token.device)
        if self.use_graphs:
            self._replay(k, gen)
        else:
            self._block(k, gen)
        return self.packed[k]

    def _replay(self, k: int, gen: torch.Generator) -> None:
        """The block as a CUDA graph, captured at its first use."""
        graph = self.graphs.get(k)
        if graph is None:
            graph = self.graphs[k] = capture_graph(
                lambda: self._block(k, gen),
                lambda: warm_step(self.model, self.rows, self._warm_sample, self.fused_prep),
                gen, self.token.device)
        graph.replay()

    def _warm_sample(self, logits: torch.Tensor) -> None:
        scratch = torch.Generator(device=logits.device).manual_seed(0)
        sample_token_rows(logits, torch.zeros_like(self.occ), self.knobs, self.sampling, scratch)


class GenerationEngine:
    """Generation with one model (``RWKV`` of any family, possibly quantized
    or with slot-LoRA projections) on its device; ``tokenizer`` turns str
    prompts into ids and ids into text. A model with ``head_qk``,
    ``tiny_att_dim`` or ``my_pos_emb`` is refused by name
    (``refuse_chunk_dependent``). ``mesh`` (tp > 1) cuts the whole model
    given into this rank's part, in place (module docstring)."""

    def __init__(self, model, tokenizer=None, *, chunk_len: int = 256,
                 fused_prep: Optional[bool] = None, state_cache=None,
                 adapter_ids: Optional[Dict[str, int]] = None, mesh=None):
        refuse_chunk_dependent(model.cfg, "GenerationEngine")
        if mesh is not None and mesh.dp > 1:
            raise ValueError(f"serving takes dp = 1, not dp={mesh.dp}: replicas behind one "
                             "server are not ported (ROADMAP A.12)")
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        if self.mesh is not None:
            from rwkv_lm_ext_tpu_torch.parallel.tp import shard_model

            if fused_prep:
                raise ValueError(
                    "fused_prep is refused under tensor parallelism: B.10 writes the decay over "
                    "all n_embd channels, a rank's decay is its dim_att / tp slice")
            if has_slot_lora(model):
                raise ValueError("slot-LoRA serving is not ported under tensor parallelism "
                                 "(ROADMAP A.12)")
            shard_model(model, self.mesh)
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.chunk_len = chunk_len
        self.fused_prep = fused_prep
        self.state_cache = state_cache
        self.adapter_ids = adapter_ids
        self.device = model.emb.weight.device
        self.lock = threading.RLock()
        self._slot_lora = has_slot_lora(model)
        self._row_idx: Dict[int, torch.Tensor] = {}
        self._decoders: "OrderedDict[tuple, _Decoder]" = OrderedDict()
        self._gen = torch.Generator(device=self.device)
        self.graph_blocks = self.device.type == "cuda" and (
            self.mesh is None or self.mesh.graph_capture)

    def route(self) -> Dict:
        """How this engine runs: its device, its decode blocks ("graph" or
        "eager") and, under tensor parallelism, the group (tp, rank,
        backend)."""
        blocks = "graph" if self.graph_blocks else "eager"
        if self.device.type == "cuda" and not self.graph_blocks:
            blocks = "eager (gloo collectives cannot be captured into a CUDA graph)"
        out = {"device": str(self.device), "blocks": blocks}
        if self.mesh is not None:
            out.update(self.mesh.describe())
        return out

    def init_state(self, batch_size: int = 1, wkv_init: Optional[torch.Tensor] = None) -> ModelState:
        return init_model_state(self.cfg, batch_size, device=self.device, wkv_init=wkv_init)

    def _ids(self, prompt) -> List[int]:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("a str prompt needs a tokenizer")
            return self.tokenizer.encode(prompt)
        return [int(t) for t in prompt]

    def adapter_id(self, adapter: Optional[str]) -> int:
        """The stack row of a named adapter; None and "base" are 0."""
        if adapter is None or adapter == "base":
            return 0
        if not self._slot_lora or not self.adapter_ids or adapter not in self.adapter_ids:
            raise ValueError(f"unknown adapter {adapter!r}")
        return self.adapter_ids[adapter]

    def select_rows(self, rows: int, adapter_id: int = 0) -> None:
        """Run the next calls of ``rows`` rows under one adapter: the model's
        slot index becomes this engine's (rows,) tensor for that count,
        filled in place with ``adapter_id``. No-op without slot-LoRA."""
        if not self._slot_lora:
            return
        idx = self._row_idx.get(rows)
        if idx is None:
            idx = self._row_idx[rows] = torch.zeros(rows, dtype=torch.int64, device=self.device)
        idx.fill_(adapter_id)
        set_slot_idx(self.model, idx)

    def prefill(self, tokens: Sequence[int], state: Optional[ModelState] = None, *,
                cache_salt: Optional[str] = None) -> Tuple[torch.Tensor, ModelState]:
        """Run the prompt in _chunk_plan pieces; returns (last-token logits
        (V,), state). The given state is not modified. ``cache_salt`` names
        the adapter the prompt runs under (None: the base) and namespaces
        its prefix-cache entries. With a state cache and no explicit state,
        the longest cached strict prefix is resumed and only the rest runs;
        every chunk-boundary state and the final state are inserted."""
        if len(tokens) == 0:
            raise ValueError("empty prompt")
        with self.lock, torch.inference_mode():
            self.select_rows(1, self.adapter_id(cache_salt))
            use_cache = state is None and self.state_cache is not None
            off = 0
            if use_cache:
                cached, off = self.state_cache.lookup(tokens, salt=cache_salt)
                if cached is not None:
                    state = cached
            if state is None:
                state = self.init_state(1)
            tok = torch.as_tensor(list(tokens), dtype=torch.int64, device=self.device)
            sizes = _chunk_plan(len(tokens) - off, self.chunk_len)
            logits = None
            for i, size in enumerate(sizes):
                logits, state = self.model(tok[off: off + size][None], state)
                off += size
                # a repeated prompt resumes from its last chunk boundary: the
                # whole prompt's entry can never serve it (lookups are strict)
                if use_cache and i < len(sizes) - 1:
                    self.state_cache.insert(tokens[:off], state, salt=cache_salt)
            if use_cache:
                self.state_cache.insert(tokens, state, salt=cache_salt)
        return logits[0, -1], state

    def _decoder(self, sampling: SamplingParams, rows: int, stop_cap: int) -> _Decoder:
        key = (global_knobs(sampling), rows, stop_cap, bool(self.fused_prep))
        dec = self._decoders.pop(key, None) or _Decoder(self.model, self.fused_prep, sampling,
                                                        rows, stop_cap, self.graph_blocks)
        self._decoders[key] = dec
        while len(self._decoders) > MAX_DECODERS:
            self._decoders.popitem(last=False)
        return dec

    def generate_batch(
        self,
        prompts,
        *,
        max_tokens: int = 128,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
    ):
        """All prompts decode together on the batch axis. Prompts are
        left-padded with 0 so every row's last prompt token lands on the
        same step; whole blocks of BATCH_BLOCK steps (a last block's tokens
        past max_tokens are dropped), one fetch at the end. Returns
        per-prompt texts (or id lists without a tokenizer), each cut at its
        first stop token."""
        enc = [self._ids(p) for p in prompts]
        B, L = len(enc), max(len(e) for e in enc)
        tok = np.zeros((B, L), np.int64)
        for i, e in enumerate(enc):
            tok[i, L - len(e):] = e
        with self.lock, torch.inference_mode():
            self.select_rows(B)
            logits, state = self.model(torch.from_numpy(tok).to(self.device))
            gen = self._gen.manual_seed(seed)
            dec = self._decoder(sampling, B, 0)
            dec.load(logits[:, -1], state, sampling, max_tokens, gen)
            blocks = [dec.run(BATCH_BLOCK, gen)[:BATCH_BLOCK].clone()
                      for _ in range(-(-max_tokens // BATCH_BLOCK))]
            rows = (torch.cat(blocks)[:max_tokens].t().tolist() if blocks
                    else [[] for _ in enc])
        stops = set(sampling.token_stop)
        outs = []
        for row in rows:
            ids = []
            for t in row:
                if t in stops:
                    break
                ids.append(t)
            outs.append(self.tokenizer.decode(ids) if self.tokenizer else ids)
        return outs

    def generate(
        self,
        prompt,
        *,
        max_tokens: int = 128,
        sampling: SamplingParams = SamplingParams(),
        state: Optional[ModelState] = None,
        seed: int = 0,
        callback: Optional[Callable[[str], None]] = None,
        return_state: bool = False,
        adapter: Optional[str] = None,
        block_size: int = 16,
    ):
        """Autoregressive generation: occurrence penalties, token ban and
        stop, a UTF-8-safe streaming ``callback`` (text pieces), under the
        slot-LoRA ``adapter`` named (None or "base": the base weights).
        ``block_size``: decode steps between host fetches; the callback
        fires once a block. Returns the text (or ids without a tokenizer),
        and the final state with ``return_state``."""
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        ids = self._ids(prompt)
        salt = None if adapter in (None, "base") else adapter
        self.adapter_id(salt)
        out_ids: List[int] = []
        decoder = self.tokenizer.streaming_decoder() if self.tokenizer else None

        def emit(t: int) -> None:
            out_ids.append(t)
            if decoder is not None and callback is not None:
                piece = decoder.push(t)
                if piece:
                    callback(piece)

        with self.lock, torch.inference_mode():
            logits, cur = self.prefill(ids, state, cache_salt=salt)
            gen = self._gen.manual_seed(seed)
            dec = self._decoder(sampling, 1, max(STOP_CAPACITY, len(sampling.token_stop)))
            dec.load(logits[None], cur, sampling, max_tokens, gen)
            remaining = max_tokens
            while remaining > 0:
                # a whole block even for a shorter rest: its budget freezes
                # the stream after the last token
                packed = dec.run(block_size, gen).view(-1).tolist()      # one fetch a block
                for t, e in zip(packed[:block_size], packed[block_size:2 * block_size]):
                    if not e:
                        break
                    emit(t)
                remaining -= block_size
                if packed[-1]:
                    break
            final = clone_state(dec.state) if return_state else None
        if decoder is not None and callback is not None:
            tail = decoder.flush()
            if tail:
                callback(tail)
        result = self.tokenizer.decode(out_ids) if self.tokenizer else out_ids
        return (result, final) if return_state else result
