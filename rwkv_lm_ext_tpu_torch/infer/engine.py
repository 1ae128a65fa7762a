"""Generation engine: chunked prefill, then decode steps with sampling.

Counterpart of rwkv_lm_ext_tpu/infer/engine.py:24-40 (_chunk_plan),
43-235 and 300-480 (GenerationEngine: init_state, prefill, generate_batch,
generate). Left out for now: ``mesh``, ``state_cache``, the slot-LoRA
``adapter``, ``wkv_backend`` and ``generate_on_device`` (a workaround for
TPU dispatch latency).

Decode runs eagerly on the device. ``generate`` runs ``block_size`` decode
and sample steps between host fetches: within a block nothing is read back,
the stop rule runs on the device (once a stop token is sampled the state,
the occurrences and the token freeze), and one packed fetch of the block's
tokens, emit flags and done flag follows it, as the JAX engine's jitted
block does (:121-180). Outputs and the final state do not depend on
``block_size``; the streaming callback fires once per block, so the library
default is 1 (a callback per token). The state buffers are updated in
place: ``generate_batch`` decodes into its own state, ``generate``
ping-pongs between two buffers so that a frozen step can keep the old one.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams, sample_token
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.state import ModelState, init_model_state


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


class GenerationEngine:
    """Generation with one model (``RWKV``, possibly quantized) on its
    device; ``tokenizer`` turns str prompts into ids and ids into text."""

    def __init__(self, model, tokenizer=None, *, chunk_len: int = 256):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.chunk_len = chunk_len
        self.device = model.emb.weight.device

    def init_state(self, batch_size: int = 1) -> ModelState:
        return init_model_state(self.cfg, batch_size, device=self.device)

    def _ids(self, prompt) -> List[int]:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("a str prompt needs a tokenizer")
            return self.tokenizer.encode(prompt)
        return [int(t) for t in prompt]

    def prefill(self, tokens: Sequence[int], state: Optional[ModelState] = None
                ) -> Tuple[torch.Tensor, ModelState]:
        """Run the prompt in _chunk_plan pieces; returns (last-token logits
        (V,), state). The given state is not modified."""
        if len(tokens) == 0:
            raise ValueError("empty prompt")
        if state is None:
            state = self.init_state(1)
        tok = torch.as_tensor(list(tokens), dtype=torch.int64, device=self.device)
        off, logits = 0, None
        with torch.inference_mode():
            for size in _chunk_plan(len(tokens), self.chunk_len):
                logits, state = self.model(tok[off: off + size][None], state)
                off += size
        return logits[0, -1], state

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
        same step; one fetch at the end. Returns per-prompt texts (or id
        lists without a tokenizer), each cut at its first stop token."""
        enc = [self._ids(p) for p in prompts]
        B, L = len(enc), max(len(e) for e in enc)
        tok = np.zeros((B, L), np.int64)
        for i, e in enumerate(enc):
            tok[i, L - len(e):] = e
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            logits, state = self.model(torch.from_numpy(tok).to(self.device))
            occ = torch.zeros(B, self.cfg.vocab_size, device=self.device)
            token, occ = sample_token(logits[:, -1], occ, sampling, gen)
            toks = []
            for _ in range(max_tokens):
                toks.append(token)
                logits, state = rwkv_decode_step(self.model, token, state, out=state)
                token, occ = sample_token(logits, occ, sampling, gen)
            rows = torch.stack(toks, 1).cpu().tolist() if toks else [[] for _ in enc]
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
        block_size: int = 1,
    ):
        """Autoregressive generation: occurrence penalties, token ban and
        stop, a UTF-8-safe streaming ``callback`` (text pieces).
        ``block_size``: decode steps between host fetches; the callback
        fires once per block. Returns the text (or ids without a tokenizer),
        and the final state with ``return_state``."""
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        ids = self._ids(prompt)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        out_ids: List[int] = []
        decoder = self.tokenizer.streaming_decoder() if self.tokenizer else None

        def emit(t: int) -> None:
            out_ids.append(t)
            if decoder is not None and callback is not None:
                piece = decoder.push(t)
                if piece:
                    callback(piece)

        with torch.inference_mode():
            logits, cur = self.prefill(ids, state)
            occ = torch.zeros(self.cfg.vocab_size, device=dev)
            token, occ = sample_token(logits, occ, sampling, gen)
            nxt = {key: torch.empty_like(value) for key, value in cur.items()}
            stops = torch.as_tensor(sampling.token_stop, dtype=torch.int64, device=dev)
            done = torch.zeros((), dtype=torch.bool, device=dev)
            remaining = max_tokens
            while remaining > 0:
                k = min(block_size, remaining)
                toks, emits = [], []
                for _ in range(k):
                    done = done | torch.isin(token, stops)
                    toks.append(token)
                    emits.append(~done)
                    logits, nxt = rwkv_decode_step(self.model, token.view(1), cur, out=nxt)
                    new_token, new_occ = sample_token(logits[0], occ, sampling, gen)
                    # once done, the step's results are dropped: the state,
                    # occurrences and token keep their values
                    for key in cur:
                        torch.where(done, cur[key], nxt[key], out=nxt[key])
                    cur, nxt = nxt, cur
                    occ = torch.where(done, occ, new_occ)
                    token = torch.where(done, token, new_token)
                flags = [e.long() for e in emits + [done]]
                packed = torch.stack(toks + flags).tolist()   # one fetch a block
                for t, e in zip(packed[:k], packed[k:2 * k]):
                    if not e:
                        break
                    emit(int(t))
                remaining -= k
                if packed[-1]:
                    break
        if decoder is not None and callback is not None:
            tail = decoder.flush()
            if tail:
                callback(tail)
        result = self.tokenizer.decode(out_ids) if self.tokenizer else out_ids
        return (result, cur) if return_state else result
