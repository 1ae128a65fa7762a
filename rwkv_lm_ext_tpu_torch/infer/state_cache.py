"""Prompt prefix cache: the recurrent state after a token prefix.

Counterpart of rwkv_lm_ext_tpu/infer/state_cache.py:38-112
(PrefixStateCache). RWKV's whole per-request cache is its O(1) recurrent
state, so a prefix cache is a small LRU map from (salt, token prefix) to the
state after that prefix: a later prompt that starts with a cached prefix
(a system prompt, a few-shot header, a chat history) resumes from it and
prefills only the rest. A cached state equals the one a full prefill reaches
at that position (the engine's chunk-boundary state contract).

The port decodes in place, so the cache never shares storage with a
caller: an insert stores a private clone and a lookup hands out a clone
(the counterpart of the JAX cache's copies around donated buffers).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

from rwkv_lm_ext_tpu_torch.models.state import ModelState, clone_state


class PrefixStateCache:
    """LRU map (salt, token prefix) -> state after consuming the prefix. The
    salt keeps namespaces apart (one per adapter in multi-adapter serving).

    ``lookup`` returns the longest cached key that is a STRICT prefix of the
    prompt, so at least one token is always prefilled and gives logits.
    Thread-safe: HTTP handler threads and the batcher's thread share one."""

    def __init__(self, capacity: int = 8, min_prefix: int = 8):
        self.capacity = int(capacity)
        self.min_prefix = int(min_prefix)
        self._entries: "OrderedDict[Tuple[object, Tuple[int, ...]], ModelState]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, tokens: Sequence[int], *, salt=None) -> Tuple[Optional[ModelState], int]:
        """Longest strict-prefix hit: (a clone of its state, its length), or
        (None, 0)."""
        ids = tuple(tokens)
        best = None
        with self._lock:
            for skey, key in self._entries:
                if (skey == salt and len(key) < len(ids)
                        and (best is None or len(key) > len(best[1]))
                        and ids[: len(key)] == key):
                    best = (skey, key)
            if best is None:
                self.misses += 1
                return None, 0
            self._entries.move_to_end(best)
            self.hits += 1
            state = self._entries[best]
        return clone_state(state), len(best[1])

    def insert(self, tokens: Sequence[int], state: ModelState, *, salt=None) -> None:
        """Cache the state reached after ``tokens`` (a private clone); nothing
        below ``min_prefix`` tokens or for a key already held."""
        key = (salt, tuple(tokens))
        if len(key[1]) < self.min_prefix:
            return
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
        copy = clone_state(state)
        with self._lock:
            self._entries[key] = copy
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses}
