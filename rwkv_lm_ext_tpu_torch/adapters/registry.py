"""Named adapter registry: merged serving weights per adapter.

Counterpart of rwkv_lm_ext_tpu/adapters/registry.py:21-54
(AdapterRegistry). One base model serves several LoRA adapters: an adapter
switch is ``materialize(name)``, which returns a model holding the merged
weights W + scale * A @ B (``adapters.lora.merge_lora``), cached per adapter
(memory for zero switch latency), so requests with different adapters can
run concurrently. The base itself is never modified: every adapter merges
into its own copy. PiSSA's init-residual merge waits with PiSSA training.
"""
from __future__ import annotations

import copy
from typing import Dict

from rwkv_lm_ext_tpu_torch.adapters.lora import Adapter, LoraConfig, apply_lora, merge_lora


class AdapterRegistry:
    def __init__(self, base_model):
        self.base = base_model
        self._adapters: Dict[str, tuple] = {}
        self._cache: Dict[str, object] = {}

    def register(self, name: str, adapter: Adapter, lc: LoraConfig) -> None:
        if lc.pissa:
            raise NotImplementedError(f"adapter {name!r}: PiSSA merges wait in the port")
        self._adapters[name] = (adapter, lc)
        self._cache.pop(name, None)

    def names(self):
        return ["default", *self._adapters]

    def materialize(self, name: str = "default"):
        """The serving model of an adapter ("default" is the bare base)."""
        if name == "default":
            return self.base
        if name in self._cache:
            return self._cache[name]
        adapter, lc = self._adapters[name]
        merged = self._cache[name] = merge_lora(apply_lora(copy.deepcopy(self.base), lc, adapter))
        return merged
