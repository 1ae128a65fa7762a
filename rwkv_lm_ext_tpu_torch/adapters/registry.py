"""Named adapter registry: merged serving weights per adapter.

Counterpart of rwkv_lm_ext_tpu/adapters/registry.py:21-54
(AdapterRegistry). One base model serves several LoRA adapters: an adapter
switch is ``materialize(name)``, which returns a model holding the merged
weights W + scale * A @ B (``adapters.lora.merge_lora``), cached per adapter
(memory for zero switch latency), so requests with different adapters can
run concurrently. The base itself is never modified: every adapter merges
into its own copy. A PiSSA adapter registered with its SVD init
(``pissa_init``) merges against the original base (``merge_pissa``).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    Adapter,
    LoraConfig,
    apply_lora,
    merge_lora,
    merge_pissa,
)


class AdapterRegistry:
    def __init__(self, base_model):
        self.base = base_model
        self._adapters: Dict[str, tuple] = {}
        self._cache: Dict[str, object] = {}

    def register(self, name: str, adapter: Adapter, lc: LoraConfig,
                 pissa_init: Optional[Adapter] = None) -> None:
        """pissa_init: the SVD init saved at training start; when given, the
        adapter merges against the original base (``merge_pissa``)."""
        self._adapters[name] = (adapter, lc, pissa_init)
        self._cache.pop(name, None)

    def names(self):
        return ["default", *self._adapters]

    def materialize(self, name: str = "default"):
        """The serving model of an adapter ("default" is the bare base)."""
        if name == "default":
            return self.base
        if name in self._cache:
            return self._cache[name]
        adapter, lc, pissa_init = self._adapters[name]
        if pissa_init is not None:
            merged = merge_pissa(copy.deepcopy(self.base), adapter, pissa_init, lc)
        else:
            merged = merge_lora(apply_lora(copy.deepcopy(self.base), lc, adapter))
        self._cache[name] = merged
        return merged
