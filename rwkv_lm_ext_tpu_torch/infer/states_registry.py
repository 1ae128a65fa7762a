"""Named state-tuned initial states for "states" serving.

Counterpart of rwkv_lm_ext_tpu/infer/states_registry.py:20-71
(extract_time_states, StatesRegistry). A state-tuning checkpoint holds one
``blocks.{i}.att.time_state`` (H, N, N) per layer, the WKV initial state of
its task (the shift states start at zero). A named state is their (L, H, N,
N) fp32 stack, plugged into ``init_model_state(wkv_init=...)``, so the
engine's prefill starts from it; each name carries an instruction template.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.checkpoint.pth import strip_prefix
from rwkv_lm_ext_tpu_torch.models.state import ModelState, init_model_state


def extract_time_states(state_dict: Dict, n_layer: int) -> torch.Tensor:
    """blocks.{i}.att.time_state for every layer -> (L, H, N, N) fp32 on the
    CPU (values may be tensors or numpy arrays)."""
    mats = []
    for i in range(n_layer):
        key = f"blocks.{i}.att.time_state"
        if key not in state_dict:
            raise KeyError(f"missing {key}: not a state-tuning checkpoint")
        value = state_dict[key]
        mats.append(value.detach().float().cpu() if isinstance(value, torch.Tensor)
                    else torch.from_numpy(np.asarray(value, np.float32)))
    return torch.stack(mats)


class StatesRegistry:
    """name -> (L, H, N, N) initial WKV states and instruction templates,
    kept on ``device`` (the engine's: a required keyword, as ``RWKV(cfg, *,
    device)`` has it). An RWKV-4 config is refused by name."""

    def __init__(self, cfg, *, device):
        if cfg.version < 5:
            raise ValueError("named states need an (H, N, N) WKV state: an RWKV-4 model has none "
                             "(the JAX package asserts the same, models/state.py:78)")
        self.cfg = cfg
        self.device = torch.device(device)
        self._states: Dict[str, torch.Tensor] = {}
        self._templates: Dict[str, str] = {}

    def register(self, name: str, wkv_init, template: str = "{input}") -> None:
        wkv_init = torch.as_tensor(wkv_init, dtype=torch.float32).to(self.device)
        want = (self.cfg.n_layer, self.cfg.n_head, self.cfg.head_size, self.cfg.head_size)
        if tuple(wkv_init.shape) != want:
            raise ValueError(f"state {name!r} has shape {tuple(wkv_init.shape)}, the model {want}")
        self._states[name] = wkv_init
        self._templates[name] = template

    def register_pth(self, name: str, path: str, template: str = "{input}") -> None:
        sd = strip_prefix(torch.load(path, map_location="cpu", weights_only=True))
        self.register(name, extract_time_states(sd, self.cfg.n_layer), template)

    def names(self):
        return list(self._states)

    def initial_state(self, name: str, batch_size: int = 1) -> ModelState:
        return init_model_state(self.cfg, batch_size, device=self.device,
                                wkv_init=self._states[name])

    def build_prompt(self, name: str, user_input: str) -> str:
        return self._templates[name].format(input=user_input)

    def generate(self, engine, name: str, user_input: str, **kw):
        """Generation from the named state on its template (the
        /process_text behaviour)."""
        return engine.generate(self.build_prompt(name, user_input),
                               state=self.initial_state(name, 1), **kw)
