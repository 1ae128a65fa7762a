"""Recurrent model state in the logical layout.

Counterpart of rwkv_lm_ext_tpu/models/state.py:70-96 (init_model_state,
with ``wkv_init``), :127 (clone_state) and :133 (gather_beams); the row
scatter ``scatter_rows`` is the batcher's admission (the ``.at[:, slots].set``
of rwkv_lm_ext_tpu/infer/continuous.py:251-253), in place. The state is a
dict of stacked fp32 tensors with a leading layer axis:

    att_shift: (L, B, C)        last ln1 output row fed to each time mix
    wkv:       (L, B, H, N, N)  WKV state in (K, V) layout
    ffn_shift: (L, B, C)        last ln2 output row fed to each channel mix

An RWKV-4 model's state (rwkv_lm_ext_tpu/models/rwkv4.py:35-44) has no
``wkv``; its WKV state is the log-space triple, each (L, B, C) fp32:

    att_shift, aa, bb, pp (starts at -1e38), ffn_shift

The functions below that walk the state's keys work on either layout.

The JAX package keeps ``wkv`` tile-packed as (L, B, H, N*N/128, 128), a
workaround for the TPU's 128-lane tiles; the port keeps it logical. The two
numpy helpers below convert a JAX state to the port's layout and back, the
same reshape as ``unpack_wkv``/``pack_wkv`` (state.py:53-67).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.ops.wkv4 import PP_START

ModelState = Dict[str, torch.Tensor]

V4_STATE_KEYS = ("att_shift", "aa", "bb", "pp", "ffn_shift")


def init_model_state(cfg, batch_size: int, *, device,
                     wkv_init: Optional[torch.Tensor] = None) -> ModelState:
    """Zero state (pp at -1e38 for RWKV-4); ``wkv_init`` ((L, H, N, N) shared
    by every row, or (L, B, H, N, N)) sets the WKV part: the initial state of
    named-states serving, which RWKV-4 has not."""
    L, B, C = cfg.n_layer, batch_size, cfg.n_embd
    H, N = cfg.n_head, cfg.head_size
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.version < 5:
        if wkv_init is not None:
            raise ValueError("an RWKV-4 model has no (H, N, N) WKV state to initialise: "
                             "named states are RWKV-5/6 only")
        state = {key: torch.zeros(L, B, C, **f32) for key in V4_STATE_KEYS}
        state["pp"].fill_(PP_START)
        return state
    if wkv_init is None:
        wkv = torch.zeros(L, B, H, N, N, **f32)
    else:
        wkv_init = wkv_init.to(**f32)
        if wkv_init.dim() == 4:
            wkv_init = wkv_init[:, None]
        wkv = wkv_init.expand(L, B, H, N, N).contiguous()
    return {
        "att_shift": torch.zeros(L, B, C, **f32),
        "wkv": wkv,
        "ffn_shift": torch.zeros(L, B, C, **f32),
    }


def clone_state(state: ModelState) -> ModelState:
    """A private copy: the port updates states in place."""
    return {key: value.clone() for key, value in state.items()}


def gather_beams(state: ModelState, beam_idx: torch.Tensor) -> ModelState:
    """Rows ``beam_idx`` (b,) of the batch axis, in that order: beam search's
    fork and reorder. A new state."""
    return {key: value.index_select(1, beam_idx) for key, value in state.items()}


def scatter_rows(state: ModelState, rows: torch.Tensor, src: ModelState) -> None:
    """Write ``src`` (b rows) into rows ``rows`` (b,) of ``state`` in place;
    the rows must be distinct."""
    for key, value in state.items():
        value.index_copy_(1, rows, src[key])


def state_from_jax(state: Dict[str, np.ndarray], head_size: int) -> Dict[str, np.ndarray]:
    """JAX model state (packed or logical ``wkv``) -> the logical layout; an
    RWKV-4 state (no ``wkv``) is the same in both."""
    out = {k: np.asarray(v, np.float32) for k, v in state.items()}
    if "wkv" not in out:
        return out
    wkv = out["wkv"]
    out["wkv"] = wkv.reshape(wkv.shape[:3] + (head_size, head_size))
    return out


def state_to_jax(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Logical state -> the JAX package's canonical layout (``wkv`` packed
    to (..., N*N/128, 128) where N*N is a multiple of 128)."""
    out = {k: np.asarray(v, np.float32) for k, v in state.items()}
    if "wkv" not in out:
        return out
    n = out["wkv"].shape[-1]
    if (n * n) % 128 == 0:
        out["wkv"] = out["wkv"].reshape(out["wkv"].shape[:3] + ((n * n) // 128, 128))
    return out
