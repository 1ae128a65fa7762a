"""T=1 decode step: one token per stream through the whole layer stack.

Counterpart of rwkv_lm_ext_tpu/models/decode.py:38-279 (decode_supported,
rwkv_decode_step without ``fused_prep``, which the JAX engine never sets).
The step reuses the model's blocks (Block.step): K3 for ln0/ln2/ln_out, K2
at T=1 for ln1 + shift + ddlerp, the projections (dense, int8 or int8c),
the fp32 decay low-rank, and the decode kernel B.9 in place of K1.

Unlike the generic forward, which stacks a fresh state every call, the step
writes each layer's slice of an output state that the caller may pass in:
``out=state`` updates the state in place, which is what the generation
engine does every token.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS
from rwkv_lm_ext_tpu_torch.models.state import ModelState, init_model_state
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import HEAD_SIZES


def decode_supported(cfg) -> bool:
    """True when the step covers this config: an RWKV-6 block stack whose
    head size the decode kernel takes."""
    return cfg.version >= 6 and cfg.head_size in HEAD_SIZES


def rwkv_decode_step(
    model,
    tokens: torch.Tensor,
    state: Optional[ModelState] = None,
    *,
    out: Optional[ModelState] = None,
    reference: bool = False,
) -> Tuple[torch.Tensor, ModelState]:
    """tokens: (B,) int, the current token of each stream; state: a
    models.state dict or None for zeros. Returns (logits (B, V), new state).
    The new state is written into ``out`` when given (``out=state`` updates
    in place) and into fresh buffers otherwise. ``reference=True`` runs the
    kernels' plain versions. Equals ``model(tokens[:, None], state,
    t1_step=False)`` up to summation order."""
    ops = PLAIN_OPS if reference else KERNEL_OPS
    if state is None:
        state = init_model_state(model.cfg, tokens.shape[0], device=tokens.device)
    if out is None:
        out = {key: torch.empty_like(value) for key, value in state.items()}
    x = F.embedding(tokens[:, None], model.emb.weight)            # (B, 1, C)
    for i, block in enumerate(model.blocks):
        x = block.step(x, state, out, i, ops)
    x = ops.layer_norm(x, model.ln_out.weight, model.ln_out.bias)
    return model.head(x, ops)[:, 0], out
