"""T=1 decode step: one token per stream through the whole layer stack.

Counterpart of rwkv_lm_ext_tpu/models/decode.py:38-279 (decode_supported,
rwkv_decode_step). The step reuses the model's blocks (Block.step): K3 for
ln0/ln2/ln_out, K2 at T=1 for ln1 + shift + ddlerp, the projections (dense,
int8 or int8c), the fp32 decay low-rank, and the decode kernel B.9 in place
of K1.

``fused_prep=True`` is the JAX step's opt-in fused route (:247-262): per layer
the attention prologue is one kernel (B.10: ln1 + shift + ddlerp + decay
low-rank) and the channel mix is one kernel (B.12, dense weights) or the
prologue kernel B.11 plus the quantized projections; only ln0 and ln_out
remain K3 calls. As in the JAX package the default is the unfused route and
the generation engine never sets the option. The fused route carries the
shift rows as unrounded fp32 LayerNorm outputs (the unfused one rounds them
to the compute dtype first) and computes the decay from an unrounded ``xw``,
so in bf16 the two routes' states differ in the last bf16 bit.

RWKV-5.x takes the same step with ``TimeMixV5.step`` (K3 for ln1, B.9 with
the constant decay); RWKV-4 its own (``models.rwkv4.rwkv4_step``, B.14); a
model with a legacy option runs the generic forward at T=1, as in the JAX
package, whose ``decode_supported`` (:38-53) turns those configs away. The
fused route stays RWKV-6 only and refuses any other model by name.

Unlike the generic forward, which stacks a fresh state every call, the step
writes each layer's slice of an output state that the caller may pass in:
``out=state`` updates the state in place, which is what the generation
engine does every token.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS
from rwkv_lm_ext_tpu_torch.models.state import ModelState, init_model_state
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import HEAD_SIZES


def decode_supported(cfg) -> bool:
    """True when the step covers this config: the JAX checks (no tiny
    attention, pre_ffn, head_qk, positional embedding or MishGLU, no dropout)
    on an RWKV-4 model or an RWKV-5/6 block stack whose head size the decode
    kernel takes."""
    return (
        not cfg.legacy_options
        and cfg.dropout == 0
        and (cfg.version < 5 or cfg.head_size in HEAD_SIZES)
    )


def rwkv_decode_step(
    model,
    tokens: torch.Tensor,
    state: Optional[ModelState] = None,
    *,
    out: Optional[ModelState] = None,
    reference: bool = False,
    fused_prep: Optional[bool] = None,
) -> Tuple[torch.Tensor, ModelState]:
    """tokens: (B,) int, the current token of each stream; state: a
    models.state dict or None for zeros. Returns (logits (B, V), new state).
    The new state is written into ``out`` when given (``out=state`` updates
    in place) and into fresh buffers otherwise. ``reference=True`` runs the
    kernels' plain versions. ``fused_prep`` runs the per-layer glue as the
    fused decode kernels (see the module docstring); None is off. Equals
    ``model(tokens[:, None], state, t1_step=False)`` up to summation order
    (and, with ``fused_prep`` in bf16, up to the roundings named above)."""
    cfg = model.cfg
    ops = PLAIN_OPS if reference else KERNEL_OPS
    fused_prep = bool(fused_prep)
    if fused_prep and (cfg.version < 6 or not decode_supported(cfg)):
        raise ValueError(
            f"fused_prep runs the RWKV-6 decode kernels B.10-B.12 only; this model is "
            f"v{cfg.version} with options {cfg.legacy_options} (the unfused step takes it)")
    if state is None:
        state = init_model_state(cfg, tokens.shape[0], device=tokens.device)
    if not decode_supported(cfg):
        logits, new = model(tokens[:, None], state, reference=reference, t1_step=False)
        if out is None:
            return logits[:, 0], new
        for key, value in out.items():
            value.copy_(new[key])
        return logits[:, 0], out
    if out is None:
        out = {key: torch.empty_like(value) for key, value in state.items()}
    if cfg.version < 5:
        from rwkv_lm_ext_tpu_torch.models.rwkv4 import rwkv4_step

        return rwkv4_step(model, tokens, state, out, ops)
    x = model.embed(tokens[:, None])                              # (B, 1, C)
    for i, block in enumerate(model.blocks):
        x = block.step(x, state, out, i, ops, fused_prep)
    x = ops.layer_norm(x, model.ln_out.weight, model.ln_out.bias)
    return model.head(x, ops)[:, 0], out
