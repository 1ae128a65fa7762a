"""Forward pass that returns the model state after EVERY position.

Counterpart of rwkv_lm_ext_tpu/models/collect.py:44-154 (collect_supported,
rwkv_forward_collect, _v5_projections, select_state). The speculative verify
pass (infer/speculative.py) needs, on a partial acceptance of j of gamma
drafted tokens, the target's state after the accepted prefix; RWKV has no
cache to truncate, so the verify pass keeps the state after every fed token
and a rollback is one select into a (T, ...) stack. The WKV states come from
kernel B.15 (ops/wkv_collect.py: K1's function that also writes the state
after each step) on the kernel route and from its plain version on the plain
route (``reference=True``); the shift states cost nothing: the att shift
after position t is ln1's output at t and the ffn shift ln2's, which the
forward computes anyway (JAX :107-110).

The pass is the model's own forward: each ``Block.forward`` runs with its
layer's slices of the stacks (``collect``), which swaps K1 for B.15 and
writes the shift states; the rest is unchanged: K3 for ln0 / ln2 / ln_out
(and ln1 of an RWKV-5 block), K2 for ln1 + shift + ddlerp of an RWKV-6
block, the projections (dense or ``QuantLinear`` under --quant) and the
channel mix. JAX's ``_v5_projections`` (:128-150, the v5 r, k, v and decay
for a second scan) has no counterpart: B.15 takes v5's decay expanded over
(B, T) and its ones gate as K1 does, so one call gives the v5 output and the
states.

States are the port's ModelState layout with a leading T axis, the WKV
part logical: {att_shift: (T, L, B, C), wkv: (T, L, B, H, N, N), ffn_shift:
(T, L, B, C)}, fp32; index t is the state after tokens[:, :t+1]. At 1B6, B=1
and T=9 the WKV stack is 113 MB.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS
from rwkv_lm_ext_tpu_torch.models.state import ModelState, init_model_state
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import HEAD_SIZES


def collect_supported(cfg) -> bool:
    """JAX's rule (RWKV-5/6, no tiny attention, pre_ffn or dropout), and, as
    the port's serving entry points refuse them, no head_qk or my_pos_emb (the
    JAX collect forward leaves both out; with tiny attention they are the
    chunk-dependent options), at a head size B.15 takes."""
    return (
        cfg.version >= 5
        and cfg.pre_ffn <= 0
        and cfg.dropout == 0.0
        and not cfg.chunk_dependent_options
        and cfg.head_size in HEAD_SIZES
    )


def rwkv_forward_collect(
    model, tokens: torch.Tensor, state: Optional[ModelState] = None, *, reference: bool = False,
) -> Tuple[torch.Tensor, ModelState]:
    """tokens (B, T) -> (logits (B, T, V), the states after every position,
    see the module docstring). ``state`` is left as it was; None is zeros.
    ``reference=True`` runs the kernels' plain versions."""
    cfg = model.cfg
    if not collect_supported(cfg):
        raise ValueError(f"the collect forward takes RWKV-5/6 models without tiny attention, "
                         f"pre_ffn, head_qk, my_pos_emb or dropout, at head sizes {HEAD_SIZES}; "
                         f"this one is v{cfg.version:g} with {cfg.legacy_options}, head size "
                         f"{cfg.head_size}")
    ops = PLAIN_OPS if reference else KERNEL_OPS
    B, T = tokens.shape
    L, C, H, N = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_size
    if state is None:
        state = init_model_state(cfg, B, device=tokens.device)
    f32 = dict(dtype=torch.float32, device=tokens.device)
    states = {"att_shift": torch.empty(T, L, B, C, **f32),
              "wkv": torch.empty(T, L, B, H, N, N, **f32),
              "ffn_shift": torch.empty(T, L, B, C, **f32)}
    x = model.embed(tokens)
    for i, block in enumerate(model.blocks):
        layer = (state["att_shift"][i], state["wkv"][i], state["ffn_shift"][i])
        x, _ = block(x, layer, ops, collect={key: value[:, i] for key, value in states.items()})
    x = ops.layer_norm(x, model.ln_out.weight, model.ln_out.bias)
    return model.head(x, ops), states


def select_state(states: ModelState, j: torch.Tensor) -> ModelState:
    """The ModelState after tokens[:, :j+1] from rwkv_forward_collect's
    stack. ``j`` is a device tensor of one int64 (shape (1,) or ()), so the
    select launches no copy from the host and one captured graph covers every
    j (JAX selects with a traced index, :153)."""
    j = j.reshape(1)
    return {key: value.index_select(0, j)[0] for key, value in states.items()}
