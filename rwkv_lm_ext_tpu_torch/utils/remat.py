"""Activation-rematerialization policies for the per-block checkpoint.

Counterpart of rwkv_lm_ext_tpu/utils/remat.py:1-63. Everywhere the port
accepts ``remat=``, the value may be:

- ``False`` (or "off"/"none"): no recompute;
- ``True`` (or "on"/"full"): the whole block forward again in the backward
  (``torch.utils.checkpoint``, non-reentrant);
- ``"dots"``: the outputs of every matrix product are saved, everything else
  is recomputed (``jax.checkpoint_policies.dots_saveable``);
- ``"dots_nobatch"``: the products without a batch axis (the weight
  projections) are saved, the batched ones recomputed with the rest
  (``dots_with_no_batch_dims_saveable``).

The two policies are ``torch.utils.checkpoint`` selective checkpointing over
the aten operations that the products reach on this torch. ``F.linear`` of a
(B, T, C) input without bias and ``x @ W`` of a (B, T, C) input both reach
``aten.t`` / ``aten.view``, ``aten.mm`` and ``aten._unsafe_view``; with a bias
``aten.addmm``; ``torch.bmm`` and the batched ``torch.einsum`` contractions
reach ``aten.bmm``; the int8c product is ``aten._int_mm`` on the GPU and an
int32 ``aten.mm`` on the CPU. The views around a product are recomputed: they
cost nothing. The kernels (K1-K3, B.4) launch outside the dispatcher, so a
policy never saves their outputs: they are recomputed, as ``pallas_call``
outputs are under JAX's ``dots_saveable``.
"""
from __future__ import annotations

import functools
from typing import Union

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

RematSpec = Union[bool, str]

aten = torch.ops.aten
# the products with no batch axis, then those with one
UNBATCHED_PRODUCTS = (aten.mm.default, aten.addmm.default, aten._int_mm.default)
BATCHED_PRODUCTS = (aten.bmm.default, aten.baddbmm.default)
POLICIES = {
    "dots": UNBATCHED_PRODUCTS + BATCHED_PRODUCTS,
    "dots_nobatch": UNBATCHED_PRODUCTS,
}

_FALSY = (False, None, "off", "none", "0", "false")
_TRUTHY = (True, "on", "full", "1", "true")


def normalize_remat(spec: RematSpec) -> RematSpec:
    """Map CLI spellings to ``False | True | policy name``."""
    value = spec.lower() if isinstance(spec, str) else spec
    if value in _FALSY:
        return False
    if value in _TRUTHY:
        return True
    if value in POLICIES:
        return value
    raise ValueError(f"unknown remat spec {spec!r}; expected on/off/full/none or one of "
                     f"{sorted(POLICIES)}")


def _policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, *args, remat: RematSpec):
    """``fn(*args)`` under the remat spec while grad mode is on (``remat_wrap``):
    directly when it is off, else through ``torch.utils.checkpoint``, with the
    policy's selective contexts for a policy name."""
    remat = normalize_remat(remat)
    if remat is False or not torch.is_grad_enabled():
        return fn(*args)
    if remat is True:
        return checkpoint(fn, *args, use_reentrant=False)
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   functools.partial(_policy, POLICIES[remat]))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
