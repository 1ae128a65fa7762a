"""Per-row (multi-adapter) LoRA: different adapters in one batched step.

Counterpart of rwkv_lm_ext_tpu/adapters/slot_lora.py:43-246: the per-row
apply (``SlotLoraLeaf.slot_apply``, :43-74) as the ``SlotLoraLinear`` module,
``build_slot_lora`` (:77-138), the joint-training stacks
``init_slot_stacks`` / ``apply_slot_stacks`` / ``split_slot_stacks``
(:165-233), ``set_slot_idx`` (:236) and ``has_slot_lora`` (:243).

Adapters are stacked: an adapted projection holds its base (a ``Linear`` or
a ``QuantLinear``), A (n, in, r_max) and B (n, r_max, out), and a per-row
adapter index (rows,). Each batch row adds its own adapter's delta,
``y = base(x) + (x @ A[idx]) @ B[idx]``, so the continuous batcher decodes a
mixed pool (the pristine base next to several adapters) in one step. Entry
0 is the base: zero stacks. Per-adapter ranks are zero-padded to the
largest, and each adapter's alpha / r is folded into its B, so the runtime
math is uniform. The JAX package computes the delta of every adapter and
selects one by a one-hot product; the port gathers each row's A and B,
which is the same sum without the n - 1 zero terms.

Joint multi-task training (``sft --train-type slot-lora``): the raw stacks
that ``apply_slot_stacks`` installs are the model's trainable parameters
(``slot_stacks`` reads them back), the scale applied at use as plain LoRA's;
each step points the modules at its batch's ``adapter_ids``
(``set_slot_idx``), so a row's gradient reaches only its task's rows of the
stacks, and the base row 0, never routed, gets none.

The index is a buffer that every ``SlotLoraLinear`` of a model shares
(``set_slot_idx``): a CUDA graph captured over the model reads whatever
index was last written into that tensor, so the batcher's admission sets a
slot's adapter by writing one element.

Refused by name, as in the JAX package: PiSSA adapters (each subtracts its
own top-r SVD from the base weight, so two cannot share one base; serve
them merged) and the embedding table as a target (read by a gather, not a
projection).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple, Union

import torch
from torch import nn

from rwkv_lm_ext_tpu_torch.adapters.lora import Adapter, LoraConfig, init_lora_params, weight_shape


class SlotLoraLinear(nn.Module):
    """A projection plus stacked per-adapter low-rank deltas and the per-row
    adapter index. ``scale`` multiplies B at use (1 where build_slot_lora
    folded it in; lc.scaling for raw training stacks)."""

    def __init__(self, base: nn.Module, A: torch.Tensor, B: torch.Tensor,
                 idx: torch.Tensor, scale: float = 1.0):
        super().__init__()
        self.base = base
        self.A = nn.Parameter(A, requires_grad=A.requires_grad)     # (n, in, r)
        self.B = nn.Parameter(B, requires_grad=B.requires_grad)     # (n, r, out)
        self.register_buffer("idx", idx, persistent=False)         # (rows,) int64
        self.scale = scale

    def forward(self, x: torch.Tensor, ops=None) -> torch.Tensor:
        """x (rows, ..., in): the base projection plus each row's delta."""
        y = self.base(x, ops)
        rows, dt = x.shape[0], x.dtype
        if self.idx.shape[0] != rows:
            raise ValueError(f"the slot index has {self.idx.shape[0]} rows, the input {rows}: "
                             "set_slot_idx with one adapter id a row first")
        B = self.B[self.idx]
        B = (B if self.scale == 1.0 else self.scale * B).to(dt)
        t = torch.bmm(x.reshape(rows, -1, x.shape[-1]), self.A[self.idx].to(dt))
        return y + torch.bmm(t, B).reshape(y.shape)


def _leaf(model, key: str) -> Tuple[nn.Module, str]:
    """(parent module, attribute) of an adapter key: ``blocks.{i}.{att|ffn}.
    {name}`` or a top-level projection such as ``head``."""
    if key == "emb" or key.startswith("emb."):
        raise ValueError("slot-lora cannot adapt the embedding table (it is read by a gather, "
                         "not a projection); drop 'emb' from the adapter's targets")
    parent_name, _, attr = key.rpartition(".")
    return (model.get_submodule(parent_name) if parent_name else model), attr


def _fans(base: nn.Module) -> Tuple[int, int]:
    n_out, n_in = weight_shape(base)
    return n_in, n_out


def build_slot_lora(
    model,
    adapters: Dict[str, Adapter],
    configs: Union[LoraConfig, Dict[str, LoraConfig]],
    *,
    rows: int = 1,
):
    """Swap every projection that any adapter targets for a SlotLoraLinear,
    in place. adapters: {name: adapter dict} (adapters.lora layout);
    configs: one LoraConfig for all or one per name. Returns (model,
    name_to_id) with name_to_id["base"] == 0. The stacks are stored in the
    compute dtype; the index starts as zeros (rows,)."""
    names = list(adapters)
    if isinstance(configs, LoraConfig):
        configs = {n: configs for n in names}
    for n in names:
        if configs[n].pissa:
            raise ValueError(f"adapter {n!r} is PiSSA: its base-weight residual cannot share a "
                             "base with other adapters; serve it merged")
    name_to_id = {"base": 0, **{n: i + 1 for i, n in enumerate(names)}}
    r_max = max((configs[n].r for n in names), default=1)
    device = model.emb.weight.device
    idx = torch.zeros(rows, dtype=torch.int64, device=device)
    for key in sorted({k for n in names for k in adapters[n]}):
        parent, attr = _leaf(model, key)
        base = getattr(parent, attr)
        fan_in, fan_out = _fans(base)
        A = torch.zeros(len(names) + 1, fan_in, r_max, device=device)
        B = torch.zeros(len(names) + 1, r_max, fan_out, device=device)
        for n in names:
            ab = adapters[n].get(key)
            if ab is None:
                continue
            r = ab["A"].shape[-1]
            A[name_to_id[n], :, :r] = ab["A"].to(device=device, dtype=torch.float32)
            B[name_to_id[n], :r, :] = configs[n].scaling * ab["B"].to(device=device,
                                                                       dtype=torch.float32)
        dt = model.cfg.compute_dtype
        setattr(parent, attr, SlotLoraLinear(base, A.to(dt), B.to(dt), idx))
    return model, name_to_id


def init_slot_stacks(model, lc: LoraConfig, names: Iterable[str], generator: torch.Generator):
    """Trainable fp32 stacks for joint multi-adapter training: per adapted
    projection {"A": (n+1, in, r), "B": (n+1, r, out)}; row 0 is the base
    (zeros), rows 1..n are init_lora_params draws in name order. Returns
    (stacks, name_to_id)."""
    names = list(names)
    name_to_id = {"base": 0, **{n: i + 1 for i, n in enumerate(names)}}
    per = [init_lora_params(model, lc, generator) for _ in names]
    stacks = {}
    for key in (per[0] if per else ()):
        stacks[key] = {
            part: torch.stack([torch.zeros_like(per[0][key][part])]
                              + [ad[key][part] for ad in per])
            for part in ("A", "B")
        }
    return stacks, name_to_id


def apply_slot_stacks(model, stacks: Dict, idx: torch.Tensor, lc: LoraConfig):
    """Wrap the model's projections with raw trainable stacks (the scale
    applied at use, as plain LoRA's) and this batch's per-row adapter ids,
    in place; the stacks become the modules' parameters (gradients flow to
    the rows the batch routes to). Returns the model."""
    idx = idx.to(torch.int64)
    for key, ab in stacks.items():
        parent, attr = _leaf(model, key)
        base = getattr(parent, attr)
        if isinstance(base, SlotLoraLinear):
            base = base.base
        A = ab["A"].detach().clone().requires_grad_(True)
        B = ab["B"].detach().clone().requires_grad_(True)
        setattr(parent, attr, SlotLoraLinear(base, A, B, idx, scale=lc.scaling))
    return model


def slot_stacks(model) -> Dict:
    """The model's stacks by adapter key, {"A", "B"} (detached), as
    ``apply_slot_stacks`` installed them and training left them."""
    return {name: {"A": m.A.detach(), "B": m.B.detach()} for name, m in model.named_modules()
            if isinstance(m, SlotLoraLinear)}


def split_slot_stacks(stacks: Dict, name_to_id: Dict[str, int]) -> Dict[str, Adapter]:
    """Trained stacks -> one adapter dict per name (row 0, the base, left
    out), servable by build_slot_lora or adapters.lora.apply_lora."""
    return {name: {k: {"A": ab["A"][aid], "B": ab["B"][aid]} for k, ab in stacks.items()}
            for name, aid in name_to_id.items() if aid != 0}


def set_slot_idx(model, idx: torch.Tensor) -> None:
    """Point every SlotLoraLinear of the model at ``idx`` (rows,) int64, one
    tensor shared by all: later writes into it reach every projection."""
    for m in model.modules():
        if isinstance(m, SlotLoraLinear):
            m.idx = idx


def has_slot_lora(model) -> bool:
    return any(isinstance(m, SlotLoraLinear) for m in model.modules())
