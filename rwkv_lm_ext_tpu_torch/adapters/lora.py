"""LoRA adapters on the port's RWKV module.

Counterpart of rwkv_lm_ext_tpu/adapters/lora.py: ``LoraConfig`` (:32-43),
the targets ``_ATT_TARGETS``/``_FFN_TARGETS`` (:28-29), ``init_lora_params``
(:67-79), ``LoraUnfusedLeaf`` (:214-233) as ``LoraLinear``,
``apply_lora_unfused`` (:301-332) as ``apply_lora``, ``merge_lora``
(:183-211), and the reference on-disk layout of
``lora_tree_to_state_dict``/``lora_state_dict_to_tree`` (:378-417).

An adapter is a dict {"blocks.{i}.{att|ffn}.{name}": {"A": (in, r), "B":
(r, out)}} of fp32 tensors, the JAX adapter tree's keys and layout. The
projection stays unfused, as in the JAX trainer: ``base(x) + (x @ A) @
(scale * B)`` with A and B cast to the compute dtype at use, so the frozen
base needs no weight-shaped gradient. PiSSA, slot-LoRA, QLoRA (a quantized
base) and embedding/head adapters wait.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.adapters.quant import ATT_TARGETS, FFN_TARGETS
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV, Linear

Adapter = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: float = 32.0
    parts: Tuple[str, ...] = ("att", "ffn")
    # PiSSA adapters: marked so that slot-LoRA can refuse them by name; their
    # training and merge wait
    pissa: bool = False

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def _targets(model: RWKV, lc: LoraConfig) -> Iterator[Tuple[str, nn.Module, str]]:
    """(adapter key, parent module, attribute) of every adapted projection,
    in the JAX package's order."""
    for i, block in enumerate(model.blocks):
        for part, names in (("att", ATT_TARGETS), ("ffn", FFN_TARGETS)):
            if part in lc.parts:
                for name in names:
                    yield f"blocks.{i}.{part}.{name}", getattr(block, part), name


def init_lora_params(model: RWKV, lc: LoraConfig, generator: torch.Generator) -> Adapter:
    """A fresh adapter on the model's device: A ~ U(-bound, bound) with the
    JAX bound sqrt(3) * sqrt(2 / fan_in), B = 0, both fp32. Draws from
    ``generator`` (on the model's device) in target order."""
    adapter = {}
    for key, parent, name in _targets(model, lc):
        w = getattr(parent, name).weight            # (out, in)
        fan_out, fan_in = w.shape
        bound = math.sqrt(3.0) * math.sqrt(2.0 / fan_in)
        A = torch.rand(fan_in, lc.r, generator=generator, device=w.device) * (2 * bound) - bound
        B = torch.zeros(lc.r, fan_out, dtype=torch.float32, device=w.device)
        adapter[key] = {"A": A, "B": B}
    return adapter


class LoraLinear(Linear):
    """A frozen projection with an fp32 low-rank adapter: the counterpart of
    ``proj`` on a LoraUnfusedLeaf (rwkv_lm_ext_tpu/models/rwkv.py:204-211),
    ``y = x @ W^T + (x @ A) @ (scale * B)`` in x's dtype."""

    def __init__(self, base: Linear, A: torch.Tensor, B: torch.Tensor, scale: float):
        nn.Module.__init__(self)
        self.weight = base.weight
        # copies on the projection's device: an adapter file loads on the CPU
        dev = base.weight.device
        self.lora_A = nn.Parameter(A.detach().to(dev, torch.float32, copy=True))    # (in, r)
        self.lora_B = nn.Parameter(B.detach().to(dev, torch.float32, copy=True))    # (r, out)
        self.scale = scale

    def forward(self, x: torch.Tensor, ops=None) -> torch.Tensor:
        dt = x.dtype
        return F.linear(x, self.weight) + (x @ self.lora_A.to(dt)) @ (self.scale * self.lora_B).to(dt)

    def merged_weight(self) -> torch.Tensor:
        """W + scale * (A @ B)^T in fp32, cast to W's dtype (merge_lora)."""
        delta = (self.scale * (self.lora_A.float() @ self.lora_B.float())).t()
        return (self.weight.float() + delta).to(self.weight.dtype)


def apply_lora(model: RWKV, lc: LoraConfig, adapter: Adapter) -> RWKV:
    """Swap every target Linear (8 a layer: 192 at 24 layers) for a
    LoraLinear holding ``adapter``'s A and B, freeze every other parameter,
    and return the model. Quantized projections (QLoRA) are refused."""
    missing = sorted({key for key, _, _ in _targets(model, lc)} - adapter.keys())
    if missing:
        raise KeyError(f"adapter has no entry for {missing[:4]}")
    model.requires_grad_(False)
    for key, parent, name in _targets(model, lc):
        base = getattr(parent, name)
        if type(base) is not Linear:
            raise TypeError(f"{key} is a {type(base).__name__}: LoRA takes a dense Linear only")
        ab = adapter[key]
        setattr(parent, name, LoraLinear(base, ab["A"], ab["B"], lc.scaling))
    return model


def lora_modules(model: RWKV) -> Iterator[Tuple[str, LoraLinear]]:
    for name, module in model.named_modules():
        if isinstance(module, LoraLinear):
            yield name, module


def lora_adapter(model: RWKV) -> Adapter:
    """The model's adapter as a dict of detached fp32 tensors."""
    return {name: {"A": m.lora_A.detach(), "B": m.lora_B.detach()} for name, m in lora_modules(model)}


def merge_lora(model: RWKV) -> RWKV:
    """Serving weights: every LoraLinear becomes a plain Linear holding
    W + scale * A @ B (fp32 sum, cast to W's dtype). In place; returns the
    model."""
    for name, module in list(lora_modules(model)):
        parent_name, attr = name.rsplit(".", 1)
        plain = Linear.__new__(Linear)
        nn.Module.__init__(plain)
        plain.weight = nn.Parameter(module.merged_weight().detach(), requires_grad=False)
        setattr(model.get_submodule(parent_name), attr, plain)
    return model


def lora_state_dict(model: RWKV) -> Dict[str, torch.Tensor]:
    """The reference on-disk layout: ``<path>.lora_A`` (r, in) and
    ``<path>.lora_B`` (out, r), fp32, contiguous, on the CPU."""
    sd = {}
    for name, m in lora_modules(model):
        sd[f"{name}.lora_A"] = m.lora_A.detach().float().t().contiguous().cpu()
        sd[f"{name}.lora_B"] = m.lora_B.detach().float().t().contiguous().cpu()
    return sd


_KEY = re.compile(
    r"^(?:base_model\.model\.)?(?P<path>.+?)\.lora_(?P<ab>[AB])"
    r"(?:\.(?P<name>[^.]+))?(?:\.weight)?$"
)


def lora_state_dict_to_tree(sd: Dict, *, adapter_name: Optional[str] = None) -> Adapter:
    """Reference or HF-peft LoRA keys (``<path>.lora_A``, optionally with an
    adapter name and ``.weight``) -> an adapter dict of fp32 tensors, as the
    JAX ``lora_state_dict_to_tree`` reads them. Entries without both A and
    B are dropped."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        m = _KEY.match(k)
        if not m or (adapter_name and m.group("name") not in (None, adapter_name)):
            continue
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        tree.setdefault(m.group("path"), {})[m.group("ab")] = t.float().t().contiguous()
    return {path: ab for path, ab in tree.items() if "A" in ab and "B" in ab}
