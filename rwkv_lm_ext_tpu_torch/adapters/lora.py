"""LoRA and PiSSA adapters on the port's RWKV module.

Counterpart of rwkv_lm_ext_tpu/adapters/lora.py: ``LoraConfig`` (:32-43),
the targets ``_ATT_TARGETS``/``_FFN_TARGETS`` (:28-29), ``init_lora_params``
(:67-79), ``_svd_lowrank`` and ``pissa_init`` (:82-150), ``LoraUnfusedLeaf``
(:214-233) and ``LoraDeltaLeaf`` (:153-180) as ``LoraLinear``,
``apply_lora_unfused`` (:301-332) and ``merge_lora`` under grad (:183-211)
as ``apply_lora(merge=)``, ``merge_lora`` for serving, ``merge_pissa``
(:511-524), and the reference on-disk layout of
``lora_tree_to_state_dict``/``lora_state_dict_to_tree`` (:378-417).

An adapter is a dict {"blocks.{i}.{att|ffn}.{name}": {"A": (in, r), "B":
(r, out)}} of fp32 tensors, the JAX adapter tree's keys and layout. The
projection stays unfused by default, as in the JAX trainer: ``base(x) + (x
@ A) @ (scale * B)`` with A and B cast to the compute dtype at use, so the
frozen base needs no weight-shaped gradient. ``merge=True`` (``sft
--lora-apply merge``) forms W + scale * A @ B in fp32 at every use instead.
The base is a dense ``Linear`` or a ``QuantLinear`` (QLoRA, any of the four
modes: ``base(x)`` runs its own product, and the merged form dequantizes it
to fp32 first, as ``LoraDeltaLeaf.materialize`` does).

PiSSA (``LoraConfig(pissa=True)``, scaling 1) starts the adapter at the
top-r SVD of each target weight and leaves the residual in the base. The
randomized SVD draws its test matrix from a ``torch.Generator``, so its
numbers are not JAX's; on a weight whose spectrum has a gap both converge to
the same top-r subspace. Embedding and head adapters wait.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.adapters.quant import ATT_TARGETS, FFN_TARGETS, QuantLinear
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV, Linear

Adapter = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: float = 32.0
    parts: Tuple[str, ...] = ("att", "ffn")
    # PiSSA adapters: the SVD init with the residual in the base; merged at
    # scale 1, and refused by slot-LoRA
    pissa: bool = False

    @property
    def scaling(self) -> float:
        # PiSSA merges at scale 1 (JAX adapters/lora.py:40-43)
        return 1.0 if self.pissa else self.alpha / self.r


def _targets(model: RWKV, lc: LoraConfig) -> Iterator[Tuple[str, nn.Module, str]]:
    """(adapter key, parent module, attribute) of every adapted projection,
    in the JAX package's order."""
    for i, block in enumerate(model.blocks):
        for part, names in (("att", ATT_TARGETS), ("ffn", FFN_TARGETS)):
            if part in lc.parts:
                parent = getattr(block, part)
                for name in names:
                    # a projection the block lacks (v5.0's gate) is skipped, as in JAX
                    if isinstance(getattr(parent, name, None), nn.Module):
                        yield f"blocks.{i}.{part}.{name}", parent, name


def weight_shape(proj: nn.Module) -> Tuple[int, int]:
    """(out, in) of a dense or quantized projection."""
    return tuple(proj.weight.shape) if isinstance(proj, Linear) else proj.shape


def _device(proj: nn.Module) -> torch.device:
    return proj.weight.device if isinstance(proj, Linear) else proj.q.device


def init_lora_params(model: RWKV, lc: LoraConfig, generator: torch.Generator) -> Adapter:
    """A fresh adapter on the model's device: A ~ U(-bound, bound) with the
    JAX bound sqrt(3) * sqrt(2 / fan_in), B = 0, both fp32. Draws from
    ``generator`` (on the model's device) in target order."""
    adapter = {}
    for key, parent, name in _targets(model, lc):
        proj = getattr(parent, name)
        (fan_out, fan_in), dev = weight_shape(proj), _device(proj)
        bound = math.sqrt(3.0) * math.sqrt(2.0 / fan_in)
        A = torch.rand(fan_in, lc.r, generator=generator, device=dev) * (2 * bound) - bound
        B = torch.zeros(lc.r, fan_out, dtype=torch.float32, device=dev)
        adapter[key] = {"A": A, "B": B}
    return adapter


def svd_lowrank(M: torch.Tensor, r: int, niter: int, generator: torch.Generator):
    """Randomized top-r SVD of M (m, n) fp32 (``_svd_lowrank``): a Gaussian
    test matrix of min(2r, n) columns from ``generator``, ``niter`` rounds
    of subspace iteration re-orthogonalized by QR, then the exact SVD of the
    small projection. Returns U (m, r), S (r,), Vt (r, n)."""
    n = M.shape[1]
    Q = torch.randn(n, min(2 * r, n), generator=generator, device=M.device)
    Q, _ = torch.linalg.qr(M @ Q)
    for _ in range(niter):
        Z, _ = torch.linalg.qr(M.t() @ Q)
        Q, _ = torch.linalg.qr(M @ Z)
    U_s, S, Vt = torch.linalg.svd(Q.t() @ M, full_matrices=False)
    return (Q @ U_s)[:, :r], S[:r], Vt[:r]


def pissa_init(model: RWKV, lc: LoraConfig, generator: torch.Generator, *,
               svd_niter: int = 4) -> Tuple[Adapter, Dict[str, torch.Tensor]]:
    """PiSSA: each target's adapter is the top-r SVD of its weight W (the
    JAX (in, out) layout), A = U sqrt(S), B = sqrt(S) Vt, and the base keeps
    W - A @ B, cast to the weight's dtype, in place. Returns the adapter and
    the fp32 residuals by BlinkDL key (``blocks.{i}.att.key.weight``, (out,
    in)): QLoRA quantizes those, as JAX quantizes its fp32 residual params.
    The targets must be dense. As in JAX, a zero weight (a fresh model's
    att.output and ffn.value) gives A = B = 0, a saddle that never trains."""
    adapter, residuals = {}, {}
    for key, parent, name in _targets(model, lc):
        lin = getattr(parent, name)
        if type(lin) is not Linear:
            raise TypeError(f"{key} is a {type(lin).__name__}: PiSSA takes a dense weight")
        W = lin.weight.detach().float().t()
        U, S, Vt = svd_lowrank(W, lc.r, svd_niter, generator)
        sq = S.sqrt()
        A, B = U * sq[None, :], sq[:, None] * Vt
        adapter[key] = {"A": A.contiguous(), "B": B.contiguous()}
        residuals[f"{key}.weight"] = (W - A @ B).t().contiguous()
        with torch.no_grad():
            lin.weight.copy_(residuals[f"{key}.weight"])
    return adapter, residuals


class LoraLinear(nn.Module):
    """A frozen projection (``base``: a Linear or a QuantLinear) with an fp32
    low-rank adapter. Unfused, the counterpart of ``proj`` on a
    LoraUnfusedLeaf (rwkv_lm_ext_tpu/models/rwkv.py:204-211): ``y = base(x) +
    (x @ A) @ (scale * B)`` in x's dtype. Merged (``merge``), of ``proj`` on
    merge_lora's leaf: ``x @ merged_weight(x.dtype)^T``."""

    def __init__(self, base: nn.Module, A: torch.Tensor, B: torch.Tensor, scale: float,
                 merge: bool = False):
        super().__init__()
        self.base = base
        # copies on the projection's device: an adapter file loads on the CPU
        dev = _device(base)
        self.lora_A = nn.Parameter(A.detach().to(dev, torch.float32, copy=True))    # (in, r)
        self.lora_B = nn.Parameter(B.detach().to(dev, torch.float32, copy=True))    # (r, out)
        self.scale = scale
        self.merge = merge

    def forward(self, x: torch.Tensor, ops=None) -> torch.Tensor:
        dt = x.dtype
        if self.merge:
            return F.linear(x, self.merged_weight(dt))
        return self.base(x, ops) + (x @ self.lora_A.to(dt)) @ (self.scale * self.lora_B).to(dt)

    def merged_weight(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """W + scale * (A @ B)^T summed in fp32: cast to W's dtype (then to
        ``dtype``) over a dense base (merge_lora), straight to ``dtype`` over
        a quantized one (LoraDeltaLeaf.materialize)."""
        delta = (self.scale * (self.lora_A.float() @ self.lora_B.float())).t()
        if isinstance(self.base, QuantLinear):
            return (self.base.dequantize(torch.float32) + delta).to(dtype or torch.float32)
        w = self.base.weight
        return (w.float() + delta).to(w.dtype).to(dtype or w.dtype)


def apply_lora(model: RWKV, lc: LoraConfig, adapter: Adapter, *, merge: bool = False) -> RWKV:
    """Swap every target projection (8 a layer: 192 at 24 layers), dense or
    quantized, for a LoraLinear holding ``adapter``'s A and B (``merge``: the
    merged form), freeze every other parameter, and return the model."""
    missing = sorted({key for key, _, _ in _targets(model, lc)} - adapter.keys())
    if missing:
        raise KeyError(f"adapter has no entry for {missing[:4]}")
    model.requires_grad_(False)
    for key, parent, name in _targets(model, lc):
        base = getattr(parent, name)
        if type(base) not in (Linear, QuantLinear):
            raise TypeError(f"{key} is a {type(base).__name__}: LoRA takes a Linear or a "
                            "QuantLinear")
        ab = adapter[key]
        setattr(parent, name, LoraLinear(base, ab["A"], ab["B"], lc.scaling, merge=merge))
    return model


def lora_modules(model: RWKV) -> Iterator[Tuple[str, LoraLinear]]:
    for name, module in model.named_modules():
        if isinstance(module, LoraLinear):
            yield name, module


def lora_adapter(model: RWKV) -> Adapter:
    """The model's adapter as a dict of detached fp32 tensors."""
    return {name: {"A": m.lora_A.detach(), "B": m.lora_B.detach()} for name, m in lora_modules(model)}


def merge_lora(model: RWKV) -> RWKV:
    """Serving weights: every LoraLinear over a dense base becomes a plain
    Linear holding W + scale * A @ B (fp32 sum, cast to W's dtype); one over
    a quantized base stays, frozen, in its merged form, so that the base
    stays quantized (merge_lora's LoraDeltaLeaf). In place; returns the
    model."""
    for name, module in list(lora_modules(model)):
        if isinstance(module.base, QuantLinear):
            module.merge = True
            module.requires_grad_(False)
            continue
        parent_name, attr = name.rsplit(".", 1)
        plain = Linear.__new__(Linear)
        nn.Module.__init__(plain)
        plain.weight = nn.Parameter(module.merged_weight().detach(), requires_grad=False)
        setattr(model.get_submodule(parent_name), attr, plain)
    return model


def merge_pissa(model: RWKV, adapter: Adapter, adapter_init: Adapter, lc: LoraConfig) -> RWKV:
    """Serve a PiSSA adapter against the ORIGINAL (undeflated) base: each
    dense target becomes W + A @ B - A_init @ B_init, summed in fp32 in
    merge_pissa's order (the adapter's delta, then the init's), cast to W's
    dtype, in place. ``adapter_init`` is the SVD init that training saved
    (``init_pissa.pth``). Returns the model."""
    if not lc.pissa:
        raise ValueError("merge_pissa is for PiSSA configs (LoraConfig(pissa=True), scale 1)")
    for key, parent, name in _targets(model, lc):
        if key not in adapter:
            continue
        lin = getattr(parent, name)
        if type(lin) is not Linear:
            raise TypeError(f"{key} is a {type(lin).__name__}: merge_pissa takes a dense weight "
                            "(quantize after merging)")
        ab, ab0 = adapter[key], adapter_init[key]
        dev = lin.weight.device
        w = lin.weight.float() + (ab["A"].to(dev).float() @ ab["B"].to(dev).float()).t()
        w = w + (-ab0["A"].to(dev).float() @ ab0["B"].to(dev).float()).t()
        with torch.no_grad():
            lin.weight.copy_(w)
    return model


def adapter_state_dict(adapter: Adapter) -> Dict[str, torch.Tensor]:
    """An adapter dict in the reference on-disk layout
    (``lora_tree_to_state_dict``): ``<path>.lora_A`` (r, in) and
    ``<path>.lora_B`` (out, r), fp32, contiguous, on the CPU."""
    sd = {}
    for key, ab in adapter.items():
        sd[f"{key}.lora_A"] = ab["A"].detach().float().t().contiguous().cpu()
        sd[f"{key}.lora_B"] = ab["B"].detach().float().t().contiguous().cpu()
    return sd


def lora_state_dict(model: RWKV) -> Dict[str, torch.Tensor]:
    """The model's adapter in the reference on-disk layout
    (``adapter_state_dict``)."""
    return adapter_state_dict(lora_adapter(model))


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
