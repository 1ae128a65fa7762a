"""AdamW with the reference's layerwise-lr groups and schedules.

Counterpart of rwkv_lm_ext_tpu/train/optim.py: ``lr_scale_labels`` (:36),
``decay_mask`` (:56), ``make_schedule`` (:61), ``make_optimizer`` (:108) and
``trainable_mask`` (:151). The optax chain there is global-norm clip, then
Adam(b1, b2, eps), then decoupled weight decay on ndim >= 2, then the lr
group multiplier, then the schedule evaluated at the update count. Here the
clip is done by hand exactly as ``optax.clip_by_global_norm`` does it
(g * max / |g| only when |g| >= max; ``clip_grad_norm_`` would add 1e-6),
and the rest is ``torch.optim.AdamW`` with one param group per (multiplier,
decay) pair, its lr set to multiplier * schedule(count) before each step:
AdamW's ``p -= lr * (wd * p + m_hat / (sqrt(v_hat) + eps))`` is the same
update.

``step(keep=...)`` is the update mask of LISA (JAX train/loop.py:165-169,
updates multiplied by 0/1): the parameters in ``keep`` get their values back
after AdamW's step, so their change, weight decay included, is cancelled
while their Adam moments advance and their gradients count in the norm and
the clip, as under the JAX mask.

The norm and the clip are over the parameters that train. The JAX states
mode clips over the gradients of the whole tree, frozen weights included
(train/loop.py:164, optim.py:120): see ROADMAP.md.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.config import TrainConfig

_MULT = {"1x": 1.0, "2x": 2.0, "3x": 3.0}


def lr_scale_label(name: str) -> str:
    """'1x' | '2x' | '3x' for a parameter name (the reference's groups)."""
    if "_w1" in name or "_w2" in name:
        return "1x"
    if "time_mix" in name or "time_maa" in name:
        return "1x"
    if "time_decay" in name:
        return "2x"
    if "time_faaaa" in name:
        return "1x"
    if "time_first" in name:
        return "3x"
    return "1x"


def lr_scale_labels(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, str]:
    return {name: lr_scale_label(name) for name, _ in named_params}


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """True where weight decay applies: ndim >= 2 in the JAX package's
    layout, where the (1, 1, C) vectors of the flat schema (time_maa_*,
    time_decay) are 1-D and get none."""
    return {name: p.dim() >= 2 and tuple(p.shape[:-1]) != (1, 1) for name, p in named_params}


def make_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """Warmup 0.2 + 0.8 * t / w, then decay from lr_init to lr_final over
    the remaining steps (cosine, exp, linear) or constant."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < tc.warmup_steps:
            return (0.2 + 0.8 * step / max(tc.warmup_steps, 1)) * tc.lr_init
        span = max(tc.total_steps - tc.warmup_steps, 1)
        progress = min(max((step - tc.warmup_steps) / span, 0.0), 1.0)
        if tc.lr_schedule == "cosine":
            return tc.lr_final + 0.5 * (tc.lr_init - tc.lr_final) * (1 + math.cos(math.pi * progress))
        if tc.lr_schedule == "exp":
            return tc.lr_init * (tc.lr_final / tc.lr_init) ** progress
        if tc.lr_schedule == "linear":
            return tc.lr_init + (tc.lr_final - tc.lr_init) * progress
        return tc.lr_init

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm),
    as one multi-tensor launch instead of three small ones per tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


class Optimizer:
    """The JAX optimizer chain over ``named_params`` (the trainable ones):
    ``step()`` clips the ``.grad`` of every parameter, runs AdamW at the
    scheduled lr and returns the global norm of the unclipped gradients."""

    def __init__(self, tc: TrainConfig, named_params: List[Tuple[str, torch.nn.Parameter]]):
        if not named_params:
            raise ValueError("no trainable parameters")
        self.tc = tc
        self.schedule = make_schedule(tc)
        self.count = 0
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        labels = lr_scale_labels(named_params) if tc.layerwise_lr else {}
        decays = decay_mask(named_params)
        groups: Dict[Tuple[float, bool], List[torch.nn.Parameter]] = {}
        for name, p in named_params:
            key = (_MULT[labels.get(name, "1x")], tc.weight_decay > 0 and decays[name])
            groups.setdefault(key, []).append(p)
        self.opt = torch.optim.AdamW(
            [dict(params=ps, mult=mult, weight_decay=tc.weight_decay if decay else 0.0)
             for (mult, decay), ps in groups.items()],
            lr=tc.lr_init, betas=(tc.beta1, tc.beta2), eps=tc.adam_eps,
        )

    @torch.no_grad()
    def step(self, keep: Optional[List[torch.nn.Parameter]] = None) -> torch.Tensor:
        if all(p.grad is None for p in self.params):
            raise RuntimeError("no trainable parameter got a gradient")
        # a parameter the loss does not reach (the untied head under the MLM
        # loss) has a zero gradient, as under jax.grad: Adam leaves it alone
        # and weight decay still applies
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.tc.grad_clip > 0:
            factor = torch.where(norm < self.tc.grad_clip, torch.ones_like(norm),
                                 self.tc.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr * group["mult"]
        kept = [p.clone() for p in keep or ()]
        self.opt.step()
        for p, value in zip(keep or (), kept):
            p.copy_(value)
        self.count += 1
        return norm


    def state_dict(self) -> Dict:
        """The train state: the trainable parameters by name, AdamW's state
        and the update count (the JAX TrainState's params, opt_state and
        step)."""
        return {"params": {n: p.detach().clone() for n, p in zip(self.names, self.params)},
                "adam": self.opt.state_dict(), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore what ``state_dict`` saved, over the same parameters."""
        if sorted(state["params"]) != sorted(self.names):
            raise ValueError("the train state holds other parameters than the ones that train")
        for n, p in zip(self.names, self.params):
            p.copy_(state["params"][n])
        self.opt.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(tc: TrainConfig, named_params) -> Optimizer:
    return Optimizer(tc, list(named_params))


def trainable_mask(model: torch.nn.Module, train_type: str) -> Dict[str, bool]:
    """Which parameters train (the reference's requires_grad filters):
    'full' - everything; 'lora' (and 'pissa') - LoRA factors, time_state and
    head_* leaves; 'states' - only att.time_state; 'slot-lora' - the stacks
    of the slot-LoRA projections (``<path>.A``, ``<path>.B``)."""
    def keep(name: str) -> bool:
        if train_type == "full":
            return True
        if train_type in ("state", "states"):
            return "time_state" in name
        if train_type in ("lora", "pissa"):
            return "lora" in name or "time_state" in name or name.startswith("head_")
        if train_type == "slot-lora":
            return name.rsplit(".", 1)[-1] in ("A", "B")
        raise ValueError(f"unknown train type {train_type!r}")

    return {name: keep(name) for name, _ in model.named_parameters()}


def apply_trainable_mask(model: torch.nn.Module, mask: Dict[str, bool]) -> None:
    """Freeze every parameter the mask leaves out, unfreeze the rest."""
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
