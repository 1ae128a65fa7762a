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

``ShardedOptimizer`` is the same chain over several ranks, the counterpart of
JAX's ``place_train_state`` (train/loop.py:185-208: optimizer state sharded
over dp) and ``place_pp_train_state`` (:282-308: the moments follow their
stage). The trainable parameters of a rank are laid end to end in one flat
fp32 buffer, which becomes their storage (each parameter a view of it), in
the order (class, lr multiplier, decay), so that each group is one range:
class 0 holds the leaves that are whole on every rank of the model group (tp
or pp), class 1 the whole leaves whose gradient is partial on each tp rank
(``tp_partial``, parallel/tp.py), class 2 the rank's own leaves (``tp_axis``,
or every leaf of a pipeline stage). A step:

1. the gradients land in a second flat buffer (each ``.grad`` a view of it,
   filled in place by autograd); class 1 is summed over the model group, then
   everything over dp, as a few flat buckets (``BUCKET_ELEMENTS``) and not one
   collective a parameter;
2. dp rank d owns elements [d n, (d + 1) n) of the buffer (n = ceil(N / dp)):
   only it keeps their Adam moments, so a rank holds at most ceil(1/dp) of
   the single-process moment elements;
3. the global norm, as ``optax.clip_by_global_norm`` takes it over the whole
   gradient: norm^2 of each shard, summed over dp; the rank-owned class
   summed over the model group too; a leaf whole on every rank counted once.
   The step's loss rides in the same collective;
4. the clip and AdamW (``torch.optim.AdamW`` on the owned ranges, one param
   group a range) update the owned elements, LISA's kept parameters get their
   values back, and the owned ranges are all-gathered over dp into every
   rank's buffer, hence its parameters.

Every rank starts from the values of rank 0 (of the model group's rank 0 for
class 0 and 1, of dp rank 0 for everything), broadcast once at construction.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.parallel.distributed import (
    all_gather_into,
    all_reduce,
    broadcast,
    collective_device,
)

# elements of the flat fp32 buffers a collective carries (128 MiB)
BUCKET_ELEMENTS = 1 << 25

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


def group_keys(tc: TrainConfig, named_params) -> Dict[str, Tuple[float, bool]]:
    """{name: (lr multiplier, weight decay on)}: the optax chain's lr groups
    (--layerwise-lr) and decay mask."""
    labels = lr_scale_labels(named_params) if tc.layerwise_lr else {}
    decays = decay_mask(named_params)
    return {name: (_MULT[labels.get(name, "1x")], tc.weight_decay > 0 and decays[name])
            for name, _ in named_params}


class Optimizer:
    """The JAX optimizer chain over ``named_params`` (the trainable ones):
    ``step()`` clips the ``.grad`` of every parameter, runs AdamW at the
    scheduled lr and returns the global norm of the unclipped gradients.
    ``ShardedOptimizer`` runs the same chain (``_adamw``, ``_clip``,
    ``_set_lr``, the train state) over several ranks."""

    def __init__(self, tc: TrainConfig, named_params: List[Tuple[str, torch.nn.Parameter]]):
        self._start_chain(tc, named_params)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        keys = group_keys(tc, named_params)
        groups: Dict[Tuple[float, bool], List[torch.nn.Parameter]] = {}
        for name, p in named_params:
            groups.setdefault(keys[name], []).append(p)
        self.opt = self._adamw([(ps, mult, decay) for (mult, decay), ps in groups.items()])

    def _start_chain(self, tc: TrainConfig, named_params) -> None:
        if not named_params:
            raise ValueError("no trainable parameters")
        self.tc, self.schedule, self.count = tc, make_schedule(tc), 0

    def _adamw(self, groups) -> Optional[torch.optim.AdamW]:
        """AdamW over (params, lr multiplier, decay on) groups; None with none."""
        if not groups:
            return None
        tc = self.tc
        return torch.optim.AdamW(
            [dict(params=ps, mult=mult, weight_decay=tc.weight_decay if decay else 0.0)
             for ps, mult, decay in groups],
            lr=tc.lr_init, betas=(tc.beta1, tc.beta2), eps=tc.adam_eps,
        )

    def _clip(self, grads: List[torch.Tensor], norm: torch.Tensor) -> None:
        """optax.clip_by_global_norm: g * max / |g| only when |g| >= max."""
        if self.tc.grad_clip > 0 and grads:
            factor = torch.where(norm < self.tc.grad_clip, torch.ones_like(norm),
                                 self.tc.grad_clip / norm)
            torch._foreach_mul_(grads, factor)

    def _set_lr(self) -> None:
        """Each group's lr: its multiplier times the schedule at the count."""
        lr = self.schedule(self.count)
        for group in self.opt.param_groups if self.opt is not None else ():
            group["lr"] = lr * group["mult"]

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
        self._clip(grads, norm)
        self._set_lr()
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
                "adam": None if self.opt is None else self.opt.state_dict(), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore what ``state_dict`` saved, over the same parameters."""
        if sorted(state["params"]) != sorted(self.names):
            raise ValueError("the train state holds other parameters than the ones that train")
        for n, p in zip(self.names, self.params):
            p.copy_(state["params"][n])
        if self.opt is not None:
            self.opt.load_state_dict(state["adam"])
        self.count = int(state["count"])


def _buckets(a: int, b: int):
    for lo in range(a, b, BUCKET_ELEMENTS):
        yield lo, min(lo + BUCKET_ELEMENTS, b)


def param_class(p: torch.Tensor, stage_owned: bool) -> int:
    """0: whole on every rank of the model group; 1: whole with a partial
    gradient (summed over tp); 2: this rank's own (a tp slice, a stage's)."""
    if stage_owned or getattr(p, "tp_axis", None) is not None:
        return 2
    return 1 if getattr(p, "tp_partial", False) else 0


class ShardedOptimizer(Optimizer):
    """The JAX optimizer chain over the ranks of a dp x (tp or pp) mesh with
    the Adam moments sharded over dp (the module docstring). ``dp_group``
    and ``model_group`` are this rank's groups (None where the axis is 1),
    ``dp_src`` / ``model_src`` the global ranks of their rank 0;
    ``stage_owned`` says that every parameter is this rank's own (a
    pipeline stage) and that the step's extras (its loss) are summed over
    the model group as well as over dp. ``step(keep=, extras=)`` returns
    (global norm of the unclipped gradients, the extras summed)."""

    def __init__(self, tc: TrainConfig, named_params: List[Tuple[str, torch.nn.Parameter]], *,
                 dp: int, dp_rank: int, dp_group=None, dp_src: int = 0, model: int = 1,
                 model_group=None, model_src: int = 0, stage_owned: bool = False):
        self._start_chain(tc, named_params)
        for name, p in named_params:
            if p.dtype != torch.float32:
                raise ValueError(f"the sharded optimizer keeps fp32 parameters; {name} is "
                                 f"{p.dtype}")
        self.dp, self.dp_rank, self.dp_group = dp, dp_rank, dp_group
        self.model, self.model_group, self.stage_owned = model, model_group, stage_owned
        keys = group_keys(tc, named_params)

        def key(item):
            name, p = item
            return (param_class(p, stage_owned),) + keys[name]

        order = sorted(named_params, key=key)      # stable: the model's order within a group
        self.names = [n for n, _ in order]
        self.params = [p for _, p in order]
        self.n = sum(p.numel() for p in self.params)
        per = -(-self.n // dp)
        dev = self.params[0].device
        self.flat = torch.zeros(per * dp, dtype=torch.float32, device=dev)
        self.grad = torch.zeros_like(self.flat)
        self.ranges, self.views, self.gviews, self.keys = [], [], [], []
        lo = 0
        for item, p in zip(order, self.params):
            hi = lo + p.numel()
            self.flat[lo:hi].copy_(p.detach().reshape(-1))
            p.data = self.flat[lo:hi].view_as(p)
            self.ranges.append((lo, hi))
            self.gviews.append(self.grad[lo:hi].view_as(p))
            self.keys.append(key(item))
            lo = hi
        # each (class, mult, decay) group is one range; the rank owns [a, b)
        self.shard = (dp_rank * per, (dp_rank + 1) * per)
        spans: Dict[tuple, List[int]] = {}
        for k, (lo, hi) in zip(self.keys, self.ranges):
            span = spans.setdefault(k, [lo, hi])
            span[1] = hi
        self.class_span = {c: (min(v[0] for k, v in spans.items() if k[0] == c),
                               max(v[1] for k, v in spans.items() if k[0] == c))
                           for c in {k[0] for k in spans}}
        self.segments = []       # (lo, hi, class) owned by this rank
        groups = []
        for (cls, mult, decay), (lo, hi) in spans.items():
            a, b = max(lo, self.shard[0]), min(hi, self.shard[1])
            if a < b:
                self.segments.append((a, b, cls))
                owned = torch.nn.Parameter(self.flat[a:b])
                owned.grad = self.grad[a:b]
                groups.append(([owned], mult, decay))
        self.opt = self._adamw(groups)
        self._start(dp_src, model_src)

    @torch.no_grad()
    def _start(self, dp_src: int, model_src: int) -> None:
        """Every rank takes rank 0's values (the class docstring)."""
        if self.model > 1 and not self.stage_owned:
            lo = min((self.class_span[c][0] for c in (0, 1) if c in self.class_span), default=0)
            hi = max((self.class_span[c][1] for c in (0, 1) if c in self.class_span), default=0)
            for a, b in _buckets(lo, hi):
                broadcast(self.flat[a:b], model_src, self.model_group)
        if self.dp > 1:
            for a, b in _buckets(0, self.n):
                broadcast(self.flat[a:b], dp_src, self.dp_group)

    def zero_grad(self) -> None:
        """Zero the gradient buffer and make every ``.grad`` a view of it,
        so that backward accumulates into it in place."""
        self.grad.zero_()
        for p, g in zip(self.params, self.gviews):
            p.grad = g

    def moment_elements(self) -> int:
        """Adam moment elements this rank holds (first and second)."""
        if self.opt is None:
            return 0
        return sum(t.numel() for st in self.opt.state.values() for k, t in st.items()
                   if k in ("exp_avg", "exp_avg_sq"))

    @torch.no_grad()
    def reduce(self) -> None:
        """Step 1 of ``step``: the gradients into the flat buffer, summed
        over the ranks (``named_grads`` then reads them)."""
        for p, g in zip(self.params, self.gviews):
            if p.grad is None:
                p.grad = g
            elif p.grad.data_ptr() != g.data_ptr():
                g.copy_(p.grad)
                p.grad = g
        if self.model > 1 and 1 in self.class_span:
            for a, b in _buckets(*self.class_span[1]):
                all_reduce(self.grad[a:b], self.model_group)
        if self.dp > 1:
            for a, b in _buckets(0, self.n):
                all_reduce(self.grad[a:b], self.dp_group)

    def named_grads(self) -> Dict[str, torch.Tensor]:
        """{name: the parameter's gradient} in the flat buffer (after
        ``reduce``: the global batch's, a tp slice for a ``tp_axis`` leaf)."""
        return dict(zip(self.names, self.gviews))

    @torch.no_grad()
    def step(self, keep: Optional[List[torch.nn.Parameter]] = None,
             extras: Optional[torch.Tensor] = None):
        self.reduce()
        owned = [(self.grad[a:b], cls) for a, b, cls in self.segments]
        zero = torch.zeros((), device=self.flat.device)
        sq = [sum((g.square().sum() for g, c in owned if c != 2), zero),
              sum((g.square().sum() for g, c in owned if c == 2), zero)]
        n_extra = 0 if extras is None else extras.numel()
        vec = torch.stack(sq + ([] if extras is None else list(extras.reshape(-1).float())))
        vec = vec.to(collective_device())
        if self.dp > 1:
            all_reduce(vec, self.dp_group)
        if self.model > 1:
            # the rank-owned norm^2 (and a stage's loss) over the model group
            part = vec[1:] if self.stage_owned else vec[1:2]
            vec = torch.cat([vec[:1], all_reduce(part.clone(), self.model_group),
                             vec[1 + part.numel():]])
        vec = vec.to(self.flat.device)
        norm = (vec[0] + vec[1]).sqrt()
        self._clip([g for g, _ in owned], norm)
        kept = []
        for p in keep or ():
            lo, hi = self.ranges[self._index(p)]
            a, b = max(lo, self.shard[0]), min(hi, self.shard[1])
            if a < b:
                kept.append((a, b, self.flat[a:b].clone()))
        self._set_lr()
        if self.opt is not None:
            self.opt.step()
        for a, b, value in kept:
            self.flat[a:b].copy_(value)
        if self.dp > 1:
            per = self.flat.numel() // self.dp
            for a, b in _buckets(0, per):
                outs = [self.flat[r * per + a:r * per + b] for r in range(self.dp)]
                all_gather_into(outs, self.flat[self.dp_rank * per + a:self.dp_rank * per + b],
                                self.dp_group)
        self.count += 1
        return norm, (vec[2:2 + n_extra] if n_extra else None)

    def _index(self, p: torch.nn.Parameter) -> int:
        for i, q in enumerate(self.params):
            if q is p:
                return i
        raise KeyError("a kept parameter is not one that this optimizer trains")

    def state_dict(self) -> Dict:
        """This rank's train state: ``Optimizer.state_dict`` (its trainable
        parameters, the moments of its owned ranges, the count) and the
        layout they belong to (checkpoint/orbax_io.py writes one file a
        rank)."""
        return dict(super().state_dict(), layout=self.layout())

    def layout(self) -> Dict:
        return {"dp": self.dp, "dp_rank": self.dp_rank, "model": self.model,
                "elements": self.n, "shard": list(self.shard)}

    def load_state_dict(self, state: Dict) -> None:
        """Restore what ``state_dict`` saved, on the same layout."""
        if state.get("layout") != self.layout():
            raise ValueError(f"the train state was saved on the layout {state.get('layout')}, "
                             f"this run's is {self.layout()}: resume at the same dp / tp / pp")
        super().load_state_dict(state)


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
