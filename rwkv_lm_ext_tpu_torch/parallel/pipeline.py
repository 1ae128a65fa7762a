"""Pipeline parallelism (GPipe) over the ranks of a pp group.

Counterpart of rwkv_lm_ext_tpu/parallel/pipeline.py (:47-196): ``make_pp_mesh``
(:47-70), the stage split of ``pp_param_specs`` (:73-84) and
``pipeline_loss`` (:97-196). JAX runs the schedule inside one ``shard_map``
and lets ``jax.grad`` transpose its ``ppermute``s; here each stage is a
process, and the schedule and its backward are written out:

- ``make_pp_mesh(dp, pp)``: rank = d * pp + p, so the ``pp`` ranks of a
  pipeline are consecutive and, as JAX guards, must share a host (the
  activations cross the pipeline every micro-batch); the dp groups join the
  ranks of one stage.
- ``stage_model``: stage p keeps blocks [p L/pp, (p + 1) L/pp) (``n_layer %
  pp == 0``, JAX's uniform stack), stage 0 the embedding (block 0 holds ln0,
  which JAX lifts out of the stack), the last stage ``ln_out`` and the head.
  The other blocks become parameter-free placeholders, so parameter names
  keep their global layer index; ``emb`` and the head are held only where
  they are used (JAX replicates them: layout only).
- ``pipeline_loss``: GPipe, ``n_micro`` micro-batches of this rank's rows.
  Forward: stage 0 embeds micro-batch m, every stage runs its blocks from a
  zero state (JAX's ``layer_id=1`` blocks), sends the (mb, T, C) activation in
  the compute dtype to the next stage; the last stage takes the
  token-weighted cross entropy (JAX's ``ce_sum``: no L2Wrap) over the global
  batch's token count. Backward, the micro-batches in reverse: the last stage
  differentiates its losses, every stage sends its input's gradient to the
  previous one and receives its output's from the next. Every stage walks
  the micro-batches in the same order, and messages between two stages go one
  way in each phase, so the schedule cannot deadlock. The
  ``n_micro + pp - 1`` ticks of JAX's scan are the time this takes: stage p
  starts micro-batch m when stage p - 1 has sent it.

RWKV-4 models and the legacy options are refused by name (JAX's stage body
is the RWKV-5/6 block).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS
from rwkv_lm_ext_tpu_torch.models.state import init_model_state
from rwkv_lm_ext_tpu_torch.parallel.distributed import (
    backend,
    check_on_one_host,
    isend,
    new_groups,
    process_count,
    process_index,
    recv,
)
from rwkv_lm_ext_tpu_torch.train.losses import _ce_with_ignore
from rwkv_lm_ext_tpu_torch.utils.remat import remat_call


@dataclasses.dataclass(frozen=True)
class PipeMesh:
    """A (dp, pp) mesh as this process sees it: its ``stage`` and
    ``dp_rank``, its pp group (the pipeline) and dp group (its stage's
    replicas), None where the axis is 1."""

    dp: int
    pp: int
    stage: int
    dp_rank: int
    pp_group: object = None
    dp_group: object = None
    backend: Optional[str] = None

    # no tensor-parallel axis (parallel.mesh.Mesh's ``pp`` is 1 likewise)
    tp = 1

    @property
    def rank(self) -> int:
        return self.dp_rank * self.pp + self.stage

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1


def make_pp_mesh(dp: int, pp: int) -> PipeMesh:
    """The (dp, pp) mesh over every process, dp outermost (module
    docstring). Every process must call it."""
    world = process_count()
    if dp * pp != world:
        raise ValueError(f"make_pp_mesh: dp*pp={dp * pp} must be the number of processes "
                         f"({world}): the port runs one rank a process")
    pipes = [list(range(d * pp, (d + 1) * pp)) for d in range(dp)]
    check_on_one_host(pipes, "pp")
    me = process_index()
    pp_group = new_groups(pipes) if pp > 1 else None
    dp_group = new_groups([list(range(p, world, pp)) for p in range(pp)]) if dp > 1 else None
    return PipeMesh(dp=dp, pp=pp, stage=me % pp, dp_rank=me // pp, pp_group=pp_group,
                    dp_group=dp_group, backend=backend())


def stage_layers(n_layer: int, pp: int, stage: int) -> range:
    if n_layer % pp:
        raise ValueError(f"{n_layer} layers do not divide over pp={pp} stages")
    per = n_layer // pp
    return range(stage * per, (stage + 1) * per)


def stage_model(model, mesh: PipeMesh):
    """Cut ``model`` to this rank's stage in place (module docstring);
    returns it. Idempotent."""
    if getattr(model, "pp_mesh", None) is not None:
        return model
    cfg = model.cfg
    if cfg.version < 5 or cfg.legacy_options:
        raise ValueError("pipeline training runs the RWKV-5/6 block: not an RWKV-4 model or one "
                         f"with {', '.join(cfg.legacy_options) or 'legacy options'}")
    layers = stage_layers(cfg.n_layer, mesh.pp, mesh.stage)
    for i in range(cfg.n_layer):
        if i not in layers:
            model.blocks[i] = nn.Identity()
    if mesh.stage != 0:
        model.emb = None
    if not mesh.last:
        model.ln_out = None
        model.head = None
    model.pp_mesh, model.pp_layers = mesh, layers
    return model


def _run_stage(model, x: torch.Tensor, ops, remat) -> torch.Tensor:
    state = init_model_state(model.cfg, x.shape[0], device=x.device)
    for i in model.pp_layers:
        ls = (state["att_shift"][i], state["wkv"][i], state["ffn_shift"][i])
        x, _ = remat_call(model.blocks[i], x, ls, ops, False, None, None, remat=remat)
    return x


def pipeline_loss(model, tokens: torch.Tensor, labels: torch.Tensor, mesh: PipeMesh, *,
                  n_micro: int, count: Optional[torch.Tensor] = None, remat=False,
                  reference: bool = False, backward: bool = True) -> torch.Tensor:
    """GPipe on this rank's stage (module docstring) of its rows ``tokens``
    / ``labels`` (B, T), -100 = ignored. ``count``: the global batch's
    unmasked tokens (default: this rank's). Returns this stage's share of
    the loss (the last stage's cross-entropy sum over ``count``, 0 on the
    others; summed over the pp and dp ranks it is JAX's loss) and, with
    ``backward``, leaves the stage parameters' gradients in ``.grad``."""
    stage_model(model, mesh)
    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    mb = B // n_micro
    toks = tokens.reshape(n_micro, mb, T)
    labs = labels.reshape(n_micro, mb, T)
    if count is None:
        count = (labels != -100).sum()
    cfg = model.cfg
    ops = PLAIN_OPS if reference else KERNEL_OPS
    dev = tokens.device
    prev, nxt = mesh.rank - 1, mesh.rank + 1
    ins, outs, sends = [], [], []
    loss = torch.zeros((), device=dev)
    for m in range(n_micro):
        if mesh.stage == 0:
            x = model.embed(toks[m])
        else:
            x = recv(torch.empty(mb, T, cfg.n_embd, dtype=cfg.compute_dtype, device=dev), prev)
            x.requires_grad_(backward)
        with torch.set_grad_enabled(backward):
            y = _run_stage(model, x, ops, remat)
            if mesh.last:
                h = ops.layer_norm(y, model.ln_out.weight, model.ln_out.bias)
                y = _ce_with_ignore(model.head(h, ops), labs[m], count)
                loss = loss + y.detach()
            else:
                sends.append(isend(y.detach(), nxt))
        ins.append(x)
        outs.append(y)
    for work in sends:
        work.wait()
    if not backward:
        return loss
    sends = []
    for m in reversed(range(n_micro)):
        if mesh.last:
            outs[m].backward()
        else:
            outs[m].backward(recv(torch.empty_like(outs[m]), nxt))
        if mesh.stage > 0:
            sends.append(isend(ins[m].grad, prev))
        ins[m] = outs[m] = None
    for work in sends:
        work.wait()
    return loss
