"""The serving mesh and the head-parallel tensor-parallel layout.

Counterpart of rwkv_lm_ext_tpu/parallel/mesh.py: ``make_mesh`` (:25),
``_att_spec`` / ``_ffn_spec`` / ``param_shardings`` (:35-97) and
``state_shardings`` (:107-126). In JAX a mesh names devices and GSPMD
inserts the collectives; here a ``Mesh`` is the tensor-parallel process
group (one process a rank, parallel/distributed.py) and parallel/tp.py puts
the three collectives into the model by hand.

Layout (head-parallel TP, JAX's specs in the port's (out, in) weights):

- ``att.receptance/key/value/gate``: column-parallel, JAX ``P(None, "tp")``
  on the (C, A) kernel, so the port's dim 0 of its (A, C) weight;
- ``att.output``: row-parallel, JAX ``P("tp", None)`` on (A, C): the port's
  dim 1 of (C, A);
- ``att.time_decay`` (the port's (1, 1, A); v5 (H, N)), ``time_decay_w2``
  (Dd, A), ``time_faaaa`` (H, N), ``time_state`` (H, N, N) and ``ln_x``
  (A,): over the attention width or the heads;
- ``ffn.key`` column-parallel (dim 0 of (F, C)), ``ffn.value`` row-parallel
  (dim 1 of (C, F)), ``ffn.receptance`` whole;
- ``head``: over the vocabulary, JAX ``P(None, "tp")`` on (C, V): dim 0 of
  the port's (V, C);
- everything else (``emb``, the LayerNorms, ``time_maa_*``,
  ``time_decay_w1``) whole on every rank.

``split_axis`` keeps JAX's divisibility guard (:80-95): an axis that does not
divide by tp stays whole. A rank's model (parallel/tp.py) needs the heads and
the FFN width to divide, and refuses a model where they do not; the guard
decides the quantized leaves' layout (``quant_split``), as in JAX: an int8
weight's (out, 1) scale is sliced with a column-parallel weight and whole
under a row-parallel one, and a 4-bit weight's blocks of 64 (which run along
the output axis of the JAX (in, out) array) are sliced only where no block
crosses a rank's boundary, else the packed leaf stays whole on every rank and
each rank dequantizes it and keeps its slice.

``state_shardings``' counterpart is ``init_model_state`` on a rank's config
(``local_config``): the WKV state of the rank's heads.

``make_mesh(dp, tp)`` is JAX's ``make_mesh`` (:25-32) over the processes:
rank = d * tp + t, as JAX's (dp, tp) device array reshapes. A ``Mesh`` carries
both of this rank's groups: ``group`` (its tp group: the tp ranks of its dp
index) and ``dp_group`` (the dp ranks of its tp index); ``rank`` is the rank
within the tp group, ``dp_rank`` within the dp group. Training takes any
(dp, tp); serving takes dp = 1 and refuses more by name (serve.cli, the
engine): a dp axis of replicas behind one server is not ported (ROADMAP A.12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from rwkv_lm_ext_tpu_torch.parallel.distributed import (
    all_gather_into,
    all_reduce,
    backend,
    new_groups,
    process_count,
    process_index,
)

COLUMN = ("receptance", "key", "value", "gate")   # att's column-parallel projections


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) mesh as this process sees it: ``rank`` within its tp
    ``group`` (None at tp=1), ``dp_rank`` within its ``dp_group`` (None at
    dp=1), and the backend."""

    dp: int
    tp: int
    rank: int
    group: object = None
    backend: Optional[str] = None
    dp_rank: int = 0
    dp_group: object = None

    # a (dp, tp) mesh has no pipeline axis (parallel.pipeline.PipeMesh's
    # ``tp`` is 1 likewise), so that a trainer reads either kind alike
    pp = 1

    @property
    def graph_capture(self) -> bool:
        """Whether decode blocks may be CUDA graphs: NCCL's collectives can be
        captured, gloo's (staged through host memory) cannot."""
        return self.tp == 1 or self.backend == "nccl"

    def describe(self) -> Dict:
        return {"tp": self.tp, "rank": self.rank, "backend": self.backend or "none"}

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the tp ranks, in place; returns it."""
        return all_reduce(t, self.group, op)

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The tp ranks' ``t`` joined along the last axis, in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        all_gather_into(parts, t, self.group)
        return torch.cat(parts, -1)


def make_mesh(dp: int = 1, tp: Optional[int] = None) -> Mesh:
    """The (dp, tp) mesh over every process of the group: rank = d * tp + t
    (module docstring); ``tp`` defaults to the processes over dp. Every
    process must call it, in the same order as its other group calls."""
    world = process_count()
    tp = world // dp if tp is None else tp
    if dp * tp != world:
        raise ValueError(f"make_mesh: dp*tp={dp * tp} must be the number of processes ({world}): "
                         "the port runs one rank a process")
    if world == 1:
        return Mesh(dp=1, tp=1, rank=0)
    me = process_index()
    tp_blocks = [list(range(d * tp, (d + 1) * tp)) for d in range(dp)]
    tp_group = new_groups(tp_blocks) if tp > 1 else None
    dp_group = new_groups([list(range(t, world, tp)) for t in range(tp)]) if dp > 1 else None
    return Mesh(dp=dp, tp=tp, rank=me % tp, group=tp_group, backend=backend(), dp_rank=me // tp,
                dp_group=dp_group)


def _parts(key: str) -> Tuple[Optional[str], Optional[str]]:
    """(part, name) of a flat key: ("att", "key") for blocks.0.att.key.weight,
    ("head", None) for head.weight, (None, None) otherwise."""
    parts = key.split(".")
    if parts[0] == "head":
        return "head", None
    for part in ("att", "ffn"):
        if part in parts:
            i = parts.index(part)
            return part, parts[i + 1] if i + 1 < len(parts) else None
    return None, None


def spec_axis(key: str, ndim: int) -> Optional[int]:
    """The axis JAX's spec names for the dense leaf ``key`` of a port state
    dict (its (out, in) weights and vectors), before the guard; None =
    replicated."""
    part, name = _parts(key)
    if part == "head":
        return 0
    if part == "att":
        if name in COLUMN:
            return 0
        if name == "output":
            return 1
        if name == "time_decay":
            return ndim - 1 if ndim == 3 else 0      # v6 (1, 1, A), v5 (H, N)
        if name == "time_decay_w2":
            return 1
        if name in ("time_faaaa", "time_state", "ln_x"):
            return 0
    if part == "ffn":
        if name == "key":
            return 0
        if name == "value":
            return 1
    return None


def split_axis(key: str, shape, tp: int) -> Optional[int]:
    """``spec_axis`` with JAX's divisibility guard: None where tp is 1 or the
    axis does not divide."""
    axis = spec_axis(key, len(shape))
    if tp == 1 or axis is None or shape[axis] % tp:
        return None
    return axis


def quant_split(mode: str, axis: int, shape: Tuple[int, int], tp: int) -> Optional[str]:
    """How a quantized weight of logical (out, in) ``shape``, split on
    ``axis`` (0 column-, 1 row-parallel), is cut: "rows" (int8 q and scale
    by output rows), "cols" (int8 q by input columns, the scale whole),
    "blocks" (4-bit: the rank's whole blocks) or None (4-bit blocks that
    would cross a rank's boundary: the packed leaf stays whole)."""
    out, n_in = shape
    if mode in ("int8", "int8c"):
        return "rows" if axis == 0 else "cols"
    if axis == 0:
        # the rank's columns of the JAX (in, out) array, runs of out/tp
        return "blocks" if out % tp == 0 and (out // tp) % 64 == 0 else None
    return "blocks" if n_in % tp == 0 and (n_in // tp * out) % 64 == 0 else None


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh_tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """A dense flat state dict's slice for ``rank`` of ``mesh_tp`` ranks:
    every leaf split on ``split_axis`` is cut into equal parts, the rest is
    kept whole (shared, not copied)."""
    out = {}
    for key, value in sd.items():
        axis = split_axis(key, tuple(value.shape), mesh_tp)
        out[key] = value if axis is None else value.chunk(mesh_tp, axis)[rank].contiguous()
    return out


def local_config(cfg, tp: int):
    """A rank's config: the attention and FFN widths over tp (so its heads,
    n_head / tp), the vocabulary and everything else whole."""
    return dataclasses.replace(cfg, dim_att=cfg.dim_att // tp, dim_ffn=cfg.dim_ffn // tp)
