"""A tensor-parallel rank's model: the port's RWKV at the local widths, with
three collectives.

Counterpart of what GSPMD makes of rwkv_lm_ext_tpu's forward under
``param_shardings`` (parallel/mesh.py :35-97) on a ``tp`` mesh, written out
by hand. ``shard_model`` cuts a whole model (dense, or quantized by
adapters.quant, after any LoRA merge: JAX quantizes, then places) in place
into rank ``mesh.rank``'s part, by the layout of parallel/mesh.py:

- the rank holds ``n_head / tp`` heads: its config is ``local_config``
  (``dim_att / tp``, ``dim_ffn / tp``), so the WKV kernels K1 and B.9 and the
  ``ln_x`` GroupNorm (per head) run unchanged on the local heads, and the
  decay ``time_decay + tanh(xw @ w1) @ w2`` comes out local because
  ``time_decay`` and ``w2`` are sliced;
- K2 (ln1 + shift + ddlerp), K3, ``ln0``, ``emb``, ``ffn.receptance``, the
  ``time_maa_*`` vectors and ``time_decay_w1`` stay whole: every rank
  computes them on the same values;
- ``att.output`` and ``ffn.value`` are row-parallel (``RowParallel``): each
  rank's product over its slice of the contraction axis, then an all-reduce
  (sum) in fp32, rounded once to the compute dtype;
- the head holds ``vocab / tp`` rows (``GatheredHead``): an all-gather of
  the logits after it, so every rank has the whole (…, V) logits.

All-reduce and all-gather give every rank the same values, so every rank
samples the same token from the same seeded generator, and the replicated
computations stay equal across ranks: the ranks run in lockstep.

int8c under tp. A row-parallel layer splits the contraction axis, so B.4's
row absmax on a rank's slice is not the row's. ``RowParallel`` takes each
slice's scale (B.4), the largest over the ranks (all-reduce MAX: the largest
slice scale is the row's scale, B.4's scale being monotone in the absmax),
quantizes its slice with it (B.4's given-scale entry), all-reduces the int32
partial products (exact) and rescales once, ``(y * sx) * scale`` in the order
of adapters/quant.py ``int8_matmul``. The weight was quantized whole and then
cut, so its (N, 1) scale is whole here. A sharded int8c model so gives the
single-process int8c codes and products bit for bit. int8, nf4 and fp4
dequantize on use; a 4-bit leaf whose blocks would cross a rank's boundary
stays whole and is sliced after dequantizing (``SlicedLinear``).

``shard_model`` serves: its collectives run forward only. Refused by name:
RWKV-4 (one head of width C: nothing to split), the legacy options, slot-LoRA
and unmerged LoRA projections, and widths that do not divide by tp.

Training (``shard_for_training``) cuts the same layout and puts Megatron's
conjugate pair of collectives into the model by hooks, so that no module is
renamed:

- before each column-parallel projection (att receptance / key / value /
  gate, ffn key, the head) and before ``time_decay_w2`` (its product is
  column-parallel too), ``copy_to_tp``: the identity forward, an all-reduce
  (sum over tp) of the input's gradient backward;
- after each row-parallel one (att output, ffn value), ``reduce_from_tp``:
  the all-reduce forward (in fp32, rounded once), the identity backward;
- after the head, ``gather_from_tp``: the all-gather of the logits forward,
  the rank's slice of their gradient backward.

So K2 (whole on every rank), its backward B.5, the LayerNorms, ``emb``,
``time_maa_*``, ``time_decay_w1`` and ``ffn.receptance`` see the same inputs
and get the same, whole gradients on every rank. Unmerged (or merged) LoRA
under tp: a column-parallel projection keeps A whole and cuts B along its
output, a row-parallel one cuts A along its input and adds its partial
low-rank product to the base's partial product before the one all-reduce.
The whole factor beside a cut one (A of a column-parallel projection, B of a
row-parallel one) gets a partial gradient on each rank: it is marked
``tp_partial`` and the optimizer sums it over tp (train/optim.py). Every cut
parameter carries ``tp_axis``; ``whole_state_dict`` gathers them back for
the files that rank 0 writes. Quantized bases and slot-LoRA are refused under
tp training by name (ROADMAP A.12).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.adapters.quant import QuantLinear, int8_product
from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, Linear, Ops, TimeMix
from rwkv_lm_ext_tpu_torch.parallel.distributed import all_gather_into
from rwkv_lm_ext_tpu_torch.parallel.mesh import COLUMN, Mesh, local_config, quant_split


class SlicedLinear(nn.Module):
    """A quantized projection kept whole on every rank (4-bit blocks that
    would cross a rank's boundary, JAX's replicated leaf): its dequantized
    weight's rows or columns ``[start, stop)`` along ``dim``."""

    def __init__(self, inner: QuantLinear, dim: int, start: int, stop: int):
        super().__init__()
        self.inner, self.dim, self.start, self.stop = inner, dim, start, stop

    def forward(self, x: torch.Tensor, ops: Optional[Ops] = None) -> torch.Tensor:
        w = self.inner.dequantize(x.dtype).narrow(self.dim, self.start, self.stop - self.start)
        return F.linear(x, w)


class RowParallel(nn.Module):
    """A row-parallel projection: ``inner`` holds the rank's input columns;
    the partial products are summed over the ranks (module docstring)."""

    def __init__(self, inner: nn.Module, mesh: Mesh):
        super().__init__()
        self.inner, self.mesh = inner, mesh

    def forward(self, x: torch.Tensor, ops: Optional[Ops] = None) -> torch.Tensor:
        ops = KERNEL_OPS if ops is None else ops
        inner = self.inner
        if isinstance(inner, QuantLinear) and inner.mode == "int8c":
            return row_parallel_int8c(x, inner.q, inner.scale, self.mesh, ops)
        y = inner(x, ops)
        if y.dtype == torch.float32:
            return self.mesh.all_reduce(y)
        return self.mesh.all_reduce(y.float()).to(y.dtype)


def row_parallel_int8c(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, mesh: Mesh,
                       ops: Ops = KERNEL_OPS, *, codes: Optional[dict] = None) -> torch.Tensor:
    """x (..., K/tp) @ W^T of an int8c weight whose q (N, K/tp) is the rank's
    columns and scale (N, 1) the whole weight's: the module docstring's five
    steps. ``codes``, when given, receives the rank's activation codes
    ("q", (M, K/tp) int8) and the row scales ("sx", (M, 1) fp32)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    _, sx = ops.quantize_rows(x2)
    mesh.all_reduce(sx, dist.ReduceOp.MAX)
    xq = ops.quantize_rows_given(x2, sx)
    y = mesh.all_reduce(int8_product(xq, q))
    if codes is not None:
        codes.update(q=xq, sx=sx)
    out = (y.float() * sx) * scale.reshape(1, -1)
    return out.to(x.dtype).reshape(*lead, q.shape[0])


class GatheredHead(nn.Module):
    """The head's ``vocab / tp`` rows of this rank, then an all-gather of the
    logits along the vocabulary."""

    def __init__(self, inner: nn.Module, mesh: Mesh):
        super().__init__()
        self.inner, self.mesh = inner, mesh

    def forward(self, x: torch.Tensor, ops: Optional[Ops] = None) -> torch.Tensor:
        return self.mesh.all_gather_last(self.inner(x, ops))


def _cut(t: torch.Tensor, dim: int, tp: int, rank: int) -> torch.Tensor:
    return t.chunk(tp, dim)[rank].contiguous().clone()


def _cut_param(module: nn.Module, name: str, dim: int, tp: int, rank: int) -> None:
    p = getattr(module, name, None)
    if p is not None:
        setattr(module, name, nn.Parameter(_cut(p.data, dim, tp, rank), requires_grad=False))


def _cut_blocks(lin: QuantLinear, axis: int, tp: int, rank: int) -> QuantLinear:
    """A 4-bit projection's whole blocks for the rank (``quant_split``
    "blocks"): the blocks of the rank's (in, out/tp) or (in/tp, out) part of
    the JAX (in, out) array, in its flattened order."""
    out, n_in = lin.shape
    nb = lin.q.shape[0]
    if axis == 0:
        ol = out // tp
        idx = torch.arange(nb, device=lin.q.device)
        keep = (idx * 64 % out) // ol == rank
        shape = (ol, n_in)
    else:
        per = nb // tp
        keep = torch.zeros(nb, dtype=torch.bool, device=lin.q.device)
        keep[rank * per:(rank + 1) * per] = True
        shape = (out, n_in // tp)
    return QuantLinear(lin.q[keep].clone(), lin.scale[keep].clone(), lin.mode, shape=shape, pad=0)


def cut_projection(lin: nn.Module, axis: int, mesh: Mesh) -> nn.Module:
    """The rank's part of a projection split on ``axis`` (0: its output
    rows, 1: its input columns)."""
    tp, rank = mesh.tp, mesh.rank
    if type(lin) is Linear:
        cut = Linear.__new__(Linear)
        nn.Module.__init__(cut)
        cut.weight = nn.Parameter(_cut(lin.weight.data, axis, tp, rank), requires_grad=False)
        return cut
    if isinstance(lin, QuantLinear):
        how = quant_split(lin.mode, axis, lin.shape, tp)
        if how == "rows":
            return QuantLinear(_cut(lin.q, 0, tp, rank), _cut(lin.scale, 0, tp, rank), lin.mode)
        if how == "cols":
            return QuantLinear(_cut(lin.q, 1, tp, rank), lin.scale, lin.mode)
        if how == "blocks":
            return _cut_blocks(lin, axis, tp, rank)
        size = lin.shape[axis] // tp
        return SlicedLinear(lin, axis, rank * size, (rank + 1) * size)
    raise ValueError(f"tensor parallelism takes dense or quantized projections, not "
                     f"{type(lin).__name__} (merge LoRA adapters first; slot-LoRA is not ported "
                     "under tp)")


def is_sharded(model) -> bool:
    return getattr(model, "tp_mesh", None) is not None


def check_shardable(cfg, tp: int) -> None:
    """Raise, by name, for a model that a tp group cannot split."""
    if cfg.version < 5:
        raise ValueError("tensor parallelism splits heads: an RWKV-4 model has one WKV of width "
                         "C and no heads (ROADMAP A.12)")
    if cfg.legacy_options:
        raise ValueError(f"tensor parallelism refuses the legacy options {cfg.legacy_options}")
    for what, n in (("n_head", cfg.n_head), ("dim_ffn", cfg.dim_ffn),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks needs {what} ({n}) to divide "
                             f"by {tp}")


def shard_model(model, mesh: Mesh):
    """Cut ``model`` (a whole RWKV-5/6, dense or quantized, on the rank's
    device) into this rank's part in place (module docstring); returns it.
    At tp=1 the model is left as it is."""
    if mesh.tp == 1 or is_sharded(model):
        return model
    cfg = model.cfg
    check_shardable(cfg, mesh.tp)
    tp, rank = mesh.tp, mesh.rank
    local = local_config(cfg, tp)
    for block in model.blocks:
        att, ffn = block.att, block.ffn
        for name in COLUMN:
            if getattr(att, name, None) is not None:
                setattr(att, name, cut_projection(getattr(att, name), 0, mesh))
        att.output = RowParallel(cut_projection(att.output, 1, mesh), mesh)
        _cut_param(att, "time_decay", att.time_decay.dim() - 1 if att.time_decay.dim() == 3 else 0,
                   tp, rank)
        if hasattr(att, "time_decay_w2"):
            _cut_param(att, "time_decay_w2", 1, tp, rank)
        _cut_param(att, "time_faaaa", 0, tp, rank)
        _cut_param(att, "time_state", 0, tp, rank)
        _cut_param(att.ln_x, "weight", 0, tp, rank)
        _cut_param(att.ln_x, "bias", 0, tp, rank)
        att.cfg = local
        ffn.key = cut_projection(ffn.key, 0, mesh)
        ffn.value = RowParallel(cut_projection(ffn.value, 1, mesh), mesh)
    model.head = GatheredHead(cut_projection(model.head, 0, mesh), mesh)
    model.cfg = local
    model.tp_mesh = mesh
    return model


# ---------------------------------------------------------------------------
# training: the differentiable collectives and the rank's trainable part
# ---------------------------------------------------------------------------

def _reduced(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A copy of ``t`` summed over the tp ranks in fp32, in ``t``'s dtype."""
    out = t.float().clone() if t.dtype == torch.float32 else t.float()
    return mesh.all_reduce(out.contiguous()).to(t.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        return _reduced(y, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.n = mesh, y.shape[-1]
        return mesh.all_gather_last(y)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward; the input's gradient summed over tp backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToTP.apply(x, mesh)
    return x


def reduce_from_tp(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The partial products summed over tp; the identity backward."""
    return _ReduceFromTP.apply(y, mesh)


def gather_from_tp(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' last-axis slices joined; the rank's slice of the gradient
    backward."""
    return _GatherFromTP.apply(y, mesh)


def _cut_trainable(module: nn.Module, name: str, dim: int, mesh: Mesh) -> None:
    """Replace parameter ``name`` by the rank's slice along ``dim``, keeping
    whether it trains, and mark it ``tp_axis``."""
    p = getattr(module, name, None)
    if p is None:
        return
    cut = nn.Parameter(_cut(p.data, dim, mesh.tp, mesh.rank), requires_grad=p.requires_grad)
    cut.tp_axis = dim
    setattr(module, name, cut)


def _mark_partial(p: nn.Parameter) -> None:
    p.tp_partial = True


def _cut_train_projection(proj: nn.Module, axis: int, mesh: Mesh) -> None:
    """Cut a dense projection, or a LoRA one (the module docstring's
    layout), in place for training."""
    from rwkv_lm_ext_tpu_torch.adapters.lora import LoraLinear

    if type(proj) is Linear:
        _cut_trainable(proj, "weight", axis, mesh)
        return
    if isinstance(proj, LoraLinear) and type(proj.base) is Linear:
        _cut_trainable(proj.base, "weight", axis, mesh)
        if axis == 0:      # column-parallel: B (r, out) by its output, A whole
            _cut_trainable(proj, "lora_B", 1, mesh)
            _mark_partial(proj.lora_A)
        else:              # row-parallel: A (in, r) by its input, B whole
            _cut_trainable(proj, "lora_A", 0, mesh)
            _mark_partial(proj.lora_B)
        return
    raise ValueError(f"tensor-parallel training takes dense projections or LoRA over a dense "
                     f"base, not {type(proj).__name__}"
                     + (f" over {type(proj.base).__name__}" if hasattr(proj, "base") else "")
                     + " (quantized bases and slot-LoRA are not ported under tp, ROADMAP A.12)")


def _column(parent: nn.Module, name: str, mesh: Mesh) -> nn.Module:
    proj = getattr(parent, name)
    _cut_train_projection(proj, 0, mesh)
    proj.register_forward_pre_hook(lambda m, args: (copy_to_tp(args[0], mesh),) + args[1:])
    return proj


def _row(parent: nn.Module, name: str, mesh: Mesh) -> None:
    proj = getattr(parent, name)
    _cut_train_projection(proj, 1, mesh)
    proj.register_forward_hook(lambda m, args, out: reduce_from_tp(out, mesh))


def shard_for_training(model, mesh: Mesh):
    """Cut ``model`` (a whole RWKV-5/6 on the rank's device, dense or with
    LoRA over a dense base, its trainable parameters already chosen) into
    this rank's trainable part in place, with the conjugate collectives
    (module docstring); returns it. At tp=1 it is left as it is."""
    if mesh.tp == 1 or is_sharded(model):
        return model
    cfg = model.cfg
    check_shardable(cfg, mesh.tp)
    local = local_config(cfg, mesh.tp)
    for block in model.blocks:
        att, ffn = block.att, block.ffn
        for name in COLUMN:
            if getattr(att, name, None) is not None:
                _column(att, name, mesh)
        _row(att, "output", mesh)
        decay_axis = att.time_decay.dim() - 1 if att.time_decay.dim() == 3 else 0
        _cut_trainable(att, "time_decay", decay_axis, mesh)
        if isinstance(att, TimeMix):
            _cut_trainable(att, "time_decay_w2", 1, mesh)
            att.tp_copy = functools.partial(copy_to_tp, mesh=mesh)
        _cut_trainable(att, "time_faaaa", 0, mesh)
        _cut_trainable(att, "time_state", 0, mesh)
        _cut_trainable(att.ln_x, "weight", 0, mesh)
        _cut_trainable(att.ln_x, "bias", 0, mesh)
        att.cfg = local
        _column(ffn, "key", mesh)
        _row(ffn, "value", mesh)
    head = _column(model, "head", mesh)
    head.register_forward_hook(lambda m, args, out: gather_from_tp(out, mesh))
    model.cfg = local
    model.tp_mesh = mesh
    return model


def whole_state_dict(model, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The model's parameters whole, detached, on the CPU, under the whole
    model's names: the ``tp_axis`` ones gathered over the tp ranks (a
    collective: every rank calls it, rank 0 writes the files)."""
    out = {}
    for name, p in model.state_dict(keep_vars=True).items():
        axis = getattr(p, "tp_axis", None)
        t = p.detach()
        if axis is not None and mesh is not None and mesh.tp > 1:
            src = t.contiguous()
            parts = [torch.empty_like(src) for _ in range(mesh.tp)]
            all_gather_into(parts, src, mesh.group)
            t = torch.cat(parts, axis)
        out[name] = t.cpu()
    return out
