"""Sequence parallelism: the time axis cut over the ranks of a group.

Counterpart of rwkv_lm_ext_tpu/parallel/sequence.py: ``_local_wkv_with_decay``
(:34), ``wkv6_sequence_parallel`` (:55), ``_sp_wkv_local`` (:111) and
``rwkv_forward_sequence_parallel`` (:130). The WKV state update composes
associatively over segments: a segment maps an incoming state S_in to
D_s ⊙_K S_in + S_s (D_s its total per-key decay, S_s its scan from a zero
state), so each rank scans its own shard from zero (ops/wkv_chunked.py:
B.8 on the card), the ranks all-gather their (S_s, D_s), every rank runs the
exclusive prefix-combine over the n shards and adds the incoming state's
share to its outputs, y_t += (r_t ⊙ e^{Wexc_t within the shard}) @ S_prefix.
Only (B, H, N, N) states and (B, C) token-shift rows cross ranks, never the
O(T) activations.

JAX shards one global array over a ``Mesh(devs, ("sp",))``; the port has no
global arrays: each rank is a process of its own (parallel/distributed.py)
and passes its own T-shard, rank r the r-th of the sp consecutive shards.
``make_sp_mesh(sp)`` is the stand-in for the mesh: an ``SpMesh`` holding the
group (consecutive blocks of ``sp`` ranks over every process), its size and
this rank within it. The shards must all be of one length (T divisible by
sp); the public functions check it with one small collective and refuse
otherwise by name.

The collectives are the differentiable ones of parallel/distributed.py:
``all_gather_autograd`` for the states and decays (its backward sums each
rank's slice over the ranks, as the transpose of ``lax.all_gather``: each
rank's prefix depends on every earlier rank's state) and ``ppermute_next``
for the token-shift boundary, the previous shard's last row of ln1's (and
ln2's) output, zero on rank 0. Differentiable end to end: B.8's backward
(B.6 with ``gn=False``, B.7) and the two collectives' backwards; the caller
sums the parameters' gradients over the group (each rank's loss term covers
its own shard). Every rank must make the same calls in the same order,
forward and backward (the module docstring of parallel/distributed.py).

The final WKV state that ``wkv6_sequence_parallel`` returns is the same on
every rank (the same gathered values, combined in the same order); JAX
averages it over the axis (``pmean``) to make that provable. A loss that
reads it should read it on one rank only: the backward sums over the ranks.

``rwkv_forward_sequence_parallel`` runs what JAX's runs: the RWKV-6 block
with ``tmix_v6_projections`` (here ``TimeMix.projections``, plain torch ops
as in JAX) after ln1 on K3, the sp WKV, ``TimeMix.gn_output``, ln2 on K3 and
the channel mix, then ln_out and the head. JAX's function raises on RWKV-5
or RWKV-4 weights and silently ignores ``head_qk``, tiny attention,
``my_pos_emb``, ``pre_ffn`` and the MishGLU channel mix; the port refuses all
of them by name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm
from rwkv_lm_ext_tpu_torch.ops.wkv_chunked import wkv_chunked
from rwkv_lm_ext_tpu_torch.parallel.distributed import (
    all_gather_autograd,
    all_gather_into,
    collective_device,
    new_groups,
    ppermute_next,
    process_count,
    process_index,
)


@dataclasses.dataclass(frozen=True)
class SpMesh:
    """This rank's sequence-parallel group: ``sp`` ranks, this one's
    ``rank`` within them (its shard's index), the torch.distributed
    ``group`` (None alone in a process)."""

    sp: int
    rank: int
    group: object = None


def make_sp_mesh(sp: Optional[int] = None) -> SpMesh:
    """The sp group of this process: consecutive blocks of ``sp`` ranks over
    every process (``sp`` defaults to all of them). Every process must call
    it, in the same order as its other group calls."""
    world = process_count()
    sp = sp or world
    if sp < 1 or world % sp:
        raise ValueError(f"make_sp_mesh: sp={sp} must divide the number of processes ({world})")
    if sp == 1:
        return SpMesh(sp=1, rank=0)
    group = new_groups([list(range(i, i + sp)) for i in range(0, world, sp)])
    return SpMesh(sp=sp, rank=process_index() % sp, group=group)


def _check_shards(shape, mesh: SpMesh, what: str) -> None:
    """Raise by name unless every rank of the group holds a shard of the
    same shape: the global T must divide by sp."""
    if mesh.sp == 1:
        return
    mine = torch.tensor(list(shape), dtype=torch.int64, device=collective_device())
    parts = [torch.empty_like(mine) for _ in range(mesh.sp)]
    all_gather_into(parts, mine, mesh.group)
    shapes = [tuple(p.tolist()) for p in parts]
    if len(set(shapes)) > 1:
        raise ValueError(f"{what}: every rank of the sp group must hold a shard of the same "
                         f"shape (the sequence's T must divide by sp={mesh.sp}); the ranks hold "
                         f"{shapes}")


def _local_wkv_with_decay(r, k, v, w, u, chunk_size: int):
    """The shard's scan from a zero state and what the cross-shard
    correction needs: (y_local, s_local, q_scaled = r ⊙ e^{Wexc}, d_total =
    e^{Winc[-1]}), all fp32. q_scaled underflows to 0 where the true
    contribution does (a long shard of strong decay): that is exact."""
    y_local, s_local = wkv_chunked(r, k, v, w, u, None, chunk_size=chunk_size, remat=True)
    lw = -torch.exp(w.float())
    winc = torch.cumsum(lw, 1)
    wexc = winc - lw
    return y_local, s_local, r.float() * torch.exp(wexc), torch.exp(winc[:, -1])


def _sp_combine(r, k, v, w, u, mesh: SpMesh, chunk_size: int):
    """The local scan, the gathered (state, decay) of every shard and JAX's
    exclusive prefix-combine: (y of this shard, the final state)."""
    y_local, s_local, q_scaled, d_total = _local_wkv_with_decay(r, k, v, w, u, chunk_size)
    states = all_gather_autograd(s_local, mesh.group)          # (n, B, H, N, N)
    decays = all_gather_autograd(d_total, mesh.group)          # (n, B, H, N)
    # S_prefix(idx) = sum_{s<idx} (prod_{s<q<idx} D_q) ⊙_K S_s; the zero is
    # taken from the gathered states so that every rank's graph reaches the
    # gather (rank 0's prefix reads none of them)
    carry = states[0] * 0.0
    before = []
    for i in range(states.shape[0]):
        before.append(carry)
        carry = decays[i][..., None] * carry + states[i]
    s_prefix = torch.stack(before)[mesh.rank]
    return y_local + torch.einsum("bthn,bhnm->bthm", q_scaled, s_prefix), carry


def _sp_wkv_local(r, k, v, w, u, mesh: SpMesh) -> torch.Tensor:
    """The sp WKV of one shard inside the model forward (JAX :111-127): y
    only, chunk 32."""
    return _sp_combine(r, k, v, w, u, mesh, 32)[0]


def wkv6_sequence_parallel(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor, *,
    mesh: SpMesh, chunk_size: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The time-sharded WKV: r, k, v, w (B, T_local, H, N), this rank's
    shard of T; u (H, N). Returns (y (B, T_local, H, N) fp32, the final
    state (B, H, N, N) fp32, the same on every rank). ``chunk_size`` goes to
    the local scan's plain version (B.8 on the card picks its own)."""
    _check_shards(r.shape, mesh, "wkv6_sequence_parallel")
    return _sp_combine(r, k, v, w, u, mesh, chunk_size)


def sp_refusal(cfg) -> Optional[str]:
    """Why ``rwkv_forward_sequence_parallel`` cannot run this model, or
    None: it runs the RWKV-6 block without the legacy options (the module
    docstring)."""
    if cfg.version < 6:
        return (f"sequence parallelism runs the RWKV-6 time mix only (JAX's "
                f"rwkv_forward_sequence_parallel runs tmix_v6_projections): not an "
                f"RWKV-{cfg.version:g} model")
    if cfg.legacy_options:
        return (f"sequence parallelism runs the plain RWKV-6 block: {', '.join(cfg.legacy_options)} "
                "would be ignored on the sharded time axis (JAX's function ignores them "
                "silently)")
    return None


def rwkv_forward_sequence_parallel(model, tokens_local: torch.Tensor, *, mesh: SpMesh,
                                   return_hidden: bool = False) -> torch.Tensor:
    """The model's forward with the time axis cut over the sp group:
    ``tokens_local`` (B, T_local) is this rank's shard. Returns this shard's
    logits (B, T_local, V) in the compute dtype, or the hidden states after
    ln_out with ``return_hidden``. Causal only, from a zero state, no state
    out (as JAX's)."""
    cfg = model.cfg
    why = sp_refusal(cfg)
    if why:
        raise ValueError(why)
    _check_shards(tokens_local.shape, mesh, "rwkv_forward_sequence_parallel")
    from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS

    B, Tl = tokens_local.shape
    H, N = cfg.n_head, cfg.head_size
    # rank 0's boundary row is zero; the product keeps it in the graph, so its
    # backward joins the other ranks'
    keep = 0.0 if mesh.rank == 0 else 1.0

    def boundary(x):
        """The previous shard's last row of x (zero on rank 0)."""
        return ppermute_next(x[:, -1].contiguous(), mesh.group) * keep

    x = model.embed(tokens_local)
    for block in model.blocks:
        if block.ln0 is not None:
            x = layer_norm(x, block.ln0.weight, block.ln0.bias)
        xa = layer_norm(x, block.ln1.weight, block.ln1.bias)
        att = block.att
        r, k, v, g, w = att.projections(xa, boundary(xa))
        heads = (B, Tl, H, N)
        y = _sp_wkv_local(r.view(heads), k.view(heads), v.view(heads), w.view(heads),
                          att.time_faaaa, mesh)
        x = x + att.gn_output(y.reshape(B, Tl, -1), g)
        xf = layer_norm(x, block.ln2.weight, block.ln2.bias)
        ffn_out, _ = block.ffn(xf, boundary(xf), KERNEL_OPS)
        x = x + ffn_out
    x = layer_norm(x, model.ln_out.weight, model.ln_out.bias)
    if return_hidden:
        return x
    return model.head(x, KERNEL_OPS)
