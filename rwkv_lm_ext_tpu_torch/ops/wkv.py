"""Unfused WKV: kernel B.8 (csrc/wkv.cu), its backward (the GroupNorm-free
variant of B.6 plus B.7, csrc/wkv_fused_bwd.cu), the bidirectional op built
on it, and their plain versions.

Counterpart of rwkv_lm_ext_tpu/ops/wkv.py (``wkv`` :48, ``_flip_valid_prefix``
:123, ``wkv6_bi`` :139) and of the "pallas" backend behind it,
ops/wkv_pallas.py: ``wkv_pallas`` (:667, the Pallas kernel ``_wkv_kernel`` at
:440) with its custom_vjp (``_bwd`` :587, which runs ``_fused_bwd_pallas``
with ``gn=False``).

``wkv`` returns the raw fp32 y and the final state; the bidirectional
encoders (models/bidirectional.py) are its callers. B.8 has two bodies
(csrc/wkv.cu), and ``wkv_body`` picks one by K1's rule, from dtype and head
size alone: bf16 at N of 32 or 64 runs K1's chunk factoring on the tensor
cores (``chunk_walk`` in its raw mode; ``wkv_chunked_plain`` is that
factoring in plain PyTorch), fp32 and N = 16 the sequential recurrence. Both
are exact at any decay, so ``wkv`` has no ``backend``, ``chunk_size``,
``exact`` or ``remat`` arguments (see ops/wkv_fused.py); ``body=`` forces one
for the card checks. Its backward runs the body of ``wkv_bwd_body``
(``wkv_bwd_chunked_plain`` mirrors the chunked one). It raises for a head
size outside ops/wkv_fused.HEAD_SIZES; the
JAX package zero-pads other head sizes up to one its kernels tile
(``pad_target``), which is a rule of that tiling.

``reverse`` scans from the last step down, as the JAX ``wkv`` does through
``wkv_reference``. ``lengths`` ((B,) int) is the port's own: the scan covers
only each row's first ``lengths[b]`` steps, in either direction, y is zero
beyond them and the final state is the state after them. With it
``wkv6_bi``'s reverse pass is one launch over the inputs as they lie, where
the JAX package gathers r, k, v and w into reversed copies and gathers y back
(``wkv6_bi_plain`` is that composition).

On a CUDA tensor ``wkv`` is a ``torch.autograd.Function`` when grad mode is
on and an input requires grad, and a direct launch otherwise. The initial
state may be (B, H, N, N) or (H, N, N) shared by every sequence.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    CHUNKED_HEAD_SIZES,
    BwdCarry,
    _bwd_pass1_body,
    _entry_states,
    _wkv_bwd_chunked,
    _wkv_chunked,
    check_head_size,
    k1_body,
    wkv6_bwd_reverse_pass,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_reference

# B.8's bodies, by the codes of csrc/wkv.cu
WKV_BODIES = {"sequential": 0, "chunked": 1}


def wkv_body(dtype: torch.dtype, N: int) -> str:
    """The body of B.8 that a call on r, k, v of this dtype and head size
    launches: K1's rule, bf16 at N of 32 or 64 the chunked one."""
    return k1_body(dtype, N)


def _flip_valid_prefix(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's first ``lengths[b]`` steps and keep the tail.
    x: (B, T, ...), lengths: (B,) int. A gather, so it is differentiable."""
    B, T = x.shape[:2]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(torch.int64)[:, None]
    idx = torch.where(t < L, L - 1 - t, t).reshape((B, T) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(x.shape))


def _valid(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T, 1, 1) bool: step t lies inside row b's prefix."""
    return (torch.arange(T, device=lengths.device)[None, :] < lengths[:, None])[..., None, None]


def wkv_plain(
    r, k, v, w, u, initial_state=None, *, reverse: bool = False,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv`` from ``wkv_reference`` alone. With ``lengths`` the scan is
    held to the prefix by zero k and v and a decay of one (w = -inf) beyond
    it, and a reverse scan is the causal one over the flipped prefix."""
    B, T, H, N = r.shape
    if initial_state is not None and initial_state.dim() == 3:
        initial_state = initial_state.expand(B, H, N, N)
    if lengths is None:
        return wkv_reference(r, k, v, w, u, initial_state, reverse=reverse)
    valid = _valid(lengths, T)
    k, v = k * valid, v * valid
    w = w.float().masked_fill(~valid, float("-inf"))
    if reverse:
        r, k, v, w = (_flip_valid_prefix(t, lengths) for t in (r, k, v, w))
    y, sT = wkv_reference(r, k, v, w, u, initial_state)
    if reverse:
        y = _flip_valid_prefix(y, lengths)
    return y * valid, sT


def wkv_bwd_plain(
    r, k, v, w, u, initial_state, dy, dsT, *, reverse: bool = False,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """(dr, dk, dv, dw, du, ds0) of ``wkv_plain`` by torch.autograd.grad, for
    the cotangents dy (of y) and dsT (of the final state); None for either
    is zeros. du is None when u is, ds0 when initial_state is."""
    with torch.enable_grad():
        named = dict(r=r, k=k, v=v, w=w, u=u, s0=initial_state)
        leaves = {n: t.detach().requires_grad_() for n, t in named.items() if t is not None}
        y, sT = wkv_plain(*(leaves.get(n) for n in named), reverse=reverse, lengths=lengths)
        pairs = [(o, ct) for o, ct in ((y, dy), (sT, dsT)) if ct is not None]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], list(leaves.values()), [ct for _, ct in pairs],
            allow_unused=True,
        ) if pairs else [None] * len(leaves)
    out = {n: torch.zeros_like(t) if gr is None else gr
           for (n, t), gr in zip(leaves.items(), grads)}
    return tuple(out.get(n) for n in named)


def _walk_steps(x, lengths, reverse, dtype):
    """(B, T, H, N) by time -> (B, H, T, N) by step of each row's walk (step
    s is time s, or lengths[b] - 1 - s in reverse), zero beyond the prefix."""
    x = x.to(dtype) * _valid(lengths, x.shape[1])
    return (_flip_valid_prefix(x, lengths) if reverse else x).permute(0, 2, 1, 3)


def _walk_times(x, lengths, reverse):
    """The inverse of _walk_steps, in fp32, zero beyond the prefix."""
    x = x.permute(0, 2, 1, 3)
    return ((_flip_valid_prefix(x, lengths) if reverse else x) * _valid(lengths, x.shape[1])).float()


def _walk_lengths(lengths, B, T, device):
    full = torch.full((B,), T, dtype=torch.int64, device=device)
    return full if lengths is None else lengths.to(torch.int64).clamp(0, T)


def wkv_chunked_plain(
    r, k, v, w, u, initial_state=None, *, reverse: bool = False,
    lengths: Optional[torch.Tensor] = None, chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv_plain`` by the factoring of B.8's chunked body: the walk over
    each row's valid prefix as the kernel takes it, then ops/wkv_fused.
    _wkv_chunked (K1's factoring without the GroupNorm), in fp32, any chunk
    length. The same (y, final state); y is zero beyond the prefix. For the
    tests and the card checks; no model path calls it."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, not {chunk}")
    B, T, H, N = r.shape
    f32 = torch.float32
    lengths = _walk_lengths(lengths, B, T, r.device)
    uf = torch.zeros(H, N, dtype=f32, device=r.device) if u is None else u.to(f32)
    S = (torch.zeros(B, H, N, N, dtype=f32, device=r.device) if initial_state is None
         else initial_state.to(f32).expand(B, H, N, N))
    steps = [_walk_steps(x, lengths, reverse, f32) for x in (r, k, v)]
    d = _walk_steps(-torch.exp(w.to(f32)), lengths, reverse, f32)
    y, S, _ = _wkv_chunked(*steps, d, uf, S, chunk)
    return _walk_times(y, lengths, reverse), S.contiguous()


def wkv_bwd_chunked_plain(
    r, k, v, w, u, initial_state, dy, dsT, *, reverse: bool = False,
    lengths: Optional[torch.Tensor] = None, chunk: int = 16,
) -> Tuple[Optional[torch.Tensor], ...]:
    """``wkv_bwd_plain`` by the factoring of the chunked bodies of its two
    passes (csrc/wkv_fused_bwd.cu with gn=False), in fp64, any chunk length:
    the walk over each row's valid prefix as the kernels take it (step s is
    time s, or lengths[b] - 1 - s in reverse; the steps beyond the prefix
    carry d = 0 and zero operands), then ops/wkv_fused._wkv_bwd_chunked. The
    same tuple, in fp32; zero gradients beyond the prefix. For the tests and
    the card checks; no model path calls it."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, not {chunk}")
    B, T, H, N = r.shape
    f64 = torch.float64
    lengths = _walk_lengths(lengths, B, T, r.device)
    steps = functools.partial(_walk_steps, lengths=lengths, reverse=reverse, dtype=f64)
    times = functools.partial(_walk_times, lengths=lengths, reverse=reverse)
    zeros = torch.zeros(B, T, H, N, dtype=f64, device=r.device)
    d = -torch.exp(w.to(f64))
    uf = torch.zeros(H, N, dtype=f64, device=r.device) if u is None else u.to(f64)
    s0 = (torch.zeros(B, H, N, N, dtype=f64, device=r.device) if initial_state is None
          else initial_state.to(f64).expand(B, H, N, N))
    dST = torch.zeros_like(s0) if dsT is None else dsT.to(f64)
    dr, dk, dv, dd, du, ds0 = _wkv_bwd_chunked(
        steps(r), steps(k), steps(v), steps(d), uf, steps(zeros if dy is None else dy), s0, dST,
        chunk)
    if initial_state is None:
        ds0 = None
    elif initial_state.dim() == 3:
        ds0 = ds0.sum(0)
    return (times(dr), times(dk), times(dv), times(dd) * d.float(),
            None if u is None else du.float(), None if ds0 is None else ds0.float())


def _prepare(r, k, v, w, u, initial_state, lengths):
    """Check the inputs of the CUDA route and cast them as the kernels take
    them: w, u and the (B, H, N, N) initial state in fp32, lengths in int32.
    Returns (w, u, s0, lengths); u, s0 and lengths stay None."""
    B, T, H, N = r.shape
    check_head_size(N, "the WKV kernel")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    if u is not None:
        if u.shape != (H, N):
            raise ValueError(f"u must be {(H, N)}")
        u = u.float().contiguous()
    if initial_state is None:
        s0 = None
    elif initial_state.shape == (B, H, N, N):
        s0 = initial_state.float().contiguous()
    elif initial_state.shape == (H, N, N):
        s0 = initial_state.float().expand(B, H, N, N).contiguous()
    else:
        raise ValueError(f"initial_state must be {(B, H, N, N)} or {(H, N, N)}")
    if lengths is not None:
        if lengths.shape != (B,) or lengths.dtype.is_floating_point:
            raise ValueError(f"lengths must be {(B,)} integers")
        if lengths.device != r.device:
            raise ValueError(f"lengths is on {lengths.device}, r on {r.device}")
        lengths = lengths.to(torch.int32).contiguous()
    return w.float().contiguous(), u, s0, lengths


def _optional(**tensors):
    return {n: t for n, t in tensors.items() if t is not None}


def _launch_wkv(r, k, v, w, u, s0, lengths, reverse, body=None):
    B, T, H, N = r.shape
    body = body or wkv_body(r.dtype, N)
    if body == "chunked" and wkv_body(r.dtype, N) != body:
        raise ValueError(f"B.8's chunked body takes bf16 and N in {CHUNKED_HEAD_SIZES}, "
                         f"not {r.dtype}, N={N}")
    device = _lib.check_cuda(r=r, k=k, v=v, w=w, **_optional(u=u, s0=s0))
    y = torch.empty(B, T, H, N, dtype=torch.float32, device=device)
    sT = torch.empty(B, H, N, N, dtype=torch.float32, device=device)
    _lib.launch(
        "rwkv_wkv6", device, r, k, v, w, u, s0, lengths, y, sT, B, T, H, N,
        int(reverse), _lib.DTYPE_CODES[r.dtype], WKV_BODIES[body],
    )
    wkv.launches += 1
    return y, sT


def wkv_bwd_state_pass(k, v, w, s0, dy, dsT, *, lengths=None, reverse=False, body=None):
    """Pass 1 of B.8's backward, the variant of B.6 without GroupNorm and
    gate: the forward state again over each row's walk. Takes the kernels'
    argument types (see _prepare; s0, dsT and lengths may be None; dy
    (B, T, H, N) fp32). Returns the BwdCarry for pass 2: sequential, dr'
    (fp64, defined on the steps the walk takes) and c_T, from dy and dsT;
    chunked, the chunk-entry states, which need neither. ``body`` overrides
    wkv_bwd_body's choice (for the card checks)."""
    B, T, H, N = k.shape
    body = _bwd_pass1_body(k, body)
    device = _lib.check_cuda(k=k, v=v, w=w, dy=dy, **_optional(s0=s0, dsT=dsT))
    if body == "chunked":
        carry = BwdCarry(body, states=_entry_states(B, T, H, N, device))
        _lib.launch("rwkv_wkv6_bwd_state_chunked", device, k, v, w, s0, lengths, carry.states,
                    B, T, H, N, int(reverse))
    else:
        carry = BwdCarry(body, drp=torch.empty(B, T, H, N, dtype=torch.float64, device=device),
                         cT=torch.empty(B, H, N, dtype=torch.float64, device=device))
        _lib.launch(
            "rwkv_wkv6_bwd_state", device, k, v, w, s0, dy, dsT, lengths, carry.drp, carry.cT,
            B, T, H, N, int(reverse), _lib.DTYPE_CODES[k.dtype],
        )
    wkv_bwd_state_pass.launches += 1
    return carry


def wkv_bwd(
    r, k, v, w, u, initial_state, dy, dsT, *, reverse: bool = False,
    lengths: Optional[torch.Tensor] = None, body: Optional[str] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of ``wkv``: the tuple of ``wkv_bwd_plain``, dr, dk, dv in
    the inputs' dtype and dw, du, ds0 in fp32. CPU tensors take the plain
    version; CUDA tensors launch the two passes (the body of wkv_bwd_body, or
    ``body``) and reduce the per-(b, h) partials in a fixed order, so two
    calls give the same bits."""
    if r.device.type == "cpu":
        return wkv_bwd_plain(r, k, v, w, u, initial_state, dy, dsT,
                             reverse=reverse, lengths=lengths)
    B, T, H, N = r.shape
    w32, u32, s0, lengths = _prepare(r, k, v, w, u, initial_state, lengths)
    if dy is None:
        dy = torch.zeros(B, T, H, N, dtype=torch.float32, device=r.device)
    elif dy.shape != (B, T, H, N):
        raise ValueError(f"dy must be {(B, T, H, N)}")
    dy = dy.float().contiguous()
    if dsT is not None:
        if dsT.shape != (B, H, N, N):
            raise ValueError(f"dsT must be {(B, H, N, N)}")
        dsT = dsT.float().contiguous()
    carry = wkv_bwd_state_pass(k, v, w32, s0, dy, dsT, lengths=lengths, reverse=reverse,
                               body=body)
    dr, dk, dv, dw, du_p, ds0 = wkv6_bwd_reverse_pass(
        r, k, v, w32, u32, dy, carry, dsT, lengths=lengths, reverse=reverse)
    if initial_state is None:
        ds0 = None
    elif initial_state.dim() == 3:
        ds0 = _lib.sum_partials(ds0)
    return dr, dk, dv, dw, None if u is None else _lib.sum_partials(du_p), ds0


class _Wkv(torch.autograd.Function):
    """B.8 forward, two-pass backward. Saves only the primal inputs, as
    ``_fwd`` does (wkv_pallas.py:579-584)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, initial_state, lengths, reverse, body):
        ctx.set_materialize_grads(False)
        ctx.reverse = reverse
        ctx.save_for_backward(r, k, v, w, u, initial_state, lengths)
        return _launch_wkv(r, k, v, *_prepare(r, k, v, w, u, initial_state, lengths), reverse,
                           body)

    @staticmethod
    def backward(ctx, dy, dsT):
        *primals, lengths = ctx.saved_tensors
        if dy is None and dsT is None:
            return (None,) * 9
        grads = wkv_bwd(*primals, dy, dsT, reverse=ctx.reverse, lengths=lengths)
        return tuple(
            gr.to(t.dtype) if need and gr is not None else None
            for gr, t, need in zip(grads, primals, ctx.needs_input_grad)
        ) + (None, None, None)


def wkv(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: Optional[torch.Tensor],
    initial_state: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
    lengths: Optional[torch.Tensor] = None,
    body: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, T, H, N), one dtype; w: (B, T, H, N) log-decay (run in
    fp32); u: (H, N) or None; initial_state: (B, H, N, N) or (H, N, N) fp32,
    or None. Returns y (B, T, H, N) fp32 and the final state (B, H, N, N)
    fp32. CPU tensors take the plain version; CUDA tensors launch B.8 (the
    body of wkv_body, or ``body``, a key of WKV_BODIES: the card checks time
    one beside the other; no caller in the package sets it), for any T and N
    in HEAD_SIZES, differentiable through its two-pass backward when an
    input requires grad."""
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, initial_state, reverse=reverse, lengths=lengths)
    if _lib.needs_grad(r, k, v, w, u, initial_state):
        return _Wkv.apply(r, k, v, w, u, initial_state, lengths, reverse, body)
    return _launch_wkv(r, k, v, *_prepare(r, k, v, w, u, initial_state, lengths), reverse, body)


def wkv6_bi(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional WKV: the causal pass with the bonus u over all T steps,
    plus the reverse pass without a bonus over each row's valid prefix
    (``lengths``; None = all T). Beyond the prefix only the causal pass
    contributes. Returns y (B, T, H, N) fp32. Two ``wkv`` calls."""
    y_fwd, _ = wkv(r, k, v, w, u)
    y_rev, _ = wkv(r, k, v, w, None, reverse=True, lengths=lengths)
    return y_fwd + y_rev


def wkv6_bi_plain(r, k, v, w, u, lengths=None) -> torch.Tensor:
    """``wkv6_bi`` as the JAX package composes it (ops/wkv.py:160-191): flip
    the valid prefix of r, k, v, w (k and v zeroed beyond it), run the causal
    scan, flip y back and mask it."""
    T = r.shape[1]
    y_fwd, _ = wkv_reference(r, k, v, w, u)
    if lengths is None:
        y_rev, _ = wkv_reference(*(t.flip(1) for t in (r, k, v, w)), None)
        return y_fwd + y_rev.flip(1)
    valid = _valid(lengths, T)
    vmask = valid.to(r.dtype)
    flipped = (_flip_valid_prefix(t, lengths) for t in (r, k * vmask, v * vmask, w))
    y_rev, _ = wkv_reference(*flipped, None)
    return y_fwd + _flip_valid_prefix(y_rev, lengths) * valid


wkv.launches = 0
wkv_bwd_state_pass.launches = 0
