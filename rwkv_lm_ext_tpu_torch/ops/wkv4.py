"""RWKV-4's log-space WKV: kernel B.14 (csrc/wkv4.cu), its backward kernel,
and their plain versions.

Counterpart of rwkv_lm_ext_tpu/ops/wkv4.py: ``wkv4`` (:23-62), which the JAX
package runs as an XLA ``lax.scan`` and not as a Pallas kernel, and trains
through XLA's autodiff of that scan. The port needs kernels all the same: a
PyTorch loop over T launches about fifteen operations a token and a layer,
and autograd through it about thirty more. ``wkv4_plain`` is that loop, the
scan's body in the same order of operations; the tests and the on-card
comparison use it, and autograd through it is the plain version of the
backward kernel. ``wkv4_parallel`` (:65-131) is JAX's associative-scan
form of the same recurrence, a log-depth inclusive scan (Hillis-Steele over
T) in plain PyTorch ops: in the JAX package too it is an XLA function and
not a Pallas kernel, and no model path calls it there or here.

The state is (aa, bb, pp), each (B, C) fp32; a fresh sequence starts at aa =
bb = 0 and pp = -1e38 (``init_wkv4_state``). ``out_state`` may be the input
state itself: the kernel then updates it in place, which the decode step
does. Under grad (an input requires grad and grad mode is on) a CUDA call
goes through ``_Wkv4Function``: the forward kernel also saves the state at
every chunk's entry, and the backward kernel (``wkv4_bwd``) takes the
gradients of y and of the final state and returns those of k, v, w, u and
the initial state, which TBPTT carries from chunk to chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

Wkv4State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

PP_START = -1e38
# steps between two saved states (kWkv4Chunk of csrc/wkv4.cu)
CHUNK = 16


def init_wkv4_state(B: int, C: int, device) -> Wkv4State:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(B, C, **f32), torch.zeros(B, C, **f32),
            torch.full((B, C), PP_START, **f32))


def _state_step(aa, bb, pp, kt, vt, wf):
    """The state update of one step (the scan body's second half)."""
    ww = pp + wf
    p = torch.maximum(ww, kt)
    e1 = torch.exp(ww - p)
    e2 = torch.exp(kt - p)
    return e1 * aa + e2 * vt, e1 * bb + e2, p


def wkv4_plain(
    k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    state: Optional[Wkv4State] = None, *, out_state: Optional[Wkv4State] = None,
) -> Tuple[torch.Tensor, Wkv4State]:
    """The recurrence of ``wkv4`` (ops/wkv4.py:45-56) as a torch loop over T."""
    B, T, C = k.shape
    kf, vf = k.float(), v.float()
    wf, uf = w.float(), u.float()
    if state is None:
        state = init_wkv4_state(B, C, k.device)
    aa, bb, pp = (s.float() for s in state)
    ys = []
    for t in range(T):
        kt, vt = kf[:, t], vf[:, t]
        ww = uf + kt
        p = torch.maximum(pp, ww)
        e1 = torch.exp(pp - p)
        e2 = torch.exp(ww - p)
        ys.append((e1 * aa + e2 * vt) / (e1 * bb + e2))
        aa, bb, pp = _state_step(aa, bb, pp, kt, vt, wf)
    y = torch.stack(ys, 1) if ys else torch.zeros(B, 0, C, dtype=torch.float32, device=k.device)
    if out_state is None:
        return y, (aa, bb, pp)
    for dst, src in zip(out_state, (aa, bb, pp)):
        dst.copy_(src)
    return y, out_state


def _check(k, v, w, u, *states):
    """Raise unless v matches k and w, u and every (aa, bb, pp) triple in
    ``states`` have the shapes and dtypes B.14 takes."""
    B, T, C = k.shape
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"v is {tuple(v.shape)} {v.dtype}, k {tuple(k.shape)} {k.dtype}")
    if w.shape != (C,) or u.shape != (C,):
        raise ValueError(f"w and u must be ({C},), got {tuple(w.shape)}, {tuple(u.shape)}")
    for triple in states:
        for name, s in zip(("aa", "bb", "pp"), triple):
            if s.shape != (B, C) or s.dtype != torch.float32:
                raise ValueError(f"{name} must be ({B}, {C}) fp32, got {tuple(s.shape)} {s.dtype}")


def _launch_forward(k, v, w, u, state, out_state, ck=None):
    """B.14 on CUDA tensors: y (B, T, C) fp32; the final state into
    ``out_state``; with ``ck`` ((3, B, ceil(T / CHUNK), C) fp32) also the
    chunk-entry states."""
    B, T, C = k.shape
    aa, bb, pp = state
    ao, bo, po = out_state
    extra = {} if ck is None else {"ck": ck}
    device = _lib.check_cuda(k=k, v=v, w=w, u=u, aa=aa, bb=bb, pp=pp, aa_out=ao, bb_out=bo,
                             pp_out=po, **extra)
    y = torch.empty(B, T, C, dtype=torch.float32, device=device)
    _lib.launch("rwkv_wkv4", device, k, v, w, u, aa, bb, pp, y, ao, bo, po, ck, B, T, C,
                _lib.DTYPE_CODES[k.dtype])
    wkv4.launches += 1
    return y


def wkv4_bwd(k, v, w, u, ck, gy, g_state=None):
    """The backward kernel on CUDA tensors: k, v (B, T, C) in one dtype, w, u
    (C,) fp32, ck the forward's chunk-entry states, gy (B, T, C) fp32 and the
    final state's gradient (a triple, any entry None for zeros). Returns
    (dk, dv in k's dtype, dw, du (C,) fp32, (daa, dbb, dpp) (B, C) fp32). The
    dw and du partials are added over B in a fixed order, part of this call."""
    B, T, C = k.shape
    f32 = dict(dtype=torch.float32, device=k.device)
    g_state = (None, None, None) if g_state is None else tuple(
        None if g is None else g.float().contiguous() for g in g_state)
    gy = gy.float().contiguous()
    n_ck = (T + CHUNK - 1) // CHUNK
    if ck.shape != (3, B, n_ck, C):
        raise ValueError(f"ck must be (3, {B}, {n_ck}, {C}), got {tuple(ck.shape)}")
    named = {"gaa_T": g_state[0], "gbb_T": g_state[1], "gpp_T": g_state[2]}
    device = _lib.check_cuda(k=k, v=v, w=w, u=u, ck=ck, gy=gy,
                             **{n: g for n, g in named.items() if g is not None})
    gk, gv = torch.empty_like(k), torch.empty_like(v)
    gw_p, gu_p = torch.empty(B, C, **f32), torch.empty(B, C, **f32)
    g0 = tuple(torch.empty(B, C, **f32) for _ in range(3))
    _lib.launch("rwkv_wkv4_bwd", device, k, v, w, u, ck, gy, *g_state, gk, gv, gw_p, gu_p, *g0,
                B, T, C, _lib.DTYPE_CODES[k.dtype])
    wkv4_bwd.launches += 1
    return gk, gv, _lib.sum_partials(gw_p), _lib.sum_partials(gu_p), g0


wkv4_bwd.launches = 0


class _Wkv4Function(torch.autograd.Function):
    """B.14 under autograd: the forward saves the chunk-entry states, the
    backward is ``wkv4_bwd``."""

    @staticmethod
    def forward(ctx, k, v, w, u, aa, bb, pp):
        B, T, C = k.shape
        f32 = dict(dtype=torch.float32, device=k.device)
        ck = torch.empty(3, B, (T + CHUNK - 1) // CHUNK, C, **f32)
        out_state = tuple(torch.empty(B, C, **f32) for _ in range(3))
        y = _launch_forward(k, v, w, u, (aa, bb, pp), out_state, ck)
        ctx.save_for_backward(k, v, w, u, ck)
        ctx.set_materialize_grads(False)
        return (y,) + out_state

    @staticmethod
    def backward(ctx, gy, gaa, gbb, gpp):
        k, v, w, u, ck = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        gk, gv, gw, gu, (g_aa, g_bb, g_pp) = wkv4_bwd(k, v, w, u, ck, gy, (gaa, gbb, gpp))
        return gk, gv, gw, gu, g_aa, g_bb, g_pp


def wkv4(
    k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    state: Optional[Wkv4State] = None, *, out_state: Optional[Wkv4State] = None,
) -> Tuple[torch.Tensor, Wkv4State]:
    """k, v: (B, T, C) in one dtype; w (the decay, <= 0) and u: (C,), run in
    fp32; state: (aa, bb, pp) each (B, C) fp32, or None for a fresh one.
    Returns y (B, T, C) fp32 and the final state, written into ``out_state``
    when given (it may be ``state``: the update is then in place). CPU
    tensors take the plain version (autograd differentiates it); CUDA tensors
    launch B.14, and under grad its autograd Function (no ``out_state``
    then: the new state is a result of the graph)."""
    if k.device.type == "cpu":
        return wkv4_plain(k, v, w, u, state, out_state=out_state)
    B, T, C = k.shape
    if state is None:
        state = init_wkv4_state(B, C, k.device)
    w, u = w.float().contiguous(), u.float().contiguous()
    if _lib.needs_grad(k, v, w, u, *state):
        if out_state is not None:
            raise ValueError("wkv4 under grad returns a new state: out_state is for inference")
        _check(k, v, w, u, state)
        y, aa, bb, pp = _Wkv4Function.apply(k.contiguous(), v.contiguous(), w, u,
                                            *(s.contiguous() for s in state))
        return y, (aa, bb, pp)
    if out_state is None:
        out_state = tuple(torch.empty(B, C, dtype=torch.float32, device=k.device)
                          for _ in range(3))
    _check(k, v, w, u, state, out_state)
    return _launch_forward(k, v, w, u, state, out_state), out_state


wkv4.launches = 0


def _combine(x, y, wf):
    """JAX's ``comb``: segment ``x`` (p, a, b, n) followed by segment ``y``;
    the earlier one decays by y's length times w, then the two merge in
    logsumexp form."""
    xp, xa, xb, xn = x
    yp, ya, yb, yn = y
    xp = xp + yn * wf
    m = torch.maximum(xp, yp)
    e1 = torch.exp(xp - m)
    e2 = torch.exp(yp - m)
    return m, e1 * xa + e2 * ya, e1 * xb + e2 * yb, xn + yn


def wkv4_parallel(
    k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    initial_state: Optional[Wkv4State] = None,
) -> Tuple[torch.Tensor, Wkv4State]:
    """``wkv4`` as a log-space associative scan (JAX ops/wkv4.py:65-131): k,
    v (B, T, C), w and u (C,), initial_state (aa, bb, pp) each (B, C) or None.
    Returns y (B, T, C) fp32 and the final (aa, bb, pp). The element of a
    position is (p = k_t, a = v_t, b = 1, n = 1), the initial state is
    prepended as (pp0, aa0, bb0, n = 0), and the inclusive scan at concat
    index t is the state before token t. The scan is Hillis-Steele over the
    T + 1 elements (ceil(log2(T + 1)) rounds); JAX's ``associative_scan``
    sums in another tree, so the two differ from each other and from the
    sequential ``wkv4`` by fp32 rounding only. Plain PyTorch ops on any
    device, differentiable by autograd."""
    B, T, C = k.shape
    kf, vf = k.float(), v.float()
    wf, uf = w.float(), u.float()
    if initial_state is None:
        initial_state = init_wkv4_state(B, C, k.device)
    aa0, bb0, pp0 = (s.float() for s in initial_state)
    f32 = dict(dtype=torch.float32, device=k.device)
    elems = (torch.cat([pp0[:, None], kf], 1), torch.cat([aa0[:, None], vf], 1),
             torch.cat([bb0[:, None], torch.ones(B, T, C, **f32)], 1),
             torch.cat([torch.zeros(B, 1, 1, **f32), torch.ones(B, T, 1, **f32)], 1))
    d = 1
    while d < T + 1:
        merged = _combine(tuple(e[:, :-d] for e in elems), tuple(e[:, d:] for e in elems), wf)
        elems = tuple(torch.cat([e[:, :d], m], 1) for e, m in zip(elems, merged))
        d *= 2
    P, A, Bb, _ = elems
    sp, sa, sb = P[:, :T], A[:, :T], Bb[:, :T]
    ww = uf + kf
    m = torch.maximum(sp, ww)
    e1 = torch.exp(sp - m)
    e2 = torch.exp(ww - m)
    y = (e1 * sa + e2 * vf) / (e1 * sb + e2)
    # the final state as tensors of their own: B.14 takes contiguous states
    return y, (A[:, T].contiguous(), Bb[:, T].contiguous(), P[:, T].contiguous())
