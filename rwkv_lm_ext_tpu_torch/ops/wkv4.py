"""RWKV-4's log-space WKV: kernel B.14 (csrc/wkv4.cu) and its plain version.

Counterpart of rwkv_lm_ext_tpu/ops/wkv4.py: ``wkv4`` (:23-62), which the JAX
package runs as an XLA ``lax.scan`` and not as a Pallas kernel. The port
needs a kernel all the same: a PyTorch loop over T launches about fifteen
operations a token and a layer. ``wkv4_plain`` is that loop, the scan's body
in the same order of operations; the tests and the on-card comparison use it.
``wkv4_parallel`` (:65-131, the associative-scan form that the JAX package
keeps for sequence parallelism) is not ported.

The state is (aa, bb, pp), each (B, C) fp32; a fresh sequence starts at aa =
bb = 0 and pp = -1e38 (``init_wkv4_state``). ``out_state`` may be the input
state itself: the kernel then updates it in place, which the decode step
does. No backward: the trainers refuse RWKV-4 so far.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

Wkv4State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

PP_START = -1e38


def init_wkv4_state(B: int, C: int, device) -> Wkv4State:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(B, C, **f32), torch.zeros(B, C, **f32),
            torch.full((B, C), PP_START, **f32))


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
        ww = pp + wf
        p = torch.maximum(ww, kt)
        e1 = torch.exp(ww - p)
        e2 = torch.exp(kt - p)
        aa, bb, pp = e1 * aa + e2 * vt, e1 * bb + e2, p
    y = torch.stack(ys, 1) if ys else torch.zeros(B, 0, C, dtype=torch.float32, device=k.device)
    if out_state is None:
        return y, (aa, bb, pp)
    for dst, src in zip(out_state, (aa, bb, pp)):
        dst.copy_(src)
    return y, out_state


def wkv4(
    k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    state: Optional[Wkv4State] = None, *, out_state: Optional[Wkv4State] = None,
) -> Tuple[torch.Tensor, Wkv4State]:
    """k, v: (B, T, C) in one dtype; w (the decay, <= 0) and u: (C,), run in
    fp32; state: (aa, bb, pp) each (B, C) fp32, or None for a fresh one.
    Returns y (B, T, C) fp32 and the final state, written into ``out_state``
    when given (it may be ``state``: the update is then in place). CPU
    tensors take the plain version; CUDA tensors launch B.14 (and refuse an
    input that requires grad)."""
    if k.device.type == "cpu":
        return wkv4_plain(k, v, w, u, state, out_state=out_state)
    if _lib.needs_grad(k, v, w, u):
        raise RuntimeError("wkv4 has no backward kernel yet: RWKV-4 is served, not trained")
    B, T, C = k.shape
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"v is {tuple(v.shape)} {v.dtype}, k {tuple(k.shape)} {k.dtype}")
    if w.shape != (C,) or u.shape != (C,):
        raise ValueError(f"w and u must be ({C},), got {tuple(w.shape)}, {tuple(u.shape)}")
    if state is None:
        state = init_wkv4_state(B, C, k.device)
    if out_state is None:
        out_state = tuple(torch.empty(B, C, dtype=torch.float32, device=k.device)
                          for _ in range(3))
    for name, s in zip(("aa", "bb", "pp", "aa_out", "bb_out", "pp_out"),
                       tuple(state) + tuple(out_state)):
        if s.shape != (B, C) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {C}) fp32, got {tuple(s.shape)} {s.dtype}")
    w, u = w.float().contiguous(), u.float().contiguous()
    aa, bb, pp = state
    ao, bo, po = out_state
    device = _lib.check_cuda(k=k, v=v, w=w, u=u, aa=aa, bb=bb, pp=pp, aa_out=ao, bb_out=bo,
                             pp_out=po)
    y = torch.empty(B, T, C, dtype=torch.float32, device=device)
    _lib.launch("rwkv_wkv4", device, k, v, w, u, aa, bb, pp, y, ao, bo, po, B, T, C,
                _lib.DTYPE_CODES[k.dtype])
    wkv4.launches += 1
    return y, out_state


wkv4.launches = 0
