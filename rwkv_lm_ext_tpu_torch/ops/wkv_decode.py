"""T=1 WKV6 decode step + GroupNorm(ln_x) + gate: kernel B.9
(csrc/wkv_decode.cu) and its plain version.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_decode.py: ``wkv6_decode_step`` is
``wkv6_decode_step_packed_pallas`` (:163, the Pallas kernel
``_decode_packed_kernel`` at :68) and ``wkv6_decode_step_packed`` (:242),
on the logical (B, H, N, N) state instead of the tile-packed one; the plain
version is ``_decode_ref`` (:45).

K1 (ops/wkv_fused.py) at T=1 computes the same function. This kernel exists
for the decode shape: many (b, h) rows in flight, one step, and the state
updated in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

HEAD_SIZES = (32, 64)


def wkv6_decode_step_plain(
    r, k, v, w, g, u, ln_scale, ln_bias, state, *, eps: float, out_state=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, C = r.shape
    H, N = u.shape
    rf, kf, vf, wf, gf = (t.float().reshape(B, H, N) for t in (r, k, v, w, g))
    decay = torch.exp(-torch.exp(wf))
    bonus = torch.sum(rf * u.float()[None] * kf, dim=-1, keepdim=True)
    y = torch.einsum("bhi,bhij->bhj", rf, state) + bonus * vf
    snew = decay[..., None] * state + kf[..., None] * vf[:, :, None, :]
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + eps)
    out = (yn * ln_scale.float().reshape(H, N) + ln_bias.float().reshape(H, N)) * gf
    if out_state is not None:
        snew = out_state.copy_(snew)
    return out.reshape(B, C).to(g.dtype), snew


def wkv6_decode_step(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    g: torch.Tensor,
    u: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    state: torch.Tensor,
    *,
    eps: float,
    out_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, g: (B, C), one dtype; w: (B, C) log-decay (run in fp32);
    u: (H, N); ln_scale/ln_bias: (C,); state: (B, H, N, N) fp32, C = H*N.
    Returns the gated output (B, C) in g's dtype and the new state
    (B, H, N, N) fp32, written into ``out_state`` when given. ``out_state``
    may be ``state`` itself: the step then updates the state in place, which
    is how the generation engine runs it. CPU tensors take the plain
    version; CUDA tensors launch B.9, for N in HEAD_SIZES. B.9 has no
    backward yet (training through decode waits for it): on the CUDA route
    an input that requires grad, with grad mode on, raises instead of giving
    outputs detached from the graph."""
    if r.device.type == "cpu":
        return wkv6_decode_step_plain(
            r, k, v, w, g, u, ln_scale, ln_bias, state, eps=eps, out_state=out_state
        )
    if _lib.needs_grad(r, k, v, w, g, u, ln_scale, ln_bias, state):
        raise RuntimeError(
            "wkv6_decode_step (B.9) has no backward on the CUDA route: run it under "
            "torch.no_grad() or torch.inference_mode(), or on inputs that need no grad"
        )
    B, C = r.shape
    H, N = u.shape
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not supported by the decode kernel (one of {HEAD_SIZES})")
    if H * N != C:
        raise ValueError(f"u is {(H, N)} but r has C={C}")
    for name, t in (("k", k), ("v", v), ("w", w), ("g", g)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("g", g)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    if ln_scale.shape != (C,) or ln_bias.shape != (C,):
        raise ValueError("ln_scale/ln_bias must be (C,)")
    if out_state is None:
        out_state = torch.empty(B, H, N, N, dtype=torch.float32, device=state.device)
    for name, t in (("state", state), ("out_state", out_state)):
        if t.shape != (B, H, N, N) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {H}, {N}, {N}) fp32")
    w = w.float()
    u = u.float().contiguous()
    ln_scale = ln_scale.float().contiguous()
    ln_bias = ln_bias.float().contiguous()
    device = _lib.check_cuda(
        r=r, k=k, v=v, w=w, g=g, u=u, ln_scale=ln_scale, ln_bias=ln_bias,
        state=state, out_state=out_state,
    )
    if state.data_ptr() % 16 or out_state.data_ptr() % 16:
        raise ValueError("state and out_state must be 16-byte aligned")
    out = torch.empty(B, C, dtype=g.dtype, device=device)
    _lib.launch(
        "rwkv_wkv6_decode", device, r, k, v, w, u, g, ln_scale, ln_bias, state,
        out, out_state, B, H, N, eps, _lib.DTYPE_CODES[r.dtype],
    )
    wkv6_decode_step.launches += 1
    return out, out_state


wkv6_decode_step.launches = 0
