"""The collecting WKV: kernel B.15 (csrc/wkv_collect.cu) and its plain version.

K1's function (the WKV recurrence, then the per-head GroupNorm(ln_x), scale,
bias and gate; ops/wkv_fused.py) that also returns the fp32 state after
every position, for the speculative verify pass (models/collect.py). No TPU
kernel is replaced: the JAX package's counterpart is ``wkv_collect``
(rwkv_lm_ext_tpu/ops/wkv_reference.py:80), an XLA ``lax.scan`` that
models/collect.py there follows with the GroupNorm and gate as plain ops;
``wkv6_collect_plain`` is that composition (``wkv_collect``, then K1's
plain GroupNorm-gate epilogue). Forward only: the verify pass runs under
inference mode.

CPU tensors take the plain version; CUDA tensors launch B.15 or raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import _group_norm_gate, _prepare
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_collect


def wkv6_collect_plain(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state=None, *, eps: float, out_states=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, N = r.shape
    if initial_state is not None and initial_state.dim() == 3:
        initial_state = initial_state.expand(B, H, N, N)
    y, states = wkv_collect(r, k, v, w, u, initial_state)
    if out_states is not None:
        out_states.copy_(states)
        states = out_states
    return _group_norm_gate(y, g, ln_scale, ln_bias, eps), states


def _check_out_states(out_states, shape, device) -> int:
    """The T stride (in elements) of a caller's (T, B, H, N, N) fp32 buffer
    whose last four axes are contiguous (one layer's slice of a (T, L, B, H,
    N, N) stack qualifies)."""
    if (out_states.shape != shape or out_states.dtype != torch.float32
            or out_states.device != device):
        raise ValueError(f"out_states must be a {tuple(shape)} fp32 tensor on {device}, not "
                         f"{tuple(out_states.shape)} {out_states.dtype} on {out_states.device}")
    _, _, H, N, _ = shape
    want = (H * N * N, N * N, N, 1)
    if out_states.stride()[1:] != want:
        raise ValueError(f"out_states must have contiguous (B, H, N, N) slices (strides {want}), "
                         f"not {out_states.stride()[1:]}")
    return out_states.stride(0)


def wkv6_collect(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    g: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
    *,
    eps: float,
    out_states: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's arguments (ops.wkv_fused.wkv6_fused_output): r, k, v, g (B, T, H,
    N) in one dtype, w (B, T, H, N) log-decay, u (H, N), ln_scale / ln_bias
    (H*N,), initial_state (B, H, N, N) or (H, N, N) fp32 or None. Returns the
    gated output (B, T, H*N) in g's dtype and the states (T, B, H, N, N)
    fp32, states[t] the state after position t. ``out_states`` (T, B, H, N,
    N) fp32 receives the states in place of a new tensor; its (B, H, N, N)
    slices must be contiguous, its T stride may be any (a layer's slice of a
    stacked buffer). Head sizes 16, 32, 64 and 128, any T >= 1."""
    if r.device.type == "cpu":
        return wkv6_collect_plain(r, k, v, w, u, g, ln_scale, ln_bias, initial_state, eps=eps,
                                  out_states=out_states)
    B, T, H, N = r.shape
    w32, u32, g, sc, bi, s0 = _prepare(r, k, v, w, u, g, ln_scale, ln_bias, initial_state)
    device = _lib.check_cuda(r=r, k=k, v=v, w=w32, u=u32, g=g, ln_scale=sc, ln_bias=bi, s0=s0)
    shape = (T, B, H, N, N)
    if out_states is None:
        out_states = torch.empty(shape, dtype=torch.float32, device=device)
    t_stride = _check_out_states(out_states, shape, device)
    out = torch.empty(B, T, H * N, dtype=g.dtype, device=device)
    _lib.launch("rwkv_wkv6_collect", device, r, k, v, w32, u32, g, sc, bi, s0, out, out_states,
                t_stride, B, T, H, N, eps, _lib.DTYPE_CODES[r.dtype])
    wkv6_collect.launches += 1
    return out, out_states


wkv6_collect.launches = 0
