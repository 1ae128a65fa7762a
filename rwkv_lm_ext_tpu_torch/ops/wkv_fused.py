"""Fused WKV + GroupNorm(ln_x) + gate: kernel K1 (csrc/wkv_fused.cu) and its
plain version.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_pallas.py: ``wkv6_fused_output``
(:1068, the Pallas kernel ``_wkv_gn_kernel`` at :743) and, as the plain
version, ``_fused_ref`` (:823): the sequential ``wkv_reference`` followed by
the per-head GroupNorm, scale/bias and gate.

K1 runs the sequential recurrence, which is exact at any decay. The JAX
package's chunked kernel needed an exact-A or midpoint-rescale factoring of
each chunk, chosen per checkpoint by ``cfg.wkv_exact``/``fused_chunk`` and
``suggest_/apply_/verify_wkv_dispatch`` (models/rwkv.py:74-164). The port
has nothing for that dispatch to select, so it has none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_reference

HEAD_SIZES = (32, 64)


def wkv6_fused_output_plain(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state=None, *, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, N = r.shape
    y, sT = wkv_reference(r, k, v, w, u, initial_state)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = ((y - mu) * torch.rsqrt(var + eps)).reshape(B, T, H * N)
    out = (yn * ln_scale.float() + ln_bias.float()) * g.reshape(B, T, H * N).float()
    return out.to(g.dtype), sT


def wkv6_fused_output(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, g: (B, T, H, N), one dtype; w: (B, T, H, N) log-decay (run
    in fp32); u: (H, N); ln_scale/ln_bias: (H*N,); initial_state:
    (B, H, N, N) fp32 or None. Returns the gated output (B, T, H*N) in g's
    dtype, ready for the output projection, and the final state (B, H, N, N)
    fp32. CPU tensors take the plain version; CUDA tensors launch K1, for
    any T and N in HEAD_SIZES."""
    if r.device.type == "cpu":
        return wkv6_fused_output_plain(
            r, k, v, w, u, g, ln_scale, ln_bias, initial_state, eps=eps
        )
    B, T, H, N = r.shape
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not supported by K1 (one of {HEAD_SIZES})")
    for name, t in (("k", k), ("v", v), ("w", w), ("g", g)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("g", g)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    if u.shape != (H, N) or ln_scale.shape != (H * N,) or ln_bias.shape != (H * N,):
        raise ValueError("u must be (H, N) and ln_scale/ln_bias (H*N,)")
    if initial_state is None:
        s0 = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    else:
        if initial_state.shape != (B, H, N, N):
            raise ValueError(f"initial_state must be {(B, H, N, N)}")
        s0 = initial_state.float().contiguous()
    w = w.float()
    u = u.float().contiguous()
    ln_scale = ln_scale.float().contiguous()
    ln_bias = ln_bias.float().contiguous()
    device = _lib.check_cuda(
        r=r, k=k, v=v, w=w, u=u, g=g, ln_scale=ln_scale, ln_bias=ln_bias, s0=s0
    )
    out = torch.empty(B, T, H * N, dtype=g.dtype, device=device)
    sT = torch.empty(B, H, N, N, dtype=torch.float32, device=device)
    _lib.launch(
        "rwkv_wkv6_fused", device, r, k, v, w, u, g, ln_scale, ln_bias, s0,
        out, sT, B, T, H, N, eps, _lib.DTYPE_CODES[r.dtype],
    )
    wkv6_fused_output.launches += 1
    return out, sT


wkv6_fused_output.launches = 0
