"""Sequential WKV golden model (fp32 state), forward only.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_reference.py:17-77 (wkv_reference,
a ``lax.scan`` there, a Python loop over T here). It is the core of the
plain version of kernel K1 (ops/wkv_fused.py), and K1 runs the same
recurrence on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv_reference(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV scan.

    r, k, v, w: (B, T, H, N), computed in fp32; the per-step decay is
    exp(-exp(w)). u: (H, N) bonus. initial_state: (B, H, N, N) in (K, V)
    layout, or None for zeros.

    Returns y (B, T, H, N) fp32 and the final state (B, H, N, N) fp32.
    """
    B, T, H, N = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    ew = torch.exp(-torch.exp(w.float()))
    uf = u.float()[None, :, :, None]
    if initial_state is None:
        S = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    else:
        S = initial_state.float()
    y = torch.empty(B, T, H, N, dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,K,V)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], uf * kv + S)
        S = S * ew[:, t, :, :, None] + kv
    return y, S
