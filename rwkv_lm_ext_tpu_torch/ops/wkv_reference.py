"""Sequential WKV golden model (fp32 state), forward only.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_reference.py:17-77 (wkv_reference,
a ``lax.scan`` there, a Python loop over T here). It is the core of the
plain version of every WKV kernel: K1 (ops/wkv_fused.py) and the unfused
B.8 (ops/wkv.py) run the same recurrence on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv_reference(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: Optional[torch.Tensor],
    initial_state: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV scan.

    r, k, v, w: (B, T, H, N), computed in fp32; the per-step decay is
    exp(-exp(w)). u: (H, N) bonus, or None for no bonus term (the reverse
    pass of the bidirectional op has none). initial_state: (B, H, N, N) in
    (K, V) layout, or None for zeros. reverse: scan from t = T-1 down to 0.

    Returns y (B, T, H, N) fp32 and the final state (B, H, N, N) fp32.
    """
    B, T, H, N = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    ew = torch.exp(-torch.exp(w.float()))
    uf = None if u is None else u.float()[None, :, :, None]
    if initial_state is None:
        S = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    else:
        S = initial_state.float()
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,K,V)
        attend = S if uf is None else uf * kv + S
        ys[t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], attend)
        S = S * ew[:, t, :, :, None] + kv
    if T == 0:
        return torch.zeros(B, 0, H, N, dtype=torch.float32, device=r.device), S
    return torch.stack(ys, dim=1), S
