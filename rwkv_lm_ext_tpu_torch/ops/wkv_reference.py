"""Sequential WKV golden model (fp32 state), forward only.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_reference.py:17-117 (wkv_reference
and wkv_collect, ``lax.scan``s there, Python loops over T here). It is the
core of the plain version of every WKV kernel: K1 (ops/wkv_fused.py), the
unfused B.8 (ops/wkv.py) and the collecting B.15 (ops/wkv_collect.py) run
the same recurrence on the card.
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


def wkv_collect(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: Optional[torch.Tensor],
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv_reference that also keeps the state after every position
    (rwkv_lm_ext_tpu/ops/wkv_reference.py:80-117).

    Returns y (B, T, H, N) fp32 and the states (T, B, H, N, N) fp32 in (K, V)
    layout, where states[t] is the state after tokens[..t]: the speculative
    verify pass (models/collect.py) selects states[j] on a partial
    acceptance instead of running the accepted prefix again."""
    B, T, H, N = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    ew = torch.exp(-torch.exp(w.float()))
    uf = None if u is None else u.float()[None, :, :, None]
    if initial_state is None:
        S = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    else:
        S = initial_state.float()
    ys, states = [], []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        attend = S if uf is None else uf * kv + S
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], attend))
        S = S * ew[:, t, :, :, None] + kv
        states.append(S)
    if T == 0:
        return (torch.zeros(B, 0, H, N, dtype=torch.float32, device=r.device),
                torch.zeros(0, B, H, N, N, dtype=torch.float32, device=r.device))
    return torch.stack(ys, dim=1), torch.stack(states)
