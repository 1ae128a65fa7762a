"""The chunked WKV of the JAX package's XLA backend, and the local scan of
sequence parallelism.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_chunked.py: ``wkv_chunked`` (:97,
the XLA ``chunked`` backend behind ops/wkv.py:82) with ``_intra_A_exact``
(:49). It is the local scan of parallel/sequence.py, from a zero state on
each time shard.

On CUDA tensors ``wkv_chunked`` is kernel B.8 (``ops.wkv.wkv``,
csrc/wkv.cu), under autograd through B.8's own Function (its backward B.6
with ``gn=False`` and B.7). B.8 is exact at any decay and picks its own
chunk factoring (ops/wkv.py), so ``chunk_size`` and ``remat`` change nothing
there: they are taken for the JAX signature's sake and act only on the
plain version.

``wkv_tiled_plain`` is that plain version, and CPU tensors take it: JAX's
tiled decomposition op for op in fp32, per batch and head with lw = -exp(w)
the log-decay, Winc its inclusive and Wexc its exclusive cumulative sum
within a chunk of L steps:

  y[t] = r[t]·(u ⊙ k[t]) v[t]                              (bonus, diagonal)
       + sum_{s<t} (r[t] ⊙ e^{Wexc[t]-Winc[s]})·k[s] v[s]  (intra-chunk)
       + (r[t] ⊙ e^{Wexc[t]}) @ S_chunk_start              (inter-chunk)

  S_next = e^{Winc[L-1]} ⊙_K S + sum_s (k[s] ⊙ e^{Winc[L-1]-Winc[s]})^T v[s]

The intra-chunk matrix is formed by ``_intra_A_exact``: s-tiles of
``EXACT_SUBTILE`` steps, each tile's contribution to the rows after it
factored around the cumulative decay at the tile's end (every exponent <= 0,
exact at any decay), the diagonal tile from the raw pairwise exponents
clipped at 0 (clipping touches only the s >= t entries the causal mask
drops); a chunk whose length is not a multiple of the tile is one pairwise
tile. T is padded to a multiple of L with w = -1e30 (a decay of one), so the
padded steps keep the state. ``remat`` recomputes each chunk's body in the
backward (``torch.utils.checkpoint``, as ``jax.checkpoint``). It is not
ops/wkv.py's ``wkv_chunked_plain``, which mirrors B.8's own factoring.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rwkv_lm_ext_tpu_torch.ops.wkv import wkv

# s-tile of the exact intra-chunk decomposition (JAX's EXACT_SUBTILE)
EXACT_SUBTILE = 16


def _intra_A_exact(rr, kk, wexc, winc, Ls: int = EXACT_SUBTILE) -> torch.Tensor:
    """A[..., t, s] = sum_n rr[t, n] kk[s, n] e^{wexc[t, n] - winc[s, n]},
    exact for any decay; the entries with s >= t are meaningless (the caller
    masks them). rr, kk, wexc, winc: (..., L, N) fp32."""
    L = rr.shape[-2]
    Ls = min(Ls, L)
    if L % Ls:           # a chunk that is no multiple of the tile: one pairwise tile
        Ls = L
    NT = L // Ls
    row = torch.arange(L, device=rr.device)[:, None]
    cols = []
    for j in range(NT):
        sl = slice(j * Ls, (j + 1) * Ls)
        # the diagonal tile: raw pairwise exponents (<= 0 for s < t)
        logits = wexc[..., sl, :][..., :, None, :] - winc[..., sl, :][..., None, :, :]
        pair = rr[..., sl, :][..., :, None, :] * kk[..., sl, :][..., None, :, :]
        At = (pair * torch.exp(torch.clamp_max(logits, 0.0))).sum(-1)
        col = F.pad(At, (0, 0, j * Ls, L - (j + 1) * Ls))
        if j < NT - 1:
            # the rows after the tile, factored around m = winc[tile end]:
            # wexc[t] - m <= 0 for t past the tile, m - winc[s] <= 0 within it
            m = winc[..., (j + 1) * Ls - 1:(j + 1) * Ls, :]
            kj = kk[..., sl, :] * torch.exp(m - winc[..., sl, :])
            qj = rr * torch.exp(torch.clamp_max(wexc - m, 0.0))
            C = qj @ kj.transpose(-1, -2)
            col = col + torch.where(row >= (j + 1) * Ls, C, 0.0)
        cols.append(col)
    return torch.cat(cols, -1)


def _chunk_body(S, qi, ks, dt, vv, dg, rr, kk, we, wi, tri):
    """One chunk: (the state after it, its y (B, H, L, N))."""
    A = torch.where(tri, _intra_A_exact(rr, kk, we, wi), 0.0)
    y = A @ vv + dg[..., None] * vv + qi @ S
    return S * dt[..., :, None] + ks.transpose(-1, -2) @ vv, y


def wkv_tiled_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: Optional[torch.Tensor], initial_state: Optional[torch.Tensor] = None, *,
    chunk_size: int = 32, remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``wkv_chunked`` in plain PyTorch (the module docstring): r, k,
    v, w (B, T, H, N), u (H, N) or None, initial_state (B, H, N, N) or (H,
    N, N) or None. Returns y (B, T, H, N) and the final state (B, H, N, N),
    both fp32."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, not {chunk_size}")
    B, T, H, N = r.shape
    f32 = torch.float32
    L = min(chunk_size, T)
    pad = (-T) % L
    NC = (T + pad) // L

    def chunks(x, value=0.0):
        x = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad), value=value)
        return x.reshape(B, NC, L, H, N).permute(1, 0, 3, 2, 4)      # (NC, B, H, L, N)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    lwc = -torch.exp(chunks(w, -1e30))                                # <= 0; 0 on padding
    winc = torch.cumsum(lwc, -2)
    wexc = winc - lwc
    wlast = winc[..., -1:, :]
    q_inter = rc * torch.exp(wexc)
    k_state = kc * torch.exp(wlast - winc)
    decay_total = torch.exp(wlast[..., 0, :])                        # (NC, B, H, N)
    if u is None:
        diag = torch.zeros(rc.shape[:-1], dtype=f32, device=r.device)
    else:
        diag = (rc * u.to(f32)[:, None, :] * kc).sum(-1)            # (NC, B, H, L)
    if initial_state is None:
        S = torch.zeros(B, H, N, N, dtype=f32, device=r.device)
    else:
        S = initial_state.to(f32).expand(B, H, N, N)
    tri = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for c in range(NC):
        inputs = (q_inter[c], k_state[c], decay_total[c], vc[c], diag[c], rc[c], kc[c], wexc[c],
                  winc[c], tri)
        if remat and torch.is_grad_enabled():
            S, y = checkpoint(_chunk_body, S, *inputs, use_reentrant=False)
        else:
            S, y = _chunk_body(S, *inputs)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, NC * L, H, N)[:, :T]
    return y, S


def wkv_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: Optional[torch.Tensor], initial_state: Optional[torch.Tensor] = None, *,
    chunk_size: int = 32, remat: bool = True, exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``wkv_chunked`` contract: r, k, v, w (B, T, H, N), u (H, N) or
    None, initial_state (B, H, N, N) or None. Returns y (B, T, H, N) fp32 and
    the final state (B, H, N, N) fp32. CUDA tensors launch B.8 (``chunk_size``
    and ``remat`` have no effect there; the module docstring), CPU tensors
    take ``wkv_tiled_plain``. ``exact`` is kept for JAX's signature: both of
    its values ran the exact decomposition there too."""
    del exact
    if r.device.type == "cpu":
        return wkv_tiled_plain(r, k, v, w, u, initial_state, chunk_size=chunk_size, remat=remat)
    return wkv(r.contiguous(), k.contiguous(), v.contiguous(), w, u, initial_state)
