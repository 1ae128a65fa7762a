"""T=1 WKV6 decode step + GroupNorm(ln_x) + gate: kernels B.9 and B.13
(csrc/wkv_decode.cu) and their plain versions.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_decode.py: ``wkv6_decode_step`` is
``wkv6_decode_step_packed_pallas`` (:163, the Pallas kernel
``_decode_packed_kernel`` at :68) and ``wkv6_decode_step_packed`` (:242),
on the logical (B, H, N, N) state instead of the tile-packed one; the plain
version is ``_decode_ref`` (:45).

K1 (ops/wkv_fused.py) at T=1 computes the same function. This kernel exists
for the decode shape: many (b, h) rows in flight, one step, and the state
updated in place.

``wkv6_decode_step_transposed`` (B.13) is the same step on a state stored
transposed, (B, H, N_j, N_i): the counterpart of ``decode_step_transT``
(scripts/bench_decode_transposed.py:132, the Pallas kernel ``_transT_kernel``
at :65), with ``transpose_state`` in the place of ``pack_T`` / ``unpack_T``
(:51-62). As there, it is a layout option of the op that only an op-level
bench reaches; the model keeps the logical layout.

B.13 runs on a persistent grid of ``b13_grid(...)`` blocks in which block q
takes the heads of ``b13_walk`` (q, q + grid, ...) and streams each head's
whole state tile and its five vectors through a ring of ``STREAM_STAGES``
stages in shared memory by bulk copies, updating the tile in its stage and
storing it back. ``wkv6_decode_transposed_streamed_plain`` is that order in
plain PyTorch.

Both kernels read u, ln_scale and ln_bias in their own dtype when the three
share fp32 or bf16 (a bf16 model's parameters), so a call launches the
kernel alone.

The JAX kernel is a ``custom_vjp`` whose backward recomputes through the XLA
composition (:338-354); on CUDA tensors that require grad both steps here
differentiate through their plain version the same way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

HEAD_SIZES = (16, 32, 64)
STREAM_STAGES = 3      # stages of B.13's ring (kStreamStages)


def b13_grid(heads: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of B.13: as many as the card holds at once, at most one a
    head."""
    return max(1, min(heads, blocks_per_sm * sms))


def b13_walk(heads: int, grid: int) -> torch.Tensor:
    """(grid, steps): row q lists the heads block q of B.13 takes
    in turn, q, q + grid, q + 2 grid, ..., then -1 past its last. Head m of
    a block's walk uses stage m % STREAM_STAGES of its ring."""
    steps = -(-heads // grid)
    walk = torch.arange(steps * grid).view(steps, grid).t()     # walk[q, m] = q + m grid
    return walk.masked_fill(walk >= heads, -1)


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


def transpose_state(state: torch.Tensor) -> torch.Tensor:
    """(..., N, N) state S[i][j] <-> its transpose St[j][i], contiguous: the
    layout ``wkv6_decode_step_transposed`` reads and writes. Its own inverse."""
    return state.transpose(-1, -2).contiguous()


def wkv6_decode_step_transposed_plain(
    r, k, v, w, g, u, ln_scale, ln_bias, state_t, *, eps: float, out_state=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    out, snew = wkv6_decode_step_plain(
        r, k, v, w, g, u, ln_scale, ln_bias, state_t.transpose(-1, -2), eps=eps)
    snew_t = snew.transpose(-1, -2)
    return out, snew_t.contiguous() if out_state is None else out_state.copy_(snew_t)


def wkv6_decode_transposed_streamed_plain(
    r, k, v, w, g, u, ln_scale, ln_bias, state_t, *, eps: float, grid: int, out_state=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv6_decode_step_transposed_plain in B.13's order on ``grid`` blocks: block by block, the heads of ``b13_walk(B * H, grid)``,
    each head's tile copied into stage m % STREAM_STAGES of its block's ring,
    y_j = sum_i St[j][i] r_i taken there, the tile updated in its stage and
    written back into ``out_state`` (new when None; it may be ``state_t``
    itself: every tile is read whole before it is written)."""
    B, C = r.shape
    H, N = u.shape
    rf, kf, vf, wf, gf = (t.float().reshape(B * H, N) for t in (r, k, v, w, g))
    decay = torch.exp(-torch.exp(wf))
    uf = u.float()
    sc, bi = ln_scale.float().reshape(H, N), ln_bias.float().reshape(H, N)
    if out_state is None:
        out_state = torch.empty(B, H, N, N, dtype=torch.float32, device=state_t.device)
    src, dst = state_t.reshape(B * H, N, N), out_state.view(B * H, N, N)
    out = torch.empty(B * H, N, dtype=torch.float32, device=r.device)
    ring = torch.empty(STREAM_STAGES, N, N, dtype=torch.float32, device=state_t.device)
    for walk in b13_walk(B * H, grid).tolist():
        for m, bh in enumerate(walk):
            if bh < 0:
                break
            h, tile = bh % H, ring[m % STREAM_STAGES]
            tile.copy_(src[bh])
            y = tile @ rf[bh] + torch.sum(rf[bh] * uf[h] * kf[bh]) * vf[bh]
            tile.copy_(decay[bh][None, :] * tile + kf[bh][None, :] * vf[bh][:, None])
            dst[bh].copy_(tile)
            mu = y.mean()
            var = ((y - mu) ** 2).mean()
            out[bh] = ((y - mu) * torch.rsqrt(var + eps) * sc[h] + bi[h]) * gf[bh]
    return out.reshape(B, C).to(g.dtype), out_state


def _stream_grid(heads: int, dtype: torch.dtype, pcode: int, N: int, device: torch.device) -> int:
    """B.13's grid on ``device``: b13_grid of the blocks an SM holds, which
    the library asks once per (dtype, parameter dtype, N, device), setting the
    kernel's shared-memory limit with the first query, and keeps (so neither
    runs again under CUDA-graph capture, say)."""
    with torch.cuda.device(device):
        n = _lib.library().rwkv_wkv6_decode_stream_blocks_per_sm(_lib.DTYPE_CODES[dtype], pcode, N)
    if n <= 0:
        raise RuntimeError(f"wkv6_decode_step_transposed: the occupancy query failed with CUDA "
                           f"error {-n}")
    return b13_grid(heads, n, torch.cuda.get_device_properties(device).multi_processor_count)


def _launch(entry, counter, r, k, v, w, g, u, ln_scale, ln_bias, state, *, eps, out_state=None):
    """Check the CUDA route's inputs and launch C entry point ``entry``; B.13's
    entry also needs r, k, v, w, g 16-byte aligned and takes its grid."""
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
    (u, ln_scale, ln_bias), pcode = _lib.param_vectors(u, ln_scale, ln_bias)
    device = _lib.check_cuda(
        r=r, k=k, v=v, w=w, g=g, u=u, ln_scale=ln_scale, ln_bias=ln_bias,
        state=state, out_state=out_state,
    )
    if state.data_ptr() % 16 or out_state.data_ptr() % 16:
        raise ValueError("state and out_state must be 16-byte aligned")
    grid = ()
    if entry == "rwkv_wkv6_decode_transposed":
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("g", g)):
            if t.data_ptr() % 16:
                raise ValueError(f"wkv6_decode_step_transposed: B.13 reads {name} by bulk copies "
                                 "and needs it 16-byte aligned")
        grid = (_stream_grid(B * H, r.dtype, pcode, N, device),)
    out = torch.empty(B, C, dtype=g.dtype, device=device)
    _lib.launch(
        entry, device, r, k, v, w, u, g, ln_scale, ln_bias, state,
        out, out_state, B, H, N, eps, _lib.DTYPE_CODES[r.dtype], pcode, *grid,
    )
    counter.launches += 1
    return out, out_state


def _step(entry, counter, plain, r, k, v, w, g, u, ln_scale, ln_bias, state, eps, out_state):
    args = (r, k, v, w, g, u, ln_scale, ln_bias, state)
    if r.device.type == "cpu":
        return plain(*args, eps=eps, out_state=out_state)
    if not _lib.needs_grad(*args):
        return _launch(entry, counter, *args, eps=eps, out_state=out_state)
    if out_state is state:
        raise RuntimeError(
            f"{counter.__name__}: out_state is state (the in-place step) while an input "
            "requires grad: the backward recomputes the step from the saved inputs, which the "
            "kernel would have overwritten. Run it under torch.no_grad() or "
            "torch.inference_mode(), or give another out_state")
    out, snew = _lib.recompute_backward(
        lambda *a, eps: _launch(entry, counter, *a, eps=eps), plain, args, eps=eps)
    return out, snew if out_state is None else out_state.copy_(snew)


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
    version; CUDA tensors launch B.9, for N in HEAD_SIZES. When an input
    requires grad (and grad mode is on) the CUDA route is differentiable, its
    backward autograd through the plain version on the saved inputs; the
    in-place form then raises."""
    return _step("rwkv_wkv6_decode", wkv6_decode_step, wkv6_decode_step_plain,
                 r, k, v, w, g, u, ln_scale, ln_bias, state, eps, out_state)


def wkv6_decode_step_transposed(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    g: torch.Tensor,
    u: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    state_t: torch.Tensor,
    *,
    eps: float,
    out_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6_decode_step`` on a transposed state: ``state_t`` and the state
    returned are (B, H, N_j, N_i) fp32, ``transpose_state`` of the logical
    ones; everything else as there, ``out_state=state_t`` included. CPU
    tensors take the plain version; CUDA tensors launch B.13, which needs r,
    k, v, w, g and the states 16-byte aligned (it raises by name if one is
    not)."""
    return _step("rwkv_wkv6_decode_transposed", wkv6_decode_step_transposed,
                 wkv6_decode_step_transposed_plain,
                 r, k, v, w, g, u, ln_scale, ln_bias, state_t, eps, out_state)


wkv6_decode_step.launches = 0
wkv6_decode_step_transposed.launches = 0
