"""RWKV-6 time-mix prologue (ln1 + token shift + ddlerp): kernel K2
(csrc/ddlerp.cu), its backward B.5 (csrc/ddlerp_bwd.cu), and their plain
versions.

Counterpart of rwkv_lm_ext_tpu/ops/ddlerp_pallas.py: ``tmix_prologue``
(:387, the Pallas kernel ``_prologue_kernel`` at :35) with its custom_vjp
(``_prologue``, :109, :367-384, whose backward is ``_prologue_bwd_kernel`` at
:166) and, as the plain version, ``_prologue_ref`` (:87).

On a CUDA tensor the forward is a ``torch.autograd.Function`` when grad
mode is on and an input requires grad (training), and a direct K2 launch
otherwise (serving).

K2 has two bodies (csrc/ddlerp.cu), and ``k2_body`` picks one from dtype and
shape alone: the tensor-core body (64-row tiles over the flattened rows, both
low-rank products as ``mma.sync`` on bf16 operands with fp32 accumulation,
the arithmetic of the TPU kernel's default-precision MXU products) for bf16
with C divisible by 8 and D of 32 or 64, which is every served model; the
CUDA-core body (fp32 FMAs) for fp32 and for the bf16 shapes the other does
not take.

B.5 has two bodies too (csrc/ddlerp_bwd.cu), and ``b5_body`` picks one by
the same rule: the tensor-core body (tiles of 32 flattened rows that own 31
and take the next as a halo for the token shift's adjoint, its four products
on ``mma.sync`` with the fp32 operands in two bf16 limbs, one kernel for the
whole chain) or the CUDA-core body (the chain and LayerNorm kernels on fp32
FMAs). ``tmix_prologue_bwd_tiled_plain`` is the tensor-core body's walk in
plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

BWD_ROWS = 8          # rows a block of B.5's CUDA-core body takes
MAX_LOW_RANK = 512    # 5 * D columns the B.5 chain kernel holds (2 a thread)
B5_TILE_OWN = 31      # rows a tile of B.5's tensor-core body owns (it holds one more)
# K2's and B.5's bodies, by the codes of csrc/ddlerp.cu and csrc/ddlerp_bwd.cu
K2_BODIES = {"cuda_cores": 0, "tensor_cores": 1}
B5_BODIES = K2_BODIES
# the fp32 operands of B.5's tensor-core products, each of which the kernel
# takes as two bf16 limbs
B5_LIMBS = ("xxx", "dm", "dpre", "h")


def k2_body(dtype: torch.dtype, C: int, D: int) -> str:
    """The body of K2 that a call of this dtype and shape launches."""
    if dtype == torch.bfloat16 and C % 8 == 0 and D in (32, 64):
        return "tensor_cores"
    return "cuda_cores"


def b5_body(dtype: torch.dtype, C: int, D: int) -> str:
    """The body of B.5 that a call of this dtype and shape launches: K2's rule."""
    return k2_body(dtype, C, D)


def tmix_prologue_plain(
    x, shift_ln, ln_scale, ln_bias, maa, w1, w2, *, eps: float = 1e-5,
    product_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, ...]:
    """``product_dtype`` rounds both operands of the two low-rank products to
    that dtype first, with fp32 accumulation: bf16 is the arithmetic of the
    TPU kernel's default-precision MXU products, and of K2's tensor-core body
    for h (its xxx goes in as two bf16 limbs). For tests; no model path sets
    it."""
    def operand(t):
        return t.float() if product_dtype is None else t.to(product_dtype).float()

    B, T, C = x.shape
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    xn = xn * ln_scale.float() + ln_bias.float()
    prev = torch.cat([shift_ln[:, None, :].float(), xn[:, :-1]], dim=1)
    xx = prev - xn
    maa = maa.float()
    xxx = xn + xx * maa[0]
    D = w1.shape[1] // 5
    h = torch.tanh(operand(xxx) @ operand(w1)).reshape(B, T, 5, D)
    m = torch.einsum("btfd,fdc->fbtc", operand(h), operand(w2))
    outs = tuple((xn + xx * (maa[i + 1] + m[i])).to(x.dtype) for i in range(5))
    return outs + (xn.to(x.dtype),)


def tmix_prologue_bwd_plain(
    x, shift_ln, ln_scale, ln_bias, maa, w1, w2, cts: Sequence[Optional[torch.Tensor]],
    *, eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """(dx, dshift, dln_scale, dln_bias, dmaa, dw1, dw2) of the plain forward
    by torch.autograd.grad, for the six output cotangents ``cts`` (dxw, dxk,
    dxv, dxr, dxg, dxln); a None cotangent is zeros."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, shift_ln, ln_scale, ln_bias, maa, w1, w2)]
        outs = tmix_prologue_plain(*leaves, eps=eps)
        pairs = [(o, ct) for o, ct in zip(outs, cts) if ct is not None]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], leaves, [ct for _, ct in pairs], allow_unused=True
        ) if pairs else [None] * len(leaves)
    return tuple(torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, grads))


def _limbs(t: torch.Tensor, two: bool) -> torch.Tensor:
    """fp32 t as the tensor cores take it: its bf16 hi limb, plus the bf16
    lo limb of what that left when ``two``."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float() if two else hi


def tmix_prologue_bwd_tiled_plain(
    x, shift_ln, ln_scale, ln_bias, maa, w1, w2, cts: Sequence[Optional[torch.Tensor]],
    *, eps: float = 1e-5, weights: bool = True, limbs: Sequence[str] = B5_LIMBS,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The tuple of tmix_prologue_bwd (all in fp32) by the walk of B.5's
    tensor-core body: the weights as bf16, the activation operands of the
    four products (xxx, dm_i, dpre, h; ``limbs`` names those that take two
    bf16 limbs, the rest take one) rounded as the kernel stores them, and
    the rows in tiles of 32 over the flattened B*T rows that own 31 each:
    the token shift's dxx[t+1] comes from the tile's next row (its halo for
    the last owned row; none where a sequence ends), dshift from the tile
    that owns each sequence's row 0, and the column sums (dmaa, dln) tile by
    tile in order. For the tests and the card checks; no model path calls
    it."""
    B, T, C = x.shape
    D = w1.shape[1] // 5
    M = B * T
    f = lambda t: t.float()
    bf = lambda t: t.to(torch.bfloat16).float()
    two = {n: n in limbs for n in B5_LIMBS}
    xf = f(x).reshape(M, C)
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True) + eps)
    xr = (xf - mu) * rstd
    sc, bi, mf = f(ln_scale), f(ln_bias), f(maa)
    xn = xr * sc + bi
    dev = dict(device=x.device)
    first = torch.arange(M, **dev) % T == 0        # rows whose predecessor is the shift
    prev = torch.cat([xn[:1], xn[:-1]])
    prev[first] = f(shift_ln)
    xx = prev - xn
    xxx = xn + xx * mf[0]
    w1b, w2b = bf(w1), bf(w2)
    h = torch.tanh(_limbs(xxx, two["xxx"]) @ w1b)            # (M, 5D)
    hq = _limbs(h, True)                                     # h as stored: two limbs
    hm = _limbs(h, two["h"]).reshape(M, 5, D)
    d = [torch.zeros(M, C, **dev) if ct is None else f(ct).reshape(M, C) for ct in cts]
    dm = [d[i] * xx for i in range(5)]
    dh = torch.cat([_limbs(dm[i], two["dm"]) @ w2b[i].t() for i in range(5)], dim=1)
    dpre = dh * (1 - hq * hq)
    dxxx = _limbs(dpre, two["dpre"]) @ w1b.t()
    dxx = dxxx * mf[0]
    dxnl = d[5] + dxxx
    for i in range(5):
        dxx = dxx + d[i] * (mf[i + 1] + hm[:, i] @ w2b[i])
        dxnl = dxnl + d[i]
    dxnl = dxnl - dxx
    dx = torch.empty(M, C, **dev)
    dshift = torch.empty(B, C, **dev)
    col = torch.zeros(8, C, **dev)                 # dmaa (6) and dln (2) sums
    for m0 in range(0, M, B5_TILE_OWN):
        own = torch.arange(m0, min(m0 + B5_TILE_OWN, M), **dev)
        # row t + 1 lies in the tile (the halo, m0 + 31, for its last owned
        # row); a row that ends its sequence takes nothing
        nxt = own + 1
        dxn = dxnl[own] + torch.where((nxt % T != 0)[:, None], dxx[nxt.clamp(max=M - 1)], 0.0)
        dr = dxn * sc
        dx[own] = rstd[own] * (dr - dr.mean(-1, keepdim=True)
                               - xr[own] * (dr * xr[own]).mean(-1, keepdim=True))
        starts = own[own % T == 0]
        dshift[starts // T] = dxx[starts]
        col = col + torch.stack([(dxxx[own] * xx[own]).sum(0)] + [dm[i][own].sum(0) for i in range(5)]
                                + [(dxn * xr[own]).sum(0), dxn.sum(0)])
    dx = dx.reshape(B, T, C)
    if not weights:
        return (dx, dshift) + (None,) * 5
    dw2 = torch.stack([h[:, i * D:(i + 1) * D].t() @ dm[i] for i in range(5)])
    return dx, dshift, col[6], col[7], col[:6], xxx.t() @ dpre, dw2


def _prepare(x, shift_ln, ln_scale, ln_bias, maa, w1, w2):
    """Check the CUDA route's inputs; cast the parameters to x's dtype."""
    B, T, C = x.shape
    D = w1.shape[1] // 5
    if D % 8 != 0 or w1.shape != (C, 5 * D) or w2.shape != (5, D, C):
        raise ValueError(
            f"w1 must be (C, 5D) and w2 (5, D, C) with D % 8 == 0; got "
            f"{tuple(w1.shape)}, {tuple(w2.shape)}"
        )
    if shift_ln.shape != (B, C) or maa.shape != (6, C):
        raise ValueError("shift_ln must be (B, C) and maa (6, C)")
    if ln_scale.shape != (C,) or ln_bias.shape != (C,):
        raise ValueError("ln_scale/ln_bias must be (C,)")
    dt = x.dtype
    return tuple(t.to(dt).contiguous() for t in (shift_ln, ln_scale, ln_bias, maa, w1, w2))


def _check_smem(device, name: str, smem: int, C: int, D: int) -> None:
    limit = _lib.smem_limit(device)
    if smem > limit:
        raise ValueError(f"{name}: C={C}, D={D} needs {smem} B of shared memory; the card allows {limit}")


def _launch_k2(x, shift_ln, ln_scale, ln_bias, maa, w1, w2, eps, body=None):
    """``body`` (a key of K2_BODIES) overrides k2_body's choice: the card
    checks time one body beside the other; no caller in the package sets it."""
    B, T, C = x.shape
    D = w1.shape[1] // 5
    device = _lib.check_cuda(
        x=x, shift_ln=shift_ln, ln_scale=ln_scale, ln_bias=ln_bias, maa=maa, w1=w1, w2=w2,
    )
    code = K2_BODIES[body or k2_body(x.dtype, C, D)]
    _check_smem(device, "tmix_prologue",
                _lib.library().rwkv_tmix_prologue_smem_bytes(C, D, code), C, D)
    out = torch.empty(6, B, T, C, dtype=x.dtype, device=device)
    _lib.launch(
        "rwkv_tmix_prologue", device, x, shift_ln, ln_scale, ln_bias, maa,
        w1, w2, out, B, T, C, D, eps, _lib.DTYPE_CODES[x.dtype], code,
    )
    tmix_prologue.launches += 1
    return tuple(out.unbind(0))


def tmix_prologue_bwd(
    x, shift_ln, ln_scale, ln_bias, maa, w1, w2, cts: Sequence[Optional[torch.Tensor]],
    *, eps: float = 1e-5, weights: bool = True, body: Optional[str] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of tmix_prologue: the tuple of tmix_prologue_bwd_plain,
    dx in x's dtype and the rest in fp32. With ``weights=False`` only dx and
    dshift are computed (dln_scale, dln_bias, dmaa, dw1 and dw2 are None).
    CPU tensors take the plain version; CUDA tensors launch B.5 (the body of
    b5_body, the weight products, the fixed-order partial sums), for any T
    and any D divisible by 8 with 5D <= 512. ``body`` (a key of B5_BODIES)
    overrides b5_body's choice: the card checks time one body beside the
    other; no caller in the package sets it."""
    if x.device.type == "cpu":
        grads = tmix_prologue_bwd_plain(x, shift_ln, ln_scale, ln_bias, maa, w1, w2, cts, eps=eps)
        return grads if weights else grads[:2] + (None,) * 5
    B, T, C = x.shape
    D = w1.shape[1] // 5
    shift_ln, ln_scale, ln_bias, maa, w1, w2 = _prepare(x, shift_ln, ln_scale, ln_bias, maa, w1, w2)
    if 5 * D > MAX_LOW_RANK:
        raise ValueError(f"5D = {5 * D} is above the {MAX_LOW_RANK} columns B.5 takes")
    if len(cts) != 6:
        raise ValueError("cts must hold the six output cotangents (None for zeros)")
    cts = [None if ct is None else ct.to(x.dtype).contiguous() for ct in cts]
    for ct in cts:
        if ct is not None and ct.shape != x.shape:
            raise ValueError(f"cotangent of shape {tuple(ct.shape)}, outputs are {tuple(x.shape)}")
    device = _lib.check_cuda(
        x=x, shift_ln=shift_ln, ln_scale=ln_scale, ln_bias=ln_bias, maa=maa, w1=w1, w2=w2,
        **{f"ct{i}": ct for i, ct in enumerate(cts) if ct is not None},
    )
    body = body or b5_body(x.dtype, C, D)
    if body == "tensor_cores" and b5_body(x.dtype, C, D) != body:
        raise ValueError(f"B.5's tensor-core body takes bf16, C % 8 == 0 and D of 32 or 64, "
                         f"not {x.dtype}, C={C}, D={D}")
    tc = body == "tensor_cores"
    # the CUDA-core body reads the weights transposed as well
    w1T = None if tc else w1.t().contiguous()
    w2T = None if tc else w2.permute(2, 0, 1).reshape(C, 5 * D).contiguous()
    _check_smem(device, "tmix_prologue_bwd",
                _lib.library().rwkv_tmix_prologue_bwd_smem_bytes(C, D, B5_BODIES[body]), C, D)
    f32 = dict(dtype=torch.float32, device=device)
    n_blocks = -(-B * T // B5_TILE_OWN) if tc else B * -(-T // BWD_ROWS)
    dx = torch.empty_like(x)
    dshift = torch.empty(B, C, **f32)
    # the tensor-core body: dxn alone; the CUDA-core body: dxx and the row-local dxn
    dxx, dxnp = torch.empty(B, T, C, **f32), None if tc else torch.empty(B, T, C, **f32)
    dln_p = torch.empty(n_blocks, 2, C, **f32) if weights else None
    if weights:
        dw1, dw2 = torch.empty(C, 5 * D, **f32), torch.empty(5, D, C, **f32)
        wscratch = (torch.empty(B * T, C, **f32), torch.empty(B * T, 5 * D, **f32),
                    torch.empty(B * T, 5 * D, **f32), torch.empty(5, B * T, C, **f32),
                    torch.empty(n_blocks, 6, C, **f32))
    else:
        dw1 = dw2 = None
        wscratch = (None,) * 5
    _lib.launch(
        "rwkv_tmix_prologue_bwd", device, x, shift_ln, ln_scale, ln_bias, maa, w1, w1T, w2,
        w2T, *cts, dx, dshift, dw1, dw2, dxx, dxnp, *wscratch, dln_p, B, T, C, D, eps,
        _lib.DTYPE_CODES[x.dtype], B5_BODIES[body],
    )
    tmix_prologue_bwd.launches += 1
    if not weights:
        return (dx, dshift) + (None,) * 5
    dln = _lib.sum_partials(dln_p)
    return dx, dshift, dln[0], dln[1], _lib.sum_partials(wscratch[4]), dw1, dw2


class _TmixPrologue(torch.autograd.Function):
    """K2 forward, B.5 backward. Saves only the primal inputs, as
    ``_prologue_fwd`` does (ddlerp_pallas.py:151-153); casts happen inside."""

    @staticmethod
    def forward(ctx, x, shift_ln, ln_scale, ln_bias, maa, w1, w2, eps):
        ctx.set_materialize_grads(False)
        ctx.eps = eps
        ctx.save_for_backward(x, shift_ln, ln_scale, ln_bias, maa, w1, w2)
        return _launch_k2(x, *_prepare(x, shift_ln, ln_scale, ln_bias, maa, w1, w2), eps)

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        if all(ct is None for ct in cts):
            return (None,) * 8
        grads = tmix_prologue_bwd(*saved, cts, eps=ctx.eps, weights=any(need[2:7]))
        return tuple(
            gr.to(t.dtype) if n and gr is not None else None
            for gr, t, n in zip(grads, saved, need)
        ) + (None,)


def tmix_prologue(
    x: torch.Tensor,
    shift_ln: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    maa: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """Returns (xw, xk, xv, xr, xg, x_ln), each (B, T, C) in x's dtype.

    x: (B, T, C) raw residual stream; shift_ln: (B, C), the LN'd previous
    token (the time mix carries x_ln[:, -1] as its shift state); ln_scale,
    ln_bias: (C,) of ln1; maa: (6, C) stacked [time_maa_x, w, k, v, r, g];
    w1: (C, 5D); w2: (5, D, C). CPU tensors take the plain version; CUDA
    tensors launch K2, for any T and any D divisible by 8, differentiable
    through B.5 when an input requires grad."""
    if x.device.type == "cpu":
        return tmix_prologue_plain(x, shift_ln, ln_scale, ln_bias, maa, w1, w2, eps=eps)
    args = (x, shift_ln, ln_scale, ln_bias, maa, w1, w2)
    if _lib.needs_grad(*args):
        return _TmixPrologue.apply(*args, eps)
    return _launch_k2(x, *_prepare(*args), eps)


tmix_prologue.launches = 0
tmix_prologue_bwd.launches = 0
