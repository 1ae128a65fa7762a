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
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

BWD_ROWS = 8          # rows a block of csrc/ddlerp_bwd.cu takes
MAX_LOW_RANK = 512    # 5 * D columns the B.5 chain kernel holds (2 a thread)


def tmix_prologue_plain(
    x, shift_ln, ln_scale, ln_bias, maa, w1, w2, *, eps: float = 1e-5
) -> Tuple[torch.Tensor, ...]:
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
    h = torch.tanh(xxx @ w1.float()).reshape(B, T, 5, D)
    m = torch.einsum("btfd,fdc->fbtc", h, w2.float())
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


def _launch_k2(x, shift_ln, ln_scale, ln_bias, maa, w1, w2, eps):
    B, T, C = x.shape
    D = w1.shape[1] // 5
    device = _lib.check_cuda(
        x=x, shift_ln=shift_ln, ln_scale=ln_scale, ln_bias=ln_bias, maa=maa, w1=w1, w2=w2,
    )
    _check_smem(device, "tmix_prologue", _lib.library().rwkv_tmix_prologue_smem_bytes(C, D), C, D)
    out = torch.empty(6, B, T, C, dtype=x.dtype, device=device)
    _lib.launch(
        "rwkv_tmix_prologue", device, x, shift_ln, ln_scale, ln_bias, maa,
        w1, w2, out, B, T, C, D, eps, _lib.DTYPE_CODES[x.dtype],
    )
    tmix_prologue.launches += 1
    return tuple(out.unbind(0))


def tmix_prologue_bwd(
    x, shift_ln, ln_scale, ln_bias, maa, w1, w2, cts: Sequence[Optional[torch.Tensor]],
    *, eps: float = 1e-5, weights: bool = True,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of tmix_prologue: the tuple of tmix_prologue_bwd_plain,
    dx in x's dtype and the rest in fp32. With ``weights=False`` only dx and
    dshift are computed (dln_scale, dln_bias, dmaa, dw1 and dw2 are None).
    CPU tensors take the plain version; CUDA tensors launch B.5 (the chain
    and LayerNorm kernels, the weight products, the fixed-order partial
    sums), for any T and any D divisible by 8 with 5D <= 512."""
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
    w1T = w1.t().contiguous()
    w2T = w2.permute(2, 0, 1).reshape(C, 5 * D).contiguous()
    device = _lib.check_cuda(
        x=x, shift_ln=shift_ln, ln_scale=ln_scale, ln_bias=ln_bias, maa=maa, w1=w1, w2=w2,
        **{f"ct{i}": ct for i, ct in enumerate(cts) if ct is not None},
    )
    _check_smem(device, "tmix_prologue_bwd",
                _lib.library().rwkv_tmix_prologue_bwd_smem_bytes(C, D), C, D)
    f32 = dict(dtype=torch.float32, device=device)
    n_blocks = B * -(-T // BWD_ROWS)
    dx = torch.empty_like(x)
    dshift = torch.empty(B, C, **f32)
    dxx, dxnp = torch.empty(B, T, C, **f32), torch.empty(B, T, C, **f32)
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
        _lib.DTYPE_CODES[x.dtype],
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
