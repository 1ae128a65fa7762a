"""Fused T=1 decode glue: kernels B.10 (attention prologue), B.11 (channel-mix
prologue) and B.12 (the whole channel-mix block) of csrc/decode_fused.cu, and
their plain versions.

Counterpart of rwkv_lm_ext_tpu/ops/decode_fused.py: ``att_prep_fused`` (:159,
the Pallas kernel ``_att_prep_kernel`` at :101), ``ffn_prep_fused`` (:270,
``_ffn_prep_kernel`` :251) and ``ffn_block_fused`` (:416, ``_ffn_block_kernel``
:354), with the same arguments and output order; the plain versions repeat
``_att_prep_ref`` (:53), ``_ffn_prep_ref`` (:237) and ``_ffn_block_ref``
(:324). One difference in layout: the weights of ``ffn_block_fused`` are in
torch's (out, in) layout, as the port's ``Linear`` holds them, so nothing is
transposed per call.

Precision (the JAX kernels' contract): LayerNorm, the shift difference and the
lerp adds in fp32; the ddlerp low-rank on operands rounded to x's dtype with
fp32 accumulation; the decay low-rank on fp32 operands (the mixed ``xw`` is not
rounded first, unlike the unfused step, where it leaves K2 in x's dtype); the
returned ``xn`` is the unrounded fp32 LayerNorm row. In ``ffn_block_fused`` the
key activation is rounded to x's dtype before and after relu^2, ``kv`` and
``r`` stay fp32, and the residual is added in fp32.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. When an input requires grad the call is
differentiable: the backward recomputes through the plain version, as
``_att_prep_bwd`` (:223), ``_ffn_prep_bwd`` (:310) and ``_ffn_block_bwd``
(:499) do. The TPU wrappers' gates (B % 8, C % 512, F % 512, a VMEM row cap,
with a fall-back to the jnp composition) are not carried over: any B >= 1 runs,
and the widths each kernel needs are checked and raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib


def _ln_shift(x, shift, ln_scale, ln_bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    xn = xn * ln_scale.float() + ln_bias.float()
    return xn, shift.float() - xn


def _dot(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b on operands rounded to ``dtype``, accumulated in fp32."""
    return a.to(dtype).float() @ b.to(dtype).float()


def att_prep_plain(
    x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, eps: float = 1e-5
) -> Tuple[torch.Tensor, ...]:
    od = x.dtype
    xn, xx = _ln_shift(x, shift, ln_scale, ln_bias, eps)
    maas = maas.float()
    D = w2.shape[1]
    h = torch.tanh(_dot(xn + xx * maas[0], w1, od))
    xw, xk, xv, xr, xg = (
        xn + xx * (maas[1 + i] + _dot(h[:, i * D:(i + 1) * D], w2[i], od)) for i in range(5)
    )
    hw = torch.tanh(xw @ dw1.float())
    w = time_decay.float().reshape(-1) + hw @ dw2.float()
    return xr.to(od), xk.to(od), xv.to(od), xg.to(od), w, xn


def ffn_prep_plain(
    x, shift, ln_scale, ln_bias, maa_k, maa_r, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xn, xx = _ln_shift(x, shift, ln_scale, ln_bias, eps)
    xk = xn + xx * maa_k.float().reshape(-1)
    xr = xn + xx * maa_r.float().reshape(-1)
    return xk.to(x.dtype), xr.to(x.dtype), xn


def ffn_block_plain(
    x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    od = x.dtype
    xk, xr, xn = ffn_prep_plain(x, shift, ln_scale, ln_bias, maa_k, maa_r, eps)
    k = torch.relu(_dot(xk, wk.t(), od).to(od)) ** 2
    kv = _dot(k, wv.t(), od)
    r = _dot(xr, wr.t(), od)
    return (x.float() + torch.sigmoid(r) * kv).to(od), xn


def _vectors(*params):
    """The (C,)-shaped parameters and fp32 low-rank weights of one call, in one
    dtype the kernels take: as they are when they already share one, else
    fp32. Returns (tensors, dtype code)."""
    dtypes = {p.dtype for p in params}
    dtype = dtypes.pop() if len(dtypes) == 1 and dtypes <= set(_lib.DTYPE_CODES) else torch.float32
    return [p.to(dtype).contiguous() for p in params], _lib.DTYPE_CODES[dtype]


def _check_rows(x, shift, **vectors):
    if x.dim() != 2:
        raise ValueError(f"x must be (B, C), got {tuple(x.shape)}")
    B, C = x.shape
    if shift.shape != (B, C):
        raise ValueError(f"shift must be ({B}, {C}), got {tuple(shift.shape)}")
    for name, v in vectors.items():
        if v.numel() != C:
            raise ValueError(f"{name} must hold C={C} values, got {tuple(v.shape)}")
    return B, C


def _launch_att_prep(x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, eps=1e-5):
    B, C = _check_rows(x, shift, ln_scale=ln_scale, ln_bias=ln_bias, time_decay=time_decay)
    D, Dd = w2.shape[1], dw1.shape[1]
    if maas.shape != (6, C) or w1.shape != (C, 5 * D) or w2.shape != (5, D, C):
        raise ValueError(
            f"maas must be (6, C), w1 (C, 5D) and w2 (5, D, C); got {tuple(maas.shape)}, "
            f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    if dw1.shape != (C, Dd) or dw2.shape != (Dd, C):
        raise ValueError(f"dw1 must be (C, Dd) and dw2 (Dd, C); got {tuple(dw1.shape)}, {tuple(dw2.shape)}")
    if C % 8 or D % 8 or Dd % 8 or 5 * D > 2048 or Dd > 2048:
        raise ValueError(
            f"att_prep_fused reads 16 bytes at a time: C, D and Dd must be multiples of 8 "
            f"(and 5D, Dd at most 2048); got C={C}, D={D}, Dd={Dd}")
    shift = shift.float().contiguous()
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    (ln_scale, ln_bias, maas, dw1, dw2, time_decay), pcode = _vectors(
        ln_scale, ln_bias, maas, dw1, dw2, time_decay)
    device = _lib.check_cuda(x=x, shift=shift, ln_scale=ln_scale, ln_bias=ln_bias, maas=maas,
                             w1=w1, w2=w2, dw1=dw1, dw2=dw2, time_decay=time_decay)
    smem, limit = _lib.library().rwkv_att_prep_smem_bytes(C, D, Dd), _lib.smem_limit(device)
    if smem > limit:
        raise ValueError(f"att_prep_fused: C={C}, D={D}, Dd={Dd} needs {smem} B of shared "
                         f"memory; the card allows {limit}")
    xr, xk, xv, xg = torch.empty(4, B, C, dtype=x.dtype, device=device).unbind(0)
    w, xn = torch.empty(2, B, C, dtype=torch.float32, device=device).unbind(0)
    _lib.launch("rwkv_att_prep", device, x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2,
                time_decay, xr, xk, xv, xg, w, xn, B, C, D, Dd, eps,
                _lib.DTYPE_CODES[x.dtype], pcode)
    att_prep_fused.launches += 1
    return xr, xk, xv, xg, w, xn


def _launch_ffn_prep(x, shift, ln_scale, ln_bias, maa_k, maa_r, eps=1e-5):
    B, C = _check_rows(x, shift, ln_scale=ln_scale, ln_bias=ln_bias, maa_k=maa_k, maa_r=maa_r)
    shift = shift.float().contiguous()
    (ln_scale, ln_bias, maa_k, maa_r), pcode = _vectors(ln_scale, ln_bias, maa_k, maa_r)
    device = _lib.check_cuda(x=x, shift=shift, ln_scale=ln_scale, ln_bias=ln_bias,
                             maa_k=maa_k, maa_r=maa_r)
    xk, xr = torch.empty(2, B, C, dtype=x.dtype, device=device).unbind(0)
    xn = torch.empty(B, C, dtype=torch.float32, device=device)
    _lib.launch("rwkv_ffn_prep", device, x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr, xn,
                B, C, eps, _lib.DTYPE_CODES[x.dtype], pcode)
    ffn_prep_fused.launches += 1
    return xk, xr, xn


def _launch_ffn_block(x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr, eps=1e-5):
    B, C = _check_rows(x, shift, ln_scale=ln_scale, ln_bias=ln_bias, maa_k=maa_k, maa_r=maa_r)
    F = wk.shape[0]
    if wk.shape != (F, C) or wv.shape != (C, F) or wr.shape != (C, C):
        raise ValueError(
            f"weights are (out, in): wk (F, C), wv (C, F), wr (C, C); got {tuple(wk.shape)}, "
            f"{tuple(wv.shape)}, {tuple(wr.shape)}")
    if C % 32 or F % 32:
        raise ValueError(f"ffn_block_fused takes C and F in multiples of 32 (one k chunk of "
                         f"its products); got C={C}, F={F}")
    shift = shift.float().contiguous()
    wk, wv, wr = (w.to(x.dtype).contiguous() for w in (wk, wv, wr))
    (ln_scale, ln_bias, maa_k, maa_r), pcode = _vectors(ln_scale, ln_bias, maa_k, maa_r)
    device = _lib.check_cuda(x=x, shift=shift, ln_scale=ln_scale, ln_bias=ln_bias, maa_k=maa_k,
                             maa_r=maa_r, wk=wk, wv=wv, wr=wr)
    for name, t in (("x", x), ("wk", wk), ("wv", wv), ("wr", wr)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    code = _lib.DTYPE_CODES[x.dtype]
    slices = _lib.library().rwkv_ffn_block_slices(code)
    out, xk, xr = torch.empty(3, B, C, dtype=x.dtype, device=device).unbind(0)
    k = torch.empty(B, F, dtype=x.dtype, device=device)
    xn = torch.empty(B, C, dtype=torch.float32, device=device)
    partials = torch.empty(slices + 1, B, C, dtype=torch.float32, device=device)
    _lib.launch("rwkv_ffn_block", device, x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr,
                out, xn, xk, xr, k, partials, B, C, F, eps, code, pcode)
    ffn_block_fused.launches += 1
    return out, xn


def _route(launch, plain, tensors, eps):
    if tensors[0].device.type == "cpu":
        return plain(*tensors, eps)
    if _lib.needs_grad(*tensors):
        return _lib.recompute_backward(launch, plain, tensors, eps=eps)
    return launch(*tensors, eps)


def att_prep_fused(
    x: torch.Tensor,
    shift: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    maas: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    dw1: torch.Tensor,
    dw2: torch.Tensor,
    time_decay: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """The attention prologue of one decode step.

    x (B, C), the raw residual stream; shift (B, C), the previous ln1 row
    (run in fp32); ln_scale, ln_bias, time_decay: C values each; maas (6, C)
    stacked [maa_x, maa_w, maa_k, maa_v, maa_r, maa_g]; w1 (C, 5D), w2
    (5, D, C), used in x's dtype; dw1 (C, Dd), dw2 (Dd, C), used in fp32.

    Returns xr, xk, xv, xg (B, C) in x's dtype, w (B, C) fp32, the raw
    log-decay, and xn (B, C) fp32, the ln1 output: the next shift row. CPU
    tensors take the plain version; CUDA tensors launch B.10, for any B and
    C, D, Dd in multiples of 8."""
    args = (x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay)
    return _route(_launch_att_prep, att_prep_plain, args, eps)


def ffn_prep_fused(
    x: torch.Tensor,
    shift: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    maa_k: torch.Tensor,
    maa_r: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The channel-mix prologue: ln2 + token shift + the k and r mixes.
    Returns xk, xr (B, C) in x's dtype and xn (B, C) fp32, the next ffn
    shift. CPU tensors take the plain version; CUDA tensors launch B.11, for
    any B and C."""
    args = (x, shift, ln_scale, ln_bias, maa_k, maa_r)
    return _route(_launch_ffn_prep, ffn_prep_plain, args, eps)


def ffn_block_fused(
    x: torch.Tensor,
    shift: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    maa_k: torch.Tensor,
    maa_r: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wr: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole channel-mix block of one decode step: ln2 + token shift +
    mixes + key (F, C) + relu^2 + value (C, F) + receptance (C, C) + the
    sigmoid-gated residual. Weights in torch's (out, in) layout, used in x's
    dtype. Returns (x + ffn_out (B, C) in x's dtype, xn (B, C) fp32, the next
    ffn shift). CPU tensors take the plain version; CUDA tensors launch
    B.12 (one wrapper call, four kernels in stream order), for any B and C, F
    in multiples of 32."""
    args = (x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr)
    return _route(_launch_ffn_block, ffn_block_plain, args, eps)


att_prep_fused.launches = 0
ffn_prep_fused.launches = 0
ffn_block_fused.launches = 0
