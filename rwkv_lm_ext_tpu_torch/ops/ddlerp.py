"""RWKV-6 time-mix prologue (ln1 + token shift + ddlerp): kernel K2
(csrc/ddlerp.cu) and its plain version, forward only.

Counterpart of rwkv_lm_ext_tpu/ops/ddlerp_pallas.py: ``tmix_prologue``
(:387, the Pallas kernel ``_prologue_kernel`` at :35) and, as the plain
version, ``_prologue_ref`` (:87).
"""
from __future__ import annotations

from typing import Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib


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
    tensors launch K2, for any T and any D divisible by 8."""
    if x.device.type == "cpu":
        return tmix_prologue_plain(x, shift_ln, ln_scale, ln_bias, maa, w1, w2, eps=eps)
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
    shift_ln, ln_scale, ln_bias, maa, w1, w2 = (
        t.to(dt).contiguous() for t in (shift_ln, ln_scale, ln_bias, maa, w1, w2)
    )
    device = _lib.check_cuda(
        x=x, shift_ln=shift_ln, ln_scale=ln_scale, ln_bias=ln_bias, maa=maa,
        w1=w1, w2=w2,
    )
    lib = _lib.library()
    smem = lib.rwkv_tmix_prologue_smem_bytes(C, D)
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"C={C}, D={D} needs {smem} B of shared memory; the card allows {limit}")
    out = torch.empty(6, B, T, C, dtype=dt, device=device)
    _lib.launch(
        "rwkv_tmix_prologue", device, x, shift_ln, ln_scale, ln_bias, maa,
        w1, w2, out, B, T, C, D, eps, _lib.DTYPE_CODES[dt],
    )
    tmix_prologue.launches += 1
    return tuple(out.unbind(0))


tmix_prologue.launches = 0
