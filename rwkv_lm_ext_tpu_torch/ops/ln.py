"""LayerNorm: kernel K3 (csrc/ln.cu) and its plain version.

Counterpart of rwkv_lm_ext_tpu/ops/ln_pallas.py: ``layer_norm`` is
``layer_norm_pallas`` (:74, the Pallas kernel ``_ln_kernel`` at :21) and
``layer_norm_plain`` is the two-pass jnp composition ``_ln_ref`` (:33).
Used for ln0, ln2 and ln_out on the model's main path.
"""
from __future__ import annotations

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis of (..., C) with fp32 statistics; the
    output has x's dtype. CPU tensors take the plain version; CUDA tensors
    launch K3, for any shape."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"scale/bias must be ({C},), got {scale.shape}, {bias.shape}")
    scale = scale.to(x.dtype).contiguous()
    bias = bias.to(x.dtype).contiguous()
    device = _lib.check_cuda(x=x, scale=scale, bias=bias)
    y = torch.empty_like(x)
    _lib.launch(
        "rwkv_layer_norm", device, x, scale, bias, y,
        x.numel() // max(C, 1), C, eps, _lib.DTYPE_CODES[x.dtype],
    )
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
