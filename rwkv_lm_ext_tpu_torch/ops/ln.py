"""LayerNorm: kernel K3 (csrc/ln.cu) and its plain version.

Counterpart of rwkv_lm_ext_tpu/ops/ln_pallas.py: ``layer_norm`` is
``layer_norm_pallas`` (:74, the Pallas kernel ``_ln_kernel`` at :21) and
``layer_norm_plain`` is the two-pass jnp composition ``_ln_ref`` (:33).
Used for ln0, ln2 and ln_out on the model's main path.

The backward is not a kernel, in the JAX package either: its custom_vjp
(:42-71) re-derives the gradient through the jnp composition, and
``_LayerNorm`` here recomputes through ``layer_norm_plain``'s torch ops.
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


def _launch_k3(x, scale, bias, eps):
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


class _LayerNorm(torch.autograd.Function):
    """K3 forward; the backward recomputes layer_norm_plain and
    differentiates it, as ``layer_norm_pallas``'s custom_vjp does."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias)
        return _launch_k3(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            y = layer_norm_plain(*leaves, ctx.eps)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if n else None for n in need) + (None,)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis of (..., C) with fp32 statistics; the
    output has x's dtype. CPU tensors take the plain version; CUDA tensors
    launch K3, for any shape, differentiable when an input requires grad."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if _lib.needs_grad(x, scale, bias):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _launch_k3(x, scale, bias, eps)


layer_norm.launches = 0
