"""Weight-only int8 quantization and the int8c projection.

Counterpart of rwkv_lm_ext_tpu/adapters/quant.py for the int8 and int8c
modes: ``quantize_int8`` (:76), ``dequantize_int8`` (:92), ``int8_matmul``
(:96, forward only: its custom_vjp waits for training) and
``quantize_model``, the counterpart of ``quantize_tree`` (:242) with the same
targets (att receptance/key/value/gate/output, ffn key/value/receptance,
optionally the head). The JAX package keeps quantized leaves as
QuantizedTensor pytree nodes that ``proj`` dispatches on; the port swaps
each target ``Linear`` for a ``QuantLinear`` module. nf4/fp4 wait.

Layout: the port keeps torch's (out, in) weight layout, so ``q`` is the
transpose of the JAX leaf's ``q`` and ``scale`` (out, 1) the transpose of
its (1, out).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows

MODES = ("int8", "int8c")
ATT_TARGETS = ("receptance", "key", "value", "gate", "output")
FFN_TARGETS = ("key", "value", "receptance")


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> int8 q (out, in) and fp32 scale (out, 1):
    absmax over the input axis per output channel, floor 1e-12, round half
    to even, clip to +-127, all in fp32. Both divisions are IEEE divisions
    on any device (PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal instead, hence the tensor divisor), as JAX computes
    quantize_tree eagerly."""
    wf = w.float()
    absmax = wf.abs().amax(1, keepdim=True)
    scale = (absmax / torch.full_like(absmax, 127.0)).clamp_min(1e-12)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact. On the GPU
    ``torch._int_mm`` takes more than 16 rows only, so decode-sized inputs
    are padded to 32 zero rows (a zero row quantizes to q = 0) and cut
    after."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ q.t().to(torch.int32)
    M = xq.shape[0]
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros(32 - M, xq.shape[1])])
    return torch._int_mm(xq, q.t())[:M]


def int8_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, dtype,
    *, quantize=quantize_rows,
) -> torch.Tensor:
    """x (..., K) @ W^T for an int8c weight (q (N, K), scale (N, 1)):
    per-row dynamic int8 quantization of x (``quantize``, kernel B.4 by
    default), an int8 x int8 -> int32 product, then the rescale in the
    order of ``_int8_mm_impl`` (adapters/quant.py:122-136): (y * sx) * scale,
    cast to ``dtype``."""
    lead = x.shape[:-1]
    xq, sx = quantize(x.reshape(-1, x.shape[-1]))
    y = int8_product(xq, q)
    out = (y.float() * sx) * scale.reshape(1, -1)
    return out.to(dtype).reshape(*lead, q.shape[0])


class QuantLinear(nn.Module):
    """A bias-free projection with an int8 weight: ``int8`` dequantizes on
    use, ``int8c`` runs ``int8_matmul`` with the route's quantizer
    (Ops.quantize_rows: the B.4 kernel, or its plain version on the
    reference route)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, mode: str):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown int8 mode {mode!r} (one of {MODES})")
        self.mode = mode
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    def forward(self, x: torch.Tensor, ops=None) -> torch.Tensor:
        if self.mode == "int8c":
            quantize = quantize_rows if ops is None else ops.quantize_rows
            return int8_matmul(x, self.q, self.scale, x.dtype, quantize=quantize)
        return F.linear(x, dequantize_int8(self.q, self.scale, x.dtype))


def quantize_model(
    model, mode: str, *, include_head: bool = False, weights: Optional[Dict] = None
):
    """Swap the model's target projections for QuantLinear, in place;
    returns the model. ``weights`` maps BlinkDL keys
    (``blocks.{i}.att.key.weight``, ...) to the values to quantize (tensors
    or numpy arrays), upcast to fp32 first: a checkpoint loader passes the
    checkpoint's own values, as the JAX package quantizes its fp32 params
    before any cast to the compute dtype. Without ``weights`` the module's
    current weights are quantized. Projections already quantized are
    left alone."""
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}: the port has {MODES}; nf4/fp4 wait")

    def swap(parent: nn.Module, name: str, key: str) -> None:
        lin = getattr(parent, name)
        if isinstance(lin, QuantLinear):
            return
        w = lin.weight if weights is None else weights[key]
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.asarray(w))
        with torch.no_grad():
            q, scale = quantize_int8(w.to(device=lin.weight.device, dtype=torch.float32))
        setattr(parent, name, QuantLinear(q, scale, mode))

    for i, block in enumerate(model.blocks):
        for name in ATT_TARGETS:
            swap(block.att, name, f"blocks.{i}.att.{name}.weight")
        for name in FFN_TARGETS:
            swap(block.ffn, name, f"blocks.{i}.ffn.{name}.weight")
    if include_head:
        swap(model, "head", "head.weight")
    return model
