"""Per-row int8 activation quantization: kernel B.4 (csrc/quant.cu) and its
plain version.

Counterpart of rwkv_lm_ext_tpu/ops/quant_pallas.py: ``quantize_rows`` (:67,
the Pallas kernel ``_quant_kernel`` at :29) and, as the plain version,
``quantize_rows_xla`` (:37) as XLA compiles it under jit: the division of
the row absmax by the constant 127 becomes a multiply by the fp32
reciprocal (``INV_127``), in the Pallas kernel too, while ``x / sx`` stays
an IEEE division. The kernel and the plain version are bit-identical.

``quantize_rows_given`` is B.4's second entry: the same codes for row
scales given by the caller (q = rint(x / sx), no absmax pass), the half of
the quantizer that a tensor-parallel row-parallel projection runs on its
slice of each row once the ranks agree on the row's scale
(parallel/tp.py). Its plain version is ``quantize_rows_given_plain``; with
sx from ``quantize_rows`` on the whole row the two entries give the same
q.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

INV_127 = float(np.float32(1.0 / 127.0))


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    sx = (xf.abs().amax(-1, keepdim=True) * INV_127).clamp_min(1e-12)
    return torch.round(xf / sx).to(torch.int8), sx


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C) -> int8 (..., C) and fp32 row scales (..., 1), with
    ``x ~= q * s``. CPU tensors take the plain version; CUDA tensors launch
    B.4, for any row count and any C, in fp32 or bf16. B.4 has no backward
    (its outputs are integers and a row scale): QLoRA over an int8c base
    reaches it through ``adapters.quant._Int8cMatmul``, which quantizes the
    detached input and gives the product a straight-through backward. On
    the CUDA route an input that requires grad, with grad mode on, raises
    instead of giving outputs detached from the graph."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if _lib.needs_grad(x):
        raise RuntimeError(
            "quantize_rows (B.4) has no backward on the CUDA route: run it under "
            "torch.no_grad() or torch.inference_mode(), or on an input that needs no grad "
            "(an int8c projection under grad goes through adapters.quant.QuantLinear)"
        )
    C = x.shape[-1]
    device = _lib.check_cuda(x=x)
    q = torch.empty(x.shape, dtype=torch.int8, device=device)
    s = torch.empty(*x.shape[:-1], 1, dtype=torch.float32, device=device)
    _lib.launch(
        "rwkv_quantize_rows", device, x, q, s, x.numel() // max(C, 1), C,
        _lib.DTYPE_CODES[x.dtype],
    )
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0


def quantize_rows_given_plain(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    return torch.round(x.float() / sx).to(torch.int8)


def quantize_rows_given(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """(..., C) and fp32 row scales (..., 1) -> int8 (..., C), q =
    rint(x / sx) with an IEEE division, half to even, as ``quantize_rows``
    computes it after its absmax pass. CPU tensors take the plain version;
    CUDA tensors launch B.4's given-scale entry (any row count and C, fp32
    or bf16). No backward, as for ``quantize_rows``."""
    if sx.shape != (*x.shape[:-1], 1):
        raise ValueError(f"sx must be {(*x.shape[:-1], 1)}, got {tuple(sx.shape)}")
    if sx.dtype != torch.float32:
        raise TypeError(f"sx must be fp32, not {sx.dtype}")
    if x.device.type == "cpu":
        return quantize_rows_given_plain(x, sx)
    if _lib.needs_grad(x):
        raise RuntimeError("quantize_rows_given (B.4) has no backward on the CUDA route: run it "
                           "under torch.no_grad() or torch.inference_mode()")
    C = x.shape[-1]
    device = _lib.check_cuda(x=x, sx=sx)
    q = torch.empty(x.shape, dtype=torch.int8, device=device)
    _lib.launch("rwkv_quantize_rows_given", device, x, q, sx, x.numel() // max(C, 1), C,
                _lib.DTYPE_CODES[x.dtype])
    quantize_rows_given.launches += 1
    return q


quantize_rows_given.launches = 0
