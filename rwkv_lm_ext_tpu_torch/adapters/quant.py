"""Weight-only quantization (int8, int8c, nf4, fp4) and QLoRA's projections.

Counterpart of rwkv_lm_ext_tpu/adapters/quant.py: ``quantize_int8`` (:76),
``dequantize_int8`` (:92), ``int8_matmul`` (:96-167, with a backward of its
own, below), the 4-bit block codecs ``quantize_nf4`` / ``dequantize_nf4``
(:172-224) for both code tables (``NF4_CODE`` and ``FP4_CODE``, :50-73,
copied here), ``dequantize`` (:230), and ``quantize_model`` /
``dequantize_model``, the counterparts of ``quantize_tree`` (:242) and
``dequantize_tree`` (:292) with the same targets (att
receptance/key/value/gate/output, ffn key/value/receptance, optionally the
head). The JAX package keeps quantized leaves as QuantizedTensor pytree
nodes that ``proj`` dispatches on; the port swaps each target ``Linear`` for
a ``QuantLinear`` module. ``int8``, ``nf4`` and ``fp4`` dequantize on use, in
plain torch ops, as JAX computes them in XLA outside any Pallas kernel;
``int8c`` runs the B.4 row quantizer and an int8 product.

Layout: the port keeps torch's (out, in) weight layout. For int8 ``q`` is
the transpose of the JAX leaf's ``q`` and ``scale`` (out, 1) the transpose
of its (1, out). The 4-bit codecs cut the *flattened JAX (in, out) array*
into blocks of 64, so each block runs along the output axis: they quantize
``w.t()`` and keep JAX's packed bytes (n_blocks, 32) and scales (n_blocks,)
as they are, so that both hold the same codes.

``int8c`` under grad (QLoRA over an int8c base) is the autograd Function
``_Int8cMatmul``: its forward is ``int8_matmul`` on the detached input (B.4,
the int8 product and the rescale), its backward straight-through,
``dx = g @ dequantize_int8(q, scale)``: the gradient of the ``int8`` mode on
the same codes, the function that int8c's forward approximates. JAX's
``_int8_mm_bwd`` is instead the exact VJP of the dynamic-quantization
composition, through which ``round`` passes no gradient: its dx reaches x
only through each row's absmax, one entry a row (ROADMAP C.18). The frozen
weight gets no gradient.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.models.rwkv import Linear
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows

MODES = ("int8", "int8c", "nf4", "fp4")
ATT_TARGETS = ("receptance", "key", "value", "gate", "output")
FFN_TARGETS = ("key", "value", "receptance")
BLOCK = 64

# QLoRA NF4 codebook: quantiles of N(0, 1), normalized to [-1, 1]
NF4_CODE = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495,
    0.0, 0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], np.float32)

# bitsandbytes FP4 (e2m1) codebook, sign in bit 3, normalized to [-1, 1]
FP4_CODE = np.asarray([
    0.0, 0.0052083335, 0.6666667, 1.0,
    0.33333334, 0.5, 0.16666667, 0.25,
    -0.0, -0.0052083335, -0.6666667, -1.0,
    -0.33333334, -0.5, -0.16666667, -0.25,
], np.float32)

CODE4 = {"nf4": NF4_CODE, "fp4": FP4_CODE}
# blocks coded at once: bounds the (blocks, 64, 16) distance tensor to 256 MB
_CODE_CHUNK = 1 << 16


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


def quantize_4bit(w: torch.Tensor, fmt: str = "nf4", block: int = BLOCK):
    """(out, in) weight -> (packed uint8 (n_blocks, block // 2), fp32 scale
    (n_blocks,), pad): JAX's ``quantize_nf4(W, fmt=fmt)`` of the (in, out)
    leaf W = w.t(). Blocks of ``block`` consecutive values of the flattened
    (in, out) array (zero-padded at the end) share their absmax (floor
    1e-12); each value takes the code nearest to value / absmax (an IEEE
    division by a tensor), the first of two at equal distance as jnp.argmin
    does; two codes a byte, the even position in the low nibble."""
    if fmt not in CODE4:
        raise ValueError(f"unknown 4-bit format {fmt!r} (one of {tuple(CODE4)})")
    flat = w.detach().float().t().reshape(-1)
    pad = (-flat.numel()) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block)
    absmax = blocks.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    code = torch.from_numpy(CODE4[fmt]).to(blocks.device)
    idx = torch.cat([
        ((blocks[i:i + _CODE_CHUNK] / absmax[i:i + _CODE_CHUNK])[..., None] - code)
        .abs().argmin(-1).to(torch.uint8)
        for i in range(0, blocks.shape[0], _CODE_CHUNK)])
    return idx[:, 0::2] | (idx[:, 1::2] << 4), absmax[:, 0], pad


def dequantize_4bit(packed: torch.Tensor, scale: torch.Tensor, code: torch.Tensor, shape, pad: int,
                    dtype=torch.float32) -> torch.Tensor:
    """The (out, in) weight of ``quantize_4bit``'s codes: code * scale in
    fp32 (``dequantize_nf4``), cut to the (in, out) leaf, transposed, cast to
    ``dtype``. ``code`` is the format's table (16,) fp32 on packed's
    device."""
    idx = torch.stack([packed & 0xF, packed >> 4], -1).reshape(packed.shape[0], -1).long()
    flat = (code[idx] * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    n_out, n_in = shape
    return flat.reshape(n_in, n_out).t().to(dtype)


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
    cast to ``dtype``. No gradient: under grad QuantLinear takes
    ``_Int8cMatmul``."""
    lead = x.shape[:-1]
    xq, sx = quantize(x.reshape(-1, x.shape[-1]))
    y = int8_product(xq, q)
    out = (y.float() * sx) * scale.reshape(1, -1)
    return out.to(dtype).reshape(*lead, q.shape[0])


class _Int8cMatmul(torch.autograd.Function):
    """int8_matmul forward (B.4 on the detached input), straight-through
    backward: dx = g @ dequantize_int8(q, scale), in x's dtype (the module
    docstring, ROADMAP C.18)."""

    @staticmethod
    def forward(ctx, x, q, scale, quantize):
        ctx.save_for_backward(q, scale)
        return int8_matmul(x.detach(), q, scale, x.dtype, quantize=quantize)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        return g @ dequantize_int8(q, scale, g.dtype), None, None, None


class QuantLinear(nn.Module):
    """A bias-free projection with a quantized weight of logical shape
    ``shape`` (out, in): ``int8``, ``nf4`` and ``fp4`` dequantize on use;
    ``int8c`` runs ``int8_matmul`` with the route's quantizer
    (Ops.quantize_rows: the B.4 kernel, or its plain version on the
    reference route), through ``_Int8cMatmul`` when x needs a gradient. A
    4-bit weight keeps its code table as a buffer on its device, so that
    dequantizing copies nothing from the host (a CUDA-graph capture of the
    decode step refuses such a copy)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, mode: str,
                 shape: Optional[Tuple[int, int]] = None, pad: int = 0):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown quant mode {mode!r} (one of {MODES})")
        self.mode = mode
        self.shape = tuple(q.shape) if shape is None else tuple(shape)
        self.pad = pad
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        if mode in CODE4:
            self.register_buffer("code", torch.from_numpy(CODE4[mode]).to(q.device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """The (out, in) weight in ``dtype`` (``dequantize``)."""
        if self.mode in ("int8", "int8c"):
            return dequantize_int8(self.q, self.scale, dtype)
        return dequantize_4bit(self.q, self.scale, self.code, self.shape, self.pad, dtype)

    def forward(self, x: torch.Tensor, ops=None) -> torch.Tensor:
        if self.mode == "int8c":
            quantize = quantize_rows if ops is None else ops.quantize_rows
            if torch.is_grad_enabled() and x.requires_grad:
                return _Int8cMatmul.apply(x, self.q, self.scale, quantize)
            return int8_matmul(x, self.q, self.scale, x.dtype, quantize=quantize)
        return F.linear(x, self.dequantize(x.dtype))


def quantize_linear(w: torch.Tensor, mode: str) -> QuantLinear:
    """A QuantLinear of the (out, in) weight ``w`` (upcast to fp32 first)."""
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r} (one of {MODES})")
    with torch.no_grad():
        if mode in ("int8", "int8c"):
            q, scale = quantize_int8(w.float())
            return QuantLinear(q, scale, mode)
        packed, scale, pad = quantize_4bit(w, mode)
    return QuantLinear(packed, scale, mode, shape=tuple(w.shape), pad=pad)


def _targets(model, include_head: bool):
    """(parent module, attribute, BlinkDL weight key) of every target the
    model has (a v5.0 or v4 block has no gate, MishGLU only ``value``, a
    ``pre_ffn`` layer 0 no att), as quantize_tree skips absent leaves."""
    for i, block in enumerate(model.blocks):
        for part, names in (("att", ATT_TARGETS), ("ffn", FFN_TARGETS)):
            parent = getattr(block, part)
            for name in names:
                if isinstance(getattr(parent, name, None), nn.Module):
                    yield parent, name, f"blocks.{i}.{part}.{name}.weight"
    if include_head:
        yield model, "head", "head.weight"


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
        raise ValueError(f"unknown quant mode {mode!r} (one of {MODES})")
    for parent, name, key in _targets(model, include_head):
        lin = getattr(parent, name)
        if isinstance(lin, QuantLinear):
            continue
        w = lin.weight if weights is None else weights[key]
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.asarray(w))
        setattr(parent, name, quantize_linear(w.to(device=lin.weight.device, dtype=torch.float32),
                                              mode))
    return model


def dequantize_model(model, dtype=torch.float32):
    """``dequantize_tree``: every QuantLinear of the model (the targets and
    the head) becomes a dense Linear holding its dequantized weight in
    ``dtype``, frozen; in place, returns the model."""
    for parent, name, _ in _targets(model, include_head=True):
        lin = getattr(parent, name)
        if isinstance(lin, QuantLinear):
            plain = Linear.__new__(Linear)
            nn.Module.__init__(plain)
            plain.weight = nn.Parameter(lin.dequantize(dtype), requires_grad=False)
            setattr(parent, name, plain)
    return model
