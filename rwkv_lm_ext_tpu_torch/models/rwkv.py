"""RWKV-6, RWKV-5.x and RWKV-4 forward passes as PyTorch modules.

Counterpart of rwkv_lm_ext_tpu/models/rwkv.py: ``Linear`` is ``proj`` for
dense weights (:188-216), ``ln*`` modules are ``layer_norm`` (:218), the
GroupNorm ``group_norm`` (:237) and token shift ``_token_shift`` (:248) live
inside kernels K1 and K2, ``TimeMix`` is ``time_mix_v6_fused`` (:426-493),
``ChannelMix`` is ``channel_mix`` (:575-594, v6), ``Block`` is
``block_forward`` (:635-725, v6 with the relu^2 channel mix) and ``RWKV`` is
``rwkv_forward`` (:728-878: hidden and/or logits, state in and out).

Parameter names are the BlinkDL flat keys (``blocks.{i}.att.time_maa_x``,
``blocks.{i}.att.receptance.weight``, ...) with their shapes, so a real
``.pth`` loads with checkpoint.convert.load_state_dict_into.

There is one route, the fused one: ln1 + token shift + ddlerp in K2, the
r/k/v/g/output projections and the fp32 decay low-rank as matrix products,
WKV + GroupNorm + gate in K1, and LayerNorm in K3. A projection is a
``Linear`` or, after adapters.quant.quantize_model, a ``QuantLinear``
(int8 dequantized on use, or int8c through the B.4 quantizer and an int8
product). Plain T=1 calls take the decode step (models/decode.py), which
swaps K1 for the decode kernel B.9, as ``rwkv_forward`` routes them
(:777-800); its opt-in ``fused_prep`` route runs ``TimeMix.step_fused`` and
``ChannelMix.step_fused`` (kernels B.10-B.12). On CPU tensors every kernel wrapper runs its plain version.
``reference=True`` runs the plain versions on any device: it is the on-card
reference that the kernels are checked against, not a serving path.

Other families and options (``RWKV`` dispatches on ``cfg.version`` as
``rwkv_forward`` does, :759-765). RWKV-5.x: ``TimeMixV5`` is ``time_mix_v5``
(:496-572), fed ln1's output by K3, its static lerps, projections and K1 with
the constant decay broadcast over (B, T) and a ones gate where the block has
none (v5.0); its T=1 step swaps K1 for B.9. RWKV-4: ``models/rwkv4.py``
(``TimeMixV4`` and the forward and step around the ``wkv4`` kernel B.14). Both
use ``ChannelMixLegacy``, ``channel_mix(v6=False)`` (:575-594). The legacy
RWKV-LM options are plain torch ops, as in the JAX package: ``MishGLU``
(:597-611, ``ffn_type="mishglu"``), tiny attention (:614-627, after the
channel mix of layer ``tiny_att_layer`` over the call's embeddings),
``pre_ffn`` (layer 0's attention replaced by the channel mix ``ffnPre``,
which reuses the att shift slot, :675-679), ``my_pos_emb`` (added after ln0,
:661-668) and ``head_qk`` (the copy mechanism on the logits, :866-874).
Their weights take the reference's keys (``blocks.{i}.tiny_q.weight``,
``blocks.0.pos_emb_x``, ``blocks.0.ffnPre.*``, ``blocks.{i}.ffn.aa.weight``,
``head_q.weight``, ...); under ``pre_ffn`` layer 0 has no ``att``, as in the
reference. Tiny attention, ``head_qk`` and ``my_pos_emb`` see only the tokens
of the call, so their answers depend on how a prompt is cut into calls
(ROADMAP C.21): the serving entry points refuse them.

Precision: weights and activations in cfg.dtype; LayerNorm/GroupNorm
statistics, the WKV state and the decay low-rank in fp32. The parameters
are stored in cfg.param_dtype, cfg.dtype unless told otherwise. With fp32
master weights (param_dtype="float32" under bf16 compute, what the
full-parameter encoder trainers hold) every use casts to the compute dtype,
as ``as_weight`` does (rwkv_lm_ext_tpu/models/rwkv.py:27); when the two are
equal the cast returns the parameter itself and launches nothing.

``TimeMix.projections`` and ``TimeMix.gn_output`` are the two halves of the time
mix as plain torch ops (``tmix_v6_projections`` :260 and ``tmix_v6_output``
:300, outside any Pallas kernel in the JAX package too); the bidirectional
encoders (models/bidirectional.py) put the unfused WKV between them.

Training (train/): the kernel wrappers are autograd Functions whenever an
input requires grad, so a loss differentiates through K1-K3 (backward
kernels B.5-B.7). ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, the counterpart of ``remat_wrap``,
utils/remat.py), and ``remat="dots"`` or ``"dots_nobatch"`` keeps the
matrix products' outputs and recomputes the rest; ``use_state_params=True`` feeds each layer's learnable
``att.time_state`` (H, N, N) fp32, added by ``add_state_params``, as the WKV
initial state of every sequence (state tuning,
rwkv_lm_ext_tpu/models/rwkv.py:471-476; an RWKV-6 feature, as JAX's
``block_forward`` passes the override to the v6 time mix alone). Dropout
(``_dropout``, :630) is a ``Dropout`` handed to the forward, at JAX's three
sites: the embeddings (:807-809), and each block's attention and channel-mix
outputs before they join the residual (:671-672, :705, :716). Its masks come
from an explicit ``torch.Generator`` on the model's device through
``Dropout.keep``, which a caller may replace (``mask_fn``) with masks of its
own; a block's masks are drawn before the block runs, so a rematerialized
block recomputes with the same ones. RWKV-4's forward takes none, as JAX's
``rwkv4_forward`` takes none.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.models.state import ModelState, init_model_state
from rwkv_lm_ext_tpu_torch.ops.ddlerp import tmix_prologue, tmix_prologue_plain
from rwkv_lm_ext_tpu_torch.ops.decode_fused import (
    att_prep_fused,
    att_prep_plain,
    ffn_block_fused,
    ffn_block_plain,
    ffn_prep_fused,
    ffn_prep_plain,
)
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.quant import (
    quantize_rows,
    quantize_rows_given,
    quantize_rows_given_plain,
    quantize_rows_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv4 import wkv4, wkv4_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_collect import wkv6_collect, wkv6_collect_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import (
    wkv6_decode_step,
    wkv6_decode_step_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    wkv6_fused_output,
    wkv6_fused_output_plain,
)
from rwkv_lm_ext_tpu_torch.utils.remat import remat_call


class Ops(NamedTuple):
    layer_norm: object
    tmix_prologue: object
    wkv6_fused_output: object
    wkv6_decode_step: object
    quantize_rows: object
    att_prep: object
    ffn_prep: object
    ffn_block: object
    wkv4: object
    wkv6_collect: object
    quantize_rows_given: object


KERNEL_OPS = Ops(
    layer_norm, tmix_prologue, wkv6_fused_output, wkv6_decode_step, quantize_rows,
    att_prep_fused, ffn_prep_fused, ffn_block_fused, wkv4, wkv6_collect, quantize_rows_given,
)
PLAIN_OPS = Ops(
    layer_norm_plain, tmix_prologue_plain, wkv6_fused_output_plain,
    wkv6_decode_step_plain, quantize_rows_plain,
    att_prep_plain, ffn_prep_plain, ffn_block_plain, wkv4_plain, wkv6_collect_plain,
    quantize_rows_given_plain,
)

LayerState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _param(*shape, device, dtype) -> nn.Parameter:
    # values come from models.init or a checkpoint
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class Dropout:
    """JAX's ``_dropout`` (rwkv_lm_ext_tpu/models/rwkv.py:630-632) at rate
    ``rate``: ``where(keep, x / (1 - rate), 0)`` in x's dtype, keep drawn
    with probability 1 - rate. ``keep(site, layer, shape, device)`` makes the
    mask of one site ("emb"; "att" or "ffn" of layer ``layer``) from
    ``generator`` (on the model's device), or asks ``mask_fn(site, layer,
    shape)`` for it when given (a test hands in JAX's masks that way)."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None,
                 mask_fn: Optional[Callable] = None):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1)")
        if generator is None and mask_fn is None:
            raise ValueError("Dropout needs a generator or a mask_fn")
        self.rate, self.generator, self.mask_fn = rate, generator, mask_fn

    def keep(self, site: str, layer: Optional[int], shape, device) -> torch.Tensor:
        if self.mask_fn is not None:
            return torch.as_tensor(self.mask_fn(site, layer, tuple(shape)), device=device)
        return torch.rand(shape, generator=self.generator, device=device) < (1.0 - self.rate)

    def rows(self, rank: int, n: int) -> "Dropout":
        """This dropout on rank ``rank`` of ``n`` data-parallel ranks that
        each hold an equal share of the global batch's rows: every mask is
        drawn for the global batch (n times the rows, from the same generator
        in the same order as one process draws it) and the rank keeps its
        rows, so a row's masks do not depend on n."""
        if n == 1:
            return self

        def mask_fn(site, layer, shape):
            b = shape[0]
            device = self.generator.device if self.generator is not None else "cpu"
            full = self.keep(site, layer, (b * n,) + tuple(shape[1:]), device)
            return full[rank * b:(rank + 1) * b]

        return Dropout(self.rate, mask_fn=mask_fn)

    def block_masks(self, layer: int, shape, device) -> Optional[tuple]:
        """(rate, attention keep, channel-mix keep) for layer ``layer``, or
        None at rate 0."""
        if self.rate == 0:
            return None
        return (self.rate, self.keep("att", layer, shape, device),
                self.keep("ffn", layer, shape, device))


def drop(x: torch.Tensor, rate: float, keep: torch.Tensor) -> torch.Tensor:
    """``_dropout`` with the mask given."""
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class Linear(nn.Module):
    """Bias-free projection with a torch-layout (out, in) weight. Like
    adapters.quant.QuantLinear it takes the route's Ops, which a dense
    product does not need."""

    def __init__(self, n_in: int, n_out: int, **kw):
        super().__init__()
        self.weight = _param(n_out, n_in, **kw)

    def forward(self, x: torch.Tensor, ops: Optional[Ops] = None) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype))


class Norm(nn.Module):
    """weight/bias of a LayerNorm or of the ln_x GroupNorm."""

    def __init__(self, C: int, **kw):
        super().__init__()
        self.weight = _param(C, **kw)
        self.bias = _param(C, **kw)


class TimeMix(nn.Module):
    """blocks.{i}.att: RWKV-6 time mix, fed the RAW residual stream (the
    prologue kernel owns ln1)."""

    def __init__(self, cfg, **kw):
        super().__init__()
        C, A = cfg.n_embd, cfg.dim_att
        H, N = cfg.n_head, cfg.head_size
        Dm, Dd = cfg.time_mix_extra_dim, cfg.time_decay_extra_dim
        self.cfg = cfg
        for name in ("x", "w", "k", "v", "r", "g"):
            setattr(self, f"time_maa_{name}", _param(1, 1, C, **kw))
        self.time_maa_w1 = _param(C, 5 * Dm, **kw)
        self.time_maa_w2 = _param(5, Dm, C, **kw)
        self.time_decay = _param(1, 1, A, **kw)
        self.time_decay_w1 = _param(C, Dd, **kw)
        self.time_decay_w2 = _param(Dd, A, **kw)
        self.time_faaaa = _param(H, N, **kw)
        self.receptance = Linear(C, A, **kw)
        self.key = Linear(C, A, **kw)
        self.value = Linear(C, A, **kw)
        self.gate = Linear(C, A, **kw)
        self.output = Linear(A, C, **kw)
        self.ln_x = Norm(A, **kw)
        # state tuning's learnable initial WKV state, added by
        # RWKV.add_state_params
        self.register_parameter("time_state", None)

    # tensor-parallel training (parallel.tp.shard_for_training): the
    # conjugate collective before the column-parallel decay product
    tp_copy = None

    def _maas(self) -> torch.Tensor:
        """(6, C) stacked [maa_x, maa_w, maa_k, maa_v, maa_r, maa_g]."""
        return torch.cat([
            self.time_maa_x, self.time_maa_w, self.time_maa_k,
            self.time_maa_v, self.time_maa_r, self.time_maa_g,
        ]).reshape(6, -1)

    def _mix(self, x: torch.Tensor, ln1: Norm, att_shift: torch.Tensor, ops: Ops):
        """K2, the r/k/v/g projections and the fp32 decay: (r, k, v, g) of
        shape (B, T, A) in x's dtype, w (B, T, A) fp32 and the ln1 output."""
        dt = x.dtype
        maa = self._maas()
        xw, xk, xv, xr, xg, xln = ops.tmix_prologue(
            x, att_shift.to(dt), ln1.weight, ln1.bias, maa,
            self.time_maa_w1, self.time_maa_w2, eps=1e-5,
        )
        r = self.receptance(xr, ops)
        k = self.key(xk, ops)
        v = self.value(xv, ops)
        g = F.silu(self.gate(xg, ops))
        # data-dependent decay in fp32: it feeds exp(-exp(w))
        ww = torch.tanh(xw.float() @ self.time_decay_w1.float())
        if self.tp_copy is not None:
            ww = self.tp_copy(ww)
        w = self.time_decay.float().reshape(-1) + ww @ self.time_decay_w2.float()
        return r, k, v, g, w, xln

    def projections(self, x: torch.Tensor, att_shift: torch.Tensor):
        """The ddlerp and projection half in plain torch ops: x (B, T, C) is
        already ln1's output, att_shift (B, C) the previous token's. Returns
        r, k, v, g (B, T, A) in x's dtype and the fp32 decay w (B, T, A)."""
        B, T, _ = x.shape
        dt = x.dtype
        prev = torch.cat([att_shift.to(dt)[:, None], x[:, :-1]], dim=1)
        xx = prev - x
        xxx = x + xx * self.time_maa_x.to(dt)
        m = torch.tanh(xxx @ self.time_maa_w1.to(dt)).reshape(B, T, 5, -1)
        mw, mk, mv, mr, mg = torch.einsum("btfd,fdc->fbtc", m, self.time_maa_w2.to(dt))
        xw = x + xx * (self.time_maa_w.to(dt) + mw)
        xk = x + xx * (self.time_maa_k.to(dt) + mk)
        xv = x + xx * (self.time_maa_v.to(dt) + mv)
        xr = x + xx * (self.time_maa_r.to(dt) + mr)
        xg = x + xx * (self.time_maa_g.to(dt) + mg)
        r, k, v = self.receptance(xr), self.key(xk), self.value(xv)
        g = F.silu(self.gate(xg))
        # data-dependent decay in fp32: it feeds exp(-exp(w))
        ww = torch.tanh(xw.float() @ self.time_decay_w1.float())
        w = self.time_decay.float() + ww @ self.time_decay_w2.float()
        return r, k, v, g, w

    def gn_output(self, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """GroupNorm(ln_x) per head with fp32 statistics, the gate and the
        output projection: y (B, T, A) is cast to g's dtype first."""
        dt = g.dtype
        H, N = self.cfg.n_head, self.cfg.head_size
        yf = y.to(dt).float().unflatten(-1, (H, N))
        mu = yf.mean(-1, keepdim=True)
        var = yf.var(-1, unbiased=False, keepdim=True)
        yn = ((yf - mu) * torch.rsqrt(var + self.cfg.ln_x_eps)).flatten(-2)
        yn = (yn * self.ln_x.weight.float() + self.ln_x.bias.float()).to(dt)
        return self.output(yn * g)

    def forward(
        self, x: torch.Tensor, ln1: Norm, att_shift: torch.Tensor,
        wkv_state: torch.Tensor, ops: Ops, use_state_params: bool = False,
        collect: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, C) raw residual stream; att_shift: (B, C) fp32, the
        previous token's ln1 output; wkv_state: (B, H, N, N) fp32, replaced
        by ``time_state`` (shared by every sequence) with use_state_params;
        ``collect``: see ``_wkv_output``. Returns (out (B, T, C), new
        att_shift, new wkv_state)."""
        B, T, _ = x.shape
        H, N = self.cfg.n_head, self.cfg.head_size
        r, k, v, g, w, xln = self._mix(x, ln1, att_shift, ops)
        if use_state_params:
            if self.time_state is None:
                raise ValueError("use_state_params needs RWKV.add_state_params() first")
            wkv_state = self.time_state
        gated, new_wkv = _wkv_output(self, ops, r, k, v, w.view(B, T, H, N), g, wkv_state, xln,
                                     collect)
        return self.output(gated, ops), _last(xln), new_wkv

    def step(
        self, x: torch.Tensor, ln1: Norm, att_shift: torch.Tensor,
        wkv_state: torch.Tensor, out_wkv: torch.Tensor, ops: Ops,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token: x (B, 1, C). The decode kernel takes K1's place and
        writes the new WKV state into ``out_wkv``, which may be
        ``wkv_state`` itself. Returns (out (B, 1, C), new att_shift)."""
        B = x.shape[0]
        r, k, v, g, w, xln = self._mix(x, ln1, att_shift, ops)
        gated, _ = ops.wkv6_decode_step(
            r.view(B, -1), k.view(B, -1), v.view(B, -1), w.view(B, -1),
            g.view(B, -1), self.time_faaaa, self.ln_x.weight, self.ln_x.bias,
            wkv_state, eps=self.cfg.ln_x_eps, out_state=out_wkv,
        )
        return self.output(gated.view(B, 1, -1), ops), xln[:, -1].float()

    def step_fused(
        self, x: torch.Tensor, ln1: Norm, att_shift: torch.Tensor,
        wkv_state: torch.Tensor, out_wkv: torch.Tensor, ops: Ops,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``step`` with the fused prologue (``_att_step_fused``,
        rwkv_lm_ext_tpu/models/decode.py:65-107): x (B, C). Kernel B.10 does
        ln1 + shift + ddlerp + the decay low-rank in one call; the four
        projections, the decode kernel and the output projection stay as in
        ``step``. Returns (out (B, C), new att_shift: the unrounded fp32 ln1
        row). B.10 returns the decay as (B, n_embd), so the route needs
        dim_att == n_embd (as the JAX kernel does) and refuses any other
        model by name."""
        if self.cfg.dim_att != self.cfg.n_embd:
            raise ValueError(
                f"fused_prep needs dim_att == n_embd: the fused attention prologue makes the "
                f"decay over n_embd channels; this model has dim_att={self.cfg.dim_att}, "
                f"n_embd={self.cfg.n_embd} (the unfused step takes it)"
            )
        xr, xk, xv, xg, w, xn = ops.att_prep(
            x, att_shift, ln1.weight, ln1.bias, self._maas(),
            self.time_maa_w1, self.time_maa_w2, self.time_decay_w1, self.time_decay_w2,
            self.time_decay, 1e-5,
        )
        r = self.receptance(xr, ops)
        k = self.key(xk, ops)
        v = self.value(xv, ops)
        g = F.silu(self.gate(xg, ops))
        gated, _ = ops.wkv6_decode_step(
            r, k, v, w, g, self.time_faaaa, self.ln_x.weight, self.ln_x.bias,
            wkv_state, eps=self.cfg.ln_x_eps, out_state=out_wkv,
        )
        return self.output(gated, ops), xn


class ChannelMix(nn.Module):
    """blocks.{i}.ffn: RWKV-6 channel mix with the relu^2 key."""

    def __init__(self, cfg, **kw):
        super().__init__()
        C, F_ = cfg.n_embd, cfg.dim_ffn
        self.time_maa_k = _param(1, 1, C, **kw)
        self.time_maa_r = _param(1, 1, C, **kw)
        self.key = Linear(C, F_, **kw)
        self.receptance = Linear(C, C, **kw)
        self.value = Linear(F_, C, **kw)

    def forward(
        self, x: torch.Tensor, ffn_shift: torch.Tensor, ops: Ops
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, C), the ln2 output. Returns (out, new ffn_shift)."""
        prev = torch.cat([ffn_shift.to(x.dtype)[:, None], x[:, :-1]], dim=1)
        xx = prev - x
        xk = x + xx * self.time_maa_k.to(x.dtype)
        xr = x + xx * self.time_maa_r.to(x.dtype)
        kv = self.value(torch.relu(self.key(xk, ops)) ** 2, ops)
        return torch.sigmoid(self.receptance(xr, ops)) * kv, _last(x)

    def step_fused(
        self, x: torch.Tensor, ln2: Norm, ffn_shift: torch.Tensor, ops: Ops
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token with the fused prologue (``_ffn_step_fused``,
        rwkv_lm_ext_tpu/models/decode.py:110-145): x (B, C) is the RAW
        residual stream and the residual is folded in. Dense projections take
        the whole-block kernel B.12; any other leaf (quantized, LoRA) takes
        the prologue kernel B.11 and its own projections. Returns
        (x + ffn_out (B, C), new ffn_shift in fp32)."""
        vectors = (ffn_shift, ln2.weight, ln2.bias, self.time_maa_k, self.time_maa_r)
        if all(type(m) is Linear for m in (self.key, self.value, self.receptance)):
            dt = x.dtype
            return ops.ffn_block(
                x, *vectors, self.key.weight.to(dt), self.value.weight.to(dt),
                self.receptance.weight.to(dt), 1e-5,
            )
        xk, xr, xn = ops.ffn_prep(x, *vectors, 1e-5)
        kv = self.value(torch.relu(self.key(xk, ops)) ** 2, ops)
        return x + torch.sigmoid(self.receptance(xr, ops)) * kv, xn


def _wkv_output(att, ops: Ops, r, k, v, w, g, wkv_state, xln, collect: Optional[dict]):
    """The WKV, GroupNorm(ln_x) and gate of an RWKV-5/6 time mix: r, k, v, g
    (B, T, A), w (B, T, H, N). K1, or with ``collect`` (models.collect: this
    layer's slices {att_shift: (T, B, C), wkv: (T, B, H, N, N)} of the
    verify pass's fp32 stacks) B.15, which writes the WKV state after every
    position into collect["wkv"]; ln1's output ``xln`` is then the att
    shift after every position. Returns (gated (B, T, A), new wkv_state)."""
    B, T, _ = r.shape
    heads = (B, T, att.cfg.n_head, att.cfg.head_size)
    args = (r.view(heads), k.view(heads), v.view(heads), w, att.time_faaaa, g.view(heads),
            att.ln_x.weight, att.ln_x.bias, wkv_state)
    if collect is None:
        return ops.wkv6_fused_output(*args, eps=att.cfg.ln_x_eps)
    collect["att_shift"].copy_(xln.transpose(0, 1))
    gated, states = ops.wkv6_collect(*args, eps=att.cfg.ln_x_eps, out_states=collect["wkv"])
    return gated, states[-1]


def _last(x: torch.Tensor) -> torch.Tensor:
    """x[:, -1] in fp32, always a copy: the new shift state. A view of an
    fp32 x would hold every layer's whole (B, T, C) activation until the
    forward returns."""
    return x[:, -1].to(torch.float32, copy=True)


def _prev(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The previous-token stream [shift, x[0], ..., x[T-2]] (``_token_shift``)."""
    return torch.cat([shift.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _lerp(x: torch.Tensor, prev: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """The static token mix of RWKV-4/5: x * mix + prev * (1 - mix)."""
    m = mix.to(x.dtype)
    return x * m + prev * (1 - m)


class TimeMixV5(nn.Module):
    """blocks.{i}.att of RWKV-5.x (``time_mix_v5``), fed ln1's output. v5.0
    has no gate (K1 and B.9 get ones); ``time_decay`` is (H, N), the per-head
    (H,) decay of a v5.0/5.1 checkpoint broadcast when it is loaded
    (checkpoint.convert.load_state_dict_into), as the JAX converter does."""

    def __init__(self, cfg, **kw):
        super().__init__()
        C, A = cfg.n_embd, cfg.dim_att
        H, N = cfg.n_head, cfg.head_size
        self.cfg = cfg
        has_gate = cfg.version >= 5.1
        for name in ("k", "v", "r", "g") if has_gate else ("k", "v", "r"):
            setattr(self, f"time_mix_{name}", _param(1, 1, C, **kw))
        self.time_decay = _param(H, N, **kw)
        self.time_faaaa = _param(H, N, **kw)
        self.receptance = Linear(C, A, **kw)
        self.key = Linear(C, A, **kw)
        self.value = Linear(C, A, **kw)
        self.gate = Linear(C, A, **kw) if has_gate else None
        self.output = Linear(A, C, **kw)
        self.ln_x = Norm(A, **kw)

    def _mix(self, x: torch.Tensor, att_shift: torch.Tensor, ops: Ops):
        """r, k, v and the gate (silu, or ones without one), (B, T, A) in
        x's dtype."""
        prev = _prev(x, att_shift)
        r = self.receptance(_lerp(x, prev, self.time_mix_r), ops)
        k = self.key(_lerp(x, prev, self.time_mix_k), ops)
        v = self.value(_lerp(x, prev, self.time_mix_v), ops)
        if self.gate is None:
            g = torch.ones_like(r)
        else:
            g = F.silu(self.gate(_lerp(x, prev, self.time_mix_g), ops))
        return r, k, v, g

    def forward(
        self, x: torch.Tensor, att_shift: torch.Tensor, wkv_state: torch.Tensor, ops: Ops,
        collect: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, C), ln1's output; att_shift (B, C) fp32; wkv_state (B, H,
        N, N) fp32; ``collect``: see ``_wkv_output``. K1 runs with the decay
        broadcast to (B, T, H, N) and ``cfg.ln_x_eps`` on the raw y:
        GroupNorm(y / d, 1e-5) is GroupNorm(y, d^2 1e-5), the identity the JAX
        package's Pallas branch relies on (rwkv.py:535-536). Returns (out,
        new att_shift, new wkv_state)."""
        B, T, _ = x.shape
        H, N = self.cfg.n_head, self.cfg.head_size
        r, k, v, g = self._mix(x, att_shift, ops)
        w = self.time_decay.float().reshape(1, 1, H, N).expand(B, T, H, N)
        gated, new_wkv = _wkv_output(self, ops, r, k, v, w, g, wkv_state, x, collect)
        return self.output(gated, ops), _last(x), new_wkv

    def step(
        self, x: torch.Tensor, att_shift: torch.Tensor, wkv_state: torch.Tensor,
        out_wkv: torch.Tensor, ops: Ops,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token: x (B, 1, C), ln1's output. B.9 takes K1's place with the
        decay broadcast to (B, A) and writes the new state into ``out_wkv``
        (which may be ``wkv_state``). Returns (out (B, 1, C), new att_shift)."""
        B = x.shape[0]
        r, k, v, g = self._mix(x, att_shift, ops)
        w = self.time_decay.float().reshape(1, -1).expand(B, -1).contiguous()
        gated, _ = ops.wkv6_decode_step(
            r.view(B, -1), k.view(B, -1), v.view(B, -1), w, g.view(B, -1), self.time_faaaa,
            self.ln_x.weight, self.ln_x.bias, wkv_state, eps=self.cfg.ln_x_eps,
            out_state=out_wkv,
        )
        return self.output(gated.view(B, 1, -1), ops), x[:, -1].float()


class ChannelMixLegacy(nn.Module):
    """blocks.{i}.ffn of RWKV-4/5 (and ``ffnPre``): the channel mix with
    static lerps, ``channel_mix(v6=False)``."""

    def __init__(self, cfg, **kw):
        super().__init__()
        C, F_ = cfg.n_embd, cfg.dim_ffn
        self.time_mix_k = _param(1, 1, C, **kw)
        self.time_mix_r = _param(1, 1, C, **kw)
        self.key = Linear(C, F_, **kw)
        self.receptance = Linear(C, C, **kw)
        self.value = Linear(F_, C, **kw)

    def forward(
        self, x: torch.Tensor, ffn_shift: torch.Tensor, ops: Ops
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, C), a LayerNorm's output. Returns (out, new shift)."""
        prev = _prev(x, ffn_shift)
        kv = self.value(torch.relu(self.key(_lerp(x, prev, self.time_mix_k), ops)) ** 2, ops)
        r = torch.sigmoid(self.receptance(_lerp(x, prev, self.time_mix_r), ops))
        return r * kv, _last(x)


class MishGLU(nn.Module):
    """blocks.{i}.ffn with ``ffn_type="mishglu"`` (``mish_glu``):
    value(aa(xa) * mish(bb(xb))) with static lerps."""

    def __init__(self, cfg, **kw):
        super().__init__()
        C, F_ = cfg.n_embd, cfg.dim_ffn
        self.time_mix_k = _param(1, 1, C, **kw)
        self.time_mix_r = _param(1, 1, C, **kw)
        self.aa = Linear(C, F_, **kw)
        self.bb = Linear(C, F_, **kw)
        self.value = Linear(F_, C, **kw)

    def forward(
        self, x: torch.Tensor, ffn_shift: torch.Tensor, ops: Ops
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        prev = _prev(x, ffn_shift)
        a = self.aa(_lerp(x, prev, self.time_mix_k), ops)
        b = self.bb(_lerp(x, prev, self.time_mix_r), ops)
        return self.value(a * (b * torch.tanh(F.softplus(b))), ops), _last(x)


def tiny_attention(block, x: torch.Tensor, x_emb: torch.Tensor, ops: Ops) -> torch.Tensor:
    """``tiny_attention`` on a block's ``tiny_ln``, ``tiny_q``, ``tiny_k`` and
    ``tiny_v`` (the reference's keys): a causal, unnormalised q k^T over the
    call's tokens on a small width, applied to the call's embeddings."""
    T = x.shape[1]
    xx = ops.layer_norm(x, block.tiny_ln.weight, block.tiny_ln.bias)
    c = (block.tiny_q(xx, ops) @ block.tiny_k(xx, ops).transpose(1, 2)) * (
        block.tiny_q.weight.shape[0] ** -0.5)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return c.masked_fill(~causal, 0.0) @ block.tiny_v(x_emb, ops)


class Block(nn.Module):
    """blocks.{i}: ln0 (layer 0) -> time mix -> ln2 -> channel mix, with the
    legacy options of ``block_forward`` (:635-725) on RWKV-5/6. The RWKV-4
    block's forward is models.rwkv4's."""

    def __init__(self, cfg, layer_id: int, **kw):
        super().__init__()
        C = cfg.n_embd
        self.ln0 = Norm(C, **kw) if layer_id == 0 else None
        self.ln1 = Norm(C, **kw)
        self.ln2 = Norm(C, **kw)
        legacy = cfg.version < 6
        if cfg.version < 5:
            from rwkv_lm_ext_tpu_torch.models.rwkv4 import TimeMixV4

            self.att, self.ffn = TimeMixV4(cfg, **kw), ChannelMixLegacy(cfg, **kw)
            return
        pre_ffn = layer_id == 0 and cfg.pre_ffn > 0
        if pre_ffn:
            self.ffnPre = ChannelMixLegacy(cfg, **kw)
            self.att = None
        else:
            self.att = (TimeMixV5 if legacy else TimeMix)(cfg, **kw)
        if cfg.ffn_type == "mishglu":
            self.ffn = MishGLU(cfg, **kw)
        else:
            self.ffn = (ChannelMixLegacy if legacy else ChannelMix)(cfg, **kw)
        if layer_id == 0 and cfg.my_pos_emb > 0:
            P = cfg.my_pos_emb
            self.pos_emb_x = _param(1, P, C, **kw)
            self.pos_emb_y = _param(P, 1, C, **kw)
        if cfg.tiny_att_dim > 0 and layer_id == cfg.tiny_att_layer:
            self.tiny_ln = Norm(C, **kw)
            self.tiny_q = Linear(C, cfg.tiny_att_dim, **kw)
            self.tiny_k = Linear(C, cfg.tiny_att_dim, **kw)
            self.tiny_v = Linear(C, C, **kw)

    def forward(
        self, x: torch.Tensor, layer_state: LayerState, ops: Ops,
        use_state_params: bool = False, x_emb: Optional[torch.Tensor] = None,
        masks: Optional[tuple] = None, collect: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, LayerState]:
        """x_emb: the call's embeddings, which tiny attention reads; masks:
        ``Dropout.block_masks`` of this layer, or None; collect: this layer's
        (T, ...) slices of models.collect's state stacks, filled with the
        state after every position (the time mix's ``_wkv_output`` writes
        the att shift and WKV parts, ln2's output is the ffn shift)."""
        att_shift, wkv_state, ffn_shift = layer_state
        if self.ln0 is not None:
            x = ops.layer_norm(x, self.ln0.weight, self.ln0.bias)
            if hasattr(self, "pos_emb_x"):
                pe = (self.pos_emb_x + self.pos_emb_y).reshape(-1, x.shape[-1])[:x.shape[1]]
                x = x + pe[None].to(x.dtype)
        if self.att is None:
            att_out, att_shift = self.ffnPre(
                ops.layer_norm(x, self.ln1.weight, self.ln1.bias), att_shift, ops)
        elif isinstance(self.att, TimeMixV5):
            att_out, att_shift, wkv_state = self.att(
                ops.layer_norm(x, self.ln1.weight, self.ln1.bias), att_shift, wkv_state, ops,
                collect)
        else:
            att_out, att_shift, wkv_state = self.att(
                x, self.ln1, att_shift, wkv_state, ops, use_state_params, collect)
        if masks is not None:
            att_out = drop(att_out, masks[0], masks[1])
        x = x + att_out
        xln2 = ops.layer_norm(x, self.ln2.weight, self.ln2.bias)
        if collect is not None:
            collect["ffn_shift"].copy_(xln2.transpose(0, 1))
        ffn_out, ffn_shift = self.ffn(xln2, ffn_shift, ops)
        if masks is not None:
            ffn_out = drop(ffn_out, masks[0], masks[2])
        x = x + ffn_out
        if hasattr(self, "tiny_q") and x_emb is not None:
            x = x + tiny_attention(self, x, x_emb, ops)
        return x, (att_shift, wkv_state, ffn_shift)

    def step(
        self, x: torch.Tensor, state: ModelState, out: ModelState, i: int, ops: Ops,
        fused_prep: bool = False,
    ) -> torch.Tensor:
        """One token through layer i: x (B, 1, C). Reads layer i of
        ``state`` and writes layer i of ``out``, which may be ``state``
        itself (each slice is read before it is written, in stream order).
        ``fused_prep`` takes the fused decode glue (``step_fused`` of the two
        mixes) in place of K2, K3 and the plain channel mix (RWKV-6 only:
        models.decode refuses it for another model). A v5 block runs ln1 in
        K3 and its time mix's step (B.9)."""
        if self.ln0 is not None:
            x = ops.layer_norm(x, self.ln0.weight, self.ln0.bias)
        if fused_prep:
            x = x[:, 0]
            att_out, att_shift = self.att.step_fused(
                x, self.ln1, state["att_shift"][i], state["wkv"][i], out["wkv"][i], ops
            )
            x, ffn_shift = self.ffn.step_fused(x + att_out, self.ln2, state["ffn_shift"][i], ops)
            out["att_shift"][i].copy_(att_shift)
            out["ffn_shift"][i].copy_(ffn_shift)
            return x[:, None]
        if isinstance(self.att, TimeMixV5):
            att_out, att_shift = self.att.step(
                ops.layer_norm(x, self.ln1.weight, self.ln1.bias), state["att_shift"][i],
                state["wkv"][i], out["wkv"][i], ops)
        else:
            att_out, att_shift = self.att.step(
                x, self.ln1, state["att_shift"][i], state["wkv"][i], out["wkv"][i], ops
            )
        x = x + att_out
        ffn_out, ffn_shift = self.ffn(
            ops.layer_norm(x, self.ln2.weight, self.ln2.bias), state["ffn_shift"][i], ops
        )
        out["att_shift"][i].copy_(att_shift)
        out["ffn_shift"][i].copy_(ffn_shift)
        return x + ffn_out


class RWKV(nn.Module):
    """Full RWKV-4/5/6 model: emb -> blocks -> ln_out -> head (and the
    ``head_qk`` copy mechanism where the config asks for it).

    Built with uninitialised parameters in cfg.param_dtype on `device`; fill them
    with checkpoint.convert.load_state_dict_into (from a checkpoint or from
    models.init.init_rwkv_params)."""

    def __init__(self, cfg, *, device):
        super().__init__()
        # the fp32 decay low-rank must not run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        kw = dict(device=device, dtype=cfg.params_dtype)
        self.cfg = cfg
        self.emb = nn.Module()
        self.emb.weight = _param(cfg.vocab_size, cfg.n_embd, **kw)
        self.blocks = nn.ModuleList(Block(cfg, i, **kw) for i in range(cfg.n_layer))
        self.ln_out = Norm(cfg.n_embd, **kw)
        self.head = Linear(cfg.n_embd, cfg.vocab_size, **kw)
        if cfg.head_qk > 0 and cfg.version >= 5:
            self.head_q = Linear(cfg.n_embd, cfg.head_qk, **kw)
            self.head_k = Linear(cfg.n_embd, cfg.head_qk, **kw)
        # the RetroMAE trainer's one-layer decoder
        # (models.bidirectional.OneLayerDecoder), attached after loading
        self.register_module("onelayer_decoder", None)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype (looked up in param_dtype,
        then cast)."""
        return F.embedding(tokens, self.emb.weight).to(self.cfg.compute_dtype)

    def add_state_params(self) -> None:
        """Give every layer a zero fp32 ``att.time_state`` (H, N, N)
        parameter, as the JAX trainer does for --train-type states
        (train/cli.py:511-517); existing ones are kept."""
        H, N = self.cfg.n_head, self.cfg.head_size
        for block in self.blocks:
            if block.att.time_state is None:
                block.att.time_state = nn.Parameter(torch.zeros(
                    H, N, N, dtype=torch.float32, device=self.emb.weight.device))

    def forward(
        self,
        tokens: torch.Tensor,
        state: Optional[ModelState] = None,
        *,
        return_hidden: bool = False,
        return_logits: bool = True,
        reference: bool = False,
        t1_step: bool = True,
        remat=False,
        use_state_params: bool = False,
        dropout: Optional[Dropout] = None,
    ):
        """tokens: (B, T) int. state: a models.state dict, or None for zeros.

        Returns (logits (B, T, V), new_state); with return_hidden and not
        return_logits, (hidden (B, T, C), new_state); with both,
        ((logits, hidden), new_state). reference=True runs the kernels'
        plain versions (see the module docstring). A plain T=1 call (logits
        only) goes through models.decode.rwkv_decode_step unless
        ``t1_step=False`` or ``use_state_params``; either way ``state`` is left
        as it was. ``remat`` (a utils.remat spec: off, on or a policy name)
        checkpoints each block while grad mode is on;
        ``use_state_params`` (see the module docstring) replaces the WKV part
        of ``state`` (RWKV-6 only: an RWKV-5 model refuses it, as JAX's v5
        time mix takes no override). ``dropout`` (a ``Dropout``, or None)
        drops at the embeddings and after each block's two mixes. An RWKV-4
        model (models.rwkv4) returns fp32 logits and takes neither
        ``return_hidden``, ``use_state_params`` nor ``dropout``, as the JAX
        package asserts (rwkv.py:764) and its ``rwkv4_forward`` takes no
        dropout."""
        from rwkv_lm_ext_tpu_torch.models.decode import decode_supported, rwkv_decode_step

        if (t1_step and tokens.shape[1] == 1 and return_logits and not return_hidden
                and not use_state_params and dropout is None and decode_supported(self.cfg)):
            logits, new_state = rwkv_decode_step(self, tokens[:, 0], state, reference=reference)
            return logits[:, None], new_state
        ops = PLAIN_OPS if reference else KERNEL_OPS
        if self.cfg.version < 5:
            from rwkv_lm_ext_tpu_torch.models.rwkv4 import rwkv4_forward

            if return_hidden or not return_logits or use_state_params or dropout is not None:
                raise ValueError("an RWKV-4 model returns logits only: return_hidden, "
                                 "use_state_params and dropout are RWKV-5/6 features")
            return rwkv4_forward(self, tokens, state, ops, remat=remat)
        if use_state_params and self.cfg.version < 6:
            raise ValueError(f"use_state_params is an RWKV-6 feature: the RWKV-{self.cfg.version:g} "
                             "time mix takes no learnable initial state (as in the JAX package)")
        B = tokens.shape[0]
        if state is None:
            state = init_model_state(self.cfg, B, device=tokens.device)
        x = self.embed(tokens)
        # tiny attention reads the embeddings before dropout, as in JAX (:806-809)
        x_emb = x if self.cfg.tiny_att_dim > 0 else None
        if dropout is not None and dropout.rate > 0:
            x = drop(x, dropout.rate, dropout.keep("emb", None, x.shape, x.device))
        new_state = {key: [] for key in ("att_shift", "wkv", "ffn_shift")}
        for i, block in enumerate(self.blocks):
            ls = (state["att_shift"][i], state["wkv"][i], state["ffn_shift"][i])
            masks = None if dropout is None else dropout.block_masks(i, x.shape, x.device)
            x, ls = remat_call(block, x, ls, ops, use_state_params, x_emb, masks, remat=remat)
            for key, value in zip(new_state, ls):
                new_state[key].append(value)
        new_state = {key: torch.stack(vs) for key, vs in new_state.items()}
        x = ops.layer_norm(x, self.ln_out.weight, self.ln_out.bias)
        if return_hidden and not return_logits:
            return x, new_state
        logits = self.head(x, ops)
        if hasattr(self, "head_q"):
            logits = self._copy_logits(logits, x, tokens, ops)
        if return_hidden:
            return (logits, x), new_state
        return logits, new_state

    def _copy_logits(self, logits, x, tokens, ops) -> torch.Tensor:
        """The copy mechanism (:866-874): a causal q k^T over the call's
        hidden states, scaled by 1 / head_qk, added to the logits of each
        earlier input token."""
        T = tokens.shape[1]
        c = (self.head_q(x, ops) @ self.head_k(x, ops).transpose(1, 2)) * (1.0 / self.cfg.head_qk)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        c = c.masked_fill(~causal, 0.0).to(logits.dtype)
        return logits.scatter_add(2, tokens[:, None, :].expand(-1, T, -1), c)
