"""RWKV-6 forward pass as PyTorch modules.

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
utils/remat.py); ``use_state_params=True`` feeds each layer's learnable
``att.time_state`` (H, N, N) fp32, added by ``add_state_params``, as the WKV
initial state of every sequence (state tuning,
rwkv_lm_ext_tpu/models/rwkv.py:471-476).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import (
    wkv6_decode_step,
    wkv6_decode_step_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    wkv6_fused_output,
    wkv6_fused_output_plain,
)


class Ops(NamedTuple):
    layer_norm: object
    tmix_prologue: object
    wkv6_fused_output: object
    wkv6_decode_step: object
    quantize_rows: object
    att_prep: object
    ffn_prep: object
    ffn_block: object


KERNEL_OPS = Ops(
    layer_norm, tmix_prologue, wkv6_fused_output, wkv6_decode_step, quantize_rows,
    att_prep_fused, ffn_prep_fused, ffn_block_fused,
)
PLAIN_OPS = Ops(
    layer_norm_plain, tmix_prologue_plain, wkv6_fused_output_plain,
    wkv6_decode_step_plain, quantize_rows_plain,
    att_prep_plain, ffn_prep_plain, ffn_block_plain,
)

LayerState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def normalize_remat(spec) -> bool:
    """CLI spellings of per-block remat: on/true -> True, off/false -> False.
    The JAX package's selective ``dots`` policies have no counterpart yet."""
    value = spec.lower() if isinstance(spec, str) else spec
    if value in (True, "on", "true", "1"):
        return True
    if value in (False, None, "off", "false", "0"):
        return False
    raise ValueError(f"unknown remat spec {spec!r}; expected on or off")


def _param(*shape, device, dtype) -> nn.Parameter:
    # values come from models.init or a checkpoint
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


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
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, C) raw residual stream; att_shift: (B, C) fp32, the
        previous token's ln1 output; wkv_state: (B, H, N, N) fp32, replaced
        by ``time_state`` (shared by every sequence) with use_state_params.
        Returns (out (B, T, C), new att_shift, new wkv_state)."""
        B, T, _ = x.shape
        H, N = self.cfg.n_head, self.cfg.head_size
        r, k, v, g, w, xln = self._mix(x, ln1, att_shift, ops)
        heads = (B, T, H, N)
        if use_state_params:
            if self.time_state is None:
                raise ValueError("use_state_params needs RWKV.add_state_params() first")
            wkv_state = self.time_state
        gated, new_wkv = ops.wkv6_fused_output(
            r.view(heads), k.view(heads), v.view(heads), w.view(heads),
            self.time_faaaa, g.view(heads), self.ln_x.weight, self.ln_x.bias,
            wkv_state, eps=self.cfg.ln_x_eps,
        )
        return self.output(gated, ops), xln[:, -1].float(), new_wkv

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
        return torch.sigmoid(self.receptance(xr, ops)) * kv, x[:, -1].float()

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


class Block(nn.Module):
    """blocks.{i}: ln0 (layer 0) -> time mix -> ln2 -> channel mix."""

    def __init__(self, cfg, layer_id: int, **kw):
        super().__init__()
        C = cfg.n_embd
        self.ln0 = Norm(C, **kw) if layer_id == 0 else None
        self.ln1 = Norm(C, **kw)
        self.ln2 = Norm(C, **kw)
        self.att = TimeMix(cfg, **kw)
        self.ffn = ChannelMix(cfg, **kw)

    def forward(
        self, x: torch.Tensor, layer_state: LayerState, ops: Ops,
        use_state_params: bool = False,
    ) -> Tuple[torch.Tensor, LayerState]:
        att_shift, wkv_state, ffn_shift = layer_state
        if self.ln0 is not None:
            x = ops.layer_norm(x, self.ln0.weight, self.ln0.bias)
        att_out, att_shift, wkv_state = self.att(
            x, self.ln1, att_shift, wkv_state, ops, use_state_params)
        x = x + att_out
        ffn_out, ffn_shift = self.ffn(
            ops.layer_norm(x, self.ln2.weight, self.ln2.bias), ffn_shift, ops
        )
        return x + ffn_out, (att_shift, wkv_state, ffn_shift)

    def step(
        self, x: torch.Tensor, state: ModelState, out: ModelState, i: int, ops: Ops,
        fused_prep: bool = False,
    ) -> torch.Tensor:
        """One token through layer i: x (B, 1, C). Reads layer i of
        ``state`` and writes layer i of ``out``, which may be ``state``
        itself (each slice is read before it is written, in stream order).
        ``fused_prep`` takes the fused decode glue (``step_fused`` of the two
        mixes) in place of K2, K3 and the plain channel mix."""
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
    """Full RWKV-6 model: emb -> blocks -> ln_out -> head.

    Built with uninitialised parameters in cfg.param_dtype on `device`; fill them
    with checkpoint.convert.load_state_dict_into (from a checkpoint or from
    models.init.init_rwkv_params)."""

    def __init__(self, cfg, *, device):
        super().__init__()
        if cfg.version < 6:
            raise NotImplementedError(
                f"the port runs RWKV-6 only so far (checkpoint is v{cfg.version})"
            )
        # the fp32 decay low-rank must not run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        kw = dict(device=device, dtype=cfg.params_dtype)
        self.cfg = cfg
        self.emb = nn.Module()
        self.emb.weight = _param(cfg.vocab_size, cfg.n_embd, **kw)
        self.blocks = nn.ModuleList(Block(cfg, i, **kw) for i in range(cfg.n_layer))
        self.ln_out = Norm(cfg.n_embd, **kw)
        self.head = Linear(cfg.n_embd, cfg.vocab_size, **kw)
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
        remat: bool = False,
        use_state_params: bool = False,
    ):
        """tokens: (B, T) int. state: a models.state dict, or None for zeros.

        Returns (logits (B, T, V), new_state); with return_hidden and not
        return_logits, (hidden (B, T, C), new_state); with both,
        ((logits, hidden), new_state). reference=True runs the kernels'
        plain versions (see the module docstring). A plain T=1 call (logits
        only) goes through models.decode.rwkv_decode_step unless
        ``t1_step=False`` or ``use_state_params``; either way ``state`` is left
        as it was. ``remat`` checkpoints each block while grad mode is on;
        ``use_state_params`` (see the module docstring) replaces the WKV part
        of ``state``."""
        from rwkv_lm_ext_tpu_torch.models.decode import decode_supported, rwkv_decode_step

        if (t1_step and tokens.shape[1] == 1 and return_logits and not return_hidden
                and not use_state_params and decode_supported(self.cfg)):
            logits, new_state = rwkv_decode_step(self, tokens[:, 0], state, reference=reference)
            return logits[:, None], new_state
        ops = PLAIN_OPS if reference else KERNEL_OPS
        B = tokens.shape[0]
        if state is None:
            state = init_model_state(self.cfg, B, device=tokens.device)
        x = self.embed(tokens)
        new_state = {key: [] for key in ("att_shift", "wkv", "ffn_shift")}
        remat = remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            ls = (state["att_shift"][i], state["wkv"][i], state["ffn_shift"][i])
            if remat:
                x, ls = checkpoint(block, x, ls, ops, use_state_params, use_reentrant=False)
            else:
                x, ls = block(x, ls, ops, use_state_params)
            for key, value in zip(new_state, ls):
                new_state[key].append(value)
        new_state = {key: torch.stack(vs) for key, vs in new_state.items()}
        x = ops.layer_norm(x, self.ln_out.weight, self.ln_out.bias)
        if return_hidden and not return_logits:
            return x, new_state
        logits = self.head(x, ops)
        if return_hidden:
            return (logits, x), new_state
        return logits, new_state
