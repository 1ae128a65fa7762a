"""The RWKV-4 family (RWKV-4-World, Pile, Raven): the time mix and the forward
and T=1 step around kernel B.14.

Counterpart of rwkv_lm_ext_tpu/models/rwkv4.py:35-107 (``init_v4_state``,
``v4_time_mix``, ``rwkv4_forward``). ``RWKV`` (models/rwkv.py) builds the
blocks of a ``version < 5`` config with ``TimeMixV4`` and the legacy channel
mix and hands its forward to ``rwkv4_forward``; ``models.decode`` hands its
T=1 step to ``rwkv4_step``. ln0, ln1, ln2 and ln_out run in K3, the WKV in
B.14 (ops/wkv4.py).

Training: under grad B.14 runs as its autograd Function (ops/wkv4.py) with
its backward kernel, and the forward returns the new state as a result of the
graph, so TBPTT (train/loop.py ``tbptt_loss_fn``) carries it from chunk to
chunk with its gradient, as the JAX scan does. ``remat`` checkpoints each
block as the RWKV-5/6 forward does; JAX's ``rwkv4_forward`` keeps every
activation, and the gradients are the same either way.

The time mix: static lerps (``time_mix_k/v/r``), sigmoid receptance, the
decay ``w = -exp(time_decay)`` in fp32, the bonus ``u = time_first``, then
``output(r * y)`` with y cast to the compute dtype; no GroupNorm, no gate.
The state per layer is the att shift row, the log-space accumulators aa, bb
and pp, and the ffn shift row, each (B, C) fp32 (models/state.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rwkv_lm_ext_tpu_torch.models.rwkv import Linear, Ops, _last, _lerp, _param, _prev
from rwkv_lm_ext_tpu_torch.models.state import V4_STATE_KEYS, ModelState, init_model_state
from rwkv_lm_ext_tpu_torch.utils.remat import remat_call

WKV4_KEYS = ("aa", "bb", "pp")


class TimeMixV4(nn.Module):
    """blocks.{i}.att of RWKV-4, fed ln1's output."""

    def __init__(self, cfg, **kw):
        super().__init__()
        C = cfg.n_embd
        for name in ("k", "v", "r"):
            setattr(self, f"time_mix_{name}", _param(1, 1, C, **kw))
        self.time_decay = _param(C, **kw)
        self.time_first = _param(C, **kw)
        self.key = Linear(C, C, **kw)
        self.value = Linear(C, C, **kw)
        self.receptance = Linear(C, C, **kw)
        self.output = Linear(C, C, **kw)

    def forward(
        self, x: torch.Tensor, att_shift: torch.Tensor, wkv_state, ops: Ops, out_state=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
        """x: (B, T, C), ln1's output; att_shift (B, C) fp32; wkv_state the
        (aa, bb, pp) triple, each (B, C) fp32. The new WKV state goes into
        ``out_state`` when given (it may be ``wkv_state``). Returns (out,
        new att_shift, new (aa, bb, pp))."""
        dt = x.dtype
        prev = _prev(x, att_shift)
        r = torch.sigmoid(self.receptance(_lerp(x, prev, self.time_mix_r), ops))
        k = self.key(_lerp(x, prev, self.time_mix_k), ops)
        v = self.value(_lerp(x, prev, self.time_mix_v), ops)
        w = -torch.exp(self.time_decay.float())
        y, new = ops.wkv4(k, v, w, self.time_first.float(), wkv_state, out_state=out_state)
        return self.output(r * y.to(dt), ops), _last(x), new


def _layer(state: ModelState, i: int) -> tuple:
    return tuple(state[key][i] for key in V4_STATE_KEYS)


def _block(block, x: torch.Tensor, layer: tuple, ops: Ops, out_wkv=None):
    """One layer: ln0 (layer 0), the time mix on ln1's output, the channel
    mix on ln2's; layer is (att_shift, aa, bb, pp, ffn_shift). The WKV state
    goes into ``out_wkv`` when given. Returns (x, the layer's new state)."""
    att_shift, aa, bb, pp, ffn_shift = layer
    if block.ln0 is not None:
        x = ops.layer_norm(x, block.ln0.weight, block.ln0.bias)
    att_out, att_shift, wkv = block.att(
        ops.layer_norm(x, block.ln1.weight, block.ln1.bias), att_shift, (aa, bb, pp), ops,
        out_state=out_wkv)
    x = x + att_out
    ffn_out, ffn_shift = block.ffn(
        ops.layer_norm(x, block.ln2.weight, block.ln2.bias), ffn_shift, ops)
    return x + ffn_out, (att_shift, *wkv, ffn_shift)


def rwkv4_forward(model, tokens: torch.Tensor, state: Optional[ModelState], ops: Ops,
                  *, remat=False):
    """(B, T) tokens -> (logits (B, T, V) fp32, new state), the state threaded
    as in ``rwkv4_forward``: None is a fresh state, and chunked prefill chains.
    ``remat`` (a utils.remat spec) checkpoints each block under grad."""
    if state is None:
        state = init_model_state(model.cfg, tokens.shape[0], device=tokens.device)
    x = model.embed(tokens)
    new = {key: [] for key in V4_STATE_KEYS}
    for i, block in enumerate(model.blocks):
        x, layer = remat_call(_block, block, x, _layer(state, i), ops, remat=remat)
        for key, value in zip(V4_STATE_KEYS, layer):
            new[key].append(value)
    x = ops.layer_norm(x, model.ln_out.weight, model.ln_out.bias)
    return model.head(x, ops).float(), {key: torch.stack(vs) for key, vs in new.items()}


def rwkv4_step(model, tokens: torch.Tensor, state: ModelState, out: ModelState, ops: Ops):
    """One token a stream: tokens (B,). Reads ``state`` and writes every
    layer's new state into ``out``, which may be ``state`` itself (B.14
    updates aa, bb and pp in place; each layer's shift rows are read before
    they are written). Returns (logits (B, V) fp32, out)."""
    x = model.embed(tokens[:, None])
    for i, block in enumerate(model.blocks):
        out_wkv = tuple(out[key][i] for key in WKV4_KEYS)
        x, (att_shift, *_, ffn_shift) = _block(block, x, _layer(state, i), ops, out_wkv=out_wkv)
        out["att_shift"][i].copy_(att_shift)
        out["ffn_shift"][i].copy_(ffn_shift)
    x = ops.layer_norm(x, model.ln_out.weight, model.ln_out.bias)
    return model.head(x, ops)[:, 0].float(), out
