"""Bidirectional RWKV-6 blocks and the encoder-family forwards.

Counterpart of rwkv_lm_ext_tpu/models/bidirectional.py: ``sequence_lengths``
(:39), ``bi_time_mix`` (:52), ``bi_block_forward`` (:116),
``encoder_forward`` (:143), ``encode_sentence`` (:180), the RetroMAE
one-layer decoder (``aggressive_decoder_time_mix`` :193,
``one_layer_decoder_forward`` :219, ``init_one_layer_decoder`` :307),
``mae_forward`` (:249; ``bidirectional=False`` runs the causal model and adds
``seq_emb`` back onto the token states, :283-284), ``dupmae_bow_loss`` (:298)
and the streaming variant (:340-469).

The two bidirectional modes:

- "average": the whole time mix runs on x and on x with each row's valid
  prefix reversed; the raw WKV outputs are averaged in fp32, cast, and
  GroupNorm + gate are applied once with the forward pass's gate.
- "fused": one set of projections, a causal WKV pass with the bonus u plus a
  reverse pass without it (ops.wkv.wkv6_bi).

Either way a layer launches the unfused WKV kernel B.8 twice, and LayerNorm
goes through K3; the projections, the GroupNorm and the channel mix are plain
torch ops, as they are outside any Pallas kernel in the JAX package. The JAX
functions also pass ``wkv_backend``, ``chunk_size`` and ``cfg.wkv_exact``
down to the chunked TPU kernel; the port's kernel is a sequential recurrence
with nothing to select. ``reference=True`` runs the kernels' plain versions
on any device: the on-card reference, not a serving path.

A model is an ``RWKV`` module (models/rwkv.py); with fp32 master weights
(cfg.param_dtype) every use casts to the compute dtype, inside the
checkpointed block when ``remat`` is on.

What counts as a row's valid prefix is what the code of the JAX package
counts, not what its docstrings say: every token that is neither pad nor emb,
wherever it stands, mask tokens included; the rows at and beyond that count
stay in place under the flip.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.config import EMB_ID, PAD_ID
from rwkv_lm_ext_tpu_torch.models.heads import first_token_position
from rwkv_lm_ext_tpu_torch.models.init import init_block_params, init_head
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV, Block, ChannelMix, Linear, Norm, TimeMix, _last
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.wkv import (
    _flip_valid_prefix,
    wkv,
    wkv6_bi,
    wkv6_bi_plain,
    wkv_plain,
)
from rwkv_lm_ext_tpu_torch.utils.remat import remat_call


class BiOps(NamedTuple):
    layer_norm: object
    wkv: object
    wkv6_bi: object


KERNEL_OPS = BiOps(layer_norm, wkv, wkv6_bi)
PLAIN_OPS = BiOps(layer_norm_plain, wkv_plain, wkv6_bi_plain)


def sequence_lengths(
    tokens: torch.Tensor, *, pad_id: int = PAD_ID, emb_id: Optional[int] = EMB_ID
) -> torch.Tensor:
    """(B,) int32: per row, the count of tokens that are neither pad nor emb
    (the emb terminator stays out of the bidirectional flip)."""
    valid = tokens != pad_id
    if emb_id is not None:
        valid &= tokens != emb_id
    return valid.sum(dim=1, dtype=torch.int32)


def _ln(ops: BiOps, x: torch.Tensor, norm: Norm) -> torch.Tensor:
    return ops.layer_norm(x, norm.weight, norm.bias)


def bi_time_mix(
    att: TimeMix, x: torch.Tensor, lengths: Optional[torch.Tensor], *,
    mode: str = "average", ops: BiOps = KERNEL_OPS,
) -> torch.Tensor:
    """x: (B, T, C), ln1's output; lengths: (B,) valid-prefix lengths, or
    None for all T. Returns the time mix's output (B, T, C)."""
    B, T, C = x.shape
    heads = (B, T, att.cfg.n_head, att.cfg.head_size)
    zero_shift = torch.zeros(B, C, dtype=torch.float32, device=x.device)
    if mode == "average":
        def run_pass(xi):
            r, k, v, g, w = att.projections(xi, zero_shift)
            y, _ = ops.wkv(r.view(heads), k.view(heads), v.view(heads), w.view(heads),
                           att.time_faaaa)
            return y.reshape(B, T, -1), g

        def flip(t):
            return t.flip(1) if lengths is None else _flip_valid_prefix(t, lengths)

        y_fwd, g_fwd = run_pass(x)
        y_rev, _ = run_pass(flip(x))
        y = (y_fwd + flip(y_rev)) / 2
        return att.gn_output(y.to(x.dtype), g_fwd)
    if mode == "fused":
        r, k, v, g, w = att.projections(x, zero_shift)
        y = ops.wkv6_bi(r.view(heads), k.view(heads), v.view(heads), w.view(heads),
                        att.time_faaaa, lengths)
        return att.gn_output(y.reshape(B, T, -1), g)
    raise ValueError(f"unknown bi mode {mode!r}")


def bi_block_forward(
    block: Block, x: torch.Tensor, lengths: Optional[torch.Tensor], *,
    mode: str = "average", ops: BiOps = KERNEL_OPS,
) -> torch.Tensor:
    """Bidirectional residual block: the time mix sees both directions, the
    channel mix stays causal."""
    if block.ln0 is not None:
        x = _ln(ops, x, block.ln0)
    x = x + bi_time_mix(block.att, _ln(ops, x, block.ln1), lengths, mode=mode, ops=ops)
    zero_shift = torch.zeros(x.shape[0], x.shape[2], dtype=torch.float32, device=x.device)
    ffn_out, _ = block.ffn(_ln(ops, x, block.ln2), zero_shift, None)
    return x + ffn_out


def _run_block(block, x, lengths, mode, ops):
    return bi_block_forward(block, x, lengths, mode=mode, ops=ops)


def encoder_forward(
    model: RWKV, tokens: torch.Tensor, *, mode: str = "average", pad_id: int = PAD_ID,
    emb_id: Optional[int] = EMB_ID, remat=False, reference: bool = False,
) -> torch.Tensor:
    """Bidirectional encoder: emb -> bi blocks -> ln_out. tokens (B, T) int;
    returns the hidden states (B, T, C) in the compute dtype. ``remat`` (a
    utils.remat spec) checkpoints each block while grad mode is on."""
    ops = PLAIN_OPS if reference else KERNEL_OPS
    lengths = sequence_lengths(tokens, pad_id=pad_id, emb_id=emb_id)
    x = model.embed(tokens)
    for block in model.blocks:
        x = remat_call(_run_block, block, x, lengths, mode, ops, remat=remat)
    return _ln(ops, x, model.ln_out)


def _take_position(hidden: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), pos]


def encode_sentence(
    model: RWKV, tokens: torch.Tensor, *, mode: str = "average", emb_id: int = EMB_ID, **kw
) -> torch.Tensor:
    """Sentence embedding: the hidden state at the first emb_id position."""
    hidden = encoder_forward(model, tokens, mode=mode, emb_id=emb_id, **kw)
    return _take_position(hidden, first_token_position(tokens, emb_id))


# ---------------------------------------------------------------------------
# RetroMAE: the one-layer decoder over the sentence-embedding bottleneck
# ---------------------------------------------------------------------------


class OneLayerDecoder(nn.Module):
    """One block whose time mix takes r, g and the decay from the sentence
    embedding broadcast over T and k, v from the decoder's token stream; its
    own ln_out and head. Parameter names are the block's flat keys
    (``ln1.weight``, ``att.key.weight``, ..., ``head.weight`` (V, C))."""

    def __init__(self, cfg, *, device):
        super().__init__()
        kw = dict(device=device, dtype=cfg.params_dtype)
        C = cfg.n_embd
        self.cfg = cfg
        self.ln1, self.ln2, self.ln_out = Norm(C, **kw), Norm(C, **kw), Norm(C, **kw)
        self.att = TimeMix(cfg, **kw)
        self.ffn = ChannelMix(cfg, **kw)
        self.head = Linear(C, cfg.vocab_size, **kw)

    def forward(
        self, seq_emb: torch.Tensor, decoder_ids: torch.Tensor, emb: torch.Tensor,
        ops: BiOps = KERNEL_OPS,
    ) -> torch.Tensor:
        """seq_emb (B, C), decoder_ids (B, T), emb the encoder's (V, C)
        embedding matrix. Returns fp32 logits (B, T, V)."""
        B, T = decoder_ids.shape
        dt = self.cfg.compute_dtype
        x = seq_emb[:, None, :].expand(B, T, -1).to(dt).contiguous()
        x1 = F.embedding(decoder_ids, emb).to(dt)
        x = x + aggressive_decoder_time_mix(
            self.att, _ln(ops, x, self.ln1), _ln(ops, x1, self.ln1), ops=ops)
        zero_shift = torch.zeros(B, x.shape[-1], dtype=torch.float32, device=x.device)
        ffn_out, _ = self.ffn(_ln(ops, x, self.ln2), zero_shift, None)
        x = _ln(ops, x + ffn_out, self.ln_out)
        return x.float() @ self.head.weight.float().T


def aggressive_decoder_time_mix(
    att: TimeMix, x: torch.Tensor, x1: torch.Tensor, *, ops: BiOps = KERNEL_OPS
) -> torch.Tensor:
    """r, g and the decay from the sentence-embedding stream x, k and v from
    the decoder token stream x1 (both (B, T, C), already ln1's output)."""
    B, T, C = x.shape
    heads = (B, T, att.cfg.n_head, att.cfg.head_size)
    zero = torch.zeros(B, C, dtype=torch.float32, device=x.device)
    r, _, _, g, w = att.projections(x, zero)
    _, k, v, _, _ = att.projections(x1, zero)
    y, _ = ops.wkv(r.view(heads), k.view(heads), v.view(heads), w.view(heads), att.time_faaaa)
    return att.gn_output(y.reshape(B, T, -1).to(x.dtype), g)


def init_one_layer_decoder(cfg, *, generator: torch.Generator, device) -> OneLayerDecoder:
    """A fresh decoder: layer 0's time-mix and channel-mix initialisation,
    unit LayerNorms and a scaled-normal head (gain 0.5), drawn from
    ``generator`` (which must live on ``device``)."""
    f32 = dict(dtype=torch.float32, device=device)
    C = cfg.n_embd
    sd = {k: v for k, v in init_block_params(cfg, 0, generator=generator, device=device).items()
          if not k.startswith("ln0.")}
    sd["ln_out.weight"], sd["ln_out.bias"] = torch.ones(C, **f32), torch.zeros(C, **f32)
    sd["head.weight"] = init_head(cfg, generator=generator, device=device)
    decoder = OneLayerDecoder(cfg, device=device)
    with torch.no_grad():
        for key, p in decoder.state_dict().items():
            p.copy_(sd[key].reshape(p.shape))
    return decoder


def mae_forward(
    model: RWKV, encoder_ids: torch.Tensor, decoder_ids: Optional[torch.Tensor] = None, *,
    bidirectional: bool = True, mode: str = "average", emb_id: int = EMB_ID,
    remat: bool = False, reference: bool = False,
) -> Dict[str, torch.Tensor]:
    """RetroMAE forward: ``seq_emb`` (B, C), the encoder's hidden state at
    the first emb_id; ``encoder_logits`` (B, T, V) fp32 from the tied head;
    and, with decoder_ids and a ``model.onelayer_decoder``, ``decoder_logits``
    (B, T, V) and their max over T, ``ot_logits`` (the DupMAE bag-of-words
    logits). The encoder is the bidirectional one, or with
    ``bidirectional=False`` the causal model (K1/K2), whose token states get
    seq_emb added back before the head."""
    if bidirectional:
        hidden = encoder_forward(model, encoder_ids, mode=mode, remat=remat, reference=reference)
    else:
        hidden, _ = model(encoder_ids, return_hidden=True, return_logits=False, remat=remat,
                          reference=reference)
    seq_emb = _take_position(hidden, first_token_position(encoder_ids, emb_id))
    x = hidden if bidirectional else hidden + seq_emb[:, None, :]
    out = {"seq_emb": seq_emb, "encoder_logits": x.float() @ model.emb.weight.float().T}
    if decoder_ids is not None and model.onelayer_decoder is not None:
        out["decoder_logits"] = model.onelayer_decoder(
            seq_emb, decoder_ids, model.emb.weight, PLAIN_OPS if reference else KERNEL_OPS)
        out["ot_logits"] = out["decoder_logits"].amax(dim=1)
    return out


def dupmae_bow_loss(ot_logits: torch.Tensor, bag_word_weight: torch.Tensor,
                    rows: Optional[int] = None) -> torch.Tensor:
    """Cross entropy between the max-pooled vocabulary logits (B, V) and the
    document's bag-of-words distribution (B, V), the mean over the rows (or
    the sum over ``rows``: a data-parallel rank's global row count)."""
    logp = torch.log_softmax(ot_logits.float(), dim=-1)
    per_row = -(bag_word_weight * logp).sum(-1)
    return per_row.mean() if rows is None else per_row.sum() / rows


# ---------------------------------------------------------------------------
# Streaming bidirectional runtime: long inputs chunk by chunk with O(chunk)
# memory. Per chunk k, v and w are reversed WITHIN the chunk (the last token
# stays in place on the final chunk), r and the gate are shared by the two
# passes, each pass gets its own GroupNorm + gate and the outputs are summed;
# the forward and the "reverse" WKV states both stream across chunks. It is
# the one caller that feeds B.8 a non-zero initial state and reads its final
# state.
# ---------------------------------------------------------------------------

BiStreamingState = Dict[str, torch.Tensor]


def init_bi_streaming_state(cfg, batch_size: int, *, device) -> BiStreamingState:
    """Zero per-layer state: att_shift and ffn_shift (L, B, C), wkv and
    wkv_rev (L, B, H, N, N), all fp32. The JAX package keeps the WKV slots in
    its tile-packed TPU layout; here they are the logical (K, V) matrices."""
    L, B, C = cfg.n_layer, batch_size, cfg.n_embd
    H, N = cfg.n_head, cfg.head_size

    def z(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=device)

    return {"att_shift": z(L, B, C), "wkv": z(L, B, H, N, N),
            "wkv_rev": z(L, B, H, N, N), "ffn_shift": z(L, B, C)}


def _chunk_reverse(x: torch.Tensor, is_last_chunk: bool) -> torch.Tensor:
    """Flip the time axis; on the last chunk the final token (the emb slot)
    stays in place."""
    if not is_last_chunk:
        return x.flip(1)
    return torch.cat([x[:, :-1].flip(1), x[:, -1:]], dim=1)


def bi_streaming_time_mix(
    att: TimeMix, x: torch.Tensor, att_shift: torch.Tensor, wkv_state: torch.Tensor,
    wkv_state_rev: torch.Tensor, *, is_last_chunk: bool, ops: BiOps = KERNEL_OPS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, C = x.shape
    heads = (B, T, att.cfg.n_head, att.cfg.head_size)
    r, k, v, g, w = att.projections(x, att_shift)

    def run(kk, vv, ww, s0):
        y, s = ops.wkv(r.view(heads), kk.reshape(heads), vv.reshape(heads),
                       ww.reshape(heads), att.time_faaaa, s0)
        return y.reshape(B, T, -1), s

    y_fwd, s_new = run(k, v, w, wkv_state)
    y_rev, s_rev_new = run(*(_chunk_reverse(t, is_last_chunk) for t in (k, v, w)),
                           wkv_state_rev)
    out = att.gn_output(y_fwd.to(x.dtype), g)
    out_rev = att.gn_output(y_rev.to(x.dtype), g)
    return out + _chunk_reverse(out_rev, is_last_chunk), _last(x), s_new, s_rev_new


def bi_streaming_forward(
    model: RWKV, tokens: torch.Tensor, state: Optional[BiStreamingState] = None, *,
    is_last_chunk: bool = True, reference: bool = False,
) -> Tuple[torch.Tensor, BiStreamingState]:
    """One chunk of the streaming bidirectional encoder; thread ``state``
    across chunks and set is_last_chunk on the final one. Returns
    (hidden (B, T, C), new state)."""
    ops = PLAIN_OPS if reference else KERNEL_OPS
    if state is None:
        state = init_bi_streaming_state(model.cfg, tokens.shape[0], device=tokens.device)
    x = model.embed(tokens)
    new_state = {key: [] for key in ("att_shift", "wkv", "wkv_rev", "ffn_shift")}
    for i, block in enumerate(model.blocks):
        if block.ln0 is not None:
            x = _ln(ops, x, block.ln0)
        att_out, a_s, s_new, s_rev = bi_streaming_time_mix(
            block.att, _ln(ops, x, block.ln1), state["att_shift"][i], state["wkv"][i],
            state["wkv_rev"][i], is_last_chunk=is_last_chunk, ops=ops)
        x = x + att_out
        ffn_out, f_s = block.ffn(_ln(ops, x, block.ln2), state["ffn_shift"][i], None)
        x = x + ffn_out
        for key, value in zip(new_state, (a_s, s_new, s_rev, f_s)):
            new_state[key].append(value)
    return _ln(ops, x, model.ln_out), {k: torch.stack(vs) for k, vs in new_state.items()}


def embed_mae_streaming(
    model: RWKV, tokens: torch.Tensor, *, chunk_ctx: int, emb_id: int = EMB_ID,
    reference: bool = False,
) -> torch.Tensor:
    """Chunked bidirectional embedding of long inputs: bi_streaming_forward
    chunk by chunk (tokens padded up to a multiple of chunk_ctx), then the
    hidden state at the first emb_id position."""
    B, T = tokens.shape
    pad = (-T) % chunk_ctx
    if pad:
        tokens = F.pad(tokens, (0, pad))
    state, pieces = None, []
    total = T + pad
    for s in range(0, total, chunk_ctx):
        h, state = bi_streaming_forward(
            model, tokens[:, s: s + chunk_ctx], state,
            is_last_chunk=s + chunk_ctx >= total, reference=reference)
        pieces.append(h)
    hidden = torch.cat(pieces, dim=1)[:, :T]
    return _take_position(hidden, first_token_position(tokens[:, :T], emb_id))
