"""Task heads: sequence embedding, classification / reranking, instructor
embeddings and MLM.

Counterpart of rwkv_lm_ext_tpu/models/heads.py:26-102
(first_token_position, pool_hidden, embed_sequences with its dense+tanh
head), :104-132 (classify_sequences), :134-147 (mlm_logits), :150-174
(instructor_embed), :177-218 (embed_sequences_chunked) and :221-245
(init_embedding_head, init_classification_head).

The heads' parameters are small modules in the reference's layout, so a
trainer attaches them to the model (``model.score``, ``model.dense``,
``model.ln_dense``) and its checkpoint holds them beside the base weights:
``ScoreHead`` is ``score.weight`` (num_labels, C), no bias (the JAX tree's
``{"kernel": (C, n)}`` transposed); ``DenseHead`` is ``dense.weight`` (out,
C) and ``dense.bias``; the instructor's LayerNorm is a ``models.rwkv.Norm``
(``ln_dense.weight``, ``ln_dense.bias``). Their names match none of the
optimizer's lr-group patterns (train/optim.py), and their matrices get
weight decay, their vectors none, as in the JAX optimizer. The heads run in
fp32 on the fp32 pooled embedding.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rwkv_lm_ext_tpu_torch.config import CLS_ID, EMB_ID
from rwkv_lm_ext_tpu_torch.models.rwkv import Norm
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain


class ScoreHead(nn.Module):
    """The classification / reranking head: ``weight`` (num_labels, C)."""

    def __init__(self, C: int, num_labels: int = 1, *, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_labels, C, dtype=torch.float32, device=device))


class DenseHead(nn.Module):
    """A dense projection with bias: ``weight`` (out, C), ``bias`` (out,)."""

    def __init__(self, C: int, out: int, *, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, C, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(out, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def init_embedding_head(cfg, *, generator: torch.Generator, output_dim: int = 0) -> DenseHead:
    """The add_mlp dense head: weight uniform in +-1/sqrt(C), zero bias,
    drawn from ``generator`` on its device."""
    out = output_dim or cfg.n_embd
    head = DenseHead(cfg.n_embd, out, device=generator.device)
    lim = 1.0 / cfg.n_embd ** 0.5
    with torch.no_grad():
        head.weight.uniform_(-lim, lim, generator=generator)
        head.bias.zero_()
    return head


def init_classification_head(cfg, *, generator: torch.Generator, num_labels: int = 1) -> ScoreHead:
    """The score head: weight uniform in +-1/sqrt(C), drawn from
    ``generator`` on its device."""
    head = ScoreHead(cfg.n_embd, num_labels, device=generator.device)
    lim = 1.0 / cfg.n_embd ** 0.5
    with torch.no_grad():
        head.weight.uniform_(-lim, lim, generator=generator)
    return head


def init_layer_norm(C: int, *, device) -> Norm:
    """A unit LayerNorm (weight 1, bias 0) in fp32: the instructor head's."""
    ln = Norm(C, device=device, dtype=torch.float32)
    with torch.no_grad():
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    return ln


def first_token_position(tokens: torch.Tensor, token_id: int) -> torch.Tensor:
    """Index of the first occurrence of token_id per row (0 if absent)."""
    return torch.argmax((tokens == token_id).to(torch.int32), dim=-1)


def pool_hidden(
    x: torch.Tensor, actual_len: torch.Tensor, pooling_type: str = "weightedmean"
) -> torch.Tensor:
    """Pool (B, T, C) hidden states to (B, C) fp32.

    `actual_len` is the first-emb_id position. "weightedmean" is the
    training-side pooling (the default everywhere); "weightedmean_runtime"
    the streaming runtime's off-by-one variant (actual_len + 1 in the mask,
    the weight denominator and the divisor); "lasttoken" takes the row at
    actual_len; "avg" averages the rows before it.
    """
    B, T, C = x.shape
    xf = x.float()
    pos = torch.arange(T, device=x.device)[None, :]
    ramp = torch.arange(1, T + 1, device=x.device, dtype=torch.float32)[None, :]
    L = actual_len[:, None].float()
    if pooling_type == "weightedmean":
        mask = (pos <= actual_len[:, None]).float()
        return torch.sum(xf * ((ramp / L) * mask)[..., None], dim=1) / L
    if pooling_type == "weightedmean_runtime":
        L1 = L + 1.0
        mask = (pos <= actual_len[:, None] + 1).float()
        return torch.sum(xf * ((ramp / L1) * mask)[..., None], dim=1) / L1
    if pooling_type == "lasttoken":
        return xf[torch.arange(B, device=x.device), actual_len]
    if pooling_type == "avg":
        mask = (pos < actual_len[:, None]).float()
        return torch.sum(xf * mask[..., None], dim=1) / L
    raise ValueError(f"unknown pooling_type {pooling_type!r}")


def _hidden(model, tokens, state=None, *, remat: bool = False, reference: bool = False,
            dropout=None):
    return model(tokens, state, return_hidden=True, return_logits=False, remat=remat,
                 reference=reference, dropout=dropout)


def _dense_tanh(emb: torch.Tensor, head: Optional[DenseHead]) -> torch.Tensor:
    return emb if head is None else torch.tanh(head(emb))


def embed_sequences(
    model,
    tokens: torch.Tensor,
    *,
    head: Optional[DenseHead] = None,
    pooling_type: str = "weightedmean",
    embedding_id: int = EMB_ID,
    normalize: bool = False,
    remat: bool = False,
    reference: bool = False,
    dropout=None,
) -> torch.Tensor:
    """(B, T) token ids (emb_id-terminated, pad-padded) -> (B, C) fp32
    embeddings, or (B, out) through the dense+tanh ``head``; L2-normalised
    when `normalize`. `reference` is passed to the model (plain versions of
    the kernels), `remat` too (per-block recompute under grad), and
    `dropout` (a models.rwkv.Dropout: the model drops at JAX's sites)."""
    hidden, _ = _hidden(model, tokens, remat=remat, reference=reference, dropout=dropout)
    emb = pool_hidden(hidden, first_token_position(tokens, embedding_id), pooling_type)
    emb = _dense_tanh(emb, head)
    if normalize:
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return emb


def classify_sequences(
    model,
    tokens: torch.Tensor,
    score: ScoreHead,
    *,
    class_id: int = CLS_ID,
    remat: bool = False,
    reference: bool = False,
) -> torch.Tensor:
    """Cross-encoder / classification scores: the hidden state at the first
    class_id position times ``score.weight``.T in fp32, no bias. (B,
    num_labels), squeezed to (B,) when num_labels == 1. A row without
    class_id scores position 0 (argmax of an all-zero row), as in the JAX
    package."""
    hidden, _ = _hidden(model, tokens, remat=remat, reference=reference)
    pos = first_token_position(tokens, class_id)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), pos]
    scores = pooled.float() @ score.weight.float().T
    return scores[..., 0] if scores.shape[-1] == 1 else scores


def instructor_embed(
    model,
    tokens: torch.Tensor,
    dense: DenseHead,
    ln: Norm,
    *,
    pooling_type: str = "weightedmean",
    embedding_id: int = EMB_ID,
    remat: bool = False,
    reference: bool = False,
) -> torch.Tensor:
    """Instructor embedder: pooled hidden -> ``dense`` (out) -> LayerNorm
    ``ln`` over out, through ops.ln.layer_norm (kernel K3 on the card, as
    the JAX ``layer_norm`` reaches ``ln_pallas``). fp32 (B, out)."""
    hidden, _ = _hidden(model, tokens, remat=remat, reference=reference)
    emb = dense(pool_hidden(hidden, first_token_position(tokens, embedding_id), pooling_type))
    norm = layer_norm_plain if reference else layer_norm
    return norm(emb, ln.weight, ln.bias)


def embed_sequences_chunked(
    model,
    tokens: torch.Tensor,
    *,
    chunk_ctx: int,
    head: Optional[DenseHead] = None,
    pooling_type: str = "weightedmean",
    embedding_id: int = EMB_ID,
    reference: bool = False,
) -> torch.Tensor:
    """The infinite-context embedder: the sequence in chunk_ctx pieces (the
    last padded with 0), the recurrent state carried from piece to piece,
    the hidden states reassembled and pooled, then the optional dense+tanh
    head."""
    B, T = tokens.shape
    pad = (-T) % chunk_ctx
    if pad:
        tokens = F.pad(tokens, (0, pad))
    state, pieces = None, []
    for s in range(0, T + pad, chunk_ctx):
        h, state = _hidden(model, tokens[:, s: s + chunk_ctx], state, reference=reference)
        pieces.append(h)
    hidden = torch.cat(pieces, dim=1)[:, :T]
    emb = pool_hidden(hidden, first_token_position(tokens[:, :T], embedding_id), pooling_type)
    return _dense_tanh(emb, head)


def mlm_logits(
    model, hidden: torch.Tensor, *, share_emb: bool = True,
    lm_head: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MLM prediction head in fp32: tied to the embedding matrix
    (hidden @ emb.T), or a separate (C, V) projection ``lm_head``."""
    if share_emb:
        return hidden.float() @ model.emb.weight.float().T
    if lm_head is None:
        raise ValueError("share_emb=False needs lm_head")
    return hidden.float() @ lm_head.float()
