"""The training step.

Counterpart of rwkv_lm_ext_tpu/train/loop.py:49-60 (``sft_loss_fn``),
:63-99 (``tbptt_loss_fn``) and :100-182 (``make_train_step``) on one
device, without a mesh: the loss is differentiated by autograd through the
kernel route (K1-K3 forward, B.5-B.7 backward) and the optimizer
(train/optim.py) updates the parameters that require grad. The step takes
an optional per-parameter 0/1 ``update_mask``, JAX's LISA hook (:165-169):
the masked parameters keep their values while the clip, the global norm and
the Adam moments run over every parameter.

``tbptt_loss_fn`` (TBPTT, the reference's infctx training) cuts each
sequence into ``chunk_ctx`` chunks and carries the whole model state (the
token shifts and the WKV state; RWKV-4's aa, bb and pp through B.14's
backward kernel) from chunk to chunk *with its gradient*, as
the JAX scan does (the wkv6infctx "gs path"): K1 takes the carried state as
an input that requires grad and B.6/B.7 give it its gradient (``ds0``), K2
and B.5 the same for the token shift (``dshift``). So the loss and the
gradients are those of the whole sequence without L2Wrap; nothing is
truncated, and only the activations a chunk holds are bounded. The state
starts at zeros (``init_model_state``), as JAX's does, also where the model
has a ``time_state``: the full-sequence loss that TBPTT equals does not read
it either. ``mlm_loss_fn`` and ``mae_loss_fn`` are the encoder trainers'
losses (the closures of ``cmd_mlm``, train/cli.py:1052-1074), through the
bidirectional encoder and the unfused WKV kernel B.8 with its backward
(``mae_loss_fn(bidirectional=False)`` is ``mae --uni``: the causal model as
the encoder). The sequence-level trainers' losses are the closures of the JAX
train/cli.py, one function each: ``contrastive_loss_fn`` (``cmd_bi_encoder``
:665 and ``cmd_nli`` :714: pooled embeddings of query / positive / negative,
in-batch InfoNCE or CoSENT), ``cross_encoder_loss_fn`` (``cmd_cross_encoder``
:945: the score head at the cls position, MSE on 0/1 labels),
``simcse_loss_fn`` (``cmd_simcse`` :1089, sentence pairs or, with
dropout, two noised views of one text),
``instructor_loss_fn`` (``cmd_instructor`` :1178: dense + LayerNorm head,
symmetric InfoNCE), ``encoder_biencoder_loss_fn`` (:823: bidirectional
sentence embeddings, symmetric InfoNCE) and ``encoder_crossencoder_loss_fn``
(:863: the score head on the bidirectional sentence embedding, group
softmax). The heads they read (``model.score``, ``model.dense``,
``model.ln_dense``) are attached to the model before ``make_train_step``, so
they count among its trainable parameters. With ``accumulate_grad_batches`` >
1 a batch has a leading micro-batch axis and the step takes the mean of the
micro losses and gradients, as ``micro`` does (:151-157).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.models.bidirectional import (
    dupmae_bow_loss,
    encode_sentence,
    encoder_forward,
    mae_forward,
)
from rwkv_lm_ext_tpu_torch.models.heads import (
    classify_sequences,
    embed_sequences,
    first_token_position,
    instructor_embed,
    mlm_logits,
    pool_hidden,
)
from rwkv_lm_ext_tpu_torch.train.losses import (
    causal_lm_loss,
    classification_loss,
    cosent_loss,
    group_softmax_loss,
    in_batch_infonce,
    mlm_loss,
    simcse_loss,
    symmetric_infonce,
)
from rwkv_lm_ext_tpu_torch.models.state import init_model_state
from rwkv_lm_ext_tpu_torch.train.optim import make_optimizer


def sft_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat=True,
                use_state_params: bool = False, reference: bool = False) -> torch.Tensor:
    """Causal-LM SFT loss: batch = {"input_ids" (B, T), "labels" (B, T)}
    with labels -100 on prompt and padding."""
    logits, _ = model(batch["input_ids"], remat=remat, use_state_params=use_state_params,
                      t1_step=False, reference=reference)
    return causal_lm_loss(logits, batch["labels"])


def tbptt_loss_fn(model, batch: Dict[str, torch.Tensor], *, chunk_ctx: int, remat=True,
                  reference: bool = False) -> torch.Tensor:
    """TBPTT loss (the module docstring): the running token-weighted mean of
    ``causal_lm_loss(..., l2_wrap=False)`` over the chunks of ``chunk_ctx``
    tokens, the state carried with its gradient."""
    tokens, labels = batch["input_ids"], batch["labels"]
    B, T = tokens.shape
    if T % chunk_ctx:
        raise ValueError("pad sequences to a multiple of chunk_ctx")
    state = init_model_state(model.cfg, B, device=tokens.device)
    loss_sum = torch.zeros((), device=tokens.device)
    n_sum = torch.zeros((), dtype=torch.int64, device=tokens.device)
    for start in range(0, T, chunk_ctx):
        tk, lb = tokens[:, start:start + chunk_ctx], labels[:, start:start + chunk_ctx]
        logits, state = model(tk, state, remat=remat, t1_step=False, reference=reference)
        valid = (lb != -100).sum()
        loss_sum = loss_sum + causal_lm_loss(logits, lb, l2_wrap=False) * valid
        n_sum = n_sum + valid
    return loss_sum / n_sum.clamp_min(1)


def mlm_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                mode: str = "average", reference: bool = False) -> torch.Tensor:
    """Masked-LM loss of the bidirectional encoder with the tied head:
    batch = {"input_ids" (B, T), "labels" (B, T)}, labels -100 off the masked
    positions."""
    hidden = encoder_forward(model, batch["input_ids"], mode=mode, remat=remat,
                             reference=reference)
    return mlm_loss(mlm_logits(model, hidden), batch["labels"])


def mae_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                dup_mae: bool = False, mode: str = "average", bidirectional: bool = True,
                reference: bool = False) -> torch.Tensor:
    """RetroMAE loss: the encoder's MLM loss plus the one-layer decoder's
    (``model.onelayer_decoder``), plus the DupMAE bag-of-words loss when
    ``dup_mae`` and the batch carries ``bag_word_weight``."""
    out = mae_forward(model, batch["encoder_input_ids"], batch["decoder_input_ids"],
                      bidirectional=bidirectional, mode=mode, remat=remat, reference=reference)
    loss = mlm_loss(out["encoder_logits"], batch["encoder_labels"])
    loss = loss + mlm_loss(out["decoder_logits"], batch["decoder_labels"])
    if dup_mae and "bag_word_weight" in batch:
        loss = loss + dupmae_bow_loss(out["ot_logits"], batch["bag_word_weight"])
    return loss


TRIPLET_KEYS = ("query", "positive", "negative")


def _triplet(embed, batch):
    """The embeddings of the batch's query / positive / negative fields
    (negative None when the batch has none)."""
    embs = {k: embed(batch[k]) for k in TRIPLET_KEYS if k in batch}
    return embs["query"], embs["positive"], embs.get("negative")


def contrastive_loss_fn(model, batch, *, loss: str = "infonce", pooling: str = "weightedmean",
                        remat: bool = True, reference: bool = False) -> torch.Tensor:
    """``bi-encoder`` and ``nli``: pooled embeddings of the triplet, in-batch
    InfoNCE (scale 20, ``loss="infonce"``) or CoSENT (``"cosent"``)."""
    fn = in_batch_infonce if loss == "infonce" else cosent_loss
    return fn(*_triplet(lambda t: embed_sequences(model, t, pooling_type=pooling, remat=remat,
                                                  reference=reference), batch))


def cross_encoder_loss_fn(model, batch, *, remat: bool = True,
                          reference: bool = False) -> torch.Tensor:
    """``cross-encoder``: ``model.score`` at the cls position of ``q [sep] d
    [cls]`` rows, MSE on the 0/1 labels."""
    scores = classify_sequences(model, batch["input_ids"], model.score, remat=remat,
                                reference=reference)
    return classification_loss(scores, batch["labels"])


def simcse_loss_fn(model, batch, *, pooling: str = "weightedmean", temperature: float = 0.05,
                   remat: bool = True, reference: bool = False, dropout=None) -> torch.Tensor:
    """``simcse``: pooled embeddings of a and b, in-batch cross entropy at the
    temperature. With ``dropout`` (a models.rwkv.Dropout: ``--dropout-noise``)
    each side is a view of its own, its masks drawn after the other's, as the
    JAX closure draws them from two split keys."""
    def embed(tokens):
        return embed_sequences(model, tokens, pooling_type=pooling, embedding_id=1, remat=remat,
                               reference=reference, dropout=dropout)

    return simcse_loss(embed(batch["a"]), embed(batch["b"]), temperature=temperature)


def instructor_loss_fn(model, batch, *, pooling: str = "weightedmean",
                       temperature: float = 0.05, remat: bool = True,
                       reference: bool = False) -> torch.Tensor:
    """``instructor``: instruction-prefixed triplets through the dense +
    LayerNorm head (``model.dense``, ``model.ln_dense``), symmetric InfoNCE.
    The JAX closure runs ``instructor_embed`` without remat; the gradient is
    the same either way."""
    return symmetric_infonce(*_triplet(lambda t: instructor_embed(
        model, t, model.dense, model.ln_dense, pooling_type=pooling, remat=remat,
        reference=reference), batch), temperature=temperature)


def encoder_biencoder_loss_fn(model, batch, *, mode: str = "average", temperature: float = 0.05,
                              remat: bool = True, reference: bool = False) -> torch.Tensor:
    """``encoder-biencoder``: bidirectional sentence embeddings of the
    triplet, symmetric InfoNCE."""
    return symmetric_infonce(*_triplet(lambda t: encode_sentence(
        model, t, mode=mode, remat=remat, reference=reference), batch), temperature=temperature)


def encoder_crossencoder_loss_fn(model, batch, *, group_size: int, mode: str = "average",
                                 remat: bool = True, reference: bool = False) -> torch.Tensor:
    """``encoder-crossencoder``: (B * G, T) ``q [sep] d [cls]`` rows, the
    bidirectional sentence embedding times ``model.score``, group softmax
    with the positive in column 0 of each group of G."""
    emb = encode_sentence(model, batch["input_ids"], mode=mode, remat=remat, reference=reference)
    scores = emb.float() @ model.score.weight.float().T
    return group_softmax_loss(scores.reshape(-1, group_size))


def make_train_step(model, tc: TrainConfig, loss_fn: Optional[Callable] = None):
    """step(batch, update_mask=None) -> {"loss", "grad_norm"} (0-d tensors
    on the model's device). ``loss_fn(model, batch)`` defaults, as in JAX
    (:115-120), to tbptt_loss_fn when tc.chunk_ctx is set and to sft_loss_fn
    otherwise, with tc.grad_checkpoint as remat. ``update_mask`` maps
    trainable parameter names to 0/1 (LISA): the parameters at 0 keep their
    values. The optimizer, over the parameters that require grad when this
    is called, is ``step.optimizer``."""
    if loss_fn is None and tc.chunk_ctx:
        loss_fn = functools.partial(tbptt_loss_fn, chunk_ctx=tc.chunk_ctx, remat=tc.grad_checkpoint)
    elif loss_fn is None:
        loss_fn = functools.partial(sft_loss_fn, remat=tc.grad_checkpoint)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    optimizer = make_optimizer(tc, trainable)

    def step(batch: Dict[str, torch.Tensor],
             update_mask: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
        for _, p in trainable:
            p.grad = None
        accum = tc.accumulate_grad_batches
        if accum > 1:
            loss = torch.zeros((), device=next(iter(batch.values())).device)
            for a in range(accum):
                micro = loss_fn(model, {k: v[a] for k, v in batch.items()})
                (micro / accum).backward()
                loss += micro.detach() / accum
        else:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        frozen = None if update_mask is None else [p for n, p in trainable if not update_mask[n]]
        return {"loss": loss, "grad_norm": optimizer.step(keep=frozen)}

    step.optimizer = optimizer
    return step
