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

``make_train_step(mesh=)`` is the step of one rank of a (dp, tp) mesh
(parallel/mesh.py): JAX computes the loss on the global batch, so a dp rank
(which holds its own rows, ``local_batch_to_global``) divides its masked
cross-entropy sum by the global batch's token count and its L2Wrap sum by
the global B * T, both known before the forward (one small all-reduce of the
counts, a micro-batch's and, under TBPTT, a chunk's: the batch carries them
to the loss as its ``counts`` argument); the ranks' terms then sum
to JAX's loss, and their gradients to its gradient (train/optim.py
``ShardedOptimizer``, the ZeRO AdamW over dp). ``make_pp_train_step`` trains a
pipeline stage (parallel/pipeline.py) with the moments of its parameters.
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
from rwkv_lm_ext_tpu_torch.train.optim import ShardedOptimizer, make_optimizer


def _denominators(counts, T: int, chunk: Optional[int] = None) -> dict:
    """``causal_lm_loss``'s global denominators from ``counts`` (a dp rank's
    (valid labels a chunk (chunks,), rows) of the global batch, module
    docstring); {} on one rank."""
    if counts is None:
        return {}
    valid, rows = counts
    if chunk is not None:
        return {"count": valid[chunk]}
    return {"count": valid.sum(), "positions": rows * T}


def sft_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat=True,
                use_state_params: bool = False, reference: bool = False,
                l2_wrap: bool = True, counts=None) -> torch.Tensor:
    """Causal-LM SFT loss: batch = {"input_ids" (B, T), "labels" (B, T)}
    with labels -100 on prompt and padding; ``counts``: a dp rank's global
    counts (module docstring); ``l2_wrap=False`` drops the L2Wrap term, as
    JAX's pipeline loss has none."""
    logits, _ = model(batch["input_ids"], remat=remat, use_state_params=use_state_params,
                      t1_step=False, reference=reference)
    return causal_lm_loss(logits, batch["labels"], l2_wrap=l2_wrap,
                          **_denominators(counts, batch["labels"].shape[-1]))


def tbptt_loss_fn(model, batch: Dict[str, torch.Tensor], *, chunk_ctx: int, remat=True,
                  reference: bool = False, counts=None) -> torch.Tensor:
    """TBPTT loss (the module docstring): the running token-weighted mean of
    ``causal_lm_loss(..., l2_wrap=False)`` over the chunks of ``chunk_ctx``
    tokens, the state carried with its gradient (``counts``: a dp rank's
    global counts a chunk)."""
    tokens, labels = batch["input_ids"], batch["labels"]
    B, T = tokens.shape
    if T % chunk_ctx:
        raise ValueError("pad sequences to a multiple of chunk_ctx")
    state = init_model_state(model.cfg, B, device=tokens.device)
    loss_sum = torch.zeros((), device=tokens.device)
    n_sum = torch.zeros((), dtype=torch.int64, device=tokens.device)
    for c, start in enumerate(range(0, T, chunk_ctx)):
        tk, lb = tokens[:, start:start + chunk_ctx], labels[:, start:start + chunk_ctx]
        logits, state = model(tk, state, remat=remat, t1_step=False, reference=reference)
        glob = _denominators(counts, chunk_ctx, c)
        valid = glob.get("count", (lb != -100).sum())
        loss_sum = loss_sum + causal_lm_loss(logits, lb, l2_wrap=False, **glob) * valid
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


def _global_counts(batch: Dict[str, torch.Tensor], mesh, tc: TrainConfig) -> list:
    """A dp rank's micro-batches' global counts, the losses' ``counts``: one
    (valid labels a chunk (chunks,) int64, rows) a micro-batch, from one
    collective (``local_batch_to_global``: it also checks that every rank
    holds the same shapes)."""
    from rwkv_lm_ext_tpu_torch.parallel.distributed import local_batch_to_global

    if "labels" not in batch:
        raise ValueError("a data-parallel step takes causal-LM batches ({'input_ids', 'labels'}): "
                         "the other trainers' losses couple the rows of the global batch (ROADMAP "
                         "A.12)")
    accum = tc.accumulate_grad_batches > 1
    labels = batch["labels"] if accum else batch["labels"][None]
    A, B, T = labels.shape
    chunks = T // tc.chunk_ctx if tc.chunk_ctx and T % tc.chunk_ctx == 0 else 1
    valid = (labels != -100).reshape(A, B, chunks, T // chunks).sum((1, 3))
    rows, total = local_batch_to_global(batch, mesh.dp_group, mesh.dp, counts=valid,
                                        row_axis=1 if accum else 0)
    return [(total[a], rows) for a in range(A)]


def make_train_step(model, tc: TrainConfig, loss_fn: Optional[Callable] = None, *, mesh=None):
    """step(batch, update_mask=None) -> {"loss", "grad_norm"} (0-d tensors
    on the model's device). ``loss_fn(model, batch)`` defaults, as in JAX
    (:115-120), to tbptt_loss_fn when tc.chunk_ctx is set and to sft_loss_fn
    otherwise, with tc.grad_checkpoint as remat. ``update_mask`` maps
    trainable parameter names to 0/1 (LISA): the parameters at 0 keep their
    values. The optimizer, over the parameters that require grad when this
    is called, is ``step.optimizer``.

    ``mesh`` (parallel.mesh.Mesh, dp or tp > 1; the model already cut by
    parallel.tp.shard_for_training where tp > 1) makes it one rank's step:
    the loss of the global batch (module docstring; a dp step takes the
    causal-LM losses, and passes them the global counts as ``counts=``) and
    the ZeRO AdamW
    (``ShardedOptimizer``); "loss" is the global batch's."""
    if loss_fn is None and tc.chunk_ctx:
        loss_fn = functools.partial(tbptt_loss_fn, chunk_ctx=tc.chunk_ctx, remat=tc.grad_checkpoint)
    elif loss_fn is None:
        loss_fn = functools.partial(sft_loss_fn, remat=tc.grad_checkpoint)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    sharded = mesh is not None and (mesh.dp > 1 or mesh.tp > 1)
    if sharded:
        me = mesh.dp_rank * mesh.tp + mesh.rank
        optimizer = ShardedOptimizer(tc, trainable, dp=mesh.dp, dp_rank=mesh.dp_rank,
                                     dp_group=mesh.dp_group, dp_src=mesh.rank, model=mesh.tp,
                                     model_group=mesh.group, model_src=me - mesh.rank)
    else:
        optimizer = make_optimizer(tc, trainable)

    def step(batch: Dict[str, torch.Tensor],
             update_mask: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
        accum = tc.accumulate_grad_batches
        if sharded:
            optimizer.zero_grad()
        else:
            for _, p in trainable:
                p.grad = None
        micros = [batch] if accum == 1 else [{k: v[a] for k, v in batch.items()}
                                             for a in range(accum)]
        counts = (_global_counts(batch, mesh, tc) if sharded and mesh.dp > 1
                  else [None] * len(micros))
        loss = torch.zeros((), device=next(iter(batch.values())).device)
        for micro, micro_counts in zip(micros, counts):
            value = (loss_fn(model, micro) if micro_counts is None
                     else loss_fn(model, micro, counts=micro_counts))
            (value / accum if accum > 1 else value).backward()
            loss += value.detach() / accum
        frozen = None if update_mask is None else [p for n, p in trainable if not update_mask[n]]
        if sharded:
            norm, (loss,) = optimizer.step(keep=frozen, extras=loss.reshape(1))
            return {"loss": loss, "grad_norm": norm}
        return {"loss": loss, "grad_norm": optimizer.step(keep=frozen)}

    step.optimizer = optimizer
    return step


def make_pp_train_step(model, tc: TrainConfig, mesh, *, n_micro: int, reference: bool = False):
    """step(batch) -> {"loss", "grad_norm"}: one rank of GPipe training
    (JAX ``make_pp_train_step`` / ``place_pp_train_state``, train/loop.py
    :223-308). The model is cut to this rank's stage
    (parallel.pipeline.stage_model) and AdamW runs over the stage's
    parameters, its moments sharded over the stage's dp group. The loss is
    JAX's ``pipeline_loss``: token-mean cross entropy of the global batch,
    without L2Wrap; a batch is this dp rank's rows, ``n_micro`` micro-batches
    of them."""
    from rwkv_lm_ext_tpu_torch.parallel.distributed import local_batch_to_global
    from rwkv_lm_ext_tpu_torch.parallel.pipeline import pipeline_loss, stage_model

    if tc.accumulate_grad_batches != 1:
        raise ValueError("pipeline training takes its micro-batches from n_micro, not "
                         "accumulate_grad_batches")
    stage_model(model, mesh)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    optimizer = ShardedOptimizer(tc, trainable, dp=mesh.dp, dp_rank=mesh.dp_rank,
                                 dp_group=mesh.dp_group, dp_src=mesh.stage, model=mesh.pp,
                                 model_group=mesh.pp_group, stage_owned=True)

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        labels = batch["labels"]
        _, count = local_batch_to_global(batch, mesh.dp_group, mesh.dp,
                                         counts=(labels != -100).sum().reshape(1))
        loss = pipeline_loss(model, batch["input_ids"], labels, mesh, n_micro=n_micro,
                             remat=tc.grad_checkpoint, reference=reference, count=count[0])
        norm, (loss,) = optimizer.step(extras=loss.reshape(1))
        return {"loss": loss, "grad_norm": norm}

    step.optimizer = optimizer
    return step
