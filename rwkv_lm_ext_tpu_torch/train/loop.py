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
(parallel/mesh.py): JAX computes the loss on the global batch, so the ranks'
loss terms must sum to that loss and their gradients (summed by
train/optim.py ``ShardedOptimizer``, the ZeRO AdamW over dp) to its gradient.
A dp rank holds its own rows (``local_batch_to_global``); before the forward
one small collective gives it the global counts of each micro-batch
(``GlobalBatch``: the rows, and each token-label field's count of labels
that are not -100, under TBPTT a chunk's), which the step passes to the loss
as its ``counts`` argument. By loss:

- a mean over tokens or rows (the causal LM with L2Wrap over the global B *
  T, the MLM and RetroMAE cross entropies, the DupMAE bag-of-words term, the
  cross-encoder's MSE, the encoder cross-encoder's group softmax) divides
  its rank's sum by the global count;
- a loss that couples the rows (in-batch InfoNCE, CoSENT, the symmetric
  InfoNCE of instructor and the encoder bi-encoder, SimCSE) gathers the
  pooled embeddings of the global batch with ``all_gather_autograd``
  (parallel/distributed.py) and takes the global loss over dp: every rank
  computes the same global loss, its backward sums each rank's slice of the
  embedding gradient over the ranks, so the ranks' gradients sum to the
  global loss's and their terms to the loss;
- ``encoder-crossencoder``'s rows come in groups of G (a query and its G
  documents); the dp split keeps a group on one rank (train/cli.py cuts a
  batch of whole examples into equal shares of its rows), so its softmax over
  each group needs no gather.

Under ``simcse_loss_fn(dropout=)`` a dp rank draws each mask for the global
batch and keeps its rows (``Dropout.rows``), so a row's masks do not change
with dp. ``make_pp_train_step`` trains a pipeline stage (parallel/pipeline.py)
with the moments of its parameters.
"""
from __future__ import annotations

import dataclasses
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
from rwkv_lm_ext_tpu_torch.parallel.distributed import all_gather_autograd
from rwkv_lm_ext_tpu_torch.train.optim import ShardedOptimizer, make_optimizer

# the token-label fields whose counts a dp step gathers (-100: not a target)
LABEL_KEYS = ("labels", "encoder_labels", "decoder_labels")


@dataclasses.dataclass
class GlobalBatch:
    """What a dp rank's loss knows of the global (micro-)batch (the module
    docstring): its ``rows``, ``valid[key]`` the count of labels that are
    not -100 of each token-label field (int64; ``labels`` (chunks,), one a
    TBPTT chunk), and the dp ``group`` with ``dp`` ranks, this one
    ``dp_rank``, over which a coupled loss gathers."""

    rows: int
    valid: Dict[str, torch.Tensor]
    group: object = None
    dp: int = 1
    dp_rank: int = 0


def _denominators(counts: Optional[GlobalBatch], T: int, chunk: Optional[int] = None) -> dict:
    """``causal_lm_loss``'s global denominators from ``counts`` (module
    docstring); {} on one rank."""
    if counts is None:
        return {}
    valid = counts.valid["labels"]
    if chunk is not None:
        return {"count": valid[chunk]}
    return {"count": valid.sum(), "positions": counts.rows * T}


def _count(counts: Optional[GlobalBatch], key: str):
    """The global count of ``key``'s targets, or None on one rank."""
    return None if counts is None else counts.valid[key].sum()


def _global_rows(x: torch.Tensor, counts: Optional[GlobalBatch]) -> torch.Tensor:
    """The global batch's rows of ``x`` (each rank's, in rank order), with
    the gather's gradient; ``x`` itself on one rank."""
    if counts is None or counts.dp == 1:
        return x
    return all_gather_autograd(x, counts.group).flatten(0, 1)


def _coupled(loss_fn, counts: Optional[GlobalBatch], *embeddings) -> torch.Tensor:
    """A loss that couples the rows, on the global batch's embeddings: on a
    dp rank the global loss over dp (the module docstring)."""
    value = loss_fn(*(None if e is None else _global_rows(e, counts) for e in embeddings))
    return value if counts is None else value / counts.dp


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
                mode: str = "average", reference: bool = False, counts=None) -> torch.Tensor:
    """Masked-LM loss of the bidirectional encoder with the tied head:
    batch = {"input_ids" (B, T), "labels" (B, T)}, labels -100 off the masked
    positions; ``counts``: a dp rank's ``GlobalBatch``."""
    hidden = encoder_forward(model, batch["input_ids"], mode=mode, remat=remat,
                             reference=reference)
    return mlm_loss(mlm_logits(model, hidden), batch["labels"], count=_count(counts, "labels"))


def mae_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                dup_mae: bool = False, mode: str = "average", bidirectional: bool = True,
                reference: bool = False, counts=None) -> torch.Tensor:
    """RetroMAE loss: the encoder's MLM loss plus the one-layer decoder's
    (``model.onelayer_decoder``), plus the DupMAE bag-of-words loss when
    ``dup_mae`` and the batch carries ``bag_word_weight``; ``counts``: a dp
    rank's ``GlobalBatch`` (each term over its own global count)."""
    out = mae_forward(model, batch["encoder_input_ids"], batch["decoder_input_ids"],
                      bidirectional=bidirectional, mode=mode, remat=remat, reference=reference)
    loss = mlm_loss(out["encoder_logits"], batch["encoder_labels"],
                    count=_count(counts, "encoder_labels"))
    loss = loss + mlm_loss(out["decoder_logits"], batch["decoder_labels"],
                           count=_count(counts, "decoder_labels"))
    if dup_mae and "bag_word_weight" in batch:
        loss = loss + dupmae_bow_loss(out["ot_logits"], batch["bag_word_weight"],
                                      rows=None if counts is None else counts.rows)
    return loss


TRIPLET_KEYS = ("query", "positive", "negative")


def _triplet(embed, batch):
    """The embeddings of the batch's query / positive / negative fields
    (negative None when the batch has none)."""
    embs = {k: embed(batch[k]) for k in TRIPLET_KEYS if k in batch}
    return embs["query"], embs["positive"], embs.get("negative")


def contrastive_loss_fn(model, batch, *, loss: str = "infonce", pooling: str = "weightedmean",
                        remat: bool = True, reference: bool = False, counts=None) -> torch.Tensor:
    """``bi-encoder`` and ``nli``: pooled embeddings of the triplet, in-batch
    InfoNCE (scale 20, ``loss="infonce"``) or CoSENT (``"cosent"``), over the
    global batch on a dp rank (``counts``)."""
    fn = in_batch_infonce if loss == "infonce" else cosent_loss
    return _coupled(fn, counts, *_triplet(lambda t: embed_sequences(
        model, t, pooling_type=pooling, remat=remat, reference=reference), batch))


def cross_encoder_loss_fn(model, batch, *, remat: bool = True, reference: bool = False,
                          counts=None) -> torch.Tensor:
    """``cross-encoder``: ``model.score`` at the cls position of ``q [sep] d
    [cls]`` rows, MSE on the 0/1 labels (over the global rows on a dp
    rank)."""
    scores = classify_sequences(model, batch["input_ids"], model.score, remat=remat,
                                reference=reference)
    return classification_loss(scores, batch["labels"],
                               rows=None if counts is None else counts.rows)


def simcse_loss_fn(model, batch, *, pooling: str = "weightedmean", temperature: float = 0.05,
                   remat: bool = True, reference: bool = False, dropout=None,
                   counts=None) -> torch.Tensor:
    """``simcse``: pooled embeddings of a and b, in-batch cross entropy at the
    temperature, over the global batch on a dp rank. With ``dropout`` (a
    models.rwkv.Dropout: ``--dropout-noise``) each side is a view of its own,
    its masks drawn after the other's, as the JAX closure draws them from two
    split keys (a dp rank's: its rows of the global batch's masks)."""
    if dropout is not None and counts is not None:
        dropout = dropout.rows(counts.dp_rank, counts.dp)

    def embed(tokens):
        return embed_sequences(model, tokens, pooling_type=pooling, embedding_id=1, remat=remat,
                               reference=reference, dropout=dropout)

    return _coupled(functools.partial(simcse_loss, temperature=temperature), counts,
                    embed(batch["a"]), embed(batch["b"]))


def instructor_loss_fn(model, batch, *, pooling: str = "weightedmean",
                       temperature: float = 0.05, remat: bool = True,
                       reference: bool = False, counts=None) -> torch.Tensor:
    """``instructor``: instruction-prefixed triplets through the dense +
    LayerNorm head (``model.dense``, ``model.ln_dense``), symmetric InfoNCE
    (over the global batch on a dp rank). The JAX closure runs
    ``instructor_embed`` without remat; the gradient is the same either
    way."""
    return _coupled(functools.partial(symmetric_infonce, temperature=temperature), counts,
                    *_triplet(lambda t: instructor_embed(
                        model, t, model.dense, model.ln_dense, pooling_type=pooling,
                        remat=remat, reference=reference), batch))


def encoder_biencoder_loss_fn(model, batch, *, mode: str = "average", temperature: float = 0.05,
                              remat: bool = True, reference: bool = False,
                              counts=None) -> torch.Tensor:
    """``encoder-biencoder``: bidirectional sentence embeddings of the
    triplet, symmetric InfoNCE (over the global batch on a dp rank)."""
    return _coupled(functools.partial(symmetric_infonce, temperature=temperature), counts,
                    *_triplet(lambda t: encode_sentence(model, t, mode=mode, remat=remat,
                                                        reference=reference), batch))


def encoder_crossencoder_loss_fn(model, batch, *, group_size: int, mode: str = "average",
                                 remat: bool = True, reference: bool = False,
                                 counts=None) -> torch.Tensor:
    """``encoder-crossencoder``: (B * G, T) ``q [sep] d [cls]`` rows, the
    bidirectional sentence embedding times ``model.score``, group softmax
    with the positive in column 0 of each group of G (a dp rank holds whole
    groups and divides by the global count of them)."""
    if batch["input_ids"].shape[0] % group_size:
        raise ValueError(f"encoder-crossencoder rows come in groups of {group_size}: a batch of "
                         f"{batch['input_ids'].shape[0]} rows splits one")
    emb = encode_sentence(model, batch["input_ids"], mode=mode, remat=remat, reference=reference)
    scores = emb.float() @ model.score.weight.float().T
    return group_softmax_loss(scores.reshape(-1, group_size),
                              count=None if counts is None else counts.rows // group_size)


def _global_counts(batch: Dict[str, torch.Tensor], mesh, tc: TrainConfig) -> list:
    """A dp rank's micro-batches' ``GlobalBatch``, the losses' ``counts``:
    the global rows and, for each token-label field of ``LABEL_KEYS`` the
    batch has (``labels`` a TBPTT chunk at a time), its count of targets,
    from one collective (``local_batch_to_global``: it also checks that
    every rank holds the same shapes)."""
    from rwkv_lm_ext_tpu_torch.parallel.distributed import local_batch_to_global

    accum = tc.accumulate_grad_batches > 1
    lead = 1 if accum else 0
    first = next(iter(batch.values()))
    A = first.shape[0] if accum else 1
    keys, parts = [], []
    for key in LABEL_KEYS:
        if key not in batch or batch[key].dim() != 2 + lead:   # not (B, T) token labels
            continue
        labels = batch[key] if accum else batch[key][None]
        T = labels.shape[2]
        chunks = (T // tc.chunk_ctx if key == "labels" and tc.chunk_ctx and T % tc.chunk_ctx == 0
                  else 1)
        parts.append((labels != -100).reshape(A, labels.shape[1], chunks, T // chunks).sum((1, 3)))
        keys.append((key, chunks))
    valid = (torch.cat(parts, 1) if parts
             else torch.zeros(A, 0, dtype=torch.int64, device=first.device))
    rows, total = local_batch_to_global(batch, mesh.dp_group, mesh.dp, counts=valid,
                                        row_axis=lead)
    return [GlobalBatch(rows, dict(zip((k for k, _ in keys), total[a].split([c for _, c in keys]))),
                        mesh.dp_group, mesh.dp, mesh.dp_rank) for a in range(A)]


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
    the loss of the global batch (module docstring; a dp step passes each
    micro-batch's ``GlobalBatch`` to the loss as ``counts=``) and the ZeRO
    AdamW (``ShardedOptimizer``); "loss" is the global batch's."""
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
