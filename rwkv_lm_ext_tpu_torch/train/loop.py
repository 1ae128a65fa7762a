"""The training step.

Counterpart of rwkv_lm_ext_tpu/train/loop.py:49-60 (``sft_loss_fn``) and
:100-182 (``make_train_step``) on one device, without a mesh: the loss is
differentiated by autograd through the kernel route (K1-K3 forward, B.5-B.7
backward) and the optimizer (train/optim.py) updates the parameters that
require grad. ``mlm_loss_fn`` and ``mae_loss_fn`` are the encoder trainers'
losses (the closures of ``cmd_mlm``, train/cli.py:1052-1074), through the
bidirectional encoder and the unfused WKV kernel B.8 with its backward. With ``accumulate_grad_batches`` > 1 a batch has a leading
micro-batch axis and the step takes the mean of the micro losses and
gradients, as ``micro`` does (:151-157).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.models.bidirectional import (
    dupmae_bow_loss,
    encoder_forward,
    mae_forward,
)
from rwkv_lm_ext_tpu_torch.models.heads import mlm_logits
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss, mlm_loss
from rwkv_lm_ext_tpu_torch.train.optim import make_optimizer


def sft_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                use_state_params: bool = False) -> torch.Tensor:
    """Causal-LM SFT loss: batch = {"input_ids" (B, T), "labels" (B, T)}
    with labels -100 on prompt and padding."""
    logits, _ = model(batch["input_ids"], remat=remat, use_state_params=use_state_params,
                      t1_step=False)
    return causal_lm_loss(logits, batch["labels"])


def mlm_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                mode: str = "average", reference: bool = False) -> torch.Tensor:
    """Masked-LM loss of the bidirectional encoder with the tied head:
    batch = {"input_ids" (B, T), "labels" (B, T)}, labels -100 off the masked
    positions."""
    hidden = encoder_forward(model, batch["input_ids"], mode=mode, remat=remat,
                             reference=reference)
    return mlm_loss(mlm_logits(model, hidden), batch["labels"])


def mae_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                dup_mae: bool = False, mode: str = "average",
                reference: bool = False) -> torch.Tensor:
    """RetroMAE loss: the encoder's MLM loss plus the one-layer decoder's
    (``model.onelayer_decoder``), plus the DupMAE bag-of-words loss when
    ``dup_mae`` and the batch carries ``bag_word_weight``."""
    out = mae_forward(model, batch["encoder_input_ids"], batch["decoder_input_ids"],
                      mode=mode, remat=remat, reference=reference)
    loss = mlm_loss(out["encoder_logits"], batch["encoder_labels"])
    loss = loss + mlm_loss(out["decoder_logits"], batch["decoder_labels"])
    if dup_mae and "bag_word_weight" in batch:
        loss = loss + dupmae_bow_loss(out["ot_logits"], batch["bag_word_weight"])
    return loss


def make_train_step(model, tc: TrainConfig, loss_fn: Optional[Callable] = None):
    """step(batch) -> {"loss", "grad_norm"} (0-d tensors on the model's
    device). ``loss_fn(model, batch)`` defaults to sft_loss_fn with
    tc.grad_checkpoint as remat. The optimizer, over the parameters that
    require grad when this is called, is ``step.optimizer``."""
    if loss_fn is None:
        loss_fn = functools.partial(sft_loss_fn, remat=tc.grad_checkpoint)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    optimizer = make_optimizer(tc, trainable)

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
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
        return {"loss": loss, "grad_norm": optimizer.step()}

    step.optimizer = optimizer
    return step
