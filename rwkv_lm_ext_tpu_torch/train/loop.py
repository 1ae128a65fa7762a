"""The training step.

Counterpart of rwkv_lm_ext_tpu/train/loop.py:49-60 (``sft_loss_fn``) and
:100-182 (``make_train_step``) on one device, without a mesh: the loss is
differentiated by autograd through the kernel route (K1-K3 forward, B.5-B.7
backward) and the optimizer (train/optim.py) updates the parameters that
require grad. With ``accumulate_grad_batches`` > 1 a batch has a leading
micro-batch axis and the step takes the mean of the micro losses and
gradients, as ``micro`` does (:151-157).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss
from rwkv_lm_ext_tpu_torch.train.optim import make_optimizer


def sft_loss_fn(model, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                use_state_params: bool = False) -> torch.Tensor:
    """Causal-LM SFT loss: batch = {"input_ids" (B, T), "labels" (B, T)}
    with labels -100 on prompt and padding."""
    logits, _ = model(batch["input_ids"], remat=remat, use_state_params=use_state_params,
                      t1_step=False)
    return causal_lm_loss(logits, batch["labels"])


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
            loss = torch.zeros((), device=batch["input_ids"].device)
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
