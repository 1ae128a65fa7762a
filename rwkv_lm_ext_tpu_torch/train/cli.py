"""Trainer entry point: LoRA and state-tuning SFT on one device.

Counterpart of rwkv_lm_ext_tpu/train/cli.py: the ``sft`` subcommand
(``cmd_sft``, :355-548, with ``_common_args`` :28-90, ``_train_config``,
``_sft_batches`` :320-352 and ``_run_loop`` :225-317) for the train types
``lora`` and ``state``/``states``. Full fine-tuning, PiSSA, slot-LoRA, QLoRA
(--quant), TBPTT (--chunk-ctx), LISA, dp/tp/pp, Orbax train-state I/O, the
``dots`` remat policies and the other trainers wait; their flags and train
types are refused by argparse.

Usage:
  python -m rwkv_lm_ext_tpu_torch.train.cli sft --model base.pth \\
      --train-data data.jsonl --output-dir out --train-type lora

Prints ``step N: {json}`` lines (loss, grad_norm, lr, it/s, Kt/s) and writes
``lora-step{N}.pth`` or ``states-step{N}.pth`` and ``train_log.txt`` into
--output-dir.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
from typing import Callable, Iterator

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    init_lora_params,
    lora_state_dict_to_tree,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.data.buckets import BucketBatchSampler
from rwkv_lm_ext_tpu_torch.data.collators import sft_collate
from rwkv_lm_ext_tpu_torch.data.sft import load_sft_jsonl
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.models.rwkv import normalize_remat
from rwkv_lm_ext_tpu_torch.train.callbacks import (
    MetricsLogger,
    save_lora_checkpoint,
    save_states_checkpoint,
)
from rwkv_lm_ext_tpu_torch.train.loop import make_train_step, sft_loss_fn
from rwkv_lm_ext_tpu_torch.train.optim import apply_trainable_mask, make_schedule, trainable_mask


def _common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", required=True, help="base .pth checkpoint")
    p.add_argument("--train-data", required=True, help="jsonl input")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--vocab", default=None, help="world-vocab path")
    p.add_argument("--lr-init", type=float, default=3e-4)
    p.add_argument("--lr-final", type=float, default=1e-5)
    p.add_argument("--lr-schedule", default="cosine",
                   choices=["cosine", "exp", "linear", "constant"])
    p.add_argument("--warmup-steps", type=int, default=50)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--micro-bsz", type=int, default=4)
    p.add_argument("--accumulate-grad-batches", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=0, help="0 = all data")
    p.add_argument("--ctx-len", type=int, default=512,
                   help="accepted as in the reference; SFT batches take their bucket's length")
    p.add_argument("--grad-checkpoint", choices=["on", "off"], default="on",
                   help="per-block activation recompute in the backward")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-every-steps", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--platform", default="cuda",
                   help="torch device: cuda (default) or cpu (the kernels' plain versions)")


def _sft_batches(args, tokenizer) -> Callable[[int], Iterator]:
    """batches(epoch) -> iterator of {"input_ids", "labels"} numpy arrays,
    one length bucket a batch, bucket batch size micro_bsz * 64 // len."""
    ds = load_sft_jsonl(args.train_data, tokenizer)
    sizes = {b.fixed_len: max(1, args.micro_bsz * 64 // b.fixed_len) for b in ds.buckets}

    def batches(epoch: int):
        sampler = BucketBatchSampler(ds, sizes, seed=args.seed + epoch)
        for fixed_len, examples in sampler.batches():
            yield sft_collate(examples, fixed_len)

    return batches


def _group_accum(batch_iter, accum: int):
    """Group ``accum`` same-shape batches into one (accum, B, T) batch; a
    trailing partial group of a shape is dropped."""
    pending = {}
    for b in batch_iter:
        key = tuple(sorted((k, v.shape) for k, v in b.items()))
        pending.setdefault(key, []).append(b)
        if len(pending[key]) == accum:
            grp = pending.pop(key)
            yield {k: np.stack([g[k] for g in grp]) for k in grp[0]}


def _run_loop(args, tc: TrainConfig, step_fn, batches, save_fn, device) -> None:
    os.makedirs(args.output_dir, exist_ok=True)
    schedule = make_schedule(tc)
    logger = MetricsLogger(args.output_dir)
    step = steps = tokens = 0   # steps and tokens since the last log
    for epoch in range(args.epochs):
        epoch_losses = []
        epoch_batches = batches(epoch)
        if tc.accumulate_grad_batches > 1:
            epoch_batches = _group_accum(epoch_batches, tc.accumulate_grad_batches)
        for batch in epoch_batches:
            if args.max_steps and step >= args.max_steps:
                break
            batch = {k: torch.from_numpy(v).to(device, torch.int64) for k, v in batch.items()}
            metrics = step_fn(batch)
            epoch_losses.append(float(metrics["loss"]))
            steps, tokens = steps + 1, tokens + batch["input_ids"].numel()
            if step % args.log_every == 0:
                m = logger.on_step(step, metrics, schedule(step), steps=steps, tokens=tokens)
                steps = tokens = 0
                print(f"step {step}: {json.dumps(m)}", flush=True)
            step += 1
            if args.save_every_steps and step % args.save_every_steps == 0:
                save_fn(step)
        logger.on_epoch_end(epoch, float(np.mean(epoch_losses or [0.0])), schedule(step))
        save_fn(step)


def cmd_sft(args) -> None:
    device = torch.device(args.platform)
    model, cfg = load_rwkv_checkpoint(args.model, device=device)
    tokenizer = WorldTokenizer(args.vocab)
    batches = _sft_batches(args, tokenizer)
    n_batches = sum(1 for _ in batches(0))
    tc = TrainConfig(
        lr_init=args.lr_init, lr_final=args.lr_final, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        lr_schedule=args.lr_schedule, total_steps=args.max_steps or n_batches * args.epochs,
        micro_bsz=args.micro_bsz, accumulate_grad_batches=args.accumulate_grad_batches,
        grad_checkpoint=normalize_remat(args.grad_checkpoint), seed=args.seed,
    )
    remat = tc.grad_checkpoint
    if args.train_type == "lora":
        lc = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
        adapter = init_lora_params(model, lc, torch.Generator(device).manual_seed(args.seed))
        if args.peft_checkpoint:
            loaded = torch.load(args.peft_checkpoint, map_location=device, weights_only=True)
            adapter = lora_state_dict_to_tree(loaded)
        apply_lora(model, lc, adapter)
        loss_fn = functools.partial(sft_loss_fn, remat=remat)

        def save_fn(step):
            save_lora_checkpoint(model, os.path.join(args.output_dir, f"lora-step{step}.pth"))
    else:   # state / states: only the per-layer initial WKV states train
        model.add_state_params()
        loss_fn = functools.partial(sft_loss_fn, remat=remat, use_state_params=True)

        def save_fn(step):
            save_states_checkpoint(model, os.path.join(args.output_dir, f"states-step{step}.pth"))

    apply_trainable_mask(model, trainable_mask(model, args.train_type))
    step_fn = make_train_step(model, tc, loss_fn)
    _run_loop(args, tc, step_fn, batches, save_fn, device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="rwkv_lm_ext_tpu_torch.train")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("sft")
    _common_args(p)
    p.add_argument("--train-type", default="lora", choices=["lora", "state", "states"])
    p.add_argument("--lora-r", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=32.0)
    p.add_argument("--peft-checkpoint", default=None,
                   help="start from this LoRA .pth (reference layout)")
    p.set_defaults(fn=cmd_sft)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
