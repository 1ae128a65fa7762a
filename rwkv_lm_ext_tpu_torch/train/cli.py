"""Trainer entry point: SFT (full, LoRA, PiSSA, state tuning, slot-LoRA;
QLoRA, TBPTT and LISA), the contrastive and reranking trainers, and
full-parameter training of the causal model as an embedder and of the
bidirectional encoder, on one device.

Counterpart of rwkv_lm_ext_tpu/train/cli.py: the ``sft`` subcommand
(``cmd_sft``, :355-625, with ``_common_args`` :28-90, ``_train_config``,
``_wrap_save`` :155-188, ``_run_loop`` :225-317 and ``_sft_batches``
:320-352) for every train type: ``full`` (every parameter over fp32 master
weights with bf16 compute, ``--chunk-ctx`` TBPTT, ``--lisa-k`` LISA),
``lora`` and ``pissa`` (``--quant`` QLoRA over an int8, int8c, nf4 or fp4
base, ``--lora-apply unfused|merge``), ``state``/``states`` and
``slot-lora`` (one adapter a row's ``task``, trained jointly);
``bi-encoder`` (``cmd_bi_encoder`` :665,
LoRA, in-batch InfoNCE or CoSENT) and ``cross-encoder``
(``cmd_cross_encoder`` :945, LoRA and a score head, MSE on 0/1 labels), both
on ``_contrastive_batches`` (:627-662: bucketed by query length, collated to
min(2 * bucket, ctx_len)); ``nli`` (``cmd_nli`` :714, AllNLI triplets, STS-b
evaluation), ``simcse`` (``cmd_simcse`` :1089, the sentence-pair variant) and
``instructor`` (``cmd_instructor`` :1178, a dense + LayerNorm head), which
train every parameter of the causal model; ``encoder-biencoder``
(:823) and ``encoder-crossencoder`` (:863, group softmax over G documents a
query) on the bidirectional encoder; and ``mlm`` and ``mae`` (``cmd_mlm``,
:999-1086, ``--uni``: the causal model as the RetroMAE encoder). The
full-parameter commands train over fp32 master weights with bf16 compute.
Every command takes ``--grad-checkpoint on|off|dots|dots_nobatch``
(utils/remat.py), ``--skip-steps``, ``--upload-cmd``, ``--save-train-state``
and ``--resume-train-state`` (checkpoint/orbax_io.py).

As in JAX, ``--chunk-ctx`` and ``--lisa-k`` act under ``--train-type full``
only and ``--quant`` under lora, pissa and slot-lora; the other train types
ignore them.

Multi-process training, JAX's flags with JAX's meaning:
``--dp N`` (every command; 0, the default: every card of this host, one rank
each; 1 on the CPU or a one-card host), ``--tp N`` (``sft``; head-parallel,
parallel/tp.py), ``--pp N --n-micro M`` (``sft``; GPipe,
parallel/pipeline.py), ``--coordinator host:port``
(or ``file://…``) with ``--num-processes`` and ``--process-id`` (or
RWKV_COORDINATOR / RWKV_NUM_PROCESSES / RWKV_PROCESS_ID with ``RWKV_DIST=1``).
torch.distributed runs one rank a process: started alone, ``--dp/--tp/--pp``
make this process rank 0, which starts the other ranks of this host (the
same arguments with a ``file://`` rendezvous in a fresh directory), and a rank
that fails makes the command exit non-zero within ``WORKER_EXIT_S``; across
hosts the same command runs on every host with ``--coordinator``. The
backend is NCCL where every rank has a card of its own, gloo where ranks
share a card or on the CPU (printed at start-up). The batch follows JAX: on
one host ``--micro-bsz`` makes the global batch (each bucket's batch must
divide by dp: a rank trains its rows, ``parallel.local_batch_to_global``),
under ``--coordinator`` each process's sampler shard contributes
``--micro-bsz`` rows (the bucket sampler's ``world_size`` / ``rank`` over the
dp ranks). The step is the global batch's (train/loop.py), AdamW's moments
are sharded over dp (train/optim.py ``ShardedOptimizer``), rank 0 alone logs
and writes the .pth files, and ``--save-train-state`` writes one file a rank
plus a manifest (checkpoint/orbax_io.py), resumed at the same dp / tp / pp.
Under ``--dp``: every ``sft`` train type and every other command, each on
the global batch's loss (train/loop.py: the coupled losses gather the pooled
embeddings of the global batch, the means take the global counts, an
``encoder-crossencoder`` rank keeps whole groups of G rows, ``simcse
--dropout-noise`` draws each row's masks as one process does), rank 0 alone
running ``nli``'s STS-b evaluation; under ``--tp``: ``sft`` ``full`` and
``lora`` (dense base); under ``--pp``: ``sft`` ``full`` (with JAX's asserts:
no ``--accumulate-grad-batches``, ``--lisa-k`` or ``--chunk-ctx``, the batch
divisible by ``--n-micro``; the pipeline loss has no L2Wrap, as JAX's).

Refused, by argparse (exit 2), and why:
- ``--stack-layers`` and ``--bwd-transpose``: TPU layout workarounds (the
  scan-over-layers tree for XLA's compile time; a stored W^T for a transpose
  XLA materialized), with no counterpart in torch (ROADMAP "Not to port");
- every command but ``sft`` under ``--tp`` or ``--pp`` above 1: their
  tensor-parallel and pipeline forms are the next slice of ROADMAP A.12;
  the other multi-process combinations outside the scope above (``--tp`` and
  ``--pp`` together, ``--pp`` beside a train type but ``full``, ``--tp``
  under ``--quant`` or a train type but ``full`` and ``lora``);
- ``--wandb-project``: it needs a network service;
- ``--quant`` under ``mlm``, ``mae``, ``bi-encoder`` and ``cross-encoder``:
  the JAX ``bi-encoder`` and ``cross-encoder`` accept it and never read it
  (ROADMAP C.19), and the encoders have no QLoRA;
- ``--chunk-ctx`` under any command but ``sft``;

Every command trains RWKV-6, RWKV-5.x (5.0, 5.1, 5.2) and RWKV-4 models and
the legacy RWKV-LM options where the JAX command trains them. Refused at load
(exit 1, by name), each where the JAX command fails or trains nothing
(ROADMAP C.26-C.29, each pinned by a test):
- an RWKV-4 model under the commands that embed through the hidden states
  (``bi-encoder``, ``cross-encoder``, ``nli``, ``simcse``, ``instructor``):
  JAX's ``rwkv_forward`` asserts that a v4 model returns logits only;
- ``sft --train-type state`` / ``states`` on RWKV-4 (JAX asserts on
  ``use_state_params``) and on RWKV-5.x (JAX's v5 time mix takes no state
  override, so the states get a zero gradient and train nothing);
- the encoder trainers (``mlm``, ``mae``, ``encoder-biencoder``,
  ``encoder-crossencoder``) on RWKV-4 and RWKV-5.x (JAX's bidirectional
  encoder runs the RWKV-6 time mix only), and on a model with a legacy option
  (its encoder runs the plain v6 block and ignores or trips on the option).

A checkpoint's ``dropout`` is not applied by any command but ``simcse
--dropout-noise``, as in JAX, whose trainers pass no dropout key elsewhere;
``simcse --dropout-noise`` drops at the model's rate, 0.1 where it has none
(JAX's wiki1m recipe), with masks from a ``torch.Generator`` seeded by
``--seed``.

Usage:
  python -m rwkv_lm_ext_tpu_torch.train.cli sft --model base.pth \\
      --train-data data.jsonl --output-dir out --train-type lora [--quant nf4]
  python -m rwkv_lm_ext_tpu_torch.train.cli sft --train-type full [--chunk-ctx 128] \\
      [--lisa-k 2] --model base.pth --train-data data.jsonl --output-dir out
  python -m rwkv_lm_ext_tpu_torch.train.cli bi-encoder|cross-encoder|nli|simcse|instructor \\
      --model base.pth --train-data data.jsonl --output-dir out
  python -m rwkv_lm_ext_tpu_torch.train.cli encoder-biencoder|encoder-crossencoder|mlm \\
      --model base.pth --train-data data.jsonl --output-dir out
  python -m rwkv_lm_ext_tpu_torch.train.cli mae [--dup-mae] [--uni] --model base.pth \\
      --train-data text.jsonl --output-dir out

Data: ``sft`` jsonl rows {"instruction", "input", "output"} (and "task"
for slot-lora); ``bi-encoder``,
``encoder-biencoder`` {"query", "positive", "negative"} (a field may hold a
list of candidates); ``cross-encoder`` {"query", "document", "label"};
``nli`` an AllNLI .tsv (``--sts-file`` an STS-benchmark .tsv); ``simcse``
{"sentence_a", "sentence_b"}; ``instructor`` {"instruction", "query",
"positive", "negative"}; ``encoder-crossencoder`` {"query", "documents"}
(the first the positive); ``mlm`` and ``mae`` {"text"} (or bare strings).
Prints ``step N: {json}`` lines (loss, grad_norm, lr, it/s, Kt/s) and writes
the JAX package's files into --output-dir: ``lora-step{N}.pth`` (lora,
pissa), ``init_pissa.pth`` (pissa, the SVD init, at the start),
``lora-{task}-step{N}.pth`` (slot-lora), ``model-step{N}.pth`` (full, the
base layout in fp32), ``states-step{N}.pth``, ``bi-encoder-step{N}.pth`` and
``cross-encoder-step{N}.pth`` (LoRA, reference layout), ``score-step{N}.pth``
(``score.weight`` (n, C)); ``nli-``, ``simcse-``, ``instructor-``,
``encoder-bi-``, ``encoder-cross-`` and ``encoder-step{N}.pth`` in the base
checkpoint's layout (fp32; with ``score.weight`` or ``dense.*`` /
``ln_dense.*`` beside it; without the RetroMAE decoder); ``train_log.txt``;
``train_state.pth`` with ``--save-train-state``; and for ``nli --sts-file``
``similarity_evaluation_sts-{split}_results.csv``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    adapter_state_dict,
    apply_lora,
    init_lora_params,
    lora_state_dict_to_tree,
    pissa_init,
)
from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import (
    apply_slot_stacks,
    init_slot_stacks,
    set_slot_idx,
    slot_stacks,
    split_slot_stacks,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.checkpoint.orbax_io import (
    load_rank_checkpoint,
    save_checkpoint,
    save_rank_checkpoint,
)
from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.data.buckets import BucketBatchSampler, LengthBucketedDataset
from rwkv_lm_ext_tpu_torch.config import EMB_ID
from rwkv_lm_ext_tpu_torch.data.collators import (
    _pad_to,
    cross_encoder_collate,
    mae_collate,
    mlm_collate,
    sft_collate,
    triplet_collate,
)
from rwkv_lm_ext_tpu_torch.data.nli import load_allnli_triplets, load_stsb_pairs
from rwkv_lm_ext_tpu_torch.data.sft import load_sft_jsonl
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.eval.sts import SimilarityEvaluator
from rwkv_lm_ext_tpu_torch.models.bidirectional import init_one_layer_decoder
from rwkv_lm_ext_tpu_torch.models.rwkv import Dropout
from rwkv_lm_ext_tpu_torch.models.heads import (
    embed_sequences,
    init_classification_head,
    init_embedding_head,
    init_layer_norm,
)
from rwkv_lm_ext_tpu_torch.parallel.distributed import (
    broadcast,
    init_distributed,
    leave_within,
    make_hybrid_mesh,
    process_count,
    process_index,
    rank_device,
)
from rwkv_lm_ext_tpu_torch.parallel.pipeline import make_pp_mesh
from rwkv_lm_ext_tpu_torch.parallel.tp import shard_for_training
from rwkv_lm_ext_tpu_torch.train.callbacks import (
    LisaSchedule,
    MetricsLogger,
    gather_model_state,
    save_lora_checkpoint,
    save_lora_state,
    save_model_checkpoint,
    save_model_state,
    save_score_head,
    save_states_checkpoint,
)
from rwkv_lm_ext_tpu_torch.train.loop import (
    contrastive_loss_fn,
    cross_encoder_loss_fn,
    encoder_biencoder_loss_fn,
    encoder_crossencoder_loss_fn,
    instructor_loss_fn,
    mae_loss_fn,
    make_pp_train_step,
    make_train_step,
    mlm_loss_fn,
    sft_loss_fn,
    simcse_loss_fn,
)
from rwkv_lm_ext_tpu_torch.train.optim import apply_trainable_mask, make_schedule, trainable_mask
from rwkv_lm_ext_tpu_torch.utils.device import resolve_device
from rwkv_lm_ext_tpu_torch.utils.remat import normalize_remat


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
                   help="the longest bucket a text (mlm, mae), a query or a pair may take; "
                        "contrastive batches are collated to min(2 * bucket, ctx-len); SFT "
                        "batches take "
                        "their bucket's length")
    p.add_argument("--grad-checkpoint", choices=["on", "off", "dots", "dots_nobatch"],
                   default="on",
                   help="per-block activation recompute in the backward: on (the whole block), "
                        "off, or a selective policy that keeps the matrix products' outputs "
                        "(dots) or the unbatched ones (dots_nobatch) and recomputes the rest")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-every-steps", type=int, default=0)
    p.add_argument("--skip-steps", type=int, default=0,
                   help="skip this many batches (with --resume-train-state: the steps done)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--upload-cmd", default=None,
                   help="shell command run in the background after each save; {dir} expands "
                        "to --output-dir")
    p.add_argument("--save-train-state", action="store_true",
                   help="also write train_state.pth (trainable parameters, optimizer state, "
                        "step count) at each save, for an exact resume")
    p.add_argument("--resume-train-state", default=None,
                   help="a train_state.pth to resume from (pair it with --skip-steps)")
    p.add_argument("--platform", default="cuda",
                   help="torch device: cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="compute dtype (default: the checkpoint's, bf16); the trained "
                        "parameters stay fp32 masters where the command keeps them")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks (sft): 0 = every card of this host, one rank each "
                        "(1 on the CPU)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (sft full / lora)")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages (sft full)")
    p.add_argument("--n-micro", type=int, default=4,
                   help="GPipe micro-batches a step when --pp > 1")
    p.add_argument("--coordinator", default=None,
                   help="host:port (or file://path) of the rendezvous, for a run across hosts")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


# seconds rank 0 waits for the ranks it started to finish after it has, and
# the bound on leaving the process group
WORKER_EXIT_S = 60.0
TEARDOWN_S = 10.0
# set for the ranks that rank 0 starts on its host: they take their rows of
# the global batch, as rank 0 does, not a sampler shard
SPLIT_ENV = "RWKV_TRAIN_SPLIT_ROWS"


def _mesh(args):
    """This process's mesh in a multi-process run (a parallel.mesh.Mesh or a
    parallel.pipeline.PipeMesh, both with ``dp``, ``dp_rank``, ``tp`` and
    ``pp``), or None in a single-process one."""
    return getattr(args, "mesh", None)


def _main_process(args) -> bool:
    return _mesh(args) is None or process_index() == 0


def _device(args) -> torch.device:
    """This process's device: the --platform device alone, the rank's own
    in a multi-process run."""
    return resolve_device(args.platform) if _mesh(args) is None else rank_device(args.platform)


def _jsonl(path: str):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def _sizes(args, ds, least: int = 1) -> dict:
    """Per-bucket batch sizes: micro_bsz * 64 // bucket, at least `least`."""
    return {b.fixed_len: max(least, args.micro_bsz * 64 // b.fixed_len) for b in ds.buckets}


def _bucketed(args, ds, sizes, collate) -> Callable[[int], Iterator]:
    """batches(epoch) -> the batches ``collate(examples, length, epoch)``
    makes of one epoch, the buckets' orders drawn from seed + epoch. A dp
    rank (``args.mesh``) takes its sampler shard (``args.shard``:
    --coordinator) or its rows of the global batch (one host: every
    bucket's batch must divide by dp, and under --pp a rank's rows by
    --n-micro). Every rank collates the global batch (so that masks drawn
    in the collate are the single process's) and keeps its rows; a batch of
    whole examples splits into equal shares of them, so an example's rows
    (``encoder-crossencoder``'s G pairs) stay on one rank."""
    mesh = _mesh(args)
    shard = mesh is not None and args.shard
    world, rank = (mesh.dp, mesh.dp_rank) if shard else (1, 0)
    split = mesh is not None and not shard and mesh.dp > 1
    if mesh is not None:
        # the sampler's batch size of each bucket in use (1 where ``sizes``
        # has none: nli at a --max-seq-len that is not a bucket length)
        used = sorted({b.fixed_len for b in ds.buckets if b.examples})
        for fixed_len, n in ((k, sizes.get(k, 1)) for k in used):
            if split and n % mesh.dp:
                raise SystemExit(
                    f"--micro-bsz {args.micro_bsz}: the {fixed_len}-token bucket's batch of {n} "
                    f"rows (micro_bsz * 64 // length) does not divide over dp={mesh.dp}")
            local = n // mesh.dp if split else n
            if mesh.pp > 1 and local % args.n_micro:
                raise SystemExit(f"--n-micro {args.n_micro}: a rank's batch of {local} rows "
                                 f"(bucket {fixed_len}) does not divide into micro-batches")

    def batches(epoch: int):
        sampler = BucketBatchSampler(ds, sizes, seed=args.seed + epoch, world_size=world,
                                     rank=rank)
        for fixed_len, examples in sampler.batches():
            batch = collate(examples, fixed_len, epoch)
            if split:
                batch = {k: np.array_split(v, mesh.dp)[mesh.dp_rank] for k, v in batch.items()}
            yield batch

    return batches


def _lora_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--lora-r", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=32.0)


def _sft_batches(args, tokenizer, *, want_tasks: bool = False):
    """(batches, task names): batches(epoch) -> iterator of {"input_ids",
    "labels"} numpy arrays, one length bucket a batch, bucket batch size
    micro_bsz * 64 // len. With ``want_tasks`` (slot-lora) every row needs a
    "task"; the sorted names get the adapter ids 1..n, and the batches carry
    "adapter_ids"."""
    ds = load_sft_jsonl(args.train_data, tokenizer)
    task_names = None
    if want_tasks:
        exs = [e for b in ds.buckets for e in b.examples]
        task_names = sorted({e["task"] for e in exs if "task" in e})
        if not task_names or any("task" not in e for e in exs):
            raise SystemExit("--train-type slot-lora needs a 'task' field on every training row")
        task_to_id = {n: i + 1 for i, n in enumerate(task_names)}
        for e in exs:
            e["adapter_id"] = task_to_id[e["task"]]
    return _bucketed(args, ds, _sizes(args, ds),
                     lambda examples, n, epoch: sft_collate(examples, n)), task_names


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


def _tokens(batch) -> int:
    """Tokens a batch trains on: its input ids (the RetroMAE encoder's
    view), or the sum over the contrastive fields."""
    for key in ("input_ids", "encoder_input_ids"):
        if key in batch:
            return batch[key].numel()
    return sum(batch[k].numel() for k in ("query", "positive", "negative", "a", "b") if k in batch)


def _wrap_save(args, save_fn, optimizer):
    """save_fn(step), then the train state (--save-train-state) and the
    upload command (--upload-cmd, in a background thread), as ``_wrap_save``
    does. The thread is not a daemon, as JAX's is: the process waits for the
    last upload before it exits, where JAX's drops it."""
    def wrapped(step):
        save_fn(step)
        path = os.path.join(args.output_dir, "train_state.pth")
        if args.save_train_state and _mesh(args) is None:
            save_checkpoint(path, optimizer.state_dict())
        elif args.save_train_state:
            save_rank_checkpoint(path, optimizer.state_dict(), process_index(), process_count())
        if args.upload_cmd and _main_process(args):
            cmd = args.upload_cmd.format(dir=args.output_dir)
            threading.Thread(target=subprocess.run, args=(cmd,),
                             kwargs={"shell": True, "check": False}).start()

    return wrapped


def _run_loop(args, tc: TrainConfig, step_fn, batches, save_fn, device, eval_fn=None) -> None:
    """The epochs: a step a batch (the first --skip-steps batches skipped),
    a log line every --log-every steps, a save every --save-every-steps and
    at each epoch's end; ``eval_fn(step, epoch)`` every --eval-every-steps
    (where the command has it) and at each epoch's end.
    --resume-train-state restores ``step_fn.optimizer`` first."""
    os.makedirs(args.output_dir, exist_ok=True)
    mesh = _mesh(args)
    main = _main_process(args)
    if args.resume_train_state:
        step_fn.optimizer.load_state_dict(
            load_rank_checkpoint(args.resume_train_state, process_index(), process_count()))
    save_fn = _wrap_save(args, save_fn, step_fn.optimizer)
    schedule = make_schedule(tc)
    logger = MetricsLogger(args.output_dir if main else None)
    # a step trains the global batch: dp ranks' rows alike
    row_share = mesh.dp if mesh is not None else 1
    step = steps = tokens = 0   # steps and tokens since the last log
    for epoch in range(args.epochs):
        epoch_losses = []
        epoch_batches = batches(epoch)
        if tc.accumulate_grad_batches > 1:
            epoch_batches = _group_accum(epoch_batches, tc.accumulate_grad_batches)
        for batch in epoch_batches:
            if step < args.skip_steps:
                step += 1
                continue
            if args.max_steps and step >= args.max_steps:
                break
            # token ids and labels as int64; the DupMAE target stays fp32
            batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v).to(device)
                     for k, v in batch.items()}
            metrics = step_fn(batch)
            epoch_losses.append(float(metrics["loss"]))
            steps, tokens = steps + 1, tokens + _tokens(batch) * row_share
            if step % args.log_every == 0 and main:
                m = logger.on_step(step, metrics, schedule(step), steps=steps, tokens=tokens)
                steps = tokens = 0
                print(f"step {step}: {json.dumps(m)}", flush=True)
            step += 1
            if args.save_every_steps and step % args.save_every_steps == 0:
                save_fn(step)
            if eval_fn is not None and getattr(args, "eval_every_steps", 0) and \
                    step % args.eval_every_steps == 0:
                eval_fn(step, epoch)
        logger.on_epoch_end(epoch, float(np.mean(epoch_losses or [0.0])), schedule(step))
        save_fn(step)
        if eval_fn is not None:
            eval_fn(step, epoch)


def _train_config(args, batches) -> TrainConfig:
    n_batches = sum(1 for _ in batches(0))
    return TrainConfig(
        lr_init=args.lr_init, lr_final=args.lr_final, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        lr_schedule=args.lr_schedule, total_steps=args.max_steps or n_batches * args.epochs,
        micro_bsz=args.micro_bsz, accumulate_grad_batches=args.accumulate_grad_batches,
        grad_checkpoint=normalize_remat(args.grad_checkpoint), seed=args.seed,
        chunk_ctx=getattr(args, "chunk_ctx", 0),
    )


# the commands that embed through the hidden states of the causal model
HIDDEN_COMMANDS = ("bi-encoder", "cross-encoder", "nli", "simcse", "instructor")
ENCODER_COMMANDS = ("mlm", "mae", "encoder-biencoder", "encoder-crossencoder")


def _refusal(cfg, command: str, train_type: str = ""):
    """Why ``command`` cannot train this model, or None: the cases where the
    JAX command fails or trains nothing (the module docstring)."""
    family = f"RWKV-{cfg.version:g}"
    if cfg.version < 5 and command in HIDDEN_COMMANDS:
        return (f"{command} embeds through the hidden states, which an {family} model does not "
                "return (the JAX package asserts the same, models/rwkv.py:764)")
    if command == "sft" and train_type in ("state", "states") and cfg.version < 6:
        why = ("asserts on use_state_params" if cfg.version < 5 else
               "gives the v5 time mix no state override, so the states get no gradient")
        return f"sft --train-type {train_type} needs an RWKV-6 model: on {family} the JAX trainer {why}"
    if command in ENCODER_COMMANDS and cfg.version < 6:
        return (f"{command} trains the bidirectional encoder, which runs the RWKV-6 time mix only "
                f"(as JAX's models/bidirectional.py): not an {family} model")
    if command in ENCODER_COMMANDS and cfg.legacy_options:
        return (f"{command} trains the bidirectional encoder, whose blocks are the plain RWKV-6 "
                f"ones: a model with {', '.join(cfg.legacy_options)} is not one")
    return None


def _load_checkpoint(path: str, command: str, train_type: str = "", *, dtype=None, **kw):
    """``load_rwkv_checkpoint`` (``dtype``: the compute dtype, --dtype, or the
    checkpoint's default), refusing by name (``_refusal``) what the JAX
    command cannot train."""
    if dtype is not None:
        kw["dtype"] = dtype
    model, cfg = load_rwkv_checkpoint(path, **kw)
    why = _refusal(cfg, command, train_type)
    if why:
        raise SystemExit(why)
    return model, cfg


def _full_model(args):
    """(device, model, cfg) for a command that trains every parameter: fp32
    master weights, cast to the compute dtype at each use."""
    device = _device(args)
    model, cfg = _load_checkpoint(args.model, args.command, dtype=args.dtype, device=device,
                                  param_dtype="float32")
    return device, model, cfg


def _train_full(args, model, tc, loss_fn, batches, device, prefix: str, eval_fn=None) -> None:
    """Train every parameter of the model and of the heads attached to it;
    save ``{prefix}-step{N}.pth`` in the base checkpoint's layout (rank 0)."""
    def save_fn(step):
        save_model_checkpoint(model, os.path.join(args.output_dir, f"{prefix}-step{step}.pth"))

    apply_trainable_mask(model, trainable_mask(model, "full"))
    _run_loop(args, tc, make_train_step(model, tc, loss_fn, mesh=_mesh(args)), batches,
              _on_main(args, save_fn), device, eval_fn)


def _lora_model(args):
    """(device, model, cfg, lc) with a fresh LoRA adapter (seed --seed)
    applied; only the adapter trains."""
    device = _device(args)
    model, cfg = _load_checkpoint(args.model, args.command, dtype=args.dtype, device=device)
    lc = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
    apply_lora(model, lc, init_lora_params(model, lc, torch.Generator(device).manual_seed(args.seed)))
    apply_trainable_mask(model, trainable_mask(model, "lora"))
    return device, model, cfg, lc


def _lora_sft(args, device, lc):
    """The model for --train-type lora or pissa: the checkpoint, the base
    quantized under --quant after the PiSSA subtraction, and the adapter
    (PiSSA's SVD init, written to init_pissa.pth, or a fresh one from
    --seed; --peft-checkpoint's in their place) applied."""
    quant = None if args.quant == "none" else args.quant
    gen = torch.Generator(device).manual_seed(args.seed)
    if lc.pissa:
        # the SVD of the checkpoint's values, the fp32 residual kept as JAX
        # keeps it, cast at every use
        model, _ = _load_checkpoint(args.model, "sft", dtype=args.dtype, device=device,
                                    param_dtype="float32")
        adapter, _ = pissa_init(model, lc, gen)
        mesh = _mesh(args)
        if mesh is not None:
            # every dp rank trains on rank 0's residual base (its adapter is
            # the optimizer's to broadcast)
            for path in adapter:
                broadcast(model.get_submodule(path).weight.data, 0, mesh.dp_group)
        if _main_process(args):
            os.makedirs(args.output_dir, exist_ok=True)
            torch.save(adapter_state_dict(adapter),
                       os.path.join(args.output_dir, "init_pissa.pth"))
        if quant:
            quantize_model(model, quant)
    else:
        model, _ = _load_checkpoint(args.model, "sft", dtype=args.dtype, device=device,
                                    quant=quant)
        adapter = init_lora_params(model, lc, gen)
    if args.peft_checkpoint:
        loaded = torch.load(args.peft_checkpoint, map_location=device, weights_only=True)
        adapter = lora_state_dict_to_tree(loaded)
    return apply_lora(model, lc, adapter, merge=args.lora_apply == "merge")


def _lisa_step(step_fn, model, args):
    """step_fn with LISA's update mask: --lisa-k blocks train, drawn anew
    every --lisa-interval steps (LisaSchedule, seed --seed); the optimizer
    and its moments stay, as under JAX's mask."""
    lisa = LisaSchedule(model.cfg.n_layer, k=args.lisa_k, interval=args.lisa_interval,
                        seed=args.seed)
    names = step_fn.optimizer.names
    count = {"step": 0}

    def step(batch):
        mask = lisa.trainable_mask(names, count["step"])
        count["step"] += 1
        return step_fn(batch, mask)

    step.optimizer = step_fn.optimizer
    return step


def _save_whole(args, model, path_fn, writer) -> Callable[[int], None]:
    """save_fn(step) of a multi-process run: every rank joins in gathering
    the model's whole parameters (``gather_model_state``: tp slices, pipeline
    stages), and rank 0 writes ``writer(state, path_fn(step))``."""
    def save_fn(step):
        state = gather_model_state(model, args.mesh)
        if _main_process(args):
            writer(state, path_fn(step))

    return save_fn


def _on_main(args, save_fn) -> Callable[[int], None]:
    """save_fn for the replicated parameters of a dp run: rank 0 writes."""
    if _mesh(args) is None:
        return save_fn
    return lambda step: save_fn(step) if _main_process(args) else None


def cmd_sft(args) -> None:
    mesh = _mesh(args)
    device = _device(args)
    tokenizer = WorldTokenizer(args.vocab)
    batches, task_names = _sft_batches(args, tokenizer, want_tasks=args.train_type == "slot-lora")
    tc = _train_config(args, batches)
    remat = tc.grad_checkpoint
    out = args.output_dir
    whole = mesh is not None and (mesh.tp > 1 or mesh.pp > 1)
    if args.train_type == "full":
        # every parameter over fp32 masters; TBPTT when --chunk-ctx
        model, cfg = _load_checkpoint(args.model, "sft", dtype=args.dtype, device=device,
                                      param_dtype="float32")
        apply_trainable_mask(model, trainable_mask(model, "full"))
        if mesh is not None and mesh.pp > 1:
            step_fn = make_pp_train_step(model, tc, mesh, n_micro=args.n_micro)
        else:
            if mesh is not None:
                shard_for_training(model, mesh)
            step_fn = make_train_step(model, tc, mesh=mesh)
        if args.lisa_k > 0:
            step_fn = _lisa_step(step_fn, model, args)

        def save_fn(step):
            save_model_checkpoint(model, os.path.join(out, f"model-step{step}.pth"))

        if whole:
            save_fn = _save_whole(args, model,
                                  lambda step: os.path.join(out, f"model-step{step}.pth"),
                                  save_model_state)
        _run_loop(args, tc, step_fn, batches, save_fn if whole else _on_main(args, save_fn),
                  device)
        return
    if args.train_type in ("lora", "pissa"):
        lc = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, pissa=args.train_type == "pissa")
        model = _lora_sft(args, device, lc)
        loss_fn = functools.partial(sft_loss_fn, remat=remat)

        def save_fn(step):
            save_lora_checkpoint(model, os.path.join(out, f"lora-step{step}.pth"))

        if whole:
            save_fn = _save_whole(args, model,
                                  lambda step: os.path.join(out, f"lora-step{step}.pth"),
                                  save_lora_state)
    elif args.train_type == "slot-lora":
        # one adapter a task, trained jointly: each row routes to its task's
        # rows of the stacks (adapters.slot_lora)
        lc = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
        quant = None if args.quant == "none" else args.quant
        model, _ = _load_checkpoint(args.model, "sft", dtype=args.dtype, device=device,
                                    quant=quant)
        stacks, name_to_id = init_slot_stacks(model, lc, task_names,
                                              torch.Generator(device).manual_seed(args.seed))
        apply_slot_stacks(model, stacks, torch.zeros(1, dtype=torch.int64, device=device), lc)

        def loss_fn(model_, batch, counts=None):
            set_slot_idx(model_, batch["adapter_ids"])
            return sft_loss_fn(model_, batch, remat=remat, counts=counts)

        def save_fn(step):
            for name, adapter in split_slot_stacks(slot_stacks(model), name_to_id).items():
                torch.save(adapter_state_dict(adapter), os.path.join(out, f"lora-{name}-step{step}.pth"))
    else:   # state / states: only the per-layer initial WKV states train
        model, _ = _load_checkpoint(args.model, "sft", args.train_type, dtype=args.dtype,
                                    device=device)
        model.add_state_params()
        loss_fn = functools.partial(sft_loss_fn, remat=remat, use_state_params=True)

        def save_fn(step):
            save_states_checkpoint(model, os.path.join(out, f"states-step{step}.pth"))

    apply_trainable_mask(model, trainable_mask(model, args.train_type))
    if mesh is not None:
        shard_for_training(model, mesh)
    step_fn = make_train_step(model, tc, loss_fn, mesh=mesh)
    _run_loop(args, tc, step_fn, batches, _on_main(args, save_fn) if not whole else save_fn,
              device)


def _text_batches(args, tokenizer, vocab_size: int, mae: bool) -> Callable[[int], Iterator]:
    """batches(epoch) -> iterator of mlm_collate (or mae_collate) batches of
    the jsonl's texts, one length bucket a batch (a text of n tokens takes
    n + 1 slots: the emb terminator), masks drawn from seed + epoch."""
    ds = LengthBucketedDataset()
    for row in _jsonl(args.train_data):
        ids = tokenizer.encode(row["text"] if isinstance(row, dict) else row)
        ds.add({"input_ids": ids}, min(len(ids) + 1, args.ctx_len))

    def collate(examples, fixed_len, epoch):
        if mae:
            return mae_collate(examples, fixed_len, bag_of_words=args.dup_mae,
                               vocab_size=vocab_size, seed=args.seed + epoch)
        return mlm_collate(examples, fixed_len, seed=args.seed + epoch, emb_id=1)

    return _bucketed(args, ds, _sizes(args, ds), collate)


def cmd_mlm(args, mae: bool = False) -> None:
    device, model, cfg = _full_model(args)
    if mae:
        model.onelayer_decoder = init_one_layer_decoder(
            cfg, generator=torch.Generator(device).manual_seed(args.seed), device=device)
    batches = _text_batches(args, WorldTokenizer(args.vocab), cfg.vocab_size, mae)
    tc = _train_config(args, batches)
    if mae:
        loss_fn = functools.partial(mae_loss_fn, remat=tc.grad_checkpoint, dup_mae=args.dup_mae,
                                    bidirectional=not args.uni)
    else:
        loss_fn = functools.partial(mlm_loss_fn, remat=tc.grad_checkpoint)
    # the encoder alone, in the base checkpoint's layout
    _train_full(args, model, tc, loss_fn, batches, device, "encoder")


def _contrastive_batches(args, tokenizer, collate) -> Callable[[int], Iterator]:
    """Rows with "query", "positive", "negative", "document" (a string or a
    list of candidates) and "label", bucketed by the query's length + 1 (at
    most ctx_len), collated to min(2 * bucket, ctx_len)."""
    ds = LengthBucketedDataset()
    for row in _jsonl(args.train_data):
        ex = {k: ([tokenizer.encode(x) for x in v] if isinstance(v, list) else tokenizer.encode(v))
              for k, v in row.items() if k in ("query", "positive", "negative", "document")}
        if "label" in row:
            ex["label"] = row["label"]
        ds.add(ex, min(len(ex.get("query", [])) + 1, args.ctx_len))
    return _bucketed(args, ds, _sizes(args, ds),
                     lambda examples, n, epoch: collate(examples, min(n * 2, args.ctx_len)))


def cmd_bi_encoder(args) -> None:
    device, model, cfg, lc = _lora_model(args)
    batches = _contrastive_batches(args, WorldTokenizer(args.vocab), triplet_collate)
    tc = _train_config(args, batches)
    loss_fn = functools.partial(contrastive_loss_fn, loss=args.loss, pooling=args.pooling,
                                remat=tc.grad_checkpoint)

    def save_fn(step):
        save_lora_checkpoint(model, os.path.join(args.output_dir, f"bi-encoder-step{step}.pth"))

    _run_loop(args, tc, make_train_step(model, tc, loss_fn, mesh=_mesh(args)), batches,
              _on_main(args, save_fn), device)


def cmd_cross_encoder(args) -> None:
    device, model, cfg, lc = _lora_model(args)
    batches = _contrastive_batches(args, WorldTokenizer(args.vocab), cross_encoder_collate)
    tc = _train_config(args, batches)
    # the score head trains beside the adapter
    model.score = init_classification_head(
        cfg, generator=torch.Generator(device).manual_seed(args.seed + 1))
    loss_fn = functools.partial(cross_encoder_loss_fn, remat=tc.grad_checkpoint)

    def save_fn(step):
        save_lora_checkpoint(model, os.path.join(args.output_dir, f"cross-encoder-step{step}.pth"))
        save_score_head(model.score, os.path.join(args.output_dir, f"score-step{step}.pth"))

    _run_loop(args, tc, make_train_step(model, tc, loss_fn, mesh=_mesh(args)), batches,
              _on_main(args, save_fn), device)


def _nli_batches(args, tokenizer) -> Callable[[int], Iterator]:
    """AllNLI triplets, every field cut to max_seq_len - 1 tokens and added
    at length max_seq_len, a batch size of micro_bsz keyed by max_seq_len.
    As in the JAX command, the sampler looks a bucket's size up by the
    bucket's length, so a max_seq_len that is not a bucket length (33, the
    default, lands in 64) gives batches of one row, collated to the bucket."""
    L = args.max_seq_len
    rows = load_allnli_triplets(args.train_data, seed=args.seed)
    if not rows:
        raise SystemExit("no usable AllNLI triplets in --train-data")
    ds = LengthBucketedDataset()
    for r in rows:
        ds.add({k: tokenizer.encode(v)[: L - 1] for k, v in r.items()}, L)
    return _bucketed(args, ds, {L: args.micro_bsz},
                     lambda examples, n, epoch: triplet_collate(examples, n))


def cmd_nli(args) -> None:
    device, model, cfg = _full_model(args)
    tokenizer = WorldTokenizer(args.vocab)
    batches = _nli_batches(args, tokenizer)
    tc = _train_config(args, batches)
    loss_fn = functools.partial(contrastive_loss_fn, pooling=args.pooling, remat=tc.grad_checkpoint,
                                loss="infonce" if args.in_batch_negative else "cosent")
    eval_fn = None
    if args.sts_file:
        s1, s2, gold = load_stsb_pairs(args.sts_file, split=args.sts_split)
        evaluator = SimilarityEvaluator(s1, s2, gold, csv_dir=args.output_dir,
                                        name="sts-" + args.sts_split)
        L, Bv = args.max_seq_len, max(1, args.micro_bsz * 4)

        def encode(sentences):
            toks = np.zeros((len(sentences), L), np.int64)
            for i, s in enumerate(sentences):
                ids = tokenizer.encode(s)[: L - 1] + [EMB_ID]
                toks[i, : len(ids)] = ids
            with torch.inference_mode():
                return np.concatenate([
                    embed_sequences(model, torch.from_numpy(toks[i: i + Bv]).to(device),
                                    pooling_type=args.pooling).cpu().numpy()
                    for i in range(0, len(sentences), Bv)])

        def eval_fn(step, epoch):
            if not _main_process(args):     # rank 0 alone evaluates
                return
            out = evaluator(encode, epoch=epoch, steps=step)
            print(f"nli eval step {step}: cosine_spearman={out['cosine_spearman']:.4f} "
                  f"cosine_pearson={out['cosine_pearson']:.4f}", flush=True)

    _train_full(args, model, tc, loss_fn, batches, device, "nli", eval_fn)


def _simcse_batches(args, tokenizer) -> Callable[[int], Iterator]:
    """Rows {"sentence_a", "sentence_b"} (or {"text"} for both), bucketed by
    the longer + 1, at least 2 rows a batch; each side cut to bucket - 1,
    emb-terminated and padded: {"a", "b"}."""
    ds = LengthBucketedDataset()
    for row in _jsonl(args.train_data):
        if "sentence_b" in row:
            a, b = tokenizer.encode(row["sentence_a"]), tokenizer.encode(row["sentence_b"])
        else:
            a = b = tokenizer.encode(row["text"])
        ds.add({"a": a, "b": b}, min(max(len(a), len(b)) + 1, args.ctx_len))

    def collate(examples, n, epoch):
        return {k: np.stack([_pad_to(e[k][: n - 1] + [1], n, 0) for e in examples])
                for k in ("a", "b")}

    return _bucketed(args, ds, _sizes(args, ds, 2), collate)


def cmd_simcse(args) -> None:
    device, model, cfg = _full_model(args)
    batches = _simcse_batches(args, WorldTokenizer(args.vocab))
    tc = _train_config(args, batches)
    dropout = None
    if args.dropout_noise:
        # two dropout-noised views (the wiki1m recipe's p = 0.1 where the
        # model has no rate of its own, as the JAX command sets it)
        dropout = Dropout(cfg.dropout or 0.1, torch.Generator(device).manual_seed(args.seed))
    loss_fn = functools.partial(simcse_loss_fn, pooling=args.pooling,
                                temperature=args.temperature, remat=tc.grad_checkpoint,
                                dropout=dropout)
    _train_full(args, model, tc, loss_fn, batches, device, "simcse")


def _instructor_batches(args, tokenizer) -> Callable[[int], Iterator]:
    """Rows {"instruction", "query", "positive", "negative"}: each field
    prefixed by the instruction, bucketed by the query's length + 1, at least
    2 rows a batch, cut to bucket - 1, emb-terminated and padded."""
    ds = LengthBucketedDataset()
    for row in _jsonl(args.train_data):
        inst = row.get("instruction", "")
        ex = {k: tokenizer.encode(inst + row[k]) for k in ("query", "positive", "negative")
              if k in row}
        ds.add(ex, min(len(ex["query"]) + 1, args.ctx_len))

    def collate(examples, n, epoch):
        return {k: np.stack([_pad_to(e[k][: n - 1] + [1], n, 0) for e in examples])
                for k in ("query", "positive", "negative") if k in examples[0]}

    return _bucketed(args, ds, _sizes(args, ds, 2), collate)


def cmd_instructor(args) -> None:
    device, model, cfg = _full_model(args)
    batches = _instructor_batches(args, WorldTokenizer(args.vocab))
    tc = _train_config(args, batches)
    out_dim = args.output_dim or cfg.n_embd
    model.dense = init_embedding_head(cfg, generator=torch.Generator(device).manual_seed(args.seed),
                                      output_dim=out_dim)
    model.ln_dense = init_layer_norm(out_dim, device=device)
    loss_fn = functools.partial(instructor_loss_fn, pooling=args.pooling,
                                temperature=args.temperature, remat=tc.grad_checkpoint)
    _train_full(args, model, tc, loss_fn, batches, device, "instructor")


def cmd_encoder_biencoder(args) -> None:
    device, model, cfg = _full_model(args)
    batches = _contrastive_batches(args, WorldTokenizer(args.vocab), triplet_collate)
    tc = _train_config(args, batches)
    loss_fn = functools.partial(encoder_biencoder_loss_fn, mode=args.bi_mode,
                                temperature=args.temperature, remat=tc.grad_checkpoint)
    _train_full(args, model, tc, loss_fn, batches, device, "encoder-bi")


def _encoder_crossencoder_batches(args, tokenizer) -> Callable[[int], Iterator]:
    """Rows {"query", "documents"} (the first document the positive): the
    first G documents as G ``q [sep] d [cls]`` rows, a row with fewer than G
    dropped, bucketed by its longest pair (at most ctx_len), each pair cut to
    the bucket: {"input_ids" (B * G, T)}."""
    G = args.group_size
    ds = LengthBucketedDataset()
    for row in _jsonl(args.train_data):
        q = tokenizer.encode(row["query"])
        docs = [tokenizer.encode(d) for d in row["documents"]][:G]
        if len(docs) < G:
            continue
        pairs = [q + [2] + d + [1] for d in docs]
        ds.add({"pairs": pairs}, min(max(map(len, pairs)), args.ctx_len))

    def collate(examples, n, epoch):
        return {"input_ids": np.stack([_pad_to(p[:n], n, 0) for e in examples for p in e["pairs"]])}

    return _bucketed(args, ds, _sizes(args, ds), collate)


def cmd_encoder_crossencoder(args) -> None:
    device, model, cfg = _full_model(args)
    batches = _encoder_crossencoder_batches(args, WorldTokenizer(args.vocab))
    tc = _train_config(args, batches)
    model.score = init_classification_head(
        cfg, generator=torch.Generator(device).manual_seed(args.seed + 1))
    loss_fn = functools.partial(encoder_crossencoder_loss_fn, group_size=args.group_size,
                                mode=args.bi_mode, remat=tc.grad_checkpoint)
    _train_full(args, model, tc, loss_fn, batches, device, "encoder-cross")


def _refuse_parallel(parser: argparse.ArgumentParser, args) -> None:
    """Exit 2, by name, on a multi-process flag outside what is ported (the
    module docstring); resolve --dp 0 (every card of this host)."""
    if min(args.dp, args.tp - 1, args.pp - 1, args.n_micro - 1) < 0:
        parser.error("--dp must be >= 0, --tp, --pp and --n-micro >= 1")
    if args.command != "sft" and (args.tp > 1 or args.pp > 1):
        parser.error(f"multi-process training of {args.command} is not ported under --tp / --pp "
                     "(its tensor-parallel and pipeline forms are the next slice of ROADMAP "
                     "A.12); it trains under --dp / --coordinator")
    if args.tp > 1 and args.pp > 1:
        parser.error("--tp and --pp together are not ported (JAX's meshes are (dp, tp) or "
                     "(dp, pp))")
    if args.pp > 1:
        if args.train_type != "full":
            parser.error(f"--pp takes --train-type full only (as JAX), not {args.train_type}")
        if args.accumulate_grad_batches != 1:
            parser.error("--pp pipelines micro-batches itself: use --n-micro, not "
                         "--accumulate-grad-batches")
        if args.lisa_k or args.chunk_ctx:
            parser.error("--pp does not compose with --lisa-k or --chunk-ctx (JAX's pipeline "
                         "step has neither)")
    if args.tp > 1:
        if args.train_type not in ("full", "lora"):
            parser.error(f"--tp trains --train-type full or lora, not {args.train_type} "
                         "(ROADMAP A.12)")
        if args.quant != "none":
            parser.error("--tp with --quant is not ported: tensor-parallel training takes a "
                         "dense base (ROADMAP A.12)")
    if args.dp == 0:
        if args.coordinator is not None or os.environ.get("RWKV_DIST") == "1":
            args.dp = 0      # resolved from the number of processes at start-up
        elif args.platform == "cuda" and torch.cuda.is_available():
            args.dp = max(1, torch.cuda.device_count() // (args.tp * args.pp))
        else:
            args.dp = 1


def _start_workers(args, argv: list, world: int) -> tuple:
    """On one host: the world - 1 other ranks as processes of this command
    with a file rendezvous in a fresh directory. Returns (processes,
    directory)."""
    tmp = tempfile.mkdtemp(prefix="rwkv_train_")
    args.coordinator = "file://" + os.path.join(tmp, "rendezvous")
    args.num_processes, args.process_id = world, 0
    env = dict(os.environ, **{SPLIT_ENV: "1"})
    workers = [
        subprocess.Popen([sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", *argv,
                          "--dp", str(args.dp), "--coordinator", args.coordinator,
                          "--num-processes", str(world), "--process-id", str(rank)], env=env)
        for rank in range(1, world)]
    return workers, tmp


def _watch(workers: list, done: threading.Event) -> None:
    """Rank 0's guard: when a rank it started fails, stop the others and
    exit non-zero at once (rank 0 may be waiting in a collective). Ends
    when every rank has exited 0 or rank 0 sets ``done`` (it failed itself
    and stops them, or it returned)."""
    while not done.is_set():
        for w in workers:
            code = w.poll()
            if code not in (None, 0) and not done.is_set():
                print(f"a rank exited with code {code}; stopping the run", file=sys.stderr,
                      flush=True)
                for other in workers:
                    if other.poll() is None:
                        other.kill()
                os._exit(1)
        if all(w.poll() == 0 for w in workers):
            return
        time.sleep(0.5)


def train_multiprocess(args, argv: list) -> None:
    """One rank of a multi-process run of any command (the module
    docstring)."""
    local = (args.coordinator is None and args.num_processes is None
             and not os.environ.get("RWKV_COORDINATOR"))
    split = local or os.environ.get(SPLIT_ENV) == "1"
    workers, tmp, done = [], None, threading.Event()
    if local:
        workers, tmp = _start_workers(args, argv, args.dp * args.tp * args.pp)
        threading.Thread(target=_watch, args=(workers, done), daemon=True).start()
    try:
        if args.platform == "cuda":
            resolve_device("cuda")
        init_distributed(args.coordinator, args.num_processes, args.process_id,
                         platform=args.platform)
        world = process_count()
        dp = args.dp or world // (args.tp * args.pp)
        if args.pp > 1:
            mesh = make_pp_mesh(dp=dp, pp=args.pp)
        else:
            mesh = make_hybrid_mesh(dp=dp, tp=args.tp)
        args.mesh, args.shard = mesh, not split
        if process_index() == 0:
            print(f"ranks: dp={dp} tp={args.tp} pp={args.pp} of {world} processes, "
                  f"{'rows of the global batch' if split else 'sampler shards'}", flush=True)
        args.fn(args)
    except BaseException:
        done.set()
        for w in workers:      # a failed rank 0 ends the run at once
            if w.poll() is None:
                w.kill()
        raise
    finally:
        done.set()
        deadline = time.monotonic() + WORKER_EXIT_S
        for w in workers:
            try:
                w.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        leave_within(TEARDOWN_S)
    if any(w.returncode for w in workers):
        raise SystemExit(f"a rank exited with code {max(w.returncode for w in workers)}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(prog="rwkv_lm_ext_tpu_torch.train")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("sft")
    _common_args(p)
    p.add_argument("--train-type", default="lora",
                   choices=["full", "lora", "pissa", "state", "states", "slot-lora"])
    _lora_args(p)
    p.add_argument("--lora-apply", default="unfused", choices=["unfused", "merge"],
                   help="how LoRA enters the loss: x @ W + (x @ A) @ (scale * B) (unfused), or "
                        "x @ (W + scale * A @ B) formed at every step (merge)")
    p.add_argument("--quant", default="none", choices=["none", "int8", "int8c", "nf4", "fp4"],
                   help="QLoRA (lora, pissa and slot-lora; the other train types ignore it): "
                        "quantize the frozen base (int8 and the 4-bit codes dequantize on use; "
                        "int8c runs int8 products with a straight-through backward)")
    p.add_argument("--peft-checkpoint", default=None,
                   help="start from this LoRA .pth (reference or HF-peft keys)")
    p.add_argument("--chunk-ctx", type=int, default=0,
                   help="TBPTT under --train-type full (the other train types ignore it): "
                        "chunks of this many tokens, the state and its gradient carried "
                        "across them")
    p.add_argument("--lisa-k", type=int, default=0,
                   help="LISA under --train-type full (the other train types ignore it): "
                        "train k random blocks, drawn anew every --lisa-interval steps")
    p.add_argument("--lisa-interval", type=int, default=20)
    p.set_defaults(fn=cmd_sft)

    p = sub.add_parser("bi-encoder")
    _common_args(p)
    _lora_args(p)
    p.add_argument("--pooling", default="weightedmean")
    p.add_argument("--loss", default="infonce", choices=["infonce", "cosent"])
    p.set_defaults(fn=cmd_bi_encoder)

    p = sub.add_parser("cross-encoder")
    _common_args(p)
    _lora_args(p)
    p.set_defaults(fn=cmd_cross_encoder)

    p = sub.add_parser("nli")
    _common_args(p)
    p.add_argument("--sts-file", default=None,
                   help="stsbenchmark.tsv for per-eval STS validation")
    p.add_argument("--sts-split", default="dev")
    p.add_argument("--max-seq-len", type=int, default=33,
                   help="fixed pad length incl. the emb token")
    p.add_argument("--pooling", default="lasttoken")
    p.add_argument("--in-batch-negative", action="store_true",
                   help="in-batch InfoNCE instead of CoSENT")
    p.add_argument("--eval-every-steps", type=int, default=0)
    p.set_defaults(fn=cmd_nli)

    p = sub.add_parser("encoder-biencoder")
    _common_args(p)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--bi-mode", default="average", choices=["average", "fused"])
    p.set_defaults(fn=cmd_encoder_biencoder)

    p = sub.add_parser("encoder-crossencoder")
    _common_args(p)
    p.add_argument("--group-size", type=int, default=4)
    p.add_argument("--bi-mode", default="average", choices=["average", "fused"])
    p.set_defaults(fn=cmd_encoder_crossencoder)

    p = sub.add_parser("simcse")
    _common_args(p)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--pooling", default="weightedmean")
    p.add_argument("--dropout-noise", action="store_true",
                   help="two dropout-noised views of each text (p = 0.1 unless the model has "
                        "a dropout rate)")
    p.set_defaults(fn=cmd_simcse)

    p = sub.add_parser("instructor")
    _common_args(p)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--pooling", default="weightedmean")
    p.add_argument("--output-dim", type=int, default=0)
    p.set_defaults(fn=cmd_instructor)

    p = sub.add_parser("mlm")
    _common_args(p)
    p.set_defaults(fn=functools.partial(cmd_mlm, mae=False))
    p = sub.add_parser("mae")
    _common_args(p)
    p.add_argument("--dup-mae", action="store_true",
                   help="add the DupMAE bag-of-words loss")
    p.add_argument("--uni", action="store_true",
                   help="the causal model as the encoder, seq_emb added to its token states")
    p.set_defaults(fn=functools.partial(cmd_mlm, mae=True))
    args = parser.parse_args(argv)
    _refuse_parallel(parser, args)
    if (args.dp * args.tp * args.pp != 1 or args.coordinator or args.num_processes
            or os.environ.get("RWKV_DIST") == "1"):
        train_multiprocess(args, argv)
        return
    args.fn(args)

if __name__ == "__main__":
    main()
