#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(`python3 chip_smoke.py --merge-calibration` builds the kernels and prints
only the readings behind phase 9's merged-adapter budgets.)

Phases, each printing its own lines:
  1. the device (name and nvidia-smi's power limit) and the kernel build
     (one nvcc per source, all started together);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at the main paths' shapes, and both timed by their device time
     (torch.profiler, host overhead excluded): K1-K3 at
     B=64, T=512, K1 and K2 also body by body (the tensor-core and chunked
     bodies that bf16 runs beside the CUDA-core and sequential ones that fp32
     runs), K1 at strong, wide and no decay with its final state after T=512
     and against its chunked factoring in plain PyTorch, K2 on ragged tiles
     and at T=1; the int8 row quantizer B.4 (bit-identical) at the
     prefill and decode shapes; the decode step B.9 at B=64 and B=1, also
     against K1 at T=1; the backward kernels B.5 (ddlerp prologue) and
     B.6 + B.7 (fused WKV) at the training shape B=8, T=512 and ragged
     shapes, fp32 and bf16, against autograd through their plain versions,
     each called twice and held bit-equal; both bodies of B.5 (tensor
     cores, which bf16 runs, and CUDA cores) in turns, both forms, on row
     tiles that straddle sequences, the tensor-core body against its tiled
     mirror (dx within one bf16 rounding, the fp32 gradients within 1e-4);
     both bodies of the WKV backward
     (chunked, which bf16 runs, and sequential) in turns on the same bf16
     inputs, the fused and the gn=False form, at wide, strong and no decay,
     T = 1 to 512, forwards, in reverse and over ragged prefixes, each
     gradient's error at B=8, T=512 and strong decay, then timed in turns
     twice at B=8, T=512; the unfused WKV B.8 and its
     two-pass backward the same way, with and without a bonus, an initial
     state, `reverse` and ragged `lengths`, and `wkv6_bi` against the flip
     composition; both bodies of B.8 (chunked, which bf16 runs, and
     sequential) in turns on the same inputs at N = 64 and 32, three decay
     ranges, T = 1 to 512, timed in turns twice at B=8 and B=64; the fused decode kernels B.10 (attention prologue), B.11
     (channel-mix prologue) and B.12 (whole channel mix) at B=64 and B=1,
     fp32 and bf16, beside the calls each replaces on the unfused step (in
     turns, twice), B.10's cluster body against its row-pair body and its
     sliced mirror, B.11 against its warp-order mirror and B.12 against its
     split mirror, all three timed hot and cold (their weights, B.11's
     inputs, rotated through copies, as a decode step finds them), B.12 by
     its busy time (its launches overlap), and the transposed-state decode
     step B.13 against B.9 (state bit-equal), the two timed in turns, hot in
     place and cold.
     Beside every time stands the kernel's bound on this card
     (bytes over 3.35 TB/s against operations over the peak of their type)
     and, for LayerNorm, the time of `F.layer_norm`;
  3. a synthetic RWKV-6-World-1B6 (24 layers, C=2048, bf16, seeded weights)
     serving embeddings over HTTP: answers, launch counts, the served
     embeddings against the plain fp32 route; plus a 2-layer full-width
     checkpoint round trip;
  4. generation on the bf16 model: prefill + decode against one full
     forward, greedy generation against the plain fp32 route, and the
     launch counts of a decode step;
  5. the int8c configuration through the normal entry point: the model
     saved as a .pth and served by `python -m rwkv_lm_ext_tpu_torch.serve.cli
     --quant int8c` in a subprocess (/generate blocking and SSE, /stats),
     then built in this process by the same CLI code, served, and held
     against the int8c plain route; int8c embeddings against the int8c plain
     route;
  6. serving readings (not benchmark cells): embedded seq/s at B=64, T=512
     (a data chain with a canary: its last result must come back from its
     last input and move when that input changes), decode tok/s of
     generate_batch at B=64, single-stream tok/s of generate, bf16 and int8c;
  7. training gradients of a 2-layer full-width model at B=8, T=512, kernel
     route against plain route: LoRA A/B in fp32 and in bf16, remat on
     against off, and state tuning's time_state;
  8. LoRA train steps of the 24-layer model at B=8, T=512: the launch
     counts of one step (remat on and off), step time and Kt/s readings
     over chained steps with a canary (the last loss must come back from
     the parameters before the last step and the last batch, and move on
     another batch), and a profile of one step, which must show the chunked
     WKV backward kernels and B.5's tensor-core body and not the sequential
     or CUDA-core ones;
  9. training through `python -m rwkv_lm_ext_tpu_torch.train.cli sft` on the
     saved model (LoRA 8 steps, state tuning 4 steps, subprocesses): falling
     losses, the adapter files, the merged adapter against the unfused
     forward (its worst position and its mean over positions); then the same
     CLI in this process, whose launch counts are the training path's;
 10. the bidirectional encoder on the same 24-layer weights at B=8, T=512
     with ragged rows: both modes against the plain fp32 route (also through
     B.8's sequential body, for comparison) and the launch counts of a
     forward; `/fill_mask` through `python -m
     rwkv_lm_ext_tpu_torch.serve.cli --encoder` (a subprocess, serving the
     encoder that phase 12 trained) against the plain route's candidates,
     then in this process for its launch counts;
 11. full-parameter MLM gradients over fp32 master weights (2 layers, full
     width, B=8, T=512, both modes), kernel route against plain route in fp32
     and in bf16 compute, remat on against off, the launch counts of a step;
 12. `python -m rwkv_lm_ext_tpu_torch.train.cli mlm` (4 steps) and `mae
     --dup-mae` (2 steps) on the 24-layer model as subprocesses, the saved
     encoder, then `mlm` in this process for its launch counts;
 13. encoder readings (not benchmark cells): sequences a second at B=64,
     T=512 in both modes with a profile of one forward (B.8's chunked body
     and not its sequential one), the `mlm` step time, Kt/s, peak memory and
     profile, each chain with its canary;
 14. the fused decode route, `rwkv_decode_step(fused_prep=True, out=state)`,
     on the 24-layer bf16 model (B.10, B.9, B.12) and the int8c model (B.10,
     B.9, B.11, B.4): 16 teacher-forced steps at B=64 against the fp32 plain
     route and the unfused route, the state after them, the launch counts of
     a step, greedy tokens against the unfused route; then readings: the
     decode-step ablation (step, step_fused, step_attprep, step_ffnblk at
     B=64 and B=1: ms a step over a data chain with a canary, device operations and busy
     time of one step, whose profile must name B.10's cluster body and B.12's
     stream kernels) and the op-level comparison of the decode step on the
     logical and on the transposed state.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result. Without a CUDA device it exits non-zero
before doing anything.
"""
from __future__ import annotations

import collections
import functools
import importlib
import json
import queue
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    init_lora_params,
    lora_state_dict_to_tree,
    merge_lora,
)
from rwkv_lm_ext_tpu_torch.adapters.quant import QuantLinear, quantize_model
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_rwkv_checkpoint,
    load_state_dict_into,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.config import EMB_ID, MASK_ID, TrainConfig, rwkv6_1b6
from rwkv_lm_ext_tpu_torch.data.collators import mlm_collate
from rwkv_lm_ext_tpu_torch.data.sft import encode_sft_example
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.models.bidirectional import encoder_forward, sequence_lengths
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS, RWKV
from rwkv_lm_ext_tpu_torch.models.state import init_model_state
from rwkv_lm_ext_tpu_torch.ops import _lib, launch_counts, reset_launch_counts, wkv_fused
from rwkv_lm_ext_tpu_torch.ops.decode_fused import (
    _launch_att_prep,
    att_prep_fused,
    att_prep_plain,
    att_prep_sliced_plain,
    b10_body,
    ffn_block_fused,
    ffn_block_plain,
    ffn_block_split_plain,
    ffn_prep_fused,
    ffn_prep_plain,
    ffn_prep_warp_order_plain,
    ffn_value_splits,
)
from rwkv_lm_ext_tpu_torch.ops.ddlerp import (
    B5_BODIES,
    B5_LIMBS,
    _launch_k2,
    b5_body,
    k2_body,
    tmix_prologue,
    tmix_prologue_bwd,
    tmix_prologue_bwd_plain,
    tmix_prologue_bwd_tiled_plain,
    tmix_prologue_plain,
)
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_plain
wkv_ops = importlib.import_module("rwkv_lm_ext_tpu_torch.ops.wkv")   # the module, not the function
from rwkv_lm_ext_tpu_torch.ops.wkv import (
    WKV_BODIES,
    wkv,
    wkv6_bi,
    wkv6_bi_plain,
    wkv_body,
    wkv_bwd,
    wkv_bwd_plain,
    wkv_chunked_plain,
    wkv_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import (
    transpose_state,
    wkv6_decode_step,
    wkv6_decode_step_plain,
    wkv6_decode_step_transposed,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    WKV_BWD_BODIES,
    _launch_k1,
    _prepare as k1_prepare,
    k1_body,
    wkv6_fused_output,
    wkv6_fused_output_bwd,
    wkv6_fused_output_bwd_plain,
    wkv6_fused_output_chunked_plain,
    wkv6_fused_output_plain,
    wkv_bwd_body,
)
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http
from rwkv_lm_ext_tpu_torch.train import cli as train_cli
from rwkv_lm_ext_tpu_torch.train.loop import make_train_step, mlm_loss_fn, sft_loss_fn
from rwkv_lm_ext_tpu_torch.train.optim import apply_trainable_mask, trainable_mask
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
BF16 = torch.bfloat16
# main-path geometry of RWKV-6-World-1B6 at the headline batch
B, T, C, H, N, D, F = 64, 512, 2048, 32, 64, 32, 7168
DD = 64                # width of the decay low-rank
LN_X_EPS = 6.4e-4

KERNELS = {
    "layer_norm": dict(source="rwkv_lm_ext_tpu_torch/csrc/ln.cu",
                       replaces="rwkv_lm_ext_tpu/ops/ln_pallas.py:21"),
    "tmix_prologue": dict(source="rwkv_lm_ext_tpu_torch/csrc/ddlerp.cu",
                          replaces="rwkv_lm_ext_tpu/ops/ddlerp_pallas.py:35"),
    "wkv6_fused_output": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_fused.cu",
                              replaces="rwkv_lm_ext_tpu/ops/wkv_pallas.py:743"),
    "wkv6_decode_step": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_decode.cu",
                             replaces="rwkv_lm_ext_tpu/ops/wkv_decode.py:68"),
    "quantize_rows": dict(source="rwkv_lm_ext_tpu_torch/csrc/quant.cu",
                          replaces="rwkv_lm_ext_tpu/ops/quant_pallas.py:29"),
    "tmix_prologue_bwd": dict(source="rwkv_lm_ext_tpu_torch/csrc/ddlerp_bwd.cu",
                              replaces="rwkv_lm_ext_tpu/ops/ddlerp_pallas.py:166"),
    "wkv6_bwd_forward_pass": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_fused_bwd.cu",
                                  replaces="rwkv_lm_ext_tpu/ops/wkv_pallas.py:1132"),
    "wkv6_bwd_reverse_pass": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_fused_bwd.cu",
                                  replaces="rwkv_lm_ext_tpu/ops/wkv_pallas.py:1209"),
    "wkv": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv.cu",
                replaces="rwkv_lm_ext_tpu/ops/wkv_pallas.py:440"),
    # pass 1 of the unfused WKV's backward: B.6 with gn=False
    "wkv_bwd_state_pass": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_fused_bwd.cu",
                               replaces="rwkv_lm_ext_tpu/ops/wkv_pallas.py:1132"),
    # the fused T=1 decode route
    "att_prep_fused": dict(source="rwkv_lm_ext_tpu_torch/csrc/decode_fused.cu",
                           replaces="rwkv_lm_ext_tpu/ops/decode_fused.py:101"),
    "ffn_prep_fused": dict(source="rwkv_lm_ext_tpu_torch/csrc/decode_fused.cu",
                           replaces="rwkv_lm_ext_tpu/ops/decode_fused.py:251"),
    "ffn_block_fused": dict(source="rwkv_lm_ext_tpu_torch/csrc/decode_fused.cu",
                            replaces="rwkv_lm_ext_tpu/ops/decode_fused.py:354"),
    # the decode step on a transposed state: a layout option of the op, reached
    # by the op-level comparison only, as in the JAX package
    "wkv6_decode_step_transposed": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_decode.cu",
                                        replaces="scripts/bench_decode_transposed.py:65"),
}
NO_BACKWARD = {"tmix_prologue_bwd": 0, "wkv6_bwd_forward_pass": 0, "wkv6_bwd_reverse_pass": 0,
               "wkv_bwd_state_pass": 0}
# the kernels that only rwkv_decode_step(fused_prep=True) and the transposed
# decode step launch: no other path runs them
NO_FUSED = {"att_prep_fused": 0, "ffn_prep_fused": 0, "ffn_block_fused": 0,
            "wkv6_decode_step_transposed": 0}
# launches per forward of the 24-layer model: ln0 + 24 ln2 + ln_out, and one
# prologue and one WKV per layer; a decode step swaps K1 for the decode
# kernel; int8c adds 8 row quantizations a layer (5 att + 3 ffn projections)
PER_FORWARD = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 24,
               "wkv6_decode_step": 0, "quantize_rows": 0, "wkv": 0, **NO_BACKWARD, **NO_FUSED}
PER_STEP = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 0,
            "wkv6_decode_step": 24, "quantize_rows": 0, "wkv": 0, **NO_BACKWARD, **NO_FUSED}
# one forward of the bidirectional encoder, either mode: ln0 + 24 x (ln1, ln2)
# + ln_out through K3 (the plain projections take ln1's output), and the
# unfused WKV twice a layer
NO_LAUNCH = {k: 0 for k in PER_FORWARD}
ENCODER_FORWARD = dict(NO_LAUNCH, layer_norm=50, wkv=48)
# a decode step with fused_prep: K3 only for ln0 and ln_out, no K2; per layer
# the attention prologue B.10, the decode kernel, and the whole channel mix
# B.12 (dense weights) or its prologue B.11 (quantized weights)
PER_FUSED_STEP = dict(NO_LAUNCH, layer_norm=2, att_prep_fused=24, wkv6_decode_step=24,
                      ffn_block_fused=24)
PER_FUSED_STEP_QUANT = dict(PER_FUSED_STEP, ffn_block_fused=0, ffn_prep_fused=24)


def encoder_step_counts(n_layer: int, remat: bool) -> dict:
    """Launches of one full-parameter encoder train step: the forward's, under
    remat each block's again (ln_out is outside the blocks), and the two
    backward passes for every WKV call (every parameter trains, so layer 0's
    too)."""
    fwd = 2 if remat else 1
    return dict(NO_LAUNCH, layer_norm=(1 + 2 * n_layer) * fwd + 1, wkv=2 * n_layer * fwd,
                wkv_bwd_state_pass=2 * n_layer, wkv6_bwd_reverse_pass=2 * n_layer)


def train_step_counts(n_layer: int, remat: bool) -> dict:
    """Launches of one LoRA or state-tuning train step: the forward's, and
    under remat each block's forward kernels again (ln_out is outside the
    blocks); the backward runs B.6 and B.7 in every layer and B.5 in every
    layer but the first, whose prologue inputs (the frozen embedding after
    ln0) and weights need no gradient."""
    fwd = 2 if remat else 1
    return dict(PER_FORWARD, layer_norm=(1 + n_layer) * fwd + 1, tmix_prologue=n_layer * fwd,
                wkv6_fused_output=n_layer * fwd, tmix_prologue_bwd=n_layer - 1,
                wkv6_bwd_forward_pass=n_layer, wkv6_bwd_reverse_pass=n_layer)


INT8C_PER_LAYER = 8
GREEDY = SamplingParams(temperature=0.0, top_p=1.0, alpha_presence=0.0,
                        alpha_frequency=0.0, token_stop=())
SHORT = "RWKV is an RNN with transformer-level performance."
CJK = "北京是中华人民共和国的首都，也是全国的政治和文化中心。"
MIXED = "Embeddings 向量 🚀 for retrieval and reranking."


T_START = time.perf_counter()


def phase(title: str) -> None:
    """A phase's header, with the script's time so far."""
    print(f"{title} [{time.perf_counter() - T_START:.0f} s]", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ops(fn, reps: int) -> list:
    """The device operations that `reps` calls of fn() launch, as
    torch.profiler records them, after one warm-up. The canary of every time
    read from such a trace: the operation that the record holds most often
    must be there for (nearly) every one of the `reps` calls. The profiler
    on an H100 was seen to return no record at all (50 launches of a 10 us
    kernel) and to lose records (19 of 20, and 8 of 10, three traces in a
    row each, and once a third trace with no record after two that lost
    two in ten). One record in ten may be missing (one, from 4 calls on); a
    trace that lost more is taken again, four times at most, each time
    waiting longer between the last launch's end and the profiler's stop.
    The fifth trace is taken as it is if it holds the operation for half
    the calls or more (per_call_us works from the records that remain); if
    it holds fewer, the timed calls did not run and the script fails."""
    fn()
    allowed = 0 if reps < 4 else max(1, reps // 10)
    pauses = (0.0, 0.05, 0.25, 0.5, 1.0)
    for attempt, pause in enumerate(pauses):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pause)
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        most = max(collections.Counter(e.name for e in ops).values(), default=0)
        if most >= reps - allowed:
            return ops
        last = attempt == len(pauses) - 1
        print(f"  (a profiler trace held {len(ops)} device operations, the most frequent {most} "
              f"times, for {reps} calls; {'taken as it is' if last else 'taken again'})")
        if last and most > 0 and 2 * most >= reps:
            return ops
    raise AssertionError(f"five profiler traces in a row held their most frequent device operation "
                         f"for fewer than half of {reps} calls: the timed calls did not run, or "
                         "were not recorded")


def per_call_us(ops: list, reps: int) -> float:
    """Device microseconds of one call, from the records of `reps` calls: for
    each kernel name its mean duration times the launches a call makes of it
    (the count over `reps`, rounded), so that a record the profiler lost does
    not shorten the time. A name seen in fewer than half the calls counts
    with its sum over `reps`."""
    durations = collections.defaultdict(list)
    for e in ops:
        durations[e.name].append(e.self_device_time_total)
    total = 0.0
    for d in durations.values():
        launches = round(len(d) / reps)
        total += sum(d) / len(d) * launches if launches else sum(d) / reps
    return total


def chain_canary(step, last_in: torch.Tensor, last_out: torch.Tensor, changed_in: torch.Tensor,
                 what: str) -> None:
    """The canary of a timed data chain: the loop's last result must be what
    its last input gives when the step runs again outside the loop (the timed
    work ran on that input, not on a stale or replayed one), and must move
    when that input changes."""
    with torch.inference_mode():
        repeat = (step(last_in).float() - last_out.float()).abs().max().item()
        moved = (step(changed_in).float() - last_out.float()).abs().max().item()
    print(f"  canary, {what}: the chain's last result comes back from its last input "
          f"(max diff {repeat:.3e}) and moves by {moved:.3e} when that input changes")
    check(moved > 0 and repeat <= moved / 10,
          f"{what}: the timed chain's last result does not depend on its last input "
          f"(repeat {repeat}, changed {moved})")


def device_ms(fn, reps: int) -> float:
    """Device time of one fn() call, from the device operations of `reps`
    calls (device_ops, per_call_us). Host launch overhead and the
    gaps between launches do not count, so a kernel of a few microseconds is
    not read as the time its Python wrapper takes to launch it."""
    return per_call_us(device_ops(fn, reps), reps) / 1e3


def busy_us(ops: list) -> float:
    """Microseconds during which at least one of `ops` ran: the length of
    the union of their intervals. Kernels that overlap (B.12's dependent
    launches start while the one before them runs, and wait for it) count
    once; for kernels that run one after another it is the sum of their
    durations."""
    total, start, end = 0.0, None, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ops):
        if end is None or a > end:
            total += 0.0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    return total + (0.0 if end is None else end - start)


def device_span_ms(fn, reps: int) -> float:
    """Device time of one fn() call as the device's busy time over `reps`
    calls (busy_us) divided by the calls: device_ms for calls whose kernels
    overlap."""
    return busy_us(device_ops(fn, reps)) / reps / 1e3


def device_ms_by_kernel(fn, reps: int, groups: dict) -> dict:
    """As device_ms, split by kernel name: {group: ms of one call} for the
    device operations whose name holds one of the group's substrings."""
    ops = device_ops(fn, reps)
    out = {g: per_call_us([e for e in ops if any(k in e.name for k in keys)], reps) / 1e3
           for g, keys in groups.items()}
    check(all(v > 0 for v in out.values()), f"the profiler recorded no kernel of a group: {out}")
    return out


# Published peaks of one H100 SXM: device memory, and the dense rate of each
# type of operation (matrix products of bf16 inputs on the tensor cores; fp32
# outside them; fp64 outside them, half the fp32 rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16 mma": 989e12, "fp32": 67e12, "fp64": 33.5e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(moved: int, ops: dict) -> dict:
    """The least time the card could take: `moved` bytes (each input read
    once, each output written once) over the memory rate, against the
    operations, by type, over their peak rates."""
    t_bytes = moved / PEAK_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items()) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def phase_card_rates() -> None:
    """What this card reaches in this run: a device-to-device copy of 1 GiB
    and an fp32 (no TF32) matrix product, beside the published peaks."""
    a = torch.empty(2**28, dtype=torch.float32, device=DEV).normal_()
    b = torch.empty_like(a)
    ms = device_ms(lambda: b.copy_(a), 10)
    print(f"  measured: copy of 1 GiB {2 * a.numel() * 4 / ms / 1e9:.3f} TB/s read + write "
          f"(published {PEAK_BYTES_S / 1e12} TB/s)")
    del a, b
    m = torch.randn(8192, 8192, device=DEV)
    ms = device_ms(lambda: m @ m, 3)
    print(f"  measured: fp32 matmul 8192^3 without TF32 {2 * 8192**3 / ms / 1e9:.2f} TFLOP/s "
          f"(published {PEAK_OPS_S['fp32'] / 1e12} TFLOP/s)")
    del m
    torch.cuda.empty_cache()


class Inputs:
    def __init__(self, seed: int):
        self.gen = torch.Generator(device=DEV).manual_seed(seed)

    def normal(self, *shape, scale=1.0, dtype=BF16):
        return (torch.randn(*shape, generator=self.gen, device=DEV) * scale).to(dtype)

    def uniform(self, *shape, lo, hi, dtype=BF16):
        u = torch.rand(*shape, generator=self.gen, device=DEV)
        return (u * (hi - lo) + lo).to(dtype)


def f32(*tensors):
    return [t.float() for t in tensors]


def err_line(name, got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    limit = rel * want.float().abs().max().item()
    print(f"  {name}: max |kernel - plain| = {err:.3e}, limit {limit:.3e} ({rel:g} x max|plain|)")
    check(err <= limit, f"{name}: error {err} above {limit}")
    return err


def phase_kernels() -> dict:
    """Each kernel against its plain version, then both timed at the main
    paths' shapes. Returns {kernel: {max_abs_err, ms, plain_ms}}."""
    rng = Inputs(1)
    out = {}

    x = rng.normal(B * T, C, scale=2.0)
    sc, bi = rng.normal(C, scale=0.2) + 1, rng.normal(C, scale=0.2)
    err = err_line(f"layer_norm ({B * T}, {C})", layer_norm(x, sc, bi),
                   layer_norm_plain(*f32(x, sc, bi)), 1e-2)
    out["layer_norm"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: layer_norm(x, sc, bi), 20),
        plain_ms=device_ms(lambda: layer_norm_plain(x, sc, bi), 20),
        # mean, centred variance, normalise, scale and shift: ~8 fp32 an element
        **roofline(nbytes(x, sc, bi, x), {"fp32": 8 * x.numel()}),
    )
    # the one PyTorch call that computes the same function; the port never calls it
    out["layer_norm"]["library_ms"] = device_ms(
        lambda: torch.nn.functional.layer_norm(x, (C,), sc, bi, 1e-5), 20)

    def prologue_args(b):
        return (rng.normal(b, T, C), rng.normal(b, C), sc, bi,
                rng.uniform(6, C, lo=0.0, hi=1.0), rng.normal(C, 5 * D, scale=0.1),
                rng.normal(5, D, C, scale=0.1))

    args = prologue_args(8)
    got, want = tmix_prologue(*args), tmix_prologue_plain(*f32(*args))
    names = ("xw", "xk", "xv", "xr", "xg", "xln")
    err = max(err_line(f"tmix_prologue B=8 T={T} {n}", g, w, 1e-2)
              for n, g, w in zip(names, got, want))
    # which body runs: tensor cores for the served dtype, CUDA cores for fp32,
    # each against the plain version: fp32 within 1e-4 (the order of its sums);
    # ragged tiles that cross batch rows, and one step of 64 sequences
    print(f"  tmix_prologue bodies: bf16 {k2_body(BF16, C, D)}, fp32 {k2_body(torch.float32, C, D)}")
    check(k2_body(BF16, C, D) == "tensor_cores" and k2_body(torch.float32, C, D) == "cuda_cores",
          "tmix_prologue does not run the body its dtype should")
    for b, t in ((3, 37), (B, 1)):
        small = prologue_args(b)
        small = (small[0][:, :t].contiguous(),) + small[1:]
        for n, g, w in zip(names, tmix_prologue(*small), tmix_prologue_plain(*f32(*small))):
            err_line(f"tmix_prologue B={b} T={t} bf16 {n}", g, w, 1e-2)
        for n, g, w in zip(names, tmix_prologue(*f32(*small)), tmix_prologue_plain(*f32(*small))):
            err_line(f"tmix_prologue B={b} T={t} fp32 {n}", g, w, 1e-4)
    args = prologue_args(B)
    both = {body: device_ms(lambda: _launch_k2(*args, 1e-5, body=body), 10)
            for body in ("tensor_cores", "cuda_cores")}
    args8 = prologue_args(8)
    print(f"  tmix_prologue bf16, one body beside the other: B={B}, T={T} tensor cores "
          f"{both['tensor_cores']:.4f} ms, CUDA cores {both['cuda_cores']:.4f} ms; B=8, T={T} tensor "
          f"cores {device_ms(lambda: tmix_prologue(*args8), 10):.4f} ms, CUDA cores "
          f"{device_ms(lambda: _launch_k2(*args8, 1e-5, body='cuda_cores'), 10):.4f} ms")
    out["tmix_prologue"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: tmix_prologue(*args), 10),
        plain_ms=device_ms(lambda: tmix_prologue_plain(*args), 5),
        # six (B, T, C) outputs; the two low-rank products (C x 5D, 5 x D x C)
        # of bf16 inputs, LayerNorm and the mixes (~30 fp32 an element)
        **roofline(nbytes(*args) + 6 * nbytes(args[0]),
                   {"bf16 mma": 2 * 2 * B * T * C * 5 * D, "fp32": 30 * B * T * C}),
    )
    args1 = prologue_args(B)
    args1 = (args1[0][:, :1].contiguous(),) + args1[1:]
    print(f"  tmix_prologue at T=1, B={B} (the decode step's call): "
          f"kernel {device_ms(lambda: tmix_prologue(*args1), 20):.4f} ms, "
          f"CUDA-core body {device_ms(lambda: _launch_k2(*args1, 1e-5, body='cuda_cores'), 20):.4f} ms, "
          f"plain {device_ms(lambda: tmix_prologue_plain(*args1), 20):.4f} ms")

    def wkv_args(b, t, lo=-8.0, hi=2.5):
        r, k, v, g = (rng.normal(b, t, H, N) for _ in range(4))
        w = rng.uniform(b, t, H, N, lo=lo, hi=hi, dtype=torch.float32)
        return (r, k, v, w, rng.normal(H, N, scale=0.5), g, rng.normal(H * N, scale=0.1) + 1,
                rng.normal(H * N, scale=0.1), rng.normal(b, H, N, N, scale=0.1, dtype=torch.float32))

    # which body runs: chunks of the library's length on the tensor cores for
    # bf16, the sequential recurrence for fp32
    chunk = _lib.library().rwkv_wkv6_fused_chunk()
    print(f"  wkv6_fused_output bodies: bf16 {k1_body(BF16)} (chunks of {chunk} steps, "
          f"{_lib.library().rwkv_wkv6_fused_blocks_per_sm(N)} blocks an SM at N={N}), "
          f"fp32 {k1_body(torch.float32)}")
    check(k1_body(BF16) == "chunked" and k1_body(torch.float32) == "sequential",
          "wkv6_fused_output does not run the body its dtype should")
    errs = []
    # the wide decay range of the main path, strong decay (w in [2.5, 3.2]: a
    # decay of 5e-6 .. 2e-11 a step, where a factoring by exp(+c) overflows)
    # and no decay (w = -8: the state only grows); T = 512 with its final
    # state and a ragged T. out within 1e-2 (bf16 output), state within 1e-3
    # of the plain recurrence; state within 1e-4 of the chunked factoring in
    # plain PyTorch on the same inputs (the same sums, the kernel's in two
    # bf16 limbs)
    for lo, hi in ((-8.0, 2.5), (2.5, 3.2), (-8.0, -8.0)):
        for t in (T, 37):
            args = wkv_args(8, t, lo, hi)
            label = f"wkv6_fused_output B=8 T={t} w in [{lo}, {hi}]"
            (o, s) = wkv6_fused_output(*args, eps=LN_X_EPS)
            (o2, s2) = wkv6_fused_output(*args, eps=LN_X_EPS)
            check(torch.equal(o, o2) and torch.equal(s, s2), f"{label}: two calls differ")
            (ro, rs) = wkv6_fused_output_plain(*f32(*args), eps=LN_X_EPS)
            errs.append(err_line(f"{label} out", o, ro, 1e-2))
            err_line(f"{label} state", s, rs, 1e-3)
            (mo, ms_) = wkv6_fused_output_chunked_plain(*f32(*args), eps=LN_X_EPS, chunk=chunk)
            err_line(f"{label} out vs chunked mirror", o, mo, 1e-2)
            err_line(f"{label} state vs chunked mirror", s, ms_, 1e-4)
    args = f32(*wkv_args(2, 37))
    (o, s) = wkv6_fused_output(*args, eps=LN_X_EPS)
    (ro, rs) = wkv6_fused_output_plain(*args, eps=LN_X_EPS)
    err_line("wkv6_fused_output B=2 T=37 fp32 out", o, ro, 1e-4)
    err_line("wkv6_fused_output B=2 T=37 fp32 state", s, rs, 1e-4)
    args = wkv_args(B, T)
    prepared = args[:3] + k1_prepare(*args)
    both = {body: device_ms(lambda: _launch_k1(*prepared, LN_X_EPS, body=body), 10)
            for body in ("chunked", "sequential")}
    args8 = wkv_args(8, T)
    prepared8 = args8[:3] + k1_prepare(*args8)
    print(f"  wkv6_fused_output bf16, one body beside the other: B={B}, T={T} chunked "
          f"{both['chunked']:.4f} ms, sequential {both['sequential']:.4f} ms; B=8, T={T} chunked "
          f"{device_ms(lambda: wkv6_fused_output(*args8, eps=LN_X_EPS), 10):.4f} ms, sequential "
          f"{device_ms(lambda: _launch_k1(*prepared8, LN_X_EPS, body='sequential'), 10):.4f} ms")
    out["wkv6_fused_output"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: wkv6_fused_output(*args, eps=LN_X_EPS), 10),
        plain_ms=device_ms(lambda: wkv6_fused_output_plain(*args, eps=LN_X_EPS), 3),
        # every input once, the output in g's dtype and the final state; per
        # step and head the two products of the recurrence (r S and k v^T,
        # 2 N^2 each) at the tensor cores' rate, the decay of the state (N^2)
        # and the GroupNorm (~10 N) in fp32
        **roofline(nbytes(*args) + nbytes(args[5], args[8]),
                   {"bf16 mma": 4 * B * T * H * N * N, "fp32": B * T * H * (N * N + 10 * N)}),
    )

    # B.4: bit-identical at the prefill shapes (C and F), a ragged shape and
    # a decode row; zero rows and rows with exact half-way ties
    for shape in ((B * T, C), (B * T, F), (37, 2050), (1, C)):
        xq = rng.normal(*shape, scale=3.0)
        xq[0] = 0
        if shape[0] > 1:
            # absmax 127 makes s = 127 * fl(1/127) = 1.0: k + 0.5 are ties
            xq[1] = 0
            xq[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
        q, s = quantize_rows(xq)
        qp, sp = quantize_rows_plain(xq)
        same = torch.equal(q, qp) and torch.equal(s, sp)
        print(f"  quantize_rows {shape}: q and s {'bit-identical' if same else 'DIFFER'} to plain")
        check(same, f"quantize_rows {shape} is not bit-identical to its plain version")
    xq = rng.normal(B * T, C, scale=3.0)
    xf = rng.normal(B * T, F, scale=3.0)
    out["quantize_rows"] = dict(
        max_abs_err=0.0,
        ms=device_ms(lambda: quantize_rows(xq), 20),
        plain_ms=device_ms(lambda: quantize_rows_plain(xq), 20),
        # int8 values and one fp32 scale a row; absmax, scale, round: ~4 an element
        **roofline(nbytes(xq) + xq.numel() + 4 * xq.shape[0], {"fp32": 4 * xq.numel()}),
    )
    print(f"  quantize_rows ({B * T}, {F}): kernel {device_ms(lambda: quantize_rows(xf), 20):.4f} ms, "
          f"plain {device_ms(lambda: quantize_rows_plain(xf), 20):.4f} ms")

    # B.9 at B=64 and B=1: against plain, in place, and against K1 at T=1
    def decode_args(b):
        r, k, v, g = (rng.normal(b, C) for _ in range(4))
        w = rng.uniform(b, C, lo=-8.0, hi=2.5, dtype=torch.float32)
        return (r, k, v, w, g, rng.normal(H, N, scale=0.5), rng.normal(C, scale=0.1) + 1,
                rng.normal(C, scale=0.1), rng.normal(b, H, N, N, scale=0.3, dtype=torch.float32))

    errs, times = [], {}
    for b in (B, 1):
        args = decode_args(b)
        if b == B:
            args_main = args
        state = args[-1]
        po, ps = wkv6_decode_step_plain(*f32(*args), eps=LN_X_EPS)
        inplace = state.clone()
        o, s = wkv6_decode_step(*args[:-1], inplace, eps=LN_X_EPS, out_state=inplace)
        errs.append(err_line(f"wkv6_decode_step B={b} out", o, po, 1e-2))
        err_line(f"wkv6_decode_step B={b} state (in place)", s, ps, 1e-5)
        heads = (b, 1, H, N)
        r, k, v, w, g, u, lsc, lbi, _ = args
        k1 = (r.view(heads), k.view(heads), v.view(heads), w.view(heads), u, g.view(heads),
              lsc, lbi, state)
        ko, ks = wkv6_fused_output(*k1, eps=LN_X_EPS)
        err_line(f"wkv6_decode_step B={b} out vs K1 at T=1", o, ko.view(b, C), 1e-2)
        err_line(f"wkv6_decode_step B={b} state vs K1 at T=1", s, ks, 1e-5)
        buf = state.clone()
        times[b] = (device_ms(lambda: wkv6_decode_step(*args[:-1], buf, eps=LN_X_EPS, out_state=buf), 50),
                    device_ms(lambda: wkv6_decode_step_plain(*args, eps=LN_X_EPS), 20),
                    device_ms(lambda: wkv6_fused_output(*k1, eps=LN_X_EPS), 50))
        print(f"  wkv6_decode_step B={b}: kernel {times[b][0]:.4f} ms, plain {times[b][1]:.4f} ms, "
              f"K1 at T=1 {times[b][2]:.4f} ms")
    out["wkv6_decode_step"] = dict(
        max_abs_err=max(errs), ms=times[B][0], plain_ms=times[B][1],
        # the state is read and written; one step of the recurrence
        **roofline(nbytes(*args_main) + nbytes(args_main[0], args_main[-1]),
                   {"fp32": 5 * B * H * N * N}))
    for name, r in out.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (main-path shape)")
    return out


BWD_REL = {torch.float32: 5e-4, BF16: 2e-2}        # B.5, x max|plain|
# B.5's tensor-core body against its tiled mirror (the same operand rounding
# and tiles), x max|mirror|: dx within one bf16 rounding, the fp32 gradients
# within the order of fp32 sums
B5_MIRROR_REL = (1e-2, 1e-4)
WKV_BWD_REL = {torch.float32: 1e-4, BF16: 2e-2}    # B.6 + B.7
# B.6 + B.7's fp32 gradients (dw, du, ds0, dln_scale, dln_bias) on bf16
# inputs: no rounding to bf16, only the kernel's own sums
WKV_BWD_REL_FP32_OUT = 1e-3
TB = 8                                             # the training batch


def wkv_bwd_rel(dtype, grad: torch.Tensor) -> float:
    """The limit, x max|plain|, of one gradient of the WKV backward on
    `dtype` inputs."""
    return WKV_BWD_REL_FP32_OUT if dtype == BF16 and grad.dtype == torch.float32 else WKV_BWD_REL[dtype]


def bit_equal(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def phase_backward_kernels() -> dict:
    """B.5 and B.6 + B.7 against autograd through their plain versions, on
    the same inputs and cotangents (the plain side in fp32), at the training
    shape and a ragged one, fp32 and bf16; two calls bit-equal. Then timed
    at B=8, T=512, bf16 beside their plain versions and their forwards.
    Returns {kernel: {max_abs_err, ms, plain_ms}}; the errors are those at
    the training shape in bf16, the main path's dtype."""
    rng = Inputs(2)
    out = {}

    def prologue_case(b, t, dtype):
        args = (rng.normal(b, t, C, dtype=dtype), rng.normal(b, C, dtype=dtype),
                rng.normal(C, scale=0.2, dtype=dtype) + 1, rng.normal(C, scale=0.2, dtype=dtype),
                rng.uniform(6, C, lo=0.0, hi=1.0, dtype=dtype),
                rng.normal(C, 5 * D, scale=0.1, dtype=dtype),
                rng.normal(5, D, C, scale=0.1, dtype=dtype))
        # dxln is unused on the model's path: a missing cotangent
        return args, [rng.normal(b, t, C, dtype=dtype) for _ in range(5)] + [None]

    names = ("dx", "dshift", "dln_scale", "dln_bias", "dmaa", "dw1", "dw2")
    print(f"  B.5 bodies: bf16 {b5_body(BF16, C, D)}, fp32 {b5_body(torch.float32, C, D)}; "
          f"the tensor-core body takes {', '.join(B5_LIMBS)} in two bf16 limbs")
    check(b5_body(BF16, C, D) == "tensor_cores" and b5_body(torch.float32, C, D) == "cuda_cores",
          "B.5 does not run the body its dtype should")
    main_err = 0.0
    # bf16 runs both bodies on the same inputs; tiles of the tensor-core body
    # straddle sequences at T = 37 and T = 1
    for b, t in ((TB, T), (3, 37), (B, 1)):
        for dtype in (torch.float32, BF16):
            args, cts = prologue_case(b, t, dtype)
            want = tmix_prologue_bwd_plain(*f32(*args), [None if c is None else c.float() for c in cts])
            for body in ((b5_body(dtype, C, D),) if dtype == torch.float32 else tuple(B5_BODIES)):
                got = tmix_prologue_bwd(*args, cts, body=body)
                tag = f"B.5 {body} (B,T,C,D)=({b},{t},{C},{D}) {str(dtype)[6:]}"
                check(bit_equal(got, tmix_prologue_bwd(*args, cts, body=body)), f"{tag}: two calls differ")
                dx_only = tmix_prologue_bwd(*args, cts, weights=False, body=body)
                check(bit_equal(dx_only[:2], got[:2]) and dx_only[2:] == (None,) * 5,
                      f"{tag}: the form without weight gradients differs in dx/dshift")
                errs = [err_line(f"{tag} {n}", g, w, BWD_REL[dtype]) for n, g, w in zip(names, got, want)]
                if (b, t, dtype, body) == (TB, T, BF16, "tensor_cores"):
                    main_err = max(errs)
                    # the tensor-core body against its walk in plain PyTorch
                    # (the same operand rounding and tiles): what is left is
                    # the order of fp32 sums and dx's rounding to bf16
                    mirror = tmix_prologue_bwd_tiled_plain(*args, cts)
                    for i, (n, g, w) in enumerate(zip(names, got, mirror)):
                        err_line(f"{tag} {n} vs its tiled mirror", g, w, B5_MIRROR_REL[i > 0])
    args, cts = prologue_case(TB, T, BF16)
    # both bodies in turns, twice, both forms
    times = {}
    for rnd in range(2):
        for body in B5_BODIES:
            times[rnd, body] = (device_ms(lambda: tmix_prologue_bwd(*args, cts, weights=False, body=body), 5),
                                device_ms(lambda: tmix_prologue_bwd(*args, cts, body=body), 5))
            print(f"  B.5 at B={TB}, T={T}, bf16, {body} (round {rnd + 1}): dx and dshift only (LoRA) "
                  f"{times[rnd, body][0]:.4f} ms, with the weight gradients {times[rnd, body][1]:.4f} ms")
    # the entry times the form with the weight gradients, against its bound,
    # as before the tensor-core body; the LoRA step's dx-only form stands
    # beside it in dx_only_ms and dx_only_bound_ms. That form reads the
    # forward's inputs and five cotangents and writes dx and dshift; the
    # forward's two products again and the two adjoint products, ~60 fp32 an
    # element of elementwise adjoints
    dx_only_bound = roofline(nbytes(*args, *cts) + nbytes(args[0]) + 4 * TB * C,
                             {"bf16 mma": 4 * 2 * TB * T * C * 5 * D, "fp32": 60 * TB * T * C})
    out["tmix_prologue_bwd"] = dict(
        max_abs_err=main_err,
        ms=times[1, "tensor_cores"][1],
        plain_ms=device_ms(lambda: tmix_prologue_bwd_plain(*args, cts), 3),
        # reads the forward's inputs and five cotangents, writes a gradient
        # for every input; the forward's two products again and two adjoint
        # products for each, and ~60 fp32 an element of elementwise adjoints
        **roofline(2 * nbytes(*args) + nbytes(*cts),
                   {"bf16 mma": 3 * 2 * 2 * TB * T * C * 5 * D, "fp32": 60 * TB * T * C}),
        dx_only_ms=times[1, "tensor_cores"][0],
        dx_only_bound_ms=dx_only_bound["bound_ms"],
    )
    o = out["tmix_prologue_bwd"]
    print(f"  B.5 with the weight gradients: tensor cores {o['ms']:.4f} ms, CUDA cores "
          f"{times[1, 'cuda_cores'][1]:.4f} ms; bound {o['bound_ms']:.4f} ms by {o['bound_by']}: "
          f"{100 * o['bound_ms'] / o['ms']:.1f} %; plain (autograd) {o['plain_ms']:.4f} ms")
    print(f"  B.5 dx-only (LoRA): tensor cores {o['dx_only_ms']:.4f} ms, CUDA cores "
          f"{times[1, 'cuda_cores'][0]:.4f} ms; bound {o['dx_only_bound_ms']:.4f} ms by "
          f"{dx_only_bound['bound_by']}: {100 * o['dx_only_bound_ms'] / o['dx_only_ms']:.1f} %; "
          f"forward K2 {device_ms(lambda: tmix_prologue(*args), 5):.4f} ms")

    def wkv_case(b, t, h, n, dtype, lo=-8.0, hi=3.0):
        r, k, v, g = (rng.normal(b, t, h, n, dtype=dtype) for _ in range(4))
        w = rng.uniform(b, t, h, n, lo=lo, hi=hi, dtype=torch.float32)   # decays 1 .. e^-20
        return (r, k, v, w, rng.normal(h, n, scale=0.5, dtype=dtype), g,
                rng.normal(h * n, scale=0.1, dtype=dtype) + 1, rng.normal(h * n, scale=0.1, dtype=dtype),
                rng.normal(b, h, n, n, scale=0.1, dtype=torch.float32),
                rng.normal(b, t, h * n, dtype=dtype), rng.normal(b, h, n, n, scale=0.1, dtype=torch.float32))

    names = ("dr", "dk", "dv", "dw", "du", "ds0", "dg", "dln_scale", "dln_bias")
    print(f"  WKV backward bodies: bf16 {wkv_bwd_body(BF16, N)} (N={N}), "
          f"fp32 {wkv_bwd_body(torch.float32, N)}")
    check(wkv_bwd_body(BF16, N) == "chunked" and wkv_bwd_body(torch.float32, N) == "sequential",
          "the WKV backward does not run the body its dtype should")
    main_errs = {}
    for shape in ((TB, T, H, N), (3, 37, 4, 32), (1, 1, H, N)):
        for dtype in (torch.float32, BF16):
            args = wkv_case(*shape, dtype)
            got = wkv6_fused_output_bwd(*args, eps=LN_X_EPS)
            check(bit_equal(got, wkv6_fused_output_bwd(*args, eps=LN_X_EPS)),
                  f"B.6 + B.7 {shape} {dtype}: two calls differ")
            want = wkv6_fused_output_bwd_plain(*f32(*args), eps=LN_X_EPS)
            errs = {n: err_line(f"B.6+B.7 (B,T,H,N)={shape} {str(dtype)[6:]} {n}", g, w,
                                wkv_bwd_rel(dtype, g))
                    for n, g, w in zip(names, got, want)}
            if shape == (TB, T, H, N) and dtype == BF16:
                main_errs = errs

    # both bodies in turns on the same bf16 inputs, both forms, at wide,
    # strong and no decay, over whole, ragged and single-step chunks; the
    # unfused form forwards, in reverse and over ragged prefixes
    worst = {b_: {} for b_ in WKV_BWD_BODIES}
    n_cases = 0
    for lo, hi in ((-8.0, 3.0), (2.5, 3.2), (-8.0, -8.0)):
        for t in (1, 15, 16, 17, 37, T):
            args = wkv_case(3, t, 4, N, BF16, lo, hi)
            r, k, v, w, u, g, lsc, lbi, s0, dout, dsT = args
            dy = rng.normal(3, t, 4, N, dtype=torch.float32)
            lengths = torch.tensor([0, min(1, t), max(t - 2, 1)], dtype=torch.int32, device=DEV)
            calls = [("fused", names, lambda body: wkv6_fused_output_bwd(*args, eps=LN_X_EPS, body=body),
                      lambda: wkv6_fused_output_bwd_plain(*f32(*args), eps=LN_X_EPS))]
            for uu, ss, reverse, ln in ((u, s0, False, None), (None, s0, True, lengths),
                                        (u, None, False, lengths)):
                a = (r, k, v, w, uu, ss, dy, dsT)
                kw = dict(reverse=reverse, lengths=ln)
                calls.append((f"gn=False reverse={reverse} ragged={ln is not None}", names[:6],
                              lambda body, a=a, kw=kw: wkv_bwd(*a, body=body, **kw),
                              lambda a=a, kw=kw: wkv_bwd_plain(
                                  *(None if x is None else x.float() for x in a), **kw)))
            for form, nm, kernel, plain in calls:
                want = plain()
                # at T=1 a gradient may be zero analytically: the limit is then
                # that of the largest of dr, dk, dv of the same call
                top = max(w_.abs().max().item() for w_ in want[:3])
                for body in WKV_BWD_BODIES:
                    got = kernel(body)
                    check(bit_equal(got, kernel(body)), f"{body} WKV backward {form} T={t}: two calls differ")
                    for n, g_, w_ in zip(nm, got, want):
                        if w_ is not None:
                            rel_err(f"{body} {form} T={t} w in [{lo}, {hi}] {n}", g_, w_,
                                    wkv_bwd_rel(BF16, g_), top if t == 1 else None, worst[body])
                    n_cases += 1
    for body in WKV_BWD_BODIES:
        print(f"  WKV backward, {body} body, bf16: {n_cases // 2} calls (fused and gn=False forms, "
              f"w in [-8, 3], [2.5, 3.2] and -8, T in 1, 15, 16, 17, 37, {T}), every gradient within "
              f"{WKV_BWD_REL[BF16]:g} x max|plain| (the fp32 ones {WKV_BWD_REL_FP32_OUT:g}) and two calls "
              f"bit-equal: worst at "
              f"{worst[body]['share']:.3f} of the limit ({worst[body]['name']})")
    # each body's error per gradient at the training shape where the
    # sequential identity for dw cancels (w in [2.5, 3.2])
    args = wkv_case(TB, T, H, N, BF16, 2.5, 3.2)
    want = wkv6_fused_output_bwd_plain(*f32(*args), eps=LN_X_EPS)
    for body in WKV_BWD_BODIES:
        got = wkv6_fused_output_bwd(*args, eps=LN_X_EPS, body=body)
        shares = []
        for n, g_, w_ in zip(names, got, want):
            e = rel_err(f"{body} B={TB} T={T} w in [2.5, 3.2] {n}", g_, w_, wkv_bwd_rel(BF16, g_))
            shares.append(f"{n} {e / w_.abs().max().item():.2e}")
        print(f"  WKV backward, {body} body, B={TB}, T={T}, H={H}, N={N}, bf16, w in [2.5, 3.2]: "
              f"max|kernel - plain| / max|plain|: {', '.join(shares)}")
    del args, want, got

    # the LoRA path's call (no initial state, the final state unused) and the
    # encoder's (gn=False, u, zero state in): both bodies in turns, twice
    args = wkv_case(TB, T, H, N, BF16)
    args = args[:8] + (None, args[9], None)
    r, k, v, w, u, g, lsc, lbi, _, dout, _ = args
    dy = rng.normal(TB, T, H, N, dtype=torch.float32)
    groups = {"B.6": ("wkv6_bwd_forward",), "B.7": ("wkv6_bwd_reverse",)}
    groups_nogn = {"B.6 gn=False": ("wkv6_bwd_state",), "B.7": ("wkv6_bwd_reverse",)}
    times = {}
    for rnd in range(2):
        for body in WKV_BWD_BODIES:
            fused = device_ms_by_kernel(lambda: wkv6_fused_output_bwd(*args, eps=LN_X_EPS, body=body), 5,
                                        groups)
            nogn = device_ms_by_kernel(lambda: wkv_bwd(r, k, v, w, u, None, dy, None, body=body), 5,
                                       groups_nogn)
            times[rnd, body] = dict(fused, **{"B.6 gn=False": nogn["B.6 gn=False"],
                                              "B.7 (gn=False)": nogn["B.7"]})
            print(f"  WKV backward at B={TB}, T={T}, H={H}, N={N}, bf16, {body} body (round {rnd + 1}): "
                  + ", ".join(f"{n} {ms:.4f} ms" for n, ms in times[rnd, body].items()))
    plain = device_ms(lambda: wkv6_fused_output_bwd_plain(*args, eps=LN_X_EPS), 2)
    k1 = device_ms(lambda: wkv6_fused_output(*args[:8], eps=LN_X_EPS), 5)
    chunked = times[1, "chunked"]
    print(f"  plain (autograd through the sequential reference) {plain:.4f} ms; forward K1 {k1:.4f} ms")
    # Bounds, the same for both bodies: the bytes of the function (each input
    # read once, each gradient written once; what one pass hands the other
    # not counted) against its chunked factoring's products at the bf16
    # tensor-core rate and its CUDA-core work (the scores, the pairs below
    # the diagonal, GroupNorm) in fp32
    chunk = _lib.library().rwkv_wkv6_fused_chunk()
    heads = TB * T * H
    f32_bthn = 4 * r.numel()
    out["wkv6_bwd_forward_pass"] = dict(
        max_abs_err=max(main_errs[n] for n in ("dg", "dln_scale", "dln_bias")),
        ms=chunked["B.6"], plain_ms=plain,
        # reads r, k, v, g, dout, w; writes dy (fp32), dg and the partials;
        # per step: y's three products (4 N^2 + 2 L N) and the scores (L N)
        **roofline(nbytes(r, k, v, w, u, g, lsc, lbi, dout) + f32_bthn + nbytes(g) + 2 * 4 * TB * C,
                   {"bf16 mma": heads * (4 * N * N + 2 * chunk * N), "fp32": heads * (chunk + 30) * N}))
    out["wkv6_bwd_reverse_pass"] = dict(
        max_abs_err=max(main_errs[n] for n in ("dr", "dk", "dv", "dw", "du", "ds0")),
        ms=chunked["B.7"], plain_ms=plain,
        # reads r, k, v, w, dy (fp32); writes dr, dk, dv, dw, du and ds0; per
        # step six products with the state or its adjoint (12 N^2) and two
        # with the scores (4 L N); the scores and the pairs (4 L N) in fp32
        **roofline(nbytes(r, k, v, w, u) + f32_bthn + nbytes(r, k, v) + f32_bthn + 4 * TB * H * N
                   + 4 * TB * H * N * N,
                   {"bf16 mma": heads * (12 * N * N + 4 * chunk * N), "fp32": heads * (4 * chunk + 30) * N}))
    for name, key in (("wkv6_bwd_forward_pass", "B.6"), ("wkv6_bwd_reverse_pass", "B.7")):
        o = out[name]
        print(f"  {key}: chunked {o['ms']:.4f} ms, sequential {times[1, 'sequential'][key]:.4f} ms; bound "
              f"{o['bound_ms']:.4f} ms by {o['bound_by']}: chunked at {100 * o['bound_ms'] / o['ms']:.1f} %, "
              f"sequential at {100 * o['bound_ms'] / times[1, 'sequential'][key]:.1f} %")
    return out


def synthetic_1b6(cfg, seed: int) -> dict:
    """Seeded full-width weights; the projections that init zeroes
    (att.output, ffn.value, ffn.receptance, which would make every block a
    no-op) get small seeded values."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    sd = init_rwkv_params(cfg, generator=gen, device=DEV)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        fan_in = sd[key].shape[1]
        sd[key] = torch.randn(sd[key].shape, generator=gen, device=DEV) * (0.5 / fan_in ** 0.5)
    return sd


def post(url: str, payload) -> tuple:
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def post_sse(url: str, payload) -> list:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200, f"SSE answered {resp.status}")
        body = resp.read()
    return [json.loads(e[len(b"data: "):]) for e in body.split(b"\n\n") if e]


class Served:
    """serve_http in a background thread; stops it on exit."""

    def __init__(self, service):
        self.server = serve_http(service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self) -> str:
        self.thread.start()
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def position_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine of a and b along the last axis, one per position."""
    a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(position_cosines(a, b).min())


def phase_serve(model, cfg, reference) -> dict:
    """Serve the bf16 model's embeddings over HTTP; returns the launch
    counts of the served requests."""
    tok = WorldTokenizer()
    bi = BiEncoder(model, tok)
    long = " ".join(f"token{i} 数据{i % 7}" for i in range(120))
    with Served(ServingService(bi_encoder=bi)) as base:
        reset_launch_counts()
        code, r1 = post(base + "/embed", {"texts": [SHORT, CJK, MIXED]})
        check(code == 200, f"/embed answered {code}")
        code, r2 = post(base + "/similarity", {"texts_a": [SHORT, CJK], "texts_b": [SHORT, MIXED]})
        check(code == 200, f"/similarity answered {code}")
        code, r3 = post(base + "/embed", {"texts": [long, SHORT]})
        check(code == 200, f"/embed (long) answered {code}")
        bad = post(base + "/embed", b"{not json")[0], post(base + "/embed", {"text": SHORT})[0]
        check(bad == (400, 400), f"malformed payloads answered {bad}")
        check(post(base + "/generate", {"prompt": SHORT})[0] == 404,
              "/generate without an engine not 404")
        counts = launch_counts()
        code, stats = post(base + "/stats", {})
        check(code == 200, f"/stats answered {code}")
    forwards = 4   # /embed, /similarity (two), /embed
    print(f"  answers: /embed 200, /similarity 200, /embed(long) 200, malformed 400, "
          f"/generate (no engine) 404; stats {stats['requests']}")
    print(f"  launches in {forwards} forwards: {counts}")
    check(counts == {k: n * forwards for k, n in PER_FORWARD.items()},
          f"launch counts {counts} != {PER_FORWARD} x {forwards}")

    served = [np.asarray(r1["embeddings"]), np.asarray(r3["embeddings"])]
    for e in served:
        check(np.isfinite(e).all() and e.shape[1] == cfg.n_embd, "embeddings not finite / wrong width")
        norms = np.linalg.norm(e, axis=1)
        check(np.all(np.abs(norms - 1) < 1e-3), f"embeddings not unit-norm: {norms}")
    sim = np.asarray(r2["similarity"])
    print(f"  same-text similarity {sim[0, 0]:.6f} (limit 0.999)")
    check(sim.shape == (2, 2) and sim[0, 0] >= 0.999, f"same-text similarity {sim[0, 0]}")

    worst = 1.0
    with torch.inference_mode():
        for texts, e in (([SHORT, CJK, MIXED], served[0]), ([long, SHORT], served[1])):
            for arr in bi.token_batches(texts):
                ref = embed_sequences(reference, torch.from_numpy(arr).to(DEV),
                                      normalize=True, reference=True).cpu().numpy()
                worst = min(worst, float(np.min(np.sum(ref * e, axis=1))))
    print(f"  served bf16 vs plain fp32 route: min cosine {worst:.6f} (limit 0.999)")
    check(worst >= 0.999, f"embedding cosine {worst} below 0.999")
    return counts


def phase_roundtrip(sd) -> None:
    """A 2-layer full-width model through save_rwkv_checkpoint and
    load_rwkv_checkpoint gives identical hidden states."""
    cfg2 = rwkv6_1b6(n_layer=2)
    sd2 = {k: v for k, v in sd.items()
           if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}
    model2 = load_state_dict_into(RWKV(cfg2, device=DEV), sd2)
    tokens = torch.randint(4, cfg2.vocab_size, (4, 96), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(3))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "rwkv6_2x2048.pth")
        save_rwkv_checkpoint(model2, path)
        size_mb = Path(path).stat().st_size / 2**20
        loaded, cfg_l = load_rwkv_checkpoint(path, device=DEV)
    check(cfg_l == cfg2, f"sniffed {cfg_l} != {cfg2}")
    with torch.inference_mode():
        a, _ = model2(tokens, return_hidden=True, return_logits=False)
        b, _ = loaded(tokens, return_hidden=True, return_logits=False)
    check(torch.equal(a, b), "reloaded checkpoint gives other hidden states")
    print(f"  2-layer full-width checkpoint ({size_mb:.0f} MiB) round trip: config and hidden states identical")


def step_counts(model, quantized: bool) -> None:
    """The launches of exactly one decode step (B=4, in place)."""
    with torch.inference_mode():
        state = model(torch.full((4, 8), 7, device=DEV))[1]
        reset_launch_counts()
        rwkv_decode_step(model, torch.full((4,), 9, device=DEV), state, out=state)
        counts = launch_counts()
    want = dict(PER_STEP, quantize_rows=INT8C_PER_LAYER * model.cfg.n_layer if quantized else 0)
    print(f"  launches in one decode step: {counts}")
    check(counts == want, f"decode-step launch counts {counts} != {want}")


def teacher_forced(model, prompt, tokens, *, reference: bool) -> torch.Tensor:
    """Logits after the prompt and after each of `tokens` but the last,
    one decode step per token: (len(tokens), V) fp32."""
    with torch.inference_mode():
        logits, state = model(prompt[None], reference=reference)
        out = [logits[0, -1].float()]
        for t in tokens[:-1]:
            lg, state = rwkv_decode_step(model, t.view(1), state, out=state, reference=reference)
            out.append(lg[0].float())
    return torch.stack(out)


def phase_generate_bf16(model, reference) -> torch.Tensor:
    """Returns the prompt of its greedy generation."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    vocab = model.cfg.vocab_size
    tokens = torch.randint(4, vocab, (4, 80), device=DEV, generator=gen)
    with torch.inference_mode():
        full, _ = model(tokens)
        logits, state = model(tokens[:, :64])
        steps = [logits[:, -1]]
        for t in range(64, 80):
            lg, state = rwkv_decode_step(model, tokens[:, t], state, out=state)
            steps.append(lg)
    cos = min_cosine(torch.stack(steps[:-1], 1), full[:, 63:79])
    print(f"  prefill 64 + 16 decode steps vs one forward over 80 (B=4): min per-position "
          f"logits cosine {cos:.6f} (limit 0.999)")
    check(cos >= 0.999, f"prefill+decode vs full forward cosine {cos}")
    step_counts(model, quantized=False)

    engine = GenerationEngine(model)
    prompt = torch.randint(4, vocab, (16,), device=DEV, generator=gen)
    out = engine.generate(prompt.tolist(), max_tokens=64, sampling=GREEDY, block_size=16)
    check(len(out) == 64, f"greedy generation gave {len(out)} tokens")
    toks = torch.tensor(out, device=DEV)
    kern = teacher_forced(model, prompt, toks, reference=False)
    plain = teacher_forced(reference, prompt, toks, reference=True)
    check(bool((kern.argmax(-1) == toks).all()), "the engine's greedy tokens are not the "
          "argmax of the same route's teacher-forced logits")
    cos = min_cosine(kern, plain)
    cos_bf16 = min_cosine(kern, teacher_forced(model, prompt, toks, reference=True))
    agree = float((plain.argmax(-1) == toks).float().mean())
    print(f"  greedy 64 tokens (bf16 kernel route) vs plain fp32 route, teacher-forced: "
          f"min per-step logits cosine {cos:.6f} (limit 0.999), greedy agreement {agree:.4f}; "
          f"vs the plain route in bf16: {cos_bf16:.6f}")
    check(cos >= 0.999, f"bf16 kernel route vs plain fp32 route cosine {cos}")
    fid = layer_fidelity(model, prompt, toks[0])
    print(f"  bf16 per-layer fidelity, kernel vs plain ops on the same input: min cosine "
          f"{fid:.7f} (limit 0.999)")
    check(fid >= 0.999, f"bf16 per-layer kernel-vs-plain cosine {fid}")
    return prompt


class CliServer:
    """`python -m rwkv_lm_ext_tpu_torch.serve.cli ...` as a subprocess; the
    base URL comes from its `serving on` line. Stopped on exit."""

    def __init__(self, args, timeout: float = 600.0):
        self.cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.serve.cli", *args]
        self.timeout = timeout

    def __enter__(self) -> str:
        self.proc = subprocess.Popen(self.cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
        lines: "queue.SimpleQueue" = queue.SimpleQueue()

        def pump():
            for line in self.proc.stdout:
                lines.put(line)
            lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"{' '.join(self.cmd)} printed no 'serving on' line "
                                     f"(exit code {self.proc.poll()})")
            if line.startswith("serving on "):
                return line.split()[-1]

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)


def generate_requests(base: str) -> None:
    """The /generate requests of the int8c checks, then /stats."""
    greedy = {"max_tokens": 32, "temperature": 0.0, "token_stop": []}
    a = post(base + "/generate", {"prompt": SHORT, **greedy})
    b = post(base + "/generate", {"prompt": SHORT, **greedy})
    check(a[0] == b[0] == 200 and a[1]["backend"] == "engine", f"/generate answered {a[0]}, {b[0]}")
    check(a[1]["output"] == b[1]["output"], "two greedy /generate answers differ")
    code, sampled = post(base + "/generate", {
        "prompt": SHORT, "max_tokens": 32, "temperature": 0.8, "top_p": 0.7,
        "alpha_presence": 0.3, "alpha_frequency": 0.1, "repetition_penalty": 1.1})
    check(code == 200 and isinstance(sampled["output"], str), f"sampled /generate answered {code}")
    code, cjk = post(base + "/generate", {"prompt": CJK, **greedy})
    check(code == 200, f"CJK /generate answered {code}")
    events = post_sse(base + "/generate", {"prompt": CJK, "stream": True, **greedy})
    pieces = "".join(e["token"] for e in events[:-1])
    check(events[-1].get("done") and events[-1]["output"] == pieces,
          "SSE pieces do not concatenate to the output")
    # the stream fetches every step, the blocking answer every 16: same tokens
    check(pieces == cjk["output"], "SSE (block 1) and blocking (block 16) greedy outputs differ")
    code, err = post(base + "/generate", {"prompt": SHORT, "beam_width": 4})
    check(code == 400, f"unknown option answered {code}")
    code, stats = post(base + "/stats", {})
    check(code == 200 and stats["requests"]["/generate"] == 6, f"/stats answered {code}: {stats}")
    print(f"  /generate: greedy x2 identical ({len(a[1]['output'])} chars), sampled 200, CJK 200, "
          f"SSE {len(events) - 1} pieces == blocking output, unknown option 400 ({err['error']})")
    print(f"  /stats: {stats['requests']}, latency {stats['generate_latency_ms']}")


def phase_int8c_cli(path: str) -> tuple:
    """Serve the saved model with --quant int8c through the CLI: as a
    subprocess, then built by the same CLI code in this process (where the
    launch counts can be reset). Returns (int8c model, launch counts of the
    in-process /generate requests)."""
    args = ["--model", path, "--quant", "int8c", "--platform", DEV, "--port", "0"]
    t0 = time.perf_counter()
    with CliServer(args) as base:
        print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli {' '.join(args)}: serving on {base} "
              f"after {time.perf_counter() - t0:.1f} s")
        generate_requests(base)

    service = cli.build_service(cli.parse_args(args))
    model_q = service.engine.model
    check(all(isinstance(blk.ffn.value, QuantLinear) and blk.ffn.value.mode == "int8c"
              for blk in model_q.blocks), "the CLI's model is not int8c")
    with Served(service) as base:
        reset_launch_counts()
        code, out = post(base + "/generate", {"prompt": SHORT, "max_tokens": 32,
                                              "temperature": 0.0, "token_stop": []})
        events = post_sse(base + "/generate", {"prompt": SHORT, "max_tokens": 32, "stream": True,
                                               "temperature": 0.0, "token_stop": []})
        counts = launch_counts()
    check(code == 200 and events[-1]["output"] == out["output"], "in-process int8c /generate")
    print(f"  in-process CLI build, /generate blocking + SSE: launches {counts}")
    check(all(n > 0 for k, n in counts.items()
              if k not in NO_BACKWARD and k not in NO_FUSED and k != "wkv"),
          f"a kernel did not run in /generate: {counts}")
    return model_q, counts


def layer_fidelity(model, prompt: torch.Tensor, token: torch.Tensor) -> float:
    """Each block on the kernel route's own input and state, kernel ops
    against plain ops: the least cosine over the layers' outputs, for a
    prefill of `prompt` and one decode step of `token`. Nothing compounds
    across layers, so this is the kernels' fidelity on the path."""
    worst = 1.0
    with torch.inference_mode():
        x = torch.nn.functional.embedding(prompt[None], model.emb.weight)
        state = init_model_state(model.cfg, 1, device=DEV)
        for i, block in enumerate(model.blocks):
            ls = (state["att_shift"][i], state["wkv"][i], state["ffn_shift"][i])
            plain, _ = block(x, ls, PLAIN_OPS)
            x, (state["att_shift"][i], state["wkv"][i], state["ffn_shift"][i]) = block(x, ls, KERNEL_OPS)
            worst = min(worst, min_cosine(x, plain))
        x = torch.nn.functional.embedding(token.view(1, 1), model.emb.weight)
        for i, block in enumerate(model.blocks):
            plain = block.step(x, state, {k: v.clone() for k, v in state.items()}, i, PLAIN_OPS)
            x = block.step(x, state, {k: v.clone() for k, v in state.items()}, i, KERNEL_OPS)
            worst = min(worst, min_cosine(x, plain))
    return worst


def phase_int8c_checks(model_q, reference, weights) -> torch.Tensor:
    """The int8c kernel route against the int8c plain route; quantizes
    `reference` (int8c, fp32) and returns the prompt of its generation. Per layer
    (same inputs) the limit is 0.999. End to end, per-token int8
    quantization turns a one-ulp difference of a bf16 activation into a
    whole quantization step, so two int8c routes that round activations
    differently diverge by about the quantization's own drift: the kernel
    route is held to disagree with the int8c plain route (in bf16) by less
    than the int8c plain route (fp32) departs from the unquantized one."""
    step_counts(model_q, quantized=True)
    gen = torch.Generator(device=DEV).manual_seed(6)
    prompt = torch.randint(4, model_q.cfg.vocab_size, (16,), device=DEV, generator=gen)
    out = GenerationEngine(model_q).generate(prompt.tolist(), max_tokens=64, sampling=GREEDY,
                                             block_size=16)
    toks = torch.tensor(out, device=DEV)
    fid = layer_fidelity(model_q, prompt, toks[0])
    print(f"  int8c per-layer fidelity, kernel vs plain ops on the same input (prefill of 16 and "
          f"a decode step, {len(model_q.blocks)} layers): min cosine {fid:.7f} (limit 0.999)")
    check(fid >= 0.999, f"int8c per-layer kernel-vs-plain cosine {fid}")
    unquantized = teacher_forced(reference, prompt, toks, reference=True)
    quantize_model(reference, "int8c", weights=weights)
    kern = teacher_forced(model_q, prompt, toks, reference=False)
    plain = teacher_forced(reference, prompt, toks, reference=True)
    plain_bf16 = teacher_forced(model_q, prompt, toks, reference=True)
    cos_bf16, cos = min_cosine(kern, plain_bf16), min_cosine(kern, plain)
    floor = min_cosine(plain, unquantized)
    agree = float((plain.argmax(-1) == toks).float().mean())
    print(f"  int8c, 64 greedy tokens teacher-forced, min per-step logits cosine: kernel route vs "
          f"int8c plain route in bf16 {cos_bf16:.6f}, in fp32 {cos:.6f}; int8c plain (fp32) vs "
          f"unquantized plain (fp32) {floor:.6f}; greedy agreement with the fp32 plain route {agree:.4f}")
    check(1 - cos_bf16 <= 1 - floor,
          f"int8c kernel route departs from its plain route ({cos_bf16}) by more than int8c "
          f"departs from unquantized ({floor})")
    return prompt


def phase_int8c_embeddings(model_q, reference, unquantized) -> None:
    """int8c embeddings against the int8c plain route in the working dtype
    (held at 0.999), in fp32 and against the unquantized fp32 route
    (printed)."""
    tok = WorldTokenizer()
    bi = BiEncoder(model_q, tok)
    texts = [SHORT, CJK, MIXED]
    reset_launch_counts()
    served = bi.encode_texts(texts)
    counts = launch_counts()
    want = dict(PER_FORWARD, quantize_rows=INT8C_PER_LAYER * model_q.cfg.n_layer)
    print(f"  int8c embeddings, launches in one forward: {counts}")
    check(counts == want, f"int8c forward launch counts {counts} != {want}")
    arr = torch.from_numpy(next(bi.token_batches(texts))).to(DEV)
    with torch.inference_mode():
        plain_bf16, plain = (embed_sequences(m, arr, normalize=True, reference=True).cpu().numpy()
                             for m in (model_q, reference))
    cos_bf16, cos, drift = (float(np.min(np.sum(e * served, axis=1)))
                            for e in (plain_bf16, plain, unquantized))
    print(f"  int8c embeddings vs the int8c plain route in bf16: min cosine {cos_bf16:.6f} (limit "
          f"0.999); printed, not held: in fp32 {cos:.6f}, vs the unquantized fp32 route {drift:.6f}")
    check(cos_bf16 >= 0.999, f"int8c embedding cosine {cos_bf16} below 0.999")


def phase_throughput(model, cfg, label: str, smi: str) -> None:
    gen = torch.Generator(device=DEV).manual_seed(4)
    lo, hi, n_feed = 4, cfg.vocab_size - 4, min(T, cfg.n_embd)
    tokens = torch.randint(lo, hi, (B, T), device=DEV, generator=gen)

    def step(tokens):
        tokens = tokens.clone()
        tokens[:, -1] = EMB_ID
        emb = embed_sequences(model, tokens)
        # data chain: the next batch's tokens depend on these embeddings
        delta = (emb[:, :n_feed] * 100.0).abs().to(torch.int64) % 17
        tokens[:, :n_feed] += delta
        return lo + (tokens - lo) % (hi - lo), emb

    iters = 5
    with torch.inference_mode():
        tokens, emb = step(tokens)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        checksum = torch.zeros((), device=DEV)
        for _ in range(iters):
            last_in = tokens
            tokens, emb = step(tokens)
            checksum += emb.float().sum()
        end.record()
        torch.cuda.synchronize()
    check(bool(torch.isfinite(checksum)), "non-finite embeddings in the throughput chain")
    seconds = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  reading: {B * iters / seconds:.2f} seq/s embedded (B={B}, T={T}, {label}, "
          f"{seconds / iters * 1e3:.1f} ms/batch, peak {peak:.1f} GiB) on {smi}")
    changed = last_in.clone()
    changed[:, 0] = lo + (changed[:, 0] + 1 - lo) % (hi - lo)
    chain_canary(lambda t: step(t)[1], last_in, emb, changed, f"embedding chain, {label}")
    with torch.inference_mode():
        step_profile(step, last_in, seconds / iters * 1e3, STEP_GROUPS,
                     f"one embedding forward with its chain, {label}")


def phase_decode_readings(model, label: str, smi: str) -> None:
    """Decode tok/s: generate_batch at B=64 (16-token prompts, 128 new
    tokens, default sampling without stops) and single-stream generate
    (B=1, 128 tokens, block_size=16). Host clock around synchronised work."""
    engine = GenerationEngine(model)
    sp = SamplingParams(token_stop=())
    gen = torch.Generator(device=DEV).manual_seed(7)
    prompts = torch.randint(4, model.cfg.vocab_size, (B, 16), device=DEV, generator=gen).tolist()
    engine.generate_batch(prompts, max_tokens=2, sampling=sp)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = engine.generate_batch(prompts, max_tokens=128, sampling=sp, seed=1)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    check(all(len(r) == 128 for r in rows), "generate_batch did not give 128 tokens a row")
    engine.generate(prompts[0], max_tokens=4, sampling=sp, block_size=16)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = engine.generate(prompts[0], max_tokens=128, sampling=sp, block_size=16, seed=1)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    check(len(one) == 128, "generate did not give 128 tokens")
    print(f"  reading: decode {B * 128 / batch_s:.1f} tok/s with generate_batch (B={B}, 16-token "
          f"prompts, 128 new tokens, {label}, {batch_s:.2f} s) on {smi}")
    print(f"  reading: single stream {128 / single_s:.1f} tok/s with generate (B=1, 128 tokens, "
          f"block_size=16, {label}, {single_s:.2f} s) on {smi}")


def greedy_tokens(model, prompt: torch.Tensor, n: int, fused_prep: bool):
    """n greedy tokens after `prompt` (B=1) by rwkv_decode_step alone, and the
    logits each was picked from: (n,) tokens, (n, V) fp32 logits."""
    with torch.inference_mode():
        logits, state = model(prompt[None])
        rows, toks = [logits[0, -1].float()], []
        for _ in range(n):
            toks.append(rows[-1].argmax())
            if len(toks) < n:
                lg, state = rwkv_decode_step(model, toks[-1].view(1), state, out=state,
                                             fused_prep=fused_prep)
                rows.append(lg[0].float())
    return torch.stack(toks), torch.stack(rows)


FUSED_STEPS = 16
# least cosine of a (layer, stream) state row between the fused and the
# unfused route after FUSED_STEPS steps: unquantized, int8c
STATE_COS = {False: 0.999, True: 0.98}


def phase_fused_decode(model, plain_model, prompt: torch.Tensor, label: str, seed: int) -> dict:
    """rwkv_decode_step(fused_prep=True, out=state) on a 24-layer model:
    FUSED_STEPS teacher-forced steps at B=64 from a prefilled state, against
    the unfused kernel route and against the fp32 plain route (`plain_model`:
    the same weights in fp32, quantized the same way); the launches of one
    step; then greedy tokens at B=1 from `prompt`, fused against unfused.
    Returns the launch counts of the teacher-forced run.

    The limits. bf16: every step's logits hold cosine >= 0.999 to the fp32
    plain route, as the unfused route does. int8c: two routes that round an
    activation differently fall a whole quantization step apart (see
    phase_int8c_checks), so the fused route is held to lie no farther from
    the plain route than the unfused route does, within 2e-3. The state
    after the steps is held by the cosine of each (layer, stream) row to the
    unfused route's (STATE_COS): the fused route carries unrounded shift rows
    and an unrounded xw where the unfused one rounds both to bf16, 16 steps
    through 24 layers compound that, and under int8c each such rounding can
    move an activation by a whole quantization step, so a largest absolute
    difference says little."""
    quantized = isinstance(model.blocks[0].ffn.key, QuantLinear)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    vocab = model.cfg.vocab_size
    tokens = torch.randint(4, vocab, (B, 16 + FUSED_STEPS), device=DEV, generator=gen)
    with torch.inference_mode():
        _, state = model(tokens[:, :16])
        _, plain_state = plain_model(tokens[:, :16], reference=True)
        fused_state = {k: v.clone() for k, v in state.items()}
        rows = {"fused": [], "unfused": [], "plain": []}
        reset_launch_counts()
        for t in range(16, 16 + FUSED_STEPS):
            lg, fused_state = rwkv_decode_step(model, tokens[:, t], fused_state, out=fused_state,
                                               fused_prep=True)
            rows["fused"].append(lg.float())
        counts = launch_counts()
        for t in range(16, 16 + FUSED_STEPS):
            lg, state = rwkv_decode_step(model, tokens[:, t], state, out=state)
            rows["unfused"].append(lg.float())
            lg, plain_state = rwkv_decode_step(plain_model, tokens[:, t], plain_state,
                                               out=plain_state, reference=True)
            rows["plain"].append(lg.float())
    want = PER_FUSED_STEP_QUANT if quantized else PER_FUSED_STEP
    want = dict(want, quantize_rows=INT8C_PER_LAYER * model.cfg.n_layer if quantized else 0)
    print(f"  {label}: launches in {FUSED_STEPS} fused decode steps at B={B}: {counts}")
    check(counts == {k: n * FUSED_STEPS for k, n in want.items()},
          f"fused decode-step launch counts {counts} != {want} x {FUSED_STEPS}")
    fused, unfused, plain = (torch.stack(rows[k], 1) for k in ("fused", "unfused", "plain"))
    check(bool(torch.isfinite(fused).all()) and fused.shape == (B, FUSED_STEPS, vocab),
          "fused decode logits: shape or values")
    cos_f, cos_u, cos_fu = min_cosine(fused, plain), min_cosine(unfused, plain), min_cosine(fused, unfused)
    print(f"  {label}: {FUSED_STEPS} teacher-forced steps at B={B}, min per-step logits cosine: fused "
          f"route vs fp32 plain route {cos_f:.6f}, unfused route vs fp32 plain route {cos_u:.6f}, "
          f"fused vs unfused {cos_fu:.6f}")
    if quantized:
        check(cos_f >= cos_u - 2e-3, f"{label}: the fused route ({cos_f}) lies farther from the plain "
              f"route than the unfused route ({cos_u}) by more than 2e-3")
    else:
        check(cos_f >= 0.999, f"{label}: fused route vs fp32 plain route cosine {cos_f}")
    for key in state:
        rows_f, rows_u = (t[key].flatten(0, 1).flatten(1) for t in (fused_state, state))
        cos = min_cosine(rows_f, rows_u)
        err = (rows_f - rows_u).abs().max().item()
        print(f"  {label}: state[{key}] after {FUSED_STEPS} steps, fused vs unfused: min cosine over "
              f"the {rows_f.shape[0]} (layer, stream) rows {cos:.6f} (limit {STATE_COS[quantized]}), "
              f"max |diff| {err:.3e} of max {rows_u.abs().max().item():.3e}")
        check(cos >= STATE_COS[quantized], f"{label}: fused state[{key}] cosine {cos}")

    n = 64
    toks_f, logits_f = greedy_tokens(model, prompt, n, True)
    toks_u, logits_u = greedy_tokens(model, prompt, n, False)
    differ = (toks_f != toks_u).nonzero()
    if differ.numel() == 0:
        print(f"  {label}: {n} greedy tokens at B=1, fused route == unfused route")
    else:
        # up to the first divergence both routes saw the same tokens: the
        # step is explained when the unfused route's margin between the two
        # candidates is within the two routes' logit difference there
        i = int(differ[0])
        margin = float(logits_u[i, toks_u[i]] - logits_u[i, toks_f[i]])
        gap = float((logits_f[i] - logits_u[i]).abs().max())
        print(f"  {label}: greedy tokens at B=1 agree for {i} of {n}; at step {i} the unfused route "
              f"prefers its token by {margin:.4f}, the two routes' logits differ by up to {gap:.4f}")
        check(margin <= 2 * gap, f"{label}: greedy divergence at step {i} with margin {margin} "
              f"beyond twice the routes' logit difference {gap}")
    return counts


def spliced_step(model, tokens, state, variant: str):
    """A decode step with one side fused and the other not, in place:
    `step_attprep` runs B.10 and the unfused channel mix, `step_ffnblk` K2
    and B.12: the hand-spliced variants of scripts/ablate_decode_fused.py."""
    ops = KERNEL_OPS
    x = model.embed(tokens[:, None])
    for i, blk in enumerate(model.blocks):
        if blk.ln0 is not None:
            x = ops.layer_norm(x, blk.ln0.weight, blk.ln0.bias)
        shift, wkv_s = state["att_shift"][i], state["wkv"][i]
        if variant == "step_attprep":
            att_out, att_shift = blk.att.step_fused(x[:, 0], blk.ln1, shift, wkv_s, wkv_s, ops)
            x = x + att_out[:, None]
            ffn_out, ffn_shift = blk.ffn(ops.layer_norm(x, blk.ln2.weight, blk.ln2.bias),
                                         state["ffn_shift"][i], ops)
            x = x + ffn_out
        else:
            att_out, att_shift = blk.att.step(x, blk.ln1, shift, wkv_s, wkv_s, ops)
            x, ffn_shift = blk.ffn.step_fused((x + att_out)[:, 0], blk.ln2, state["ffn_shift"][i], ops)
            x = x[:, None]
        state["att_shift"][i].copy_(att_shift)
        state["ffn_shift"][i].copy_(ffn_shift)
    x = ops.layer_norm(x, model.ln_out.weight, model.ln_out.bias)
    return model.head(x, ops)[:, 0], state


ABLATION = ("step", "step_fused", "step_attprep", "step_ffnblk")
# B.10's cluster body (which bf16 runs) and its row-pair body; B.12's
# products and gated residual are dependent launches, so their durations
# hold the time they wait for the launch before them
FUSED_GROUPS = {
    "B.10": ("att_prep_cluster_kernel", "att_prep_kernel"), "B.11": ("ffn_prep_kernel",),
    "B.12 products": ("ffn_stream_kernel",), "B.12 gated residual": ("ffn_out_kernel",),
    "B.9": ("wkv6_decode_kernel",), "K2": ("tmix_prologue_tc_kernel", "tmix_prologue_simt_kernel"),
    "K3": ("layer_norm_kernel",), "B.4": ("quant_rows_",),
    "GEMMs": ("gemm", "nvjet", "xmma", "cutlass", "gemv"),
}


def phase_decode_ablation(model, label: str, smi: str, variants=ABLATION) -> None:
    """Readings, not checks: ms a step and aggregate tok/s of the decode step
    alone, greedy without sampling, at B=64 and B=1. Each variant runs 32
    steps in place over a data chain (the next token is the argmax of the last
    logits) between CUDA events, after 4 warm-up steps, in turns and twice;
    then one step under the profiler for its device operations, busy time
    and split."""
    def step_logits(variant, tok, state):
        if variant in ("step", "step_fused"):
            return rwkv_decode_step(model, tok, state, out=state, fused_prep=variant == "step_fused")
        return spliced_step(model, tok, state, variant)

    def one(variant, tok, state):
        lg, state = step_logits(variant, tok, state)
        return lg.argmax(-1), state

    iters = 32

    def timed(variant, b):
        """ms a step over the chain, the state before its last step copied
        outside the timed spans; then the chain's canary on the last step's
        logits."""
        state = init_model_state(model.cfg, b, device=DEV)
        tok = torch.full((b,), 5, device=DEV)
        for _ in range(4):
            tok, state = one(variant, tok, state)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        for _ in range(iters - 1):
            tok, state = one(variant, tok, state)
        ev[1].record()
        last_tok, last_state = tok, {n: x.clone() for n, x in state.items()}
        ev[2].record()
        lg, state = step_logits(variant, tok, state)
        tok = lg.argmax(-1)
        ev[3].record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(state["wkv"]).all()), f"{variant}: non-finite state")
        chain_canary(lambda x: step_logits(variant, x, {n: y.clone() for n, y in last_state.items()})[0],
                     last_tok, lg, (last_tok + 1) % model.cfg.vocab_size, f"decode {variant} B={b}")
        del last_state
        return (ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3])) / iters, tok, state

    for b in (B, 1):
        with torch.inference_mode():
            # every variant in turns, twice: the host's clock decides these
            # times and the two rounds show its spread
            rounds = [{v: timed(v, b) for v in variants} for _ in range(2)]
            for variant in variants:
                ms, tok, state = rounds[1][variant]
                ops = device_ops(lambda: one(variant, tok, state), 1)
                busy = busy_us(ops) / 1e3
                shown = ", ".join(f"{g} {v:.3f}" for g, v in split_by_group(ops, FUSED_GROUPS).items()
                                  if v > 0)
                names = " ".join(e.name for e in ops)
                if variant in ("step_fused", "step_attprep"):
                    check("att_prep_cluster_kernel" in names and "att_prep_kernel<" not in names,
                          f"{variant} B={b} {label}: the profile does not name B.10's cluster body")
                if variant in ("step_fused", "step_ffnblk") and label != "int8c":
                    check("ffn_stream_kernel" in names,
                          f"{variant} B={b} {label}: the profile does not name B.12's stream kernel")
                first = rounds[0][variant][0]
                print(f"  reading: {variant} B={b} {label}: {ms:.3f} ms a step ({first:.3f} in the first "
                      f"round), {b / ms * 1e3:.1f} tok/s aggregate; one step: {len(ops)} device ops, "
                      f"busy {busy:.3f} ms ({100 * busy / ms:.1f} % of the step); ms by group: {shown}; "
                      f"on {smi}")


def phase_transposed_bench(smi: str) -> dict:
    """The op-level comparison that reaches B.13, as
    scripts/bench_decode_transposed.py runs it for the TPU kernel: the inputs
    of that script (w ~ U(-3, -0.3), state 0.1 x normal) at the 1B6 decode
    shape, B=64 and B=1; numerics against the plain step; then a chain of 200
    in-place steps on each layout, the state being the data dependency: time
    an op between CUDA events (which at these sizes is the time to launch one
    from Python) and its device time from the profiler. Returns the launch
    counts of the chains."""
    rng = Inputs(20)
    iters = 200
    reset_launch_counts()
    for b in (B, 1):
        r, k, v, g = (rng.normal(b, C) for _ in range(4))
        w = rng.uniform(b, C, lo=-3.0, hi=-0.3, dtype=torch.float32)
        u = rng.normal(H, N, scale=0.5, dtype=torch.float32)
        sc = rng.normal(C, scale=0.1, dtype=torch.float32) + 1
        bi = rng.normal(C, scale=0.1, dtype=torch.float32)
        s_log = rng.normal(b, H, N, N, scale=0.1, dtype=torch.float32)
        args = (r, k, v, w, g, u, sc, bi)
        po, ps = wkv6_decode_step_plain(*f32(*args), s_log, eps=LN_X_EPS)
        o, s_t = wkv6_decode_step_transposed(*args, transpose_state(s_log), eps=LN_X_EPS)
        err_line(f"op bench B={b}: transposed step out", o, po, 2e-2)
        err_line(f"op bench B={b}: transposed step state", transpose_state(s_t), ps, 1e-5)
        for name, step, s0 in (("logical state (B.9)", wkv6_decode_step, s_log.clone()),
                               ("transposed state (B.13)", wkv6_decode_step_transposed,
                                transpose_state(s_log))):
            def chain(n, state=s0, step=step):
                total = torch.zeros((), device=DEV)
                for _ in range(n):
                    out, _ = step(*args, state, eps=LN_X_EPS, out_state=state)
                    total += out.float().sum()       # keeps the y path alive
                return total
            chain(8)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            total = chain(iters)
            end.record()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(total)) and bool(torch.isfinite(s0).all()),
                  f"op bench {name}: non-finite chain")
            dev_us = device_ms_by_kernel(lambda: chain(20), 1, {"step": ("wkv6_decode",)})["step"] / 20 * 1e3
            print(f"  reading: op bench B={b}, {name}: {start.elapsed_time(end) / iters * 1e3:.1f} us an "
                  f"op between CUDA events over {iters} chained in-place steps (with the sum that "
                  f"keeps y alive), {dev_us:.1f} us of device time a step; on {smi}")
    counts = launch_counts()
    check(counts["wkv6_decode_step_transposed"] > 2 * iters and counts["wkv6_decode_step"] > 2 * iters,
          f"the op bench launched {counts}")
    return counts


LORA = LoraConfig(r=8, alpha=32.0)


def train_batch(gen, vocab: int, b: int = TB, t: int = T) -> dict:
    tokens = torch.randint(4, vocab, (b, t), device=DEV, generator=gen)
    labels = torch.full_like(tokens, -100)
    labels[:, :-1] = tokens[:, 1:]
    return {"input_ids": tokens, "labels": labels}


def loss_grads(model, batch, *, reference: bool, remat: bool = True,
               use_state_params: bool = False) -> dict:
    """Gradients of the causal-LM loss for every parameter that trains; each
    must exist and be non-zero."""
    model.zero_grad(set_to_none=True)
    logits, _ = model(batch["input_ids"], reference=reference, remat=remat,
                      use_state_params=use_state_params, t1_step=False)
    causal_lm_loss(logits, batch["labels"]).backward()
    grads = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            check(p.grad is not None and bool(p.grad.abs().max() > 0),
                  f"{n} got no gradient ({'plain' if reference else 'kernel'} route)")
            grads[n] = p.grad.detach().clone()
    model.zero_grad(set_to_none=True)
    return grads


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def two_layer_sd(path: str) -> dict:
    """Layers 0 and 1 (and the embedding, ln_out and head) of the saved
    full-width model."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return {k: v for k, v in sd.items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}


def phase_train_grads(path: str) -> None:
    """A 2-layer full-width model (C=2048, H=32, F=7168, vocab 65536) at
    B=8, T=512 with remat on: LoRA r=8 (B seeded non-zero: with B = 0 every
    dA is 0) and state tuning, kernel route against plain route."""
    sd2 = two_layer_sd(path)
    gen = torch.Generator(device=DEV).manual_seed(8)

    def model_of(dtype):
        return load_state_dict_into(RWKV(rwkv6_1b6(n_layer=2, dtype=dtype), device=DEV), sd2)

    m32 = model_of("float32")
    adapter = init_lora_params(m32, LORA, gen)
    for ab in adapter.values():
        ab["B"].normal_(0.0, 0.01, generator=gen)
    apply_lora(m32, LORA, adapter)
    batch = train_batch(gen, m32.cfg.vocab_size)
    k32 = loss_grads(m32, batch, reference=False)
    p32 = loss_grads(m32, batch, reference=True)
    check(len(k32) == 2 * 8 * 2, f"{len(k32)} trainable tensors, expected 32")
    worst = max((k32[n] - p32[n]).abs().max().item() / p32[n].abs().max().item() for n in p32)
    print(f"  LoRA fp32, {len(p32)} A/B gradients: max |kernel - plain| / max|plain| = {worst:.3e} "
          f"(limit 1e-3)")
    check(worst <= 1e-3, f"LoRA fp32 gradients off by {worst} of their largest value")
    del m32

    m16 = model_of("bfloat16")
    apply_lora(m16, LORA, adapter)
    k16 = loss_grads(m16, batch, reference=False)
    p16 = loss_grads(m16, batch, reference=True)
    margins = {n: cosine(k16[n], p32[n]) - cosine(p16[n], p32[n]) for n in p32}
    worst = min(margins, key=margins.get)
    print(f"  LoRA bf16 vs the fp32 plain route, per gradient tensor: min cosine kernel route "
          f"{min(cosine(k16[n], p32[n]) for n in p32):.6f}, plain route in bf16 "
          f"{min(cosine(p16[n], p32[n]) for n in p32):.6f}; worst margin {margins[worst]:+.2e} "
          f"({worst}; the kernel route may trail bf16's own by 1e-3)")
    check(margins[worst] >= -1e-3, f"bf16 kernel-route gradient {worst} trails bf16 itself")
    off = loss_grads(m16, batch, reference=False, remat=False)
    check(all(torch.equal(off[n], k16[n]) for n in k16), "remat on and off give other gradients")
    print("  kernel route, bf16: remat on and off give bit-equal gradients")
    del m16

    ms = model_of("float32")
    ms.requires_grad_(False)
    ms.add_state_params()
    with torch.no_grad():
        for blk in ms.blocks:
            blk.att.time_state.normal_(0.0, 0.1, generator=gen)
    ks = loss_grads(ms, batch, reference=False, use_state_params=True)
    ps = loss_grads(ms, batch, reference=True, use_state_params=True)
    worst = max((ks[n] - ps[n]).abs().max().item() / ps[n].abs().max().item() for n in ps)
    print(f"  state tuning fp32, time_state gradients of {len(ps)} layers: max |kernel - plain| / "
          f"max|plain| = {worst:.3e} (limit 1e-3)")
    check(worst <= 1e-3, f"time_state gradients off by {worst} of their largest value")
    del ms
    torch.cuda.empty_cache()


STEP_GROUPS = {
    "K1 forward": ("wkv6_chunked_kernel", "wkv6_sequential_kernel"),
    "K2 forward": ("tmix_prologue_tc_kernel", "tmix_prologue_simt_kernel"),
    "K3 forward": ("layer_norm_kernel",),
    "B.5": ("prologue_bwd_tc", "prologue_bwd_chain", "prologue_bwd_ln", "atb_kernel"),
    "B.6": ("wkv6_bwd_forward_chunked_kernel", "wkv6_bwd_forward_kernel"),
    "B.7": ("wkv6_bwd_reverse_chunked_kernel", "wkv6_bwd_reverse_kernel"),
    "partial sums": ("sum_partials",),
    "GEMMs": ("gemm", "nvjet", "xmma", "cutlass"),
    "optimizer (multi-tensor)": ("multi_tensor_apply",),
}


def split_by_group(ops, groups: dict) -> dict:
    """Device ms of `ops` by kernel group: an operation counts for the first
    group one of whose substrings its name holds (case-insensitive), else
    for "elementwise, reductions, copies"."""
    split = {g: 0.0 for g in groups}
    split["elementwise, reductions, copies"] = 0.0
    for e in ops:
        name = e.name.lower()
        group = next((g for g, keys in groups.items() if any(k.lower() in name for k in keys)),
                     "elementwise, reductions, copies")
        split[group] += e.self_device_time_total / 1e3
    return split


# a bf16 train step runs the chunked bodies of the WKV kernels and the
# tensor-core body of B.5, not the sequential and CUDA-core ones (kernel names,
# as the profiler records them; "wkv6_kernel" is B.8's sequential body)
LORA_STEP_KERNELS = (("wkv6_bwd_forward_chunked_kernel", "wkv6_bwd_reverse_chunked_kernel",
                      "prologue_bwd_tc_kernel"),
                     ("wkv6_bwd_forward_kernel", "wkv6_bwd_reverse_kernel", "prologue_bwd_chain_kernel",
                      "prologue_bwd_ln_kernel"))
MLM_STEP_KERNELS = (("wkv6_bwd_state_chunked_kernel", "wkv6_bwd_reverse_chunked_kernel",
                     "wkv6_raw_chunked_kernel"),
                    ("wkv6_bwd_state_kernel", "wkv6_bwd_reverse_kernel", "wkv6_kernel"))
ENCODER_KERNELS = (("wkv6_raw_chunked_kernel",), ("wkv6_kernel",))


def step_profile(step, batch, step_ms: float, groups: dict = STEP_GROUPS,
                 what: str = "one step (remat on)", kernels=((), ())) -> None:
    """Device time of one train step (or forward) by kernel group
    (torch.profiler, device operations only); idle = the step's CUDA-event
    time less busy. `kernels`: the kernel names the step must run, and those
    it must not."""
    ops = device_ops(lambda: step(batch), 1)
    names = {e.name for e in ops}
    present, absent = kernels
    for k in present:
        check(any(k in n for n in names), f"{what}: no {k} in the profile")
    for k in absent:
        check(not any(k in n for n in names), f"{what}: {k} in the profile")
    if present or absent:
        print(f"  {what} ran {', '.join(present)}" + (f" and no {', '.join(absent)}" if absent else ""))
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    print(f"  profile of {what}: {len(ops)} device ops, busy {busy:.3f} ms of "
          f"{step_ms:.3f} ms, idle {100 * max(step_ms - busy, 0) / step_ms:.2f} %")
    for g, v in split_by_group(ops, groups).items():
        print(f"    {g}: {v:.3f} ms ({100 * v / busy:.1f} %)")


def chained_steps(step, batch, iters: int, trainable: list):
    """`iters` train steps that chain through the optimizer's updates,
    between CUDA events; the trainable parameters are copied before the last
    step, outside the timed spans. Returns (ms a step, the losses, the
    copy)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    losses = [step(batch)["loss"] for _ in range(iters - 1)]
    ev[1].record()
    before_last = [p.detach().clone() for p in trainable]
    ev[2].record()
    losses.append(step(batch)["loss"])
    ev[3].record()
    torch.cuda.synchronize()
    return (ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3])) / iters, torch.stack(losses), before_last


def train_canary(model, loss_fn, trainable: list, before_last: list, batch, other, last_loss,
                 what: str) -> None:
    """chain_canary for a chain of train steps: the last loss must be what
    the parameters before the last step give on the last batch, and must
    move on another batch. The parameters are swapped for their copy and
    back."""
    def swap():
        for p, c in zip(trainable, before_last):
            p.data, c.data = c.data, p.data

    swap()
    try:
        chain_canary(lambda b: loss_fn(model, b), batch, last_loss, other, what)
    finally:
        swap()


def phase_train_readings(path: str, smi: str) -> None:
    """LoRA r=8 train steps of the 24-layer bf16 model at B=8, T=512: the
    launches of one step (remat on and off), then step time and Kt/s over
    steps that chain through the optimizer's updates (CUDA events, after
    warm-up), and a profile of one step with remat on and one with it off."""
    model, cfg = load_rwkv_checkpoint(path, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(9)
    apply_lora(model, LORA, init_lora_params(model, LORA, gen))
    batch = train_batch(gen, cfg.vocab_size)
    iters = 5
    for remat in (True, False):
        step = make_train_step(model, TrainConfig(lr_init=1e-4, warmup_steps=0, total_steps=100,
                                                  grad_checkpoint=remat))
        reset_launch_counts()
        step(batch)
        torch.cuda.synchronize()
        counts, want = launch_counts(), train_step_counts(cfg.n_layer, remat)
        print(f"  launches in one LoRA train step, remat {'on' if remat else 'off'}: {counts}")
        check(counts == want, f"train-step launch counts {counts} != {want}")
        step(batch)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainable = [p for p in model.parameters() if p.requires_grad]
        ms, losses, before_last = chained_steps(step, batch, iters, trainable)
        check(bool(torch.isfinite(losses).all()), f"non-finite train losses {losses}")
        train_canary(model, functools.partial(sft_loss_fn, remat=remat), trainable, before_last,
                     batch, train_batch(gen, cfg.vocab_size), losses[-1],
                     f"LoRA train steps, remat {'on' if remat else 'off'}")
        del before_last
        print(f"  reading: LoRA train step {ms:.2f} ms, {TB * T / ms:.2f} Kt/s (r=8, B={TB}, T={T}, "
              f"bf16, remat {'on' if remat else 'off'}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, losses "
              f"{losses[0].item():.4f} .. {losses[-1].item():.4f}) on {smi}")
        step_profile(step, batch, ms, what=f"one step (remat {'on' if remat else 'off'})",
                     kernels=LORA_STEP_KERNELS)
    del model, step
    torch.cuda.empty_cache()


def sft_jsonl(path: Path, tok) -> None:
    """64 identical rows whose tokenized length falls in the 512 bucket."""
    row = {"instruction": "Repeat the passage.", "input": "The passage is about foxes.",
           "output": " ".join(["The quick brown fox jumps over the lazy dog."] * 30)}
    n = len(encode_sft_example(tok, row["instruction"], row["input"], row["output"])["input_ids"])
    check(256 < n <= 512, f"the SFT row is {n} tokens, not in the 512 bucket")
    path.write_text("".join(json.dumps(row) + "\n" for _ in range(64)))
    print(f"  {path.name}: 64 identical rows of {n} tokens (bucket 512, batch 64 * 64 // 512 = 8)")


def run_train_cli(args, command: str = "sft", falling: bool = True) -> list:
    """`python -m rwkv_lm_ext_tpu_torch.train.cli <command> ...` as a
    subprocess; returns the logged losses, which must be finite and, with
    `falling`, end below where they began."""
    cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", command, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    steps = [json.loads(ln.split(": ", 1)[1]) for ln in proc.stdout.splitlines()
             if ln.startswith("step ")]
    losses = [m["loss"] for m in steps]
    shown = " ".join(a for a in args if not a.startswith("/"))
    print(f"  python -m rwkv_lm_ext_tpu_torch.train.cli {command} {shown}: "
          f"{time.perf_counter() - t0:.1f} s, losses {[round(x, 4) for x in losses]}, last "
          f"logged Kt/s {steps[-1].get('Kt/s', float('nan')):.2f}")
    check(len(losses) >= 2 and all(np.isfinite(losses)), f"losses {losses}")
    check(not falling or losses[-1] < losses[0], f"the loss did not fall on repeated rows: {losses}")
    return losses


def sft_args(path: str, data: Path) -> list:
    """The arguments of every `train.cli sft` run here, but the output
    directory and the train type."""
    return ["--model", path, "--train-data", str(data), "--micro-bsz", "64", "--ctx-len", str(T),
            "--lr-init", "1e-3", "--warmup-steps", "0", "--log-every", "1", "--platform", DEV]


LORA_ARGS = ("--train-type", "lora", "--lora-r", "8", "--lora-alpha", "32", "--max-steps", "8")
# The merged bf16 adapter against the unfused bf16 route, each by its
# per-position logits cosine to the unfused route in fp32: the worst position
# and the mean over positions of the merged route may trail the unfused
# route's by these. From `python3 chip_smoke.py --merge-calibration` on an
# H100 (4 adapter seeds x 2 WKV backward bodies x 4 token batches): the worst
# positions' margin spread from -4.90e-3 to +6.06e-3 (sd 2.37e-3, alike for
# both bodies), the means' from -3.72e-5 to +7.28e-5 (sd 2.23e-5).
MERGE_WORST_BUDGET = 7.5e-3
MERGE_MEAN_BUDGET = 1e-4


def merged_adapter_readings(path: str, sd: dict, cfg, token_seeds=(10,)) -> list:
    """The LoRA adapter `sd` on the checkpoint at `path`, unfused and merged,
    in fp32 and bf16, on 2 x 128 tokens drawn from each of `token_seeds`.
    Per token batch: the merged fp32 route's worst per-position logits cosine
    to the unfused fp32 route ("fp32"), and the bf16 routes' worst and mean."""
    adapter = lora_state_dict_to_tree(sd)
    batches = [torch.randint(4, cfg.vocab_size, (2, 128), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(s)) for s in token_seeds]
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model, _ = load_rwkv_checkpoint(path, device=DEV, dtype=dtype)
        apply_lora(model, LORA, adapter)
        with torch.inference_mode():
            for i, tokens in enumerate(batches):
                logits[dtype, "unfused", i] = model(tokens)[0].float()
            merge_lora(model)
            for i, tokens in enumerate(batches):
                logits[dtype, "merged", i] = model(tokens)[0].float()
        del model
    readings = []
    for i in range(len(batches)):
        ref = logits["float32", "unfused", i]
        rd = {"fp32": min_cosine(logits["float32", "merged", i], ref)}
        for kind in ("merged", "unfused"):
            per = position_cosines(logits["bfloat16", kind, i], ref)
            rd[f"worst {kind}"], rd[f"mean {kind}"] = float(per.min()), float(per.mean())
        readings.append(rd)
    del logits
    torch.cuda.empty_cache()
    return readings


def merge_calibration(adapters: int = 4, token_seeds=(10, 11, 12, 13)) -> None:
    """The readings behind MERGE_WORST_BUDGET and MERGE_MEAN_BUDGET: the
    synthetic 24-layer model, `adapters` LoRA adapters (the seeds of
    `train.cli sft` in this process, phase 9's data and steps) trained once
    through each body of the WKV backward, and each adapter's margins (merged
    less unfused) on several token batches. The body is forced by replacing
    ops.wkv_fused.wkv_bwd_body for the run."""
    cfg = rwkv6_1b6()
    model = load_state_dict_into(RWKV(cfg, device=DEV), synthetic_1b6(cfg, seed=0))
    margins = {body: [] for body in WKV_BWD_BODIES}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = str(tmp / "rwkv6_1b6_synthetic.pth")
        save_rwkv_checkpoint(model, path)
        del model
        torch.cuda.empty_cache()
        data = tmp / "sft.jsonl"
        sft_jsonl(data, WorldTokenizer())
        for seed in range(adapters):
            for body in WKV_BWD_BODIES:
                out = tmp / f"{body}{seed}"
                with mock.patch.object(wkv_fused, "wkv_bwd_body", lambda dtype, n, b=body: b):
                    train_cli.main(["sft", *sft_args(path, data), "--output-dir", str(out), *LORA_ARGS,
                                    "--seed", str(seed)])
                sd = torch.load(out / "lora-step8.pth", map_location=DEV, weights_only=True)
                for ts, rd in zip(token_seeds, merged_adapter_readings(path, sd, cfg, token_seeds)):
                    worst = rd["worst merged"] - rd["worst unfused"]
                    mean = rd["mean merged"] - rd["mean unfused"]
                    margins[body].append((worst, mean))
                    print(f"  adapter seed {seed}, {body} body, tokens seed {ts}: bf16 worst position "
                          f"merged {rd['worst merged']:.6f} unfused {rd['worst unfused']:.6f} (margin "
                          f"{worst:+.3e}); mean merged {rd['mean merged']:.6f} unfused "
                          f"{rd['mean unfused']:.6f} (margin {mean:+.3e}); fp32 merged {rd['fp32']:.6f}",
                          flush=True)
    for body, m in margins.items():
        w_, m_ = [x for x, _ in m], [y for _, y in m]
        print(f"  {body} body, {len(m)} readings: worst-position margin {min(w_):+.3e} .. {max(w_):+.3e}, "
              f"mean margin {min(m_):+.3e} .. {max(m_):+.3e}")


def phase_train_cli(path: str, tmp: Path) -> dict:
    """The trainer's normal entry point on the saved 24-layer model: LoRA (8
    steps) and state tuning (4 steps) as subprocesses, their files, the
    merged adapter; then LoRA again in this process, where the launches of
    the training path are counted. Returns those counts."""
    data = tmp / "sft.jsonl"
    sft_jsonl(data, WorldTokenizer())
    common = sft_args(path, data)
    out = tmp / "lora"
    run_train_cli(common + ["--output-dir", str(out), *LORA_ARGS])
    check((out / "train_log.txt").is_file(), "no train_log.txt")
    sd = torch.load(out / "lora-step8.pth", map_location=DEV, weights_only=True)
    model, cfg = load_rwkv_checkpoint(path, device=DEV)
    check(len(sd) == cfg.n_layer * 8 * 2, f"lora-step8.pth holds {len(sd)} keys, not 384")
    for key, t in sd.items():
        base, ab = key.rsplit(".lora_", 1)
        n_out, n_in = model.get_submodule(base).weight.shape
        want = (LORA.r, n_in) if ab == "A" else (n_out, LORA.r)
        check(tuple(t.shape) == want and t.dtype == torch.float32, f"{key}: {tuple(t.shape)} {t.dtype}")
    check(all(bool(sd[k].abs().max() > 0) for k in sd if k.endswith("lora_B")), "a lora_B did not train")
    del model
    rd = merged_adapter_readings(path, sd, cfg)[0]
    print(f"  lora-step8.pth: {len(sd)} keys in the reference layout (lora_A (8, in), lora_B "
          f"(out, 8), fp32); per-position logits cosine to the unfused LoRA forward in fp32: "
          f"merged in fp32, min {rd['fp32']:.6f} (limit 0.999); in bf16, worst position merged "
          f"{rd['worst merged']:.6f}, unfused {rd['worst unfused']:.6f} (merged may trail by "
          f"{MERGE_WORST_BUDGET:g}), mean merged {rd['mean merged']:.6f}, unfused "
          f"{rd['mean unfused']:.6f} (by {MERGE_MEAN_BUDGET:g})")
    check(rd["fp32"] >= 0.999, f"merged adapter logits cosine {rd['fp32']} in fp32")
    check(rd["worst merged"] >= rd["worst unfused"] - MERGE_WORST_BUDGET,
          f"bf16 merged adapter cosine {rd['worst merged']} trails unfused {rd['worst unfused']}")
    check(rd["mean merged"] >= rd["mean unfused"] - MERGE_MEAN_BUDGET,
          f"bf16 merged adapter mean cosine {rd['mean merged']} trails unfused {rd['mean unfused']}")
    torch.cuda.empty_cache()

    out = tmp / "states"
    run_train_cli(common + ["--output-dir", str(out), "--train-type", "states", "--max-steps", "4"])
    sd = torch.load(out / "states-step4.pth", map_location="cpu", weights_only=True)
    check(sorted(sd) == sorted(f"blocks.{i}.att.time_state" for i in range(cfg.n_layer))
          and all(tuple(t.shape) == (H, N, N) for t in sd.values()), f"states-step4.pth: {list(sd)[:3]}")
    check(all(bool(t.abs().max() > 0) for t in sd.values()), "a time_state did not train")
    print(f"  states-step4.pth: {len(sd)} blocks.{{i}}.att.time_state ({H}, {N}, {N}) fp32")

    args = common + ["--output-dir", str(tmp / "lora_inproc"), "--train-type", "lora",
                     "--max-steps", "2"]
    reset_launch_counts()
    train_cli.main(["sft", *args])
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: 2 * n for k, n in train_step_counts(cfg.n_layer, remat=True).items()}
    print(f"  in-process train.cli sft --train-type lora --max-steps 2: launches {counts}")
    check(counts == want, f"CLI training launch counts {counts} != {want}")
    torch.cuda.empty_cache()
    return counts


WKV_REL = 2e-5      # B.8's y and final state, x max|plain|: both sides sum in fp32
# B.8's chunked body (bf16): the state and r exp(c) enter the tensor cores as
# two bf16 limbs (about 16 bits each), so its y and state sit further from the
# fp32 recurrence than the sequential body's; read 1e-5 .. 3e-5 of max|plain|
WKV_CHUNKED_REL = 1e-4


def wkv_rel(body: str) -> float:
    return WKV_CHUNKED_REL if body == "chunked" else WKV_REL


def rel_err(name, got, want, rel, scale=None, worst=None) -> float:
    """As err_line without a line of its own, for the many cases of one
    kernel: `worst` ({"share": the largest error / limit so far, "name"})
    is kept for the caller's summary. A gradient may be zero analytically
    (at T=1 from a zero state): the limit is then `rel` x `scale`, the
    largest value of a gradient of the same call that is not."""
    top = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    limit = rel * (top if scale is None else max(top, scale))
    check(err <= limit, f"{name}: error {err} above {limit}")
    if worst is not None and limit > 0 and err / limit > worst.get("share", -1.0):
        worst.update(share=err / limit, name=name)
    return err


def phase_wkv_kernels() -> dict:
    """B.8 and its two-pass backward against their plain versions (the plain
    side in fp32 on the same values): with and without the bonus u and an
    initial state, forwards and in reverse, over all T and over ragged
    prefixes (lengths with 0 and 1), w ~ U(-8, 3); two backward calls
    bit-equal; wkv6_bi against the flip composition, forward and gradients.
    Then timed at B=8 (the training batch) and B=64, T=512, bf16. Returns
    {kernel: {max_abs_err, ms, plain_ms, bound...}} at B=8."""
    rng = Inputs(11)
    out = {}

    def case(b, t, h, n, dtype):
        r, k, v = (rng.normal(b, t, h, n, dtype=dtype) for _ in range(3))
        w = rng.uniform(b, t, h, n, lo=-8.0, hi=3.0, dtype=torch.float32)   # decays 1 .. e^-20
        lengths = torch.randint(0, t + 1, (b,), device=DEV, generator=rng.gen, dtype=torch.int32)
        lengths[0], lengths[-1] = 0, min(1, t)
        return dict(r=r, k=k, v=v, w=w, u=rng.normal(h, n, scale=0.5, dtype=dtype),
                    s0=rng.normal(b, h, n, n, scale=0.1, dtype=torch.float32),
                    dy=rng.normal(b, t, h, n, dtype=torch.float32),
                    dsT=rng.normal(b, h, n, n, scale=0.1, dtype=torch.float32), lengths=lengths)

    def plain32(t):
        return None if t is None else t.float()

    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    main_fwd, main_bwd = 0.0, {}
    for shape in ((B, T, H, N), (TB, T, H, N), (3, 37, 4, 32), (1, 1, H, N)):
        for dtype in (torch.float32, BF16):
            c = case(*shape, dtype)
            fwd_worst, bwd_worst, bi_worst, n_cases = {}, {}, {}, 0
            for u, s0, reverse, ragged in ((c["u"], c["s0"], False, False), (None, None, False, False),
                                           (None, c["s0"], True, True), (c["u"], None, True, False),
                                           (c["u"], c["s0"], False, True)):
                lengths = c["lengths"] if ragged else None
                kw = dict(reverse=reverse, lengths=lengths)
                tag = (f"(B,T,H,N)={shape} {str(dtype)[6:]} u={'yes' if u is not None else 'no'} "
                       f"s0={'yes' if s0 is not None else 'no'} reverse={reverse} ragged={ragged}")
                y, sT = wkv(c["r"], c["k"], c["v"], c["w"], u, s0, **kw)
                py, psT = wkv_plain(*map(plain32, (c["r"], c["k"], c["v"], c["w"], u, s0)), **kw)
                n_cases += 1
                rel = wkv_rel(wkv_body(dtype, shape[3]))
                e = rel_err(f"B.8 {tag} y", y, py, rel, worst=fwd_worst)
                rel_err(f"B.8 {tag} sT", sT, psT, rel, worst=fwd_worst)
                if ragged:
                    beyond = torch.arange(shape[1], device=DEV)[None, :] >= lengths[:, None]
                    check(float(y[beyond].abs().max() if beyond.any() else 0) == 0.0,
                          f"B.8 {tag}: y is not zero beyond the prefix")
                if shape[0] == B:
                    continue         # the backward is checked at the training batch and below
                if shape == (TB, T, H, N) and dtype == BF16 and u is not None and not reverse:
                    main_fwd = max(main_fwd, e)
                args = (c["r"], c["k"], c["v"], c["w"], u, s0, c["dy"], c["dsT"])
                got = wkv_bwd(*args, **kw)
                check(bit_equal(got, wkv_bwd(*args, **kw)), f"B.8 backward {tag}: two calls differ")
                want = wkv_bwd_plain(*map(plain32, args), **kw)
                # at T=1 a gradient may be zero analytically (dw from a zero state)
                scale = max(w_.abs().max().item() for w_ in want[:3]) if shape[1] == 1 else None
                errs = {n: rel_err(f"B.8 backward {tag} {n}", g_, w_, wkv_bwd_rel(dtype, g_), scale,
                                   bwd_worst)
                        for n, g_, w_ in zip(names, got, want) if w_ is not None}
                check(all((g_ is None) == (w_ is None) for g_, w_ in zip(got, want)),
                      f"B.8 backward {tag}: a gradient is missing or surplus")
                if shape == (TB, T, H, N) and dtype == BF16 and u is not None and not ragged:
                    main_bwd = {n: max(main_bwd.get(n, 0.0), e_) for n, e_ in errs.items()}
            print(f"  B.8 (B,T,H,N)={shape} {str(dtype)[6:]}, {wkv_body(dtype, shape[3])} body, {n_cases} "
                  f"cases (u, s0, reverse, ragged lengths): y and sT within "
                  f"{wkv_rel(wkv_body(dtype, shape[3])):g} x max|plain|, worst at "
                  f"{fwd_worst['share']:.3f} of the limit ({fwd_worst['name']})")
            if shape[0] == B:
                continue
            print(f"    backward, every gradient within {WKV_BWD_REL[dtype]:g} x max|plain| (the fp32 "
                  f"ones on bf16 inputs {WKV_BWD_REL_FP32_OUT:g}), two calls "
                  f"bit-equal: worst at {bwd_worst['share']:.3f} of the limit ({bwd_worst['name']})")
            # wkv6_bi: two launches against the flip composition, through autograd
            for lengths in (None, torch.full_like(c["lengths"], shape[1]), c["lengths"]):
                leaves = [c[n].detach().float().clone().requires_grad_()
                          for n in ("r", "k", "v", "w", "u")]
                kleaves = [c[n].detach().clone().requires_grad_() for n in ("r", "k", "v", "w", "u")]
                yk = wkv6_bi(*kleaves, lengths)
                yp = wkv6_bi_plain(*leaves, lengths)
                what = "none" if lengths is None else ("full" if bool((lengths == shape[1]).all())
                                                       else "ragged")
                tag = f"wkv6_bi (B,T,H,N)={shape} {str(dtype)[6:]} lengths={what}"
                rel_err(f"{tag} y", yk, yp, wkv_rel(wkv_body(dtype, shape[3])), worst=bi_worst)
                yk.backward(c["dy"])
                yp.backward(c["dy"])
                scale = max(t.grad.abs().max().item() for t in leaves[:3]) if shape[1] == 1 else None
                for n, a, b_ in zip(names, kleaves, leaves):
                    # at T=1 the output does not depend on w: autograd leaves None
                    got, want = (torch.zeros_like(t) if t.grad is None else t.grad for t in (a, b_))
                    rel_err(f"{tag} {n}", got, want, WKV_BWD_REL[dtype], scale, bi_worst)
            print(f"    wkv6_bi vs the flip composition (lengths none, full, ragged), y and gradients: "
                  f"worst at {bi_worst['share']:.3f} of the limit ({bi_worst['name']})")

    # both bodies in turns on the same bf16 inputs: wide, strong and no
    # decay, T from 1 to 512, with and without u and s0, forwards, in reverse
    # and over ragged prefixes; two calls bit-equal
    worst = {b_: {} for b_ in WKV_BODIES}
    n_cases = 0
    for n_ in (N, 32):
        for lo, hi in ((-8.0, 3.0), (2.5, 3.2), (-8.0, -8.0)):
            for t in (1, 15, 16, 17, 37, T):
                r, k, v = (rng.normal(3, t, 4, n_) for _ in range(3))
                w = rng.uniform(3, t, 4, n_, lo=lo, hi=hi, dtype=torch.float32)
                u, s0 = rng.normal(4, n_, scale=0.5), rng.normal(3, 4, n_, n_, scale=0.1, dtype=torch.float32)
                lengths = torch.tensor([0, min(1, t), max(t - 2, 1)], dtype=torch.int32, device=DEV)
                for uu, ss, reverse, ln in ((u, s0, False, None), (None, None, False, None),
                                            (None, s0, True, lengths), (u, None, False, lengths),
                                            (u, s0, True, None)):
                    kw = dict(reverse=reverse, lengths=ln)
                    py, psT = wkv_plain(*map(plain32, (r, k, v, w, uu, ss)), **kw)
                    tag = (f"N={n_} T={t} w in [{lo}, {hi}] u={uu is not None} s0={ss is not None} "
                           f"reverse={reverse} ragged={ln is not None}")
                    for body in WKV_BODIES:
                        y, sT = wkv(r, k, v, w, uu, ss, body=body, **kw)
                        y2, sT2 = wkv(r, k, v, w, uu, ss, body=body, **kw)
                        check(torch.equal(y, y2) and torch.equal(sT, sT2), f"B.8 {body} {tag}: two calls differ")
                        rel_err(f"B.8 {body} {tag} y", y, py, wkv_rel(body), worst=worst[body])
                        rel_err(f"B.8 {body} {tag} sT", sT, psT, wkv_rel(body), worst=worst[body])
                        if ln is not None:
                            beyond = torch.arange(t, device=DEV)[None, :] >= ln[:, None]
                            check(float(y[beyond].abs().max() if beyond.any() else 0) == 0.0,
                                  f"B.8 {body} {tag}: y is not zero beyond the prefix")
                    n_cases += 1
    for body in WKV_BODIES:
        print(f"  B.8, {body} body, bf16: {n_cases} calls (N = {N} and 32; w in [-8, 3], [2.5, 3.2] and -8; "
              f"T in 1, 15, 16, 17, 37, {T}; u, s0, reverse, ragged lengths), y and sT within "
              f"{wkv_rel(body):g} x max|plain|, two calls bit-equal: worst at {worst[body]['share']:.3f} of "
              f"the limit, {worst[body]['share'] * wkv_rel(body):.2e} of max ({worst[body]['name']})")
    # the chunked body against its factoring in plain PyTorch on the same inputs
    chunk = _lib.library().rwkv_wkv6_fused_chunk()
    c = case(TB, T, H, N, BF16)
    for reverse, ln in ((False, None), (True, c["lengths"])):
        args = (c["r"], c["k"], c["v"], c["w"], c["u"], c["s0"])
        y, sT = wkv(*args, reverse=reverse, lengths=ln)
        my, msT = wkv_chunked_plain(*map(plain32, args), reverse=reverse, lengths=ln, chunk=chunk)
        rel_err(f"B.8 B={TB} T={T} reverse={reverse} y vs chunked mirror", y, my, WKV_CHUNKED_REL)
        rel_err(f"B.8 B={TB} T={T} reverse={reverse} sT vs chunked mirror", sT, msT, WKV_CHUNKED_REL)

    times = {}
    for b in (TB, B):
        c = case(b, T, H, N, BF16)
        fwd = (c["r"], c["k"], c["v"], c["w"], c["u"])
        bwd = fwd + (None, c["dy"], None)        # the encoder's call: zero state in, final state unused
        bodies = {}
        for rnd in range(2):
            for body in WKV_BODIES:
                bodies[rnd, body] = (device_ms(lambda: wkv(*fwd, body=body), 10),
                                     device_ms(lambda: wkv(*fwd[:4], None, reverse=True, lengths=c["lengths"],
                                                           body=body), 10))
                print(f"  B.8 at B={b}, T={T}, H={H}, N={N}, bf16, {body} body (round {rnd + 1}): forward "
                      f"{bodies[rnd, body][0]:.4f} ms, reverse over ragged prefixes {bodies[rnd, body][1]:.4f} ms")
        split = device_ms_by_kernel(lambda: wkv_bwd(*bwd), 5, {
            "state": ("wkv6_bwd_state",), "reverse": ("wkv6_bwd_reverse",)})
        times[b] = dict(fwd=bodies[1, "chunked"][0], state=split["state"],
                        reverse=split["reverse"], whole=device_ms(lambda: wkv_bwd(*bwd), 5),
                        plain=device_ms(lambda: wkv_plain(*fwd), 2),
                        plain_bwd=device_ms(lambda: wkv_bwd_plain(*bwd), 1))
        t_ = times[b]
        print(f"  B.8 at B={b}, T={T}: plain forward {t_['plain']:.4f} ms; backward pass 1 "
              f"{t_['state']:.4f} ms, pass 2 (B.7) {t_['reverse']:.4f} ms, whole wrapper "
              f"{t_['whole']:.4f} ms (plain, autograd through the sequential reference, "
              f"{t_['plain_bwd']:.4f} ms)")
        steps = b * T * H * N * N
        # reads r, k, v, w, u; writes y (fp32) and the final state; the
        # chunked factoring's products (the state's two, 4 N^2 a step and
        # head) at the bf16 tensor-core rate, its scores (chunk x N) in fp32
        bound = roofline(nbytes(*fwd) + 4 * c["r"].numel() + 4 * b * H * N * N,
                         {"bf16 mma": 4 * steps, "fp32": chunk * b * T * H * N})
        print(f"  B.8 at B={b}: bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}; chunked at "
              f"{100 * bound['bound_ms'] / t_['fwd']:.1f} %, sequential at "
              f"{100 * bound['bound_ms'] / bodies[1, 'sequential'][0]:.1f} %")
        if b == TB:
            out["wkv"] = dict(max_abs_err=main_fwd, ms=t_["fwd"], plain_ms=t_["plain"], **bound)
            out["wkv_bwd_state_pass"] = dict(
                max_abs_err=max(main_bwd[n] for n in ("dr", "dw")), ms=t_["state"],
                plain_ms=t_["plain_bwd"],
                # the function of B.6 without GroupNorm: the state carried
                # over the walk, reading k, v, w (what it hands pass 2 not
                # counted, as for B.6 and B.7); per step the state's update
                # (2 N^2) at the bf16 tensor-core rate and the decays in fp32
                **roofline(nbytes(c["k"], c["v"], c["w"]),
                           {"bf16 mma": 2 * steps, "fp32": 4 * TB * T * H * N}))
    return out


PREP_REL = {torch.float32: 2e-5, BF16: 1e-2}     # B.10, B.11, x max|plain|
BLOCK_REL = {torch.float32: 3e-5, BF16: 1e-2}    # B.12: three products deep


def phase_fused_kernels() -> dict:
    """The fused decode kernels B.10, B.11, B.12 at the 1B6 widths, B=64 and
    B=1, fp32 and bf16, each against its plain version on the same inputs
    (which repeats the kernel's roundings) and called twice bit-equal, the
    bf16 B.10, B.11 and B.12 also against the plain mirrors of their
    factorings (att_prep_sliced_plain, ffn_prep_warp_order_plain,
    ffn_block_split_plain) and B.10's two bodies against each other; B.13
    against the plain step and against B.9, whose new state it must equal
    bit for bit after a transpose. Timed in bf16 at both batch sizes, beside
    the calls each replaces on the unfused decode step: for B.10, K2 at T=1
    and the plain decay low-rank; for B.12, K3 + the mixes + three F.linear;
    for B.13, B.9 (the two in turns, twice, each hot in place and cold; its
    `ms` is the cold reading). B.10 (both bodies), B.11 and B.12 are also
    timed cold, their weights (B.11: all its inputs) rotated through copies
    as a decode step finds them (B.10: 24 copies, 43 MB; B.11: 100 MB; B.12:
    3 copies, 201 MB). B.12's launches overlap (dependent launches), so its
    time is the device's busy time over the calls (device_span_ms), and so
    is that of the calls it replaces. Returns {kernel: {max_abs_err, ms,
    plain_ms, bound...}} at B=64, bf16."""
    rng = Inputs(17)
    out = {}
    lin = torch.nn.functional.linear

    def att_args(b, dtype):
        return (rng.normal(b, C, dtype=dtype), rng.normal(b, C, dtype=torch.float32),
                rng.normal(C, scale=0.1, dtype=dtype) + 1, rng.normal(C, scale=0.1, dtype=dtype),
                rng.normal(6, C, scale=0.5, dtype=dtype), rng.normal(C, 5 * D, scale=0.05, dtype=dtype),
                rng.normal(5, D, C, scale=0.1, dtype=dtype), rng.normal(C, DD, scale=0.05, dtype=dtype),
                rng.normal(DD, C, scale=0.1, dtype=dtype), rng.normal(C, dtype=dtype))

    def ffn_weights(dtype):
        return (rng.normal(F, C, scale=0.03, dtype=dtype), rng.normal(C, F, scale=0.03, dtype=dtype),
                rng.normal(C, C, scale=0.03, dtype=dtype))

    def held(name, fn, plain, args, names, rel):
        got = fn(*args)
        check(bit_equal(got, fn(*args)), f"{name}: two calls differ")
        return max(err_line(f"{name} {n}", g, w, rel) for n, g, w in zip(names, got, plain(*args)))

    def k2_and_decay(a):
        """What B.10 replaces on the unfused step: K2 at T=1 and the fp32
        decay low-rank on its xw (TimeMix._mix)."""
        x, shift, sc, bi, maas, w1, w2, dw1, dw2, td = a
        xw = tmix_prologue(x[:, None], shift.to(x.dtype), sc, bi, maas, w1, w2)[0]
        return td.float() + torch.tanh(xw[:, 0].float() @ dw1.float()) @ dw2.float()

    def unfused_ffn_prep(a):
        """What B.11 replaces on the unfused step with quantized weights: K3
        (ln2) and the two mixes."""
        x, shift, sc, bi, maa_k, maa_r = a
        xn = layer_norm(x[:, None], sc, bi)
        xx = shift.to(x.dtype)[:, None] - xn
        return xn + xx * maa_k, xn + xx * maa_r, xn

    def unfused_channel_mix(a):
        """What B.12 replaces: K3 (ln2), the two mixes, three F.linear and the
        gated residual, as Block.step runs them without fused_prep."""
        x, shift, sc, bi, maa_k, maa_r, wk, wv, wr = a
        xn = layer_norm(x[:, None], sc, bi)
        xx = shift.to(x.dtype)[:, None] - xn
        kv = lin(torch.relu(lin(xn + xx * maa_k, wk)) ** 2, wv)
        return x[:, None] + torch.sigmoid(lin(xn + xx * maa_r, wr)) * kv

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def cold_ms(launch, args, weights: slice, copies: int, reps: int, timer=device_ms):
        """ms of one launch whose weights (args[weights]) rotate through
        `copies` copies, so that each call finds its own cold in L2."""
        sets = [tuple(w.clone() for w in args[weights]) for _ in range(copies)]
        turn = [0]

        def rotate():
            ws = sets[turn[0] % copies]
            turn[0] += 1
            launch(*args[:weights.start], *ws, *args[weights.stop:])
        ms = timer(rotate, reps)
        del sets
        torch.cuda.empty_cache()
        return ms

    errs, times, extra = {}, {}, {}
    for b in (B, 1):
        for dtype in (torch.float32, BF16):
            tag = f"(B,C)=({b},{C}) {str(dtype)[6:]}"
            a = att_args(b, dtype)
            f = a[:4] + (a[4][2], a[4][4])            # x, shift, ln, maa_k, maa_r
            blk = f + ffn_weights(dtype)
            e = dict(
                att_prep_fused=held(f"B.10 {tag} D={D} Dd={DD}", att_prep_fused, att_prep_plain, a,
                                    ("xr", "xk", "xv", "xg", "w", "xn"), PREP_REL[dtype]),
                ffn_prep_fused=held(f"B.11 {tag}", ffn_prep_fused, ffn_prep_plain, f,
                                    ("xk", "xr", "xn"), PREP_REL[dtype]),
                ffn_block_fused=held(f"B.12 {tag} F={F}", ffn_block_fused, ffn_block_plain, blk,
                                     ("out", "xn"), BLOCK_REL[dtype]))
            if dtype != BF16:
                continue
            check(b10_body(dtype, C, D, DD) == "cluster", "bf16 B.10 at the 1B6 widths is not the "
                  "cluster body")
            rows = _launch_att_prep(*a, body="row_pairs")
            e.update(
                att_prep_fused=max(e["att_prep_fused"], held(
                    f"B.10 {tag} against its sliced mirror", att_prep_fused,
                    lambda *x: att_prep_sliced_plain(*x), a, ("xr", "xk", "xv", "xg", "w", "xn"),
                    PREP_REL[dtype])),
                ffn_prep_fused=max(e["ffn_prep_fused"], held(
                    f"B.11 {tag} against its warp-order mirror", ffn_prep_fused,
                    ffn_prep_warp_order_plain, f, ("xk", "xr", "xn"), PREP_REL[dtype])),
                ffn_block_fused=max(e["ffn_block_fused"], held(
                    f"B.12 {tag} against its split mirror", ffn_block_fused,
                    lambda *x: ffn_block_split_plain(*x, splits=ffn_value_splits(C, F, sms)), blk,
                    ("out", "xn"), BLOCK_REL[dtype])))
            for n, g, w in zip(("xr", "xk", "xv", "xg", "w", "xn"), att_prep_fused(*a), rows):
                err_line(f"B.10 {tag} cluster body against the row-pair body, {n}", g, w, PREP_REL[dtype])
            errs[b] = e
            # two rounds in turns (kernel, library, library, kernel): the two
            # readings of each show the spread
            rounds = []
            for order in (1, -1):
                r = {}
                for key, fn, timer in (
                        ("att_prep_fused", lambda: att_prep_fused(*a), device_ms),
                        ("att_prep_replaced", lambda: k2_and_decay(a), device_ms),
                        ("ffn_block_replaced", lambda: unfused_channel_mix(blk), device_span_ms),
                        ("ffn_block_fused", lambda: ffn_block_fused(*blk), device_span_ms))[::order]:
                    r[key] = timer(fn, 20)
                rounds.append(r)
            times[b] = t = dict(
                att_prep_fused=(rounds[1]["att_prep_fused"], device_ms(lambda: att_prep_plain(*a), 10),
                                rounds[1]["att_prep_replaced"]),
                ffn_prep_fused=(device_ms(lambda: ffn_prep_fused(*f), 20),
                                device_ms(lambda: ffn_prep_plain(*f), 10),
                                device_ms(lambda: unfused_ffn_prep(f), 20)),
                ffn_block_fused=(rounds[1]["ffn_block_fused"], device_ms(lambda: ffn_block_plain(*blk), 5),
                                 rounds[1]["ffn_block_replaced"]))
            extra[b] = dict(
                rows_ms=device_ms(lambda: _launch_att_prep(*a, body="row_pairs"), 20),
                att_cold=cold_ms(att_prep_fused, a, slice(5, 9), 24, 48),
                rows_cold=cold_ms(lambda *x: _launch_att_prep(*x, body="row_pairs"), a, slice(5, 9), 24, 48),
                ffn_cold=cold_ms(ffn_block_fused, blk, slice(6, 9), 3, 30, timer=device_span_ms),
                # every input of B.11 in copies that together exceed the L2
                prep_cold=cold_ms(ffn_prep_fused, f, slice(0, 6), -(-100_000_000 // nbytes(*f)), 48),
                first=rounds[0])
            split = device_ms_by_kernel(lambda: ffn_block_fused(*blk), 20, {
                "prologue": ("ffn_prep_kernel",),
                "key product": ("ffn_stream_kernel<true", "ffn_stream_kernel<(bool)1"),
                "value + receptance products": ("ffn_stream_kernel<false", "ffn_stream_kernel<(bool)0"),
                "gated residual": ("ffn_out_kernel",)})
            x_ = extra[b]
            print(f"  B={b}, bf16: B.10 {t['att_prep_fused'][0]:.4f} ms hot, {x_['att_cold']:.4f} cold "
                  f"(row-pair body {x_['rows_ms']:.4f} hot, {x_['rows_cold']:.4f} cold; plain "
                  f"{t['att_prep_fused'][1]:.4f} ms; K2 at T=1 + the plain decay low-rank it replaces "
                  f"{t['att_prep_fused'][2]:.4f} ms; first round {x_['first']['att_prep_fused']:.4f} / "
                  f"{x_['first']['att_prep_replaced']:.4f}); "
                  f"B.11 {t['ffn_prep_fused'][0]:.4f} ms hot, {x_['prep_cold']:.4f} cold (plain "
                  f"{t['ffn_prep_fused'][1]:.4f} ms; K3 + the "
                  f"two mixes it replaces {t['ffn_prep_fused'][2]:.4f} ms); "
                  f"B.12 {t['ffn_block_fused'][0]:.4f} ms hot, {x_['ffn_cold']:.4f} cold (plain "
                  f"{t['ffn_block_fused'][1]:.4f} ms; the unfused channel mix it replaces, K3 + mixes + "
                  f"three F.linear, {t['ffn_block_fused'][2]:.4f} ms; first round "
                  f"{x_['first']['ffn_block_fused']:.4f} / {x_['first']['ffn_block_replaced']:.4f})")
            print("    B.12 by launch (durations; a dependent launch's holds its wait for the one "
                  "before it): " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
            if b == B:
                main = dict(att_prep_fused=a, ffn_prep_fused=f, ffn_block_fused=blk)
    a, f, blk = main["att_prep_fused"], main["ffn_prep_fused"], main["ffn_block_fused"]
    rows_bf16, rows_f32 = 2 * B * C, 4 * B * C      # one (B, C) output in each type
    bounds = dict(
        # xr, xk, xv, xg and fp32 w, xn out; the ddlerp products (C x 5D,
        # 5 x D x C) of bf16 operands, the decay products (C x Dd, Dd x C) in
        # fp32, LayerNorm and six mixes (~40 fp32 an element)
        att_prep_fused=roofline(nbytes(*a) + 4 * rows_bf16 + 2 * rows_f32, {
            "bf16 mma": 2 * 2 * B * C * 5 * D, "fp32": 2 * 2 * B * C * DD + 40 * B * C}),
        # LayerNorm and two mixes: ~14 fp32 an element
        ffn_prep_fused=roofline(nbytes(*f) + 2 * rows_bf16 + rows_f32, {"fp32": 14 * B * C}),
        # the three weight matrices once; their products of bf16 operands
        ffn_block_fused=roofline(nbytes(*blk) + rows_bf16 + rows_f32, {
            "bf16 mma": 2 * B * (2 * C * F + C * C), "fp32": 20 * B * C + 3 * B * F}))
    for name, bound in bounds.items():
        ms, plain_ms, replaced = times[B][name]
        # no single PyTorch call computes one of these functions: library_ms
        # stays null and the calls each replaces stand beside it
        out[name] = dict(max_abs_err=max(errs[B][name], errs[1][name]), ms=ms, plain_ms=plain_ms,
                         **bound, replaced_ms=replaced, ms_at_b1=times[1][name][0],
                         replaced_ms_at_b1=times[1][name][2])
    for b, tag in ((B, ""), (1, "_at_b1")):
        out["att_prep_fused"].update({f"cold_ms{tag}": extra[b]["att_cold"],
                                      f"row_pairs_ms{tag}": extra[b]["rows_ms"],
                                      f"row_pairs_cold_ms{tag}": extra[b]["rows_cold"]})
        out["ffn_block_fused"][f"cold_ms{tag}"] = extra[b]["ffn_cold"]
        out["ffn_prep_fused"][f"cold_ms{tag}"] = extra[b]["prep_cold"]

    def decode_args(b):
        r, k, v, g = (rng.normal(b, C) for _ in range(4))
        w = rng.uniform(b, C, lo=-8.0, hi=2.5, dtype=torch.float32)
        return (r, k, v, w, g, rng.normal(H, N, scale=0.5), rng.normal(C, scale=0.1) + 1,
                rng.normal(C, scale=0.1), rng.normal(b, H, N, N, scale=0.3, dtype=torch.float32))

    def decode_step(name, args, buf):
        """One in-place step on `buf` by B.9 or B.13."""
        step = wkv6_decode_step if name == "B.9" else wkv6_decode_step_transposed
        return lambda: step(*args[:-1], buf, eps=LN_X_EPS, out_state=buf)

    t13, e13 = {}, []
    for b in (B, 1):
        args = decode_args(b)
        state = args[-1]
        po, ps = wkv6_decode_step_plain(*f32(*args), eps=LN_X_EPS)
        o9, s9 = wkv6_decode_step(*args, eps=LN_X_EPS)
        buf = transpose_state(state)
        o, s_t = wkv6_decode_step_transposed(*args[:-1], buf, eps=LN_X_EPS, out_state=buf)
        check(s_t.data_ptr() == buf.data_ptr(), "B.13 did not update its state in place")
        e13.append(err_line(f"B.13 B={b} out", o, po, 1e-2))
        err_line(f"B.13 B={b} state (in place, transposed back)", transpose_state(s_t), ps, 1e-5)
        same = torch.equal(transpose_state(s_t), s9)
        print(f"  B.13 B={b}: new state {'bit-equal' if same else 'NOT bit-equal'} to B.9's after a "
              f"transpose; outputs differ by {(o.float() - o9.float()).abs().max().item():.3e} (y is "
              f"summed in another order)")
        check(same, "B.13's state is not B.9's")
        fresh = wkv6_decode_step_transposed(*args[:-1], transpose_state(state), eps=LN_X_EPS)
        check(bit_equal(fresh, (o, s_t)), "B.13: two calls differ")
        # The device time of one call (every launch it makes). Hot: one
        # buffer updated in place again and again, which partly stays in the
        # 50 MB L2 (33.5 MB of state at B=64). Cold: a decode step walks 24
        # layers' states and finds each cold; buffers in turn (six at B=64,
        # 201 MB; at B=1 enough for 100 MB) put every launch in that
        # condition. Two rounds in turns, the second in reverse order.
        copies = max(6, -(-100_000_000 // nbytes(state)))
        names = ("B.13", "B.9")
        hot = {n: (state.clone() if n == "B.9" else transpose_state(state)) for n in names}

        def cold_ms(name):
            make = torch.clone if name == "B.9" else transpose_state
            bufs, turn = [make(state) for _ in range(copies)], [0]

            def rotate():
                buf = bufs[turn[0] % copies]
                turn[0] += 1
                decode_step(name, args, buf)()
            ms = device_ms(rotate, 48)
            del bufs
            return ms
        rounds = []
        for order in (1, -1):
            rounds.append({n: (device_ms(decode_step(n, args, hot[n]), 50), cold_ms(n))
                           for n in names[::order]})
        t13[b] = dict(rounds[1], plain=device_ms(lambda: wkv6_decode_step_plain(*args, eps=LN_X_EPS), 20))
        for n in names:
            print(f"  B.13 B={b}: {n:4s} hot {rounds[0][n][0]:.4f} / {rounds[1][n][0]:.4f} ms, "
                  f"cold ({copies} buffers in turn) {rounds[0][n][1]:.4f} / {rounds[1][n][1]:.4f} ms "
                  "(two rounds)")
        print(f"  B.13 B={b}: plain {t13[b]['plain']:.4f} ms")
        torch.cuda.empty_cache()
        if b == B:
            bound = roofline(nbytes(*args) + nbytes(args[0], state), {"fp32": 5 * B * H * N * N})
    # ms: the cold reading, the one a decode step meets and the bound counts
    # (the hot one is partly served from the L2)
    b13, b9 = t13[B]["B.13"], t13[B]["B.9"]
    out["wkv6_decode_step_transposed"] = dict(
        max_abs_err=max(e13), ms=b13[1], plain_ms=t13[B]["plain"], **bound, hot_ms=b13[0],
        replaced_ms=b9[1], replaced_hot_ms=b9[0],
        ms_at_b1=t13[1]["B.13"][1], hot_ms_at_b1=t13[1]["B.13"][0],
        replaced_ms_at_b1=t13[1]["B.9"][1], replaced_hot_ms_at_b1=t13[1]["B.9"][0])
    return out


def encoder_tokens(gen, vocab: int, b: int = TB, t: int = T) -> torch.Tensor:
    """Rows of ragged valid lengths: tokens, some MASK_IDs, the emb
    terminator, then pads; one row is full."""
    tokens = torch.randint(4, vocab, (b, t), device=DEV, generator=gen)
    tokens[torch.rand(b, t, device=DEV, generator=gen) < 0.15] = MASK_ID
    ends = torch.randint(t // 4, t, (b,), device=DEV, generator=gen)
    ends[0] = t - 1
    pos = torch.arange(t, device=DEV)[None, :]
    tokens[pos == ends[:, None]] = EMB_ID
    tokens[pos > ends[:, None]] = 0
    return tokens


def phase_encoder(model, reference) -> None:
    """encoder_forward on the 24-layer model at B=8, T=512, both modes: the
    bf16 kernel route against the plain fp32 route over the valid positions
    (each row's tokens and its emb terminator), and a forward's launches."""
    tokens = encoder_tokens(torch.Generator(device=DEV).manual_seed(12), model.cfg.vocab_size)
    lengths = sequence_lengths(tokens)
    valid = torch.arange(T, device=DEV)[None, :] <= lengths[:, None]
    print(f"  tokens ({TB}, {T}), valid lengths {lengths.tolist()}, "
          f"{int((tokens == MASK_ID).sum())} mask tokens")
    for mode in ("average", "fused"):
        with torch.inference_mode():
            reset_launch_counts()
            hidden = encoder_forward(model, tokens, mode=mode)
            counts = launch_counts()
            plain = encoder_forward(reference, tokens, mode=mode, reference=True)
            check(launch_counts() == counts, "the plain route launched a kernel")
            # the same forward through B.8's sequential body, for comparison
            with mock.patch.object(wkv_ops, "wkv_body", lambda dtype, n: "sequential"):
                seq = encoder_forward(model, tokens, mode=mode)
        check(hidden.shape == (TB, T, C) and bool(torch.isfinite(hidden).all()),
              f"encoder_forward {mode}: shape or values")
        cos = min_cosine(hidden[valid], plain[valid])
        print(f"  encoder_forward mode={mode}: launches {counts}; bf16 kernel route vs plain fp32 "
              f"route, min cosine over {int(valid.sum())} valid positions {cos:.6f} (limit 0.999), "
              f"B.8 {wkv_body(BF16, N)}; through B.8's sequential body "
              f"{min_cosine(seq[valid], plain[valid]):.6f}")
        check(counts == ENCODER_FORWARD, f"encoder forward launch counts {counts} != {ENCODER_FORWARD}")
        check(cos >= 0.999, f"encoder_forward {mode} cosine {cos} below 0.999")


FILL_MASK_TEXTS = (
    "The quick brown [MASK] jumps over the lazy dog.",      # the trainer's own row
    "RWKV is an [MASK] with transformer-level performance.",
    "北京是[MASK]的首都，也是全国的[MASK]和文化[MASK]。",
    "Embeddings 向量 🚀 for [MASK] and [MASK], then [MASK].",
)


def check_fill_mask(answer: dict, text: str, top_k: int, cutoff: float) -> None:
    masks = answer["masks"]
    check(len(masks) == text.count("[MASK]"), f"{len(masks)} candidate lists for {text!r}")
    for cands in masks:
        probs = [c["prob"] for c in cands]
        check(1 <= len(cands) <= top_k and probs == sorted(probs, reverse=True)
              and all(0 <= p <= 1 for p in probs), f"candidates of {text!r}: {probs}")
        # a list ends where the cumulative cutoff is reached, or at top_k
        check(len(cands) == top_k or sum(probs) >= cutoff, f"list of {len(cands)} ends early")
        check(sum(probs[:-1]) < cutoff, "a list goes on beyond the cutoff")


def phase_fill_mask(path: str) -> dict:
    """/fill_mask through the normal entry point: the saved model served by
    `serve.cli --encoder` in a subprocess; every answer's candidates against
    the plain route's, computed by the same CLI code in this process, where
    the launches of a request are counted. Returns those counts."""
    args = ["--encoder", path, "--platform", DEV, "--port", "0"]
    service = cli.build_service(cli.parse_args(args))
    check(service.routes == {"/stats", "/fill_mask"}, f"routes {service.routes}")
    top_k, cutoff = 5, 0.5
    t0 = time.perf_counter()
    with CliServer(args) as base:
        print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli {' '.join(args)}: serving on {base} "
              f"after {time.perf_counter() - t0:.1f} s")
        for text in FILL_MASK_TEXTS:
            payload = {"text": text, "top_k": top_k, "cumulative_prob": cutoff}
            code, answer = post(base + "/fill_mask", payload)
            check(code == 200, f"/fill_mask answered {code}: {answer}")
            check_fill_mask(answer, text, top_k, cutoff)
            plain = service.fill_mask(reference=True, **payload)
            tops = [(a[0]["token_id"], p[0]["token_id"]) for a, p in zip(answer["masks"], plain["masks"])]
            print(f"  /fill_mask {text!r}: {[len(c) for c in answer['masks']]} candidates, top "
                  f"{[(c[0]['token'], c[0]['prob']) for c in answer['masks']]}; "
                  f"(served, plain route) top ids {tops}")
            # The served top candidate is the plain route's; where the plain
            # route holds two candidates within 2 % of each other's probability
            # (an encoder trained for four steps is still nearly flat over the
            # vocabulary), the two bf16 routes' roundings through 24 layers
            # may break the tie either way, and the served one must be that
            # close second.
            for a, p in zip(answer["masks"], plain["masks"]):
                close = {c["token_id"] for c in p if c["prob"] >= p[0]["prob"] * (1 - 2e-2)}
                check(a[0]["token_id"] in close,
                      f"the served top candidate {a[0]} is not the plain route's {p[:2]}")
        code, answer = post(base + "/fill_mask", {"text": SHORT})
        check(code == 200 and answer == {"masks": []}, f"a text without a mask answered {code} {answer}")
        codes = (post(base + "/generate", {"prompt": SHORT})[0], post(base + "/embed", {"texts": [SHORT]})[0],
                 post(base + "/fill_mask", b"{not json")[0], post(base + "/fill_mask", {"texts": SHORT})[0],
                 post(base + "/fill_mask", {"text": SHORT, "top_k": "many"})[0])
        check(codes == (404, 404, 400, 400, 400), f"/generate, /embed, malformed x3 answered {codes}")
        print("  /generate and /embed on this server 404, malformed payloads 400")
    reset_launch_counts()
    answer = service.handle("/fill_mask", {"text": FILL_MASK_TEXTS[2]})
    counts = launch_counts()
    check_fill_mask(answer, FILL_MASK_TEXTS[2], 10, 0.95)
    print(f"  in-process CLI build, one /fill_mask request: launches {counts}")
    check(counts == ENCODER_FORWARD, f"/fill_mask launch counts {counts} != {ENCODER_FORWARD}")
    del service
    torch.cuda.empty_cache()
    return counts


def mlm_batch(vocab: int, seed: int) -> dict:
    """One mlm_collate batch (B=8, T=512): rows of ragged lengths ending in
    the emb terminator, 15 % of the tokens masked."""
    rng = np.random.default_rng(seed)
    examples = [{"input_ids": rng.integers(4, vocab, size=int(n)).tolist()}
                for n in [T - 1, *rng.integers(T // 4, T, size=TB - 1)]]
    batch = mlm_collate(examples, T, seed=seed, emb_id=EMB_ID)
    return {k: torch.from_numpy(v.astype(np.int64)).to(DEV) for k, v in batch.items()}


def mlm_grads(model, batch, *, mode: str, reference: bool, remat: bool = True) -> dict:
    """Gradients of the MLM loss for every parameter. The loss reaches all
    of them but the untied head, whose gradient stays None."""
    model.zero_grad(set_to_none=True)
    mlm_loss_fn(model, batch, remat=remat, mode=mode, reference=reference).backward()
    grads = {}
    for n, p in model.named_parameters():
        if n == "head.weight":
            check(p.grad is None, "the untied head got a gradient under the MLM loss")
            continue
        check(p.grad is not None and p.grad.dtype == torch.float32
              and bool(p.grad.abs().max() > 0),
              f"{n} got no gradient ({'plain' if reference else 'kernel'} route, {mode})")
        grads[n] = p.grad.detach().clone()
    model.zero_grad(set_to_none=True)
    return grads


def phase_mlm_grads(path: str) -> None:
    """Full-parameter MLM gradients of a 2-layer full-width model over fp32
    master weights at B=8, T=512, remat on, both modes: kernel route against
    plain route in fp32 compute and in bf16 compute; remat on against off;
    the launches of one train step."""
    sd2 = two_layer_sd(path)

    def model_of(dtype):
        cfg = rwkv6_1b6(n_layer=2, dtype=dtype, param_dtype="float32")
        return load_state_dict_into(RWKV(cfg, device=DEV), sd2)

    m32, m16 = model_of("float32"), model_of("bfloat16")
    check(all(p.dtype == torch.float32 for m in (m32, m16) for p in m.parameters()),
          "master weights are not fp32")
    batch = mlm_batch(m32.cfg.vocab_size, 13)
    for mode in ("average", "fused"):
        k32 = mlm_grads(m32, batch, mode=mode, reference=False)
        p32 = mlm_grads(m32, batch, mode=mode, reference=True)
        rel = {n: (k32[n] - p32[n]).abs().max().item() / p32[n].abs().max().item() for n in p32}
        worst = max(rel, key=rel.get)
        print(f"  mlm fp32 compute, mode={mode}, {len(p32)} parameter gradients: max |kernel - plain| "
              f"/ max|plain| = {rel[worst]:.3e} ({worst}; limit 1e-3)")
        check(rel[worst] <= 1e-3, f"mlm fp32 gradient {worst} off by {rel[worst]}")
        k16 = mlm_grads(m16, batch, mode=mode, reference=False)
        p16 = mlm_grads(m16, batch, mode=mode, reference=True)
        margins = {n: cosine(k16[n], p32[n]) - cosine(p16[n], p32[n]) for n in p32}
        worst = min(margins, key=margins.get)
        print(f"  mlm bf16 compute over fp32 masters vs the fp32 plain route, mode={mode}, per "
              f"gradient tensor: min cosine kernel route {min(cosine(k16[n], p32[n]) for n in p32):.6f}, "
              f"plain route in bf16 {min(cosine(p16[n], p32[n]) for n in p32):.6f}; worst margin "
              f"{margins[worst]:+.2e} ({worst}; the kernel route may trail bf16's own by 1e-3)")
        check(margins[worst] >= -1e-3, f"bf16 kernel-route gradient {worst} trails bf16 itself")
        off = mlm_grads(m16, batch, mode=mode, reference=False, remat=False)
        check(all(torch.equal(off[n], k16[n]) for n in k16), "remat on and off give other gradients")
        print(f"  kernel route, bf16, mode={mode}: remat on and off give bit-equal gradients")
    del m32
    apply_trainable_mask(m16, trainable_mask(m16, "full"))
    for remat in (True, False):
        step = make_train_step(m16, TrainConfig(lr_init=1e-5, warmup_steps=0, total_steps=10),
                               lambda m, b: mlm_loss_fn(m, b, remat=remat))
        reset_launch_counts()
        loss = step(batch)["loss"]
        torch.cuda.synchronize()
        counts, want = launch_counts(), encoder_step_counts(2, remat)
        print(f"  launches in one mlm train step (2 layers), remat {'on' if remat else 'off'}: {counts}")
        check(counts == want and bool(torch.isfinite(loss)), f"mlm step counts {counts} != {want}")
        state = step.optimizer.opt.state
        check(all(t.dtype == torch.float32 for st in state.values() for t in st.values()
                  if isinstance(t, torch.Tensor) and t.dim() > 0), "the optimizer state is not fp32")
        del step
    del m16
    torch.cuda.empty_cache()


def text_jsonl(path: Path, tok) -> None:
    """64 identical {"text"} rows whose length falls in the 512 bucket."""
    text = " ".join(["The quick brown fox jumps over the lazy dog."] * 34)
    n = len(tok.encode(text)) + 1
    check(256 < n <= 512, f"the text row takes {n} slots, not in the 512 bucket")
    path.write_text("".join(json.dumps({"text": text}) + "\n" for _ in range(64)))
    print(f"  {path.name}: 64 identical rows of {n} slots (bucket 512, batch 64 * 64 // 512 = 8)")


def phase_mlm_cli(path: str, tmp: Path) -> dict:
    """The encoder trainers' normal entry point on the saved 24-layer model,
    as subprocesses: `mlm` for 4 steps (fp32 master weights, bf16 compute,
    B=8, T=512) and its saved encoder, `mae --dup-mae` for 2 steps; then
    `mlm` in this process, whose launches are the training path's. Returns
    those counts."""
    data = tmp / "text.jsonl"
    text_jsonl(data, WorldTokenizer())
    common = ["--model", path, "--train-data", str(data), "--micro-bsz", "64", "--ctx-len", str(T),
              "--warmup-steps", "0", "--log-every", "1", "--platform", DEV]
    out = tmp / "mlm"
    run_train_cli(["--output-dir", str(out), "--max-steps", "4", *common], command="mlm")
    check((out / "train_log.txt").is_file(), "no train_log.txt")
    base = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    saved = torch.load(out / "encoder-step4.pth", map_location="cpu", weights_only=True, mmap=True)
    check(sorted(saved) == sorted(base), "encoder-step4.pth has other keys than the base checkpoint")
    check(all(saved[k].shape == base[k].shape and saved[k].dtype == torch.float32 for k in base),
          "encoder-step4.pth: a shape or dtype differs")
    key = f"blocks.{max(int(k.split('.')[1]) for k in base if k.startswith('blocks.'))}.att.key.weight"
    moved = float((saved[key] - base[key].float()).abs().max())
    check(moved > 0, f"{key} did not train")
    del base, saved
    model, cfg = load_rwkv_checkpoint(str(out / "encoder-step4.pth"), device=DEV)
    tokens = encoder_tokens(torch.Generator(device=DEV).manual_seed(14), cfg.vocab_size, b=2, t=64)
    with torch.inference_mode():
        hidden = encoder_forward(model, tokens)
    check(cfg == rwkv6_1b6() and bool(torch.isfinite(hidden).all()), "the saved encoder does not load and run")
    print(f"  encoder-step4.pth: the base checkpoint's keys and shapes in fp32, loads with "
          f"load_rwkv_checkpoint and encodes; max |change| of {key} {moved:.2e}")
    del model, hidden
    torch.cuda.empty_cache()

    out = tmp / "mae"
    run_train_cli(["--dup-mae", "--output-dir", str(out), "--max-steps", "2", *common],
                  command="mae", falling=False)
    saved = torch.load(out / "encoder-step2.pth", map_location="cpu", weights_only=True, mmap=True)
    check(not any("onelayer_decoder" in k for k in saved) and "blocks.0.ln0.weight" in saved,
          "mae's saved encoder holds decoder keys")
    del saved

    args = ["--output-dir", str(tmp / "mlm_inproc"), "--max-steps", "2", *common]
    reset_launch_counts()
    train_cli.main(["mlm", *args])
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: 2 * n for k, n in encoder_step_counts(cfg.n_layer, remat=True).items()}
    print(f"  in-process train.cli mlm --max-steps 2: launches {counts}")
    check(counts == want, f"CLI mlm launch counts {counts} != {want}")
    torch.cuda.empty_cache()
    return counts


MLM_STEP_GROUPS = {
    "B.8 forward": ("wkv6_raw_chunked_kernel", "wkv6_kernel"), "K3 forward": ("layer_norm_kernel",),
    "B.8 backward pass 1 (B.6 gn=False)": ("wkv6_bwd_state_chunked_kernel", "wkv6_bwd_state_kernel"),
    "B.8 backward pass 2 (B.7)": ("wkv6_bwd_reverse_chunked_kernel", "wkv6_bwd_reverse_kernel"),
    "partial sums": ("sum_partials",),
    "fp32 GEMMs (the tied head)": ("sgemm", "gemm_f32", "f32f32", "s1688", "s161616"),
    "GEMMs": ("gemm", "nvjet", "xmma", "cutlass"),
    "optimizer (multi-tensor)": ("multi_tensor_apply",),
}


ENCODER_GROUPS = {"B.8": MLM_STEP_GROUPS["B.8 forward"], "K3": ("layer_norm_kernel",),
                  "GEMMs": MLM_STEP_GROUPS["GEMMs"]}


def phase_encoder_readings(path: str, smi: str) -> None:
    """Readings, not benchmark cells: encoder sequences a second at B=64,
    T=512 in bf16, both modes (CUDA events over a data chain); then `mlm`
    train steps of the 24-layer model over fp32 master weights at B=8,
    T=512, remat on: step time, Kt/s, peak memory and a profile."""
    model, cfg = load_rwkv_checkpoint(path, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(15)
    lo, hi, iters = 4, cfg.vocab_size - 4, 3
    for mode in ("average", "fused"):
        tokens = torch.randint(lo, hi, (B, T), device=DEV, generator=gen)

        def step(tokens):
            tokens = tokens.clone()
            tokens[:, -1] = EMB_ID
            hidden = encoder_forward(model, tokens, mode=mode)
            # data chain: the next batch's tokens depend on these hidden states
            delta = (hidden[:, -1, :T].float() * 100.0).abs().to(torch.int64) % 17
            tokens = tokens + delta
            return lo + (tokens - lo) % (hi - lo), hidden

        with torch.inference_mode():
            tokens, hidden = step(tokens)       # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            checksum = torch.zeros((), device=DEV)
            for _ in range(iters):
                last_in = tokens
                tokens, hidden = step(tokens)
                checksum += hidden[:, -1].float().sum()
            end.record()
            torch.cuda.synchronize()
        check(bool(torch.isfinite(checksum)), "non-finite hidden states in the encoder chain")
        chain_canary(lambda x: step(x)[1][:, -1], last_in, hidden[:, -1],
                     lo + (last_in - lo + 1) % (hi - lo), f"encoder_forward mode={mode}")
        seconds = start.elapsed_time(end) / 1e3
        print(f"  reading: {B * iters / seconds:.2f} seq/s encoded (encoder_forward mode={mode}, "
              f"B={B}, T={T}, bf16, {seconds / iters * 1e3:.1f} ms/batch, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB) on {smi}")
        with torch.inference_mode():
            step_profile(lambda x: step(x)[1], tokens, seconds / iters * 1e3, ENCODER_GROUPS,
                         f"one encoder forward (mode={mode})", kernels=ENCODER_KERNELS)
        del hidden
    del model
    torch.cuda.empty_cache()

    model, cfg = load_rwkv_checkpoint(path, device=DEV, param_dtype="float32")
    apply_trainable_mask(model, trainable_mask(model, "full"))
    batch = mlm_batch(cfg.vocab_size, 16)
    step = make_train_step(model, TrainConfig(lr_init=1e-5, warmup_steps=0, total_steps=100),
                           lambda m, b: mlm_loss_fn(m, b, remat=True))
    step(batch)      # warm-up; builds the optimizer state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainable = [p for p in model.parameters() if p.requires_grad]
    ms, losses, before_last = chained_steps(step, batch, iters, trainable)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(losses).all()), f"non-finite mlm losses {losses}")
    train_canary(model, lambda m, b: mlm_loss_fn(m, b, remat=True), trainable, before_last, batch,
                 mlm_batch(cfg.vocab_size, 17), losses[-1], "mlm train steps")
    del before_last
    print(f"  reading: mlm train step {ms:.2f} ms, {TB * T / ms:.2f} Kt/s (every parameter, fp32 "
          f"master weights, bf16 compute, B={TB}, T={T}, mode=average, remat on, peak "
          f"{peak:.1f} GiB, losses {losses[0].item():.4f} .. {losses[-1].item():.4f}) on {smi}")
    step_profile(step, batch, ms, MLM_STEP_GROUPS, kernels=MLM_STEP_KERNELS)
    del model, step
    torch.cuda.empty_cache()


def main() -> None:
    """With no arguments the whole check; with --merge-calibration only the
    readings behind the merged-adapter budgets (merge_calibration)."""
    if sys.argv[1:] not in ([], ["--merge-calibration"]):
        sys.exit("usage: python3 chip_smoke.py [--merge-calibration]")
    calibrate = sys.argv[1:] == ["--merge-calibration"]
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase(f"phase 1: device {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    t0 = time.perf_counter()
    _lib.library()
    print(f"  built and loaded the kernels in {time.perf_counter() - t0:.1f} s")
    if calibrate:
        phase("the merged adapter's margins over adapters trained through each WKV backward body")
        merge_calibration()
        return

    phase("phase 2: kernels vs their plain versions")
    phase_card_rates()
    kernels = phase_kernels()
    kernels.update(phase_backward_kernels())
    kernels.update(phase_wkv_kernels())
    kernels.update(phase_fused_kernels())

    phase("phase 3: synthetic RWKV-6-World-1B6, bf16, embeddings served over HTTP")
    cfg = rwkv6_1b6()
    sd = synthetic_1b6(cfg, seed=0)
    phase_roundtrip(sd)
    model = load_state_dict_into(RWKV(cfg, device=DEV), sd)
    del sd
    # the plain route in fp32 on the same (bf16-rounded) weights
    reference = load_state_dict_into(RWKV(rwkv6_1b6(dtype="float32"), device=DEV), model.state_dict())
    embed_counts = phase_serve(model, cfg, reference)

    phase("phase 4: generation, bf16")
    prompt = phase_generate_bf16(model, reference)

    phase(f"phase 14a: fused decode (rwkv_decode_step(fused_prep=True)), 24 layers, bf16, B={B}")
    fused_counts = phase_fused_decode(model, reference, prompt, "bf16", seed=18)

    phase(f"phase 10a: the bidirectional encoder, 24 layers, B={TB}, T={T}")
    phase_encoder(model, reference)

    phase("phase 5: int8c through the serving CLI")
    arr = next(BiEncoder(model, WorldTokenizer()).token_batches([SHORT, CJK, MIXED]))
    with torch.inference_mode():
        unquantized = embed_sequences(reference, torch.from_numpy(arr).to(DEV), normalize=True,
                                      reference=True).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = str(tmp / "rwkv6_1b6_synthetic.pth")
        t0 = time.perf_counter()
        save_rwkv_checkpoint(model, path)
        print(f"  saved the bf16 model ({Path(path).stat().st_size / 2**30:.2f} GiB) "
              f"in {time.perf_counter() - t0:.1f} s")
        model_q, generate_counts = phase_int8c_cli(path)
        prompt_q = phase_int8c_checks(model_q, reference, weights=model.state_dict())
        phase_int8c_embeddings(model_q, reference, unquantized)

        phase(f"phase 14b: fused decode, 24 layers, int8c, B={B}")
        fused_counts_q = phase_fused_decode(model_q, reference, prompt_q, "int8c", seed=19)
        del reference

        phase("phase 6: serving readings (not benchmark cells)")
        phase_throughput(model, cfg, "bf16", smi)
        phase_decode_readings(model, "bf16", smi)
        phase("phase 14c: decode-step ablation, bf16 (readings)")
        phase_decode_ablation(model, "bf16", smi)
        del model
        phase_throughput(model_q, cfg, "int8c", smi)
        phase_decode_readings(model_q, "int8c", smi)
        phase("phase 14d: decode-step ablation, int8c (readings)")
        phase_decode_ablation(model_q, "int8c", smi, variants=("step", "step_fused"))
        del model_q
        phase("phase 14e: the decode step on a transposed state, op-level comparison (readings)")
        bench_counts = phase_transposed_bench(smi)
        torch.cuda.empty_cache()

        phase(f"phase 7: training gradients, kernel route vs plain route (2 layers, full width, "
              f"B={TB}, T={T})")
        phase_train_grads(path)

        phase(f"phase 8: LoRA train steps of the 24-layer model (B={TB}, T={T}, bf16)")
        phase_train_readings(path, smi)

        phase("phase 9: training through python -m rwkv_lm_ext_tpu_torch.train.cli sft")
        train_counts = phase_train_cli(path, tmp)

        phase(f"phase 11: full-parameter mlm gradients over fp32 master weights, kernel route vs "
              f"plain route (2 layers, full width, B={TB}, T={T})")
        phase_mlm_grads(path)

        phase("phase 12: training through python -m rwkv_lm_ext_tpu_torch.train.cli mlm | mae")
        mlm_counts = phase_mlm_cli(path, tmp)

        phase("phase 10b: /fill_mask through python -m rwkv_lm_ext_tpu_torch.serve.cli --encoder, "
              "on the encoder that phase 12 trained")
        fill_mask_counts = phase_fill_mask(str(tmp / "mlm" / "encoder-step4.pth"))

        phase("phase 13: encoder readings (not benchmark cells)")
        phase_encoder_readings(path, smi)

    # each kernel's launches on a main path that runs it: embedding serving,
    # int8c generation, LoRA training, /fill_mask, the mlm trainer, and the
    # fused decode route on the bf16 model (B.10, B.12) and the int8c one (B.11)
    launches = {k: embed_counts[k] for k in ("layer_norm", "tmix_prologue", "wkv6_fused_output")}
    launches.update({k: generate_counts[k] for k in ("wkv6_decode_step", "quantize_rows")})
    launches.update({k: train_counts[k] for k in NO_BACKWARD})
    launches.update(wkv=fill_mask_counts["wkv"], wkv_bwd_state_pass=mlm_counts["wkv_bwd_state_pass"])
    launches.update({k: fused_counts[k] for k in ("att_prep_fused", "ffn_block_fused")})
    launches.update(ffn_prep_fused=fused_counts_q["ffn_prep_fused"],
                    wkv6_decode_step_transposed=bench_counts["wkv6_decode_step_transposed"])
    check(all(n > 0 for n in launches.values()) and mlm_counts["wkv"] > 0
          and mlm_counts["wkv6_bwd_reverse_pass"] > 0 and fill_mask_counts["layer_norm"] > 0,
          f"a kernel was launched no time on its main path: {launches}")
    print(f"whole script: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", **KERNELS[k], launches=launches[k], **kernels[k])
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
