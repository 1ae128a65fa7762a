#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(`python3 chip_smoke.py --merge-calibration` builds the kernels and prints
only the readings behind phase 9's merged-adapter budgets;
`python3 chip_smoke.py --readings` adds the reading phases 6, 8, 13, 14c,
16d and 17c and the readings of phases 18b, 18c, 20d, 21 and 22, which hold
nothing that a later phase uses and which the default run leaves out for its
time limit.)

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
     at B=8, T=512; the unfused WKV B.8 and its
     two-pass backward the same way, with and without a bonus, an initial
     state, `reverse` and ragged `lengths`, and `wkv6_bi` against the flip
     composition; both bodies of B.8 (chunked, which bf16 runs, and
     sequential) in turns on the same inputs at N = 64 and 32, three decay
     ranges, T = 1 to 512, timed in turns at B=8 and B=64; the fused decode kernels B.10 (attention prologue), B.11
     (channel-mix prologue) and B.12 (whole channel mix) at B=64 and B=1,
     fp32 and bf16, beside the calls each replaces on the unfused step (in
     turns, twice), B.10's cluster body against its row-pair body and its
     sliced mirror, B.11 against its warp-order mirror and B.12 against its
     split mirror, all three timed hot and cold (their weights, B.11's
     inputs, rotated through copies, as a decode step finds them), B.12 by
     its busy time (its launches overlap), and the transposed-state decode
     step B.13 against B.9 (state bit-equal), the two timed in turns, hot in
     place and cold; the collecting WKV B.15 of the speculative verify pass
     at T in {1, 5, 9, 17, 33}, B in {1, 4}, N in {64, 128}, fp32 and bf16
     and on v5's constant decay, timed at B=1, T=9.
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
     against the int8c plain route, one blocking /generate under the
     profiler for B.9's and B.4's launches on the device (its decode blocks
     are graph replays, which the wrappers' counters do not see), held
     against steps x layers; int8c embeddings against the int8c plain
     route;
  6. (with --readings) serving readings (not benchmark cells): embedded seq/s at B=64, T=512
     (a data chain with a canary: its last result must come back from its
     last input and move when that input changes), decode tok/s of
     generate_batch at B=64 and single-stream tok/s of generate on CUDA-graph
     blocks, twice in turns, generate_batch once on eager blocks (the same
     tokens), a generate with other knobs and length (no new capture), and the wall
     time of one 16-step graph block alone beside its device operations and
     busy time, bf16 (int8c: the embedding reading; its generate readings
     with --readings);
  7. training gradients of a 2-layer full-width model at B=8, T=512, kernel
     route against plain route: LoRA A/B in fp32 and in bf16, remat on
     against off, and state tuning's time_state;
  8. (with --readings) LoRA train steps of the 24-layer model at B=8, T=512: the launch
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
     --dup-mae` (2 steps) on the first 4 layers of the 24-layer model as
     concurrent subprocesses, the saved encoder, then `mlm` in this process
     for its launch counts;
 13. (with --readings) encoder readings (not benchmark cells): sequences a second at B=64,
     T=512 in both modes with a profile of one forward (B.8's chunked body
     and not its sequential one), the `mlm` step time, Kt/s, peak memory and
     profile, each chain with its canary;
 14. the fused decode route, `rwkv_decode_step(fused_prep=True, out=state)`,
     on the 24-layer bf16 model (B.10, B.9, B.12) and the int8c model (B.10,
     B.9, B.11, B.4): 16 teacher-forced steps at B=64 against the fp32 plain
     route and the unfused route, the state after them, the launch counts of
     a step, greedy tokens against the unfused route; then readings: (with
     --readings, phase 14c) the bf16 decode-step ablation (step and
     step_fused at B=64 and B=1; the spliced
     step_attprep and step_ffnblk only when phase_decode_ablation is called
     with its default variants: ms a step over a data chain with a canary, device operations and busy
     time of one step, whose profile must name B.10's cluster body and B.12's
     stream kernels) and the op-level comparison of the decode step on the
     logical and on the transposed state;
 15. the serving stack, bf16 then int8c: CUDA-graph decode blocks against the
     same blocks run eagerly, on both routes (generate at K = 1 and 16, greedy
     and sampled; the continuous batcher at K = 16 with 16 slots), tokens and
     final states bit-equal, and each route's launches by kernel in one
     replay (profiler); then `python -m rwkv_lm_ext_tpu_torch.serve.cli`
     with the batcher, the prefix cache, two slot-LoRA adapters and a named
     state (a subprocess, started as the graph-block checks before it begin,
     as phase 5's server is): 32 concurrent /generate requests, 200 through the
     batcher, /process_text, GET /, /stats; the greedy answers again through
     a batcher in this process, each token the argmax of its route's
     teacher-forced logits under its adapter, held to the fp32 plain route
     (bf16: cosine >= 0.999; int8c: as phase 5 holds int8c); the batcher's
     aggregate tok/s;
 16. reranking and the contrastive trainers: (a) gradients of a 2-layer
     full-width model at B=8, T=512, kernel route against plain route, of
     the cross-encoder loss (LoRA + score head), of CoSENT over every
     parameter with fp32 master weights (B.5's full form; fp32, and bf16
     compute against the fp32 plain route) and of the group softmax on the
     bidirectional sentence embedding (B.8, B.6/B.7 with gn=False), and the
     launches of one full-parameter step; (b) the trainers `bi-encoder`,
     `cross-encoder`, `simcse`, `instructor`, `encoder-biencoder`,
     `encoder-crossencoder` and `mae --uni` through `python -m
     rwkv_lm_ext_tpu_torch.train.cli` on the 24-layer model (subprocesses,
     2 steps each), their files under the JAX names, and `nli --sts-file`
     through the same CLI in this process (its launches are B.5's full-form
     main path); (c) `/rerank` and `/embed` through `python -m
     rwkv_lm_ext_tpu_torch.serve.cli --cross-adapter --cross-head
     --bi-adapter` on what (b) trained: the scores against a fp32 plain-route
     reranker on the same merged weights (no further from it than the bf16
     plain route, plus 1e-2 of max|plain|; the cls states at cosine >= 0.999;
     the ranking where no deviation could swap neighbours), 400 on malformed
     payloads, unit-norm embeddings, 404 with no cross-encoder, and the
     launches of the reranker in this process; (d, with --readings)
     readings: reranked pairs/s
     (64 pairs, bucket 512), an `nli` step at B=8, T=512 (ms, Kt/s, busy and
     idle) and B.5's full form in the `nli` step (launches and device ms);
 17. the rest of PEFT training: (a) gradients of a 2-layer full-width model
     at B=8, T=512, kernel route against plain route, in fp32 (1e-3 of max)
     and in bf16 (the cosine margin to the fp32 plain route): QLoRA over
     int8c (B.4 under grad, the straight-through backward), over int8 and
     over nf4, and a 2-layer QLoRA train step over int8c and over int8; a
     TBPTT step at chunk_ctx T/4 over every parameter (K1 / B.6 / B.7 and K2
     / B.5 with a carried state and its gradient), held also to the
     full-sequence loss without L2Wrap on the kernel route; `sft --train-type
     full` over fp32 masters; the `dots` and `dots_nobatch` policies against
     remat on, bit for bit; (b) `python -m rwkv_lm_ext_tpu_torch.train.cli
     sft` with `--train-type pissa`, `--quant int8c`, `--quant nf4` and
     `--train-type slot-lora` (two tasks), `--train-type full --lisa-k 2` and
     `--chunk-ctx 128`, all on the model's first 4 layers (depth cut for the
     script's time limit; subprocesses, 2 steps each), their files under the
     JAX names; then `serve.cli --quant nf4 --chat-adapter --pissa-init` on
     the PiSSA adapter and the same 4 layers:
     a greedy /generate whose tokens are the argmax of the served model's
     teacher-forced logits; (c, with --readings) readings at 24 layers,
     B=8, T=512: the
     int8c QLoRA step and the `full` step (ms
     over chained steps with a canary, Kt/s, busy time, idle share, peak
     memory), B.4's launches in an int8c QLoRA step (192 remat off, 384 on;
     on the device too).
 18. RWKV-5.x and RWKV-4 through the serving path: (a) B.14 (`wkv4`, the
     RWKV-4 recurrence) against its plain version at B in {1, 64}, T in {1,
     17, 512}, fp32 and bf16, from a fresh state (pp = -1e38) and a carried
     one with k up to +60, in place, and timed at B=64, T=512 beside its
     bound; K1 and B.9 on v5's constant decays (per channel and per head,
     with a gate and with ones) and the cost of K1's expanded decay; (b) a
     synthetic RWKV-5-World-1B5 (v5.2, 12 layers, bf16):
     embeddings at B=64, T=512 against the fp32 plain route and the launches
     of the forward (26 K3, 12 K1, no K2), prefill + decode against one
     forward and the launches of a step (26 K3, 12 B.9), greedy generation in graph blocks
     against eager blocks and against its teacher-forced argmax, (with
     --readings) readings (seq/s embedded, generate_batch and generate
     tok/s), and `python -m
     rwkv_lm_ext_tpu_torch.serve.cli --model` on its first 4 layers (a
     subprocess: one greedy /generate, the in-process engine's text); (c) a
     synthetic RWKV-4-World-1.5B (12 layers, C=2048, F=8192,
     bf16): logits at B=64, T=512 against the fp32 plain route and the
     launches of the forward and of a step (26 K3, 12 B.14 each), greedy generation as in
     (b), the continuous batcher over 8 concurrent requests (each row the
     argmax of its teacher-forced logits), and (with --readings) readings
     (prefill seq/s, decode tok/s).
 19. evaluation and the apps on the first 4 layers of the bf16 model that
     phase 3 saved (depth cut for the script's time limit), over a
     seeded BEIR dump (64 queries, 512 documents of 20-400 tokens), 256 STS
     pairs, 64 rerank rows of 8 documents, a ppl corpus of 32 pieces and a
     score head: (a) `python -m rwkv_lm_ext_tpu_torch.eval.cli parity` (a
     subprocess): the bf16 kernel route's embedding drift from the fp32
     plain route within its 1e-3 target, its retrieval scores this
     process's on the same routes; (b) `eval.cli retrieval-task
     --score-head --rerank-top-k 10` (a subprocess, beside (a)), then `sts`,
     `rerank` and `ppl` through `main(argv)` in this process on one loaded
     model, their K1 / K2 / K3 launches (and one forward's kernels on the
     device by name); the rerank metrics, and the dense retrieval metrics
     over 128 of the documents (every relevant one, then every 4th), equal
     to the fp32 plain route's on every row no score's deviation could
     reorder (phase 16c's rule); `ppl` no further from the fp32 plain route
     than twice the bf16 plain route is (or twice that gap's standard
     error), and per token the kernel route's mean |log p| error at most
     twice the bf16 plain route's; (c) `RagChat.answer` over
     `LocalRetriever` on the 512 documents, 32 greedy tokens in graph
     blocks, each the argmax of the engine route's teacher-forced logits,
     cosine >= 0.999 to the fp32 plain route; `KGExtractor.extract` through
     the named state of phase 15 (the schema's two lists); readings:
     documents embedded a second, ppl tokens a second, the phase's wall
     time.
 20. training the RWKV-5.x and RWKV-4 families, head size 128, dropout and
     ROADMAP C.24: (a) B.14's backward kernel against autograd through
     wkv4_plain at B=8, C=2048, T in {1, 15, 17, 512}, fp32 (1e-4 of max) and
     bf16 (2e-2), from a fresh state (pp = -1e38) and a carried one with k up
     to 60, under gradients of y and of the final state (the initial
     state's gradient held too), two calls bit-equal, and timed at B=8,
     T=512 beside its bound; (b) K1 with B.6 / B.7, B.8 with its backward and
     B.9 at N = 128 (H = 16) against their plain versions in fp32 and bf16,
     and timed beside their bounds; (c) 2-layer RWKV-5-World-1B5 (v5.2) and
     RWKV-4-World-1.5B models at full width: LoRA gradients kernel route
     against plain route in fp32 (1e-3) and bf16 (C24_BOUND), and TBPTT
     over every parameter (fp32); (d) 12-layer LoRA and `full` steps of both
     at B=8, T=512: their launches (exact; with --readings also on the
     device: K1 / B.6 / B.7, B.14 and its backward, and ms over chained
     steps with the canary, busy time, idle share and peak memory); (e)
     `train.cli simcse --dropout-noise`, 3 steps at 2 layers and full width,
     the two views apart under its dropout and bit-equal at rate 0; (f) the
     C.24 probe: over nf4 QLoRA and `full` (2 layers, bf16), the gradients
     layer by layer and every kernel-backed op replayed on the plain route's
     recorded inputs and output gradients, the kernel's error from the fp32
     op against the bf16 plain op's: the first op where they part beyond
     C24_BOUND is named, and none may.
 21. speculative decoding on the 24-layer bf16 1B6 model (run after phase
     14c): `python -m rwkv_lm_ext_tpu_torch.serve.cli --draft-layers 4
     --gamma 8` and `--draft` on a seeded RWKV-6 draft of 12 layers, C=768,
     saved as a .pth (two subprocesses, started together, serving while the
     in-process checks run): greedy and sampled /generate answered by
     "speculative", a penalized one by "engine", /stats' acceptance; in this
     process the collect forward against the forward and states[j] against
     a prefix forward (drift and state bounds), greedy and sampled rounds as
     graph replays bit-equal to eager rounds, B.15's launches (24 a replayed
     round, on the device), the fp32 greedy identity with the engine at 4
     layers (a first divergence allowed only inside the routes' logit
     deviation), RWKV-5.2 (1B5 widths, 4 layers) through the collect forward
     and RWKV-4 (4 layers, fp32) through the re-prefill rollback; (with
     --readings) readings: the verify pass's ms (CUDA events), single-stream
     tok/s against the engine's generate in turns, acceptance and tokens a
     target pass.
 22. tensor-parallel serving (run after phase 2): two ranks (processes of
     this script, ``tp_rank``) over gloo where they share the card, NCCL where
     each has one, the seeded 1B6 at 12 layers (TP_LAYERS; 24 before the
     script's time limit needed it) cut into 16 heads a rank: fp32
     logits at B=4, T=512 no further from the single-process kernel route
     than its fp32 plain route is (the same run's rounding gap, x max) and
     16 greedy tokens equal to the single-process engine's; bf16
     logits at a mean cosine >= 0.999 to the fp32 plain route, the worst
     position no more than twice as far as the single-process bf16 route's,
     and greedy tokens that are the argmax of the same route's
     teacher-forced logits on each rank;
     int8c: B.4's codes and scales on each rank's slice (its given-scale
     entry), the row-parallel product and the logits bit-equal to
     single-process int8c; K1, K2, K3, B.9 (and B.4's two entries under
     int8c) counted on each rank; then `python -m
     rwkv_lm_ext_tpu_torch.serve.cli --tp 2 --batcher-slots 4` (fp32, the
     model cut to 4 layers at full width, with a bi-encoder adapter) loading
     while the ranks run: 8 concurrent greedy /generate answers equal to the
     single-process CLI's (built in this process meanwhile), unit-norm
     /embed, /stats' route, a 200 KB request answered 400 and the next one
     200; readings: the route, tp=2 decode tok/s and (with --readings) each
     rank's busy ms.
 23. multi-process training (run after phase 22): two ranks (processes of
     this script, ``mp_rank``; gloo where they share the card, NCCL where each
     has one) on the seeded 1B6 widths. dp=2 LoRA at 24 layers, bf16, B=8
     global (4 rows a rank, token counts apart), T=512, two steps: the loss
     within 1e-3 of the single-process kernel route's on the same 8 rows,
     each of the first step's gradients no farther from the single-process
     fp32 route than C24_BOUND times the single-process bf16 route (1 -
     cosine, floor 1e-3; the comment above MP_FULL_REL says why not the
     capped form) and the norms held as the comment above MP_NORM says.
     dp=2 `full` over fp32 masters at 8 layers in fp32 with
     the ZeRO AdamW: gradients within 1e-5 of max of the single-process
     kernel route's sum over the same two halves of the rows (their and that
     sum's distance from the whole batch's printed) and, against the whole
     batch, as tp and pp are held below; each rank's Adam moment bytes at
     most half the single-process optimizer's. tp=2 LoRA at 12 layers
     (MP_TP_LORA_LAYERS; 24 before phase 24 needed the time) and
     tp=2 `full` and pp=2 (n_micro=4, `full`) at 8 layers, fp32, on all 8
     rows (dp, tp and pp `full` train the cross entropy without L2Wrap,
     JAX's pipeline loss, against one single-process reference): each
     gradient tensor within 1 - cosine 1e-2 of the single-process fp32
     kernel route's (MP_FP32_COS says why no tighter), its norm within the
     noise its cosine shows and the whole gradient's norm within 1e-2
     (MP_NORM: a cosine ignores scale), the loss within 1e-5. K2, K3,
     K1, B.5, B.6 and B.7 counted on each rank; readings with the card's
     name and power limit: each rank's step wall and busy ms, collectives a
     step, peak memory and Adam moment bytes. Beside the ranks' tp and pp
     parts, `python -m rwkv_lm_ext_tpu_torch.train.cli sft --dtype float32`
     on 2 layers at full width, 2 steps: `--dp 2` and `--tp 2` (LoRA) and
     `--pp 2 --n-micro 4` (`full`) together, beside the single-process runs
     in this process (the pp run's without L2Wrap): rank 0 alone logs, every
     rank exits 0, the logged losses agree within 1e-5 and grad norms within
     1e-3, and each tensor of the written file moved as the single-process
     run's did (the updates within 1 - cosine 1e-2; MP_CLI_COS says why not
     elementwise). ``dp_tp_run()``, which the script does not call, runs
     dp=2 x tp=2 LoRA in fp32 on four ranks (NCCL on a
     four-card host) against the single-process fp32 route the same way.
 24. sequence parallelism and the other trainers under --dp (run after phase
     23): two ranks (processes of this script, ``sp_rank``; gloo where they
     share the card, NCCL where each has one), the time axis of one sequence
     of T=8192 cut in two (4096 tokens a rank, ``make_sp_mesh``): the sp WKV
     (``wkv6_sequence_parallel``) in bf16 at the 1B6's heads (H=32, N=64)
     against one B.8 call over the whole T (y and the final state within
     2e-4 x max, SP_WKV_REL) and B.8 against wkv_chunked's plain version
     (``wkv_tiled_plain``, JAX's tiled decomposition) on one shard (1e-4,
     both timed); ``rwkv_forward_sequence_parallel`` on the seeded 1B6 at 24
     layers: fp32 logits no further from the single-process fp32 kernel
     route over the whole T than its fp32 plain route is, bf16 logits at a
     mean cosine >= 0.999 to the fp32 plain route, and the launches of the
     forward on each rank (50 K3, 24 B.8); one backward of the causal-LM
     loss at 8 layers in fp32, the ranks' gradients summed over the group
     held as phase 23 holds its fp32 gradients (MP_FP32_COS, MP_NORM)
     against the single-process kernel route's, K3, B.8, B.6 (gn=False) and
     B.7 counted on each rank (the sp time mix takes its projections in
     plain torch ops, as JAX's does: no K2, no B.5); readings with the
     card's name and power limit: each rank's forward wall (and, with
     --readings, busy) ms, collectives a layer, peak memory, the backward's
     wall, and each part's seconds. Beside the ranks, `python -m
     rwkv_lm_ext_tpu_torch.train.cli bi-encoder --loss infonce` (gathered
     embeddings), `encoder-crossencoder` (whole groups a rank) and `mlm`
     (global counts) with `--dp 2 --dtype float32` on 2 layers at full
     width, 2 steps, all at once, against the single-process runs in this
     process as phase 23 holds its CLIs; and `wkv4_parallel` (the
     associative scan, plain ops) against B.14 at B=8, T=512, C=2048 in fp32
     (1e-4 x max), both timed.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result. Without a CUDA device it exits non-zero
before doing anything.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import copy
import functools
import gc
import importlib
import io
import json
import math
import os
import queue
import signal
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
    lora_state_dict,
    lora_state_dict_to_tree,
    merge_lora,
    merge_pissa,
)
from rwkv_lm_ext_tpu_torch.adapters.quant import QuantLinear, quantize_linear, quantize_model
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import build_slot_lora, set_slot_idx
from rwkv_lm_ext_tpu_torch.apps.kg import KGExtractor
from rwkv_lm_ext_tpu_torch.apps.rag import RAG_TEMPLATE, LocalRetriever, RagChat
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_rwkv_checkpoint,
    load_state_dict_into,
    save_rwkv_checkpoint,
    score_head_from_state_dict,
)
from rwkv_lm_ext_tpu_torch.config import (
    CLS_ID,
    EMB_ID,
    MASK_ID,
    SEP_ID,
    TrainConfig,
    rwkv4_1b5,
    rwkv5_1b5,
    rwkv6_1b6,
)
from rwkv_lm_ext_tpu_torch.data.collators import mlm_collate
from rwkv_lm_ext_tpu_torch.data.sft import encode_sft_example
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.eval import cli as eval_cli
from rwkv_lm_ext_tpu_torch.eval.retrieval import metrics_from_sims, rerank_metrics
from rwkv_lm_ext_tpu_torch.eval.tasks import RetrievalTask, run_retrieval_task
from rwkv_lm_ext_tpu_torch.infer import engine as engine_module
from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder, CrossEncoder, pair_ids
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
speculative = importlib.import_module("rwkv_lm_ext_tpu_torch.infer.speculative")   # the module
from rwkv_lm_ext_tpu_torch.infer.speculative import SpeculativeEngine, truncated_draft
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache
from rwkv_lm_ext_tpu_torch.infer.states_registry import StatesRegistry
from rwkv_lm_ext_tpu_torch.models.bidirectional import encoder_forward, sequence_lengths
from rwkv_lm_ext_tpu_torch.models.collect import (
    collect_supported,
    rwkv_forward_collect,
    select_state,
)
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.heads import (
    embed_sequences,
    first_token_position,
    init_classification_head,
)
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
rwkv_models = importlib.import_module("rwkv_lm_ext_tpu_torch.models.rwkv")   # the module
from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS, RWKV, Dropout
from rwkv_lm_ext_tpu_torch.models.state import clone_state, init_model_state
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
from rwkv_lm_ext_tpu_torch.ops.quant import (
    quantize_rows,
    quantize_rows_given,
    quantize_rows_given_plain,
    quantize_rows_plain,
)
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
wkv4_ops = importlib.import_module("rwkv_lm_ext_tpu_torch.ops.wkv4")   # the module
from rwkv_lm_ext_tpu_torch.ops.wkv_collect import wkv6_collect, wkv6_collect_plain
from rwkv_lm_ext_tpu_torch.ops.wkv4 import (
    init_wkv4_state,
    wkv4,
    wkv4_bwd,
    wkv4_parallel,
    wkv4_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_chunked import wkv_tiled_plain
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
from rwkv_lm_ext_tpu_torch.parallel import distributed
from rwkv_lm_ext_tpu_torch.parallel.distributed import (
    init_distributed,
    make_hybrid_mesh,
    rank_device,
    shutdown,
)
from rwkv_lm_ext_tpu_torch.parallel.mesh import make_mesh
from rwkv_lm_ext_tpu_torch.parallel.pipeline import make_pp_mesh
from rwkv_lm_ext_tpu_torch.parallel.sequence import (
    make_sp_mesh,
    rwkv_forward_sequence_parallel,
    wkv6_sequence_parallel,
)
from rwkv_lm_ext_tpu_torch.parallel.tp import row_parallel_int8c, shard_for_training
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http
from rwkv_lm_ext_tpu_torch.train import cli as train_cli
from rwkv_lm_ext_tpu_torch.train import loop as train_loop
from rwkv_lm_ext_tpu_torch.train.loop import (
    GlobalBatch,
    contrastive_loss_fn,
    cross_encoder_loss_fn,
    encoder_crossencoder_loss_fn,
    make_pp_train_step,
    make_train_step,
    mlm_loss_fn,
    sft_loss_fn,
    tbptt_loss_fn,
)
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
    # B.4's given-scale entry: the tensor-parallel int8c row-parallel projections
    "quantize_rows_given": dict(source="rwkv_lm_ext_tpu_torch/csrc/quant.cu",
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
    # RWKV-4's WKV: an XLA lax.scan in the JAX package, not a Pallas kernel
    "wkv4": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv4.cu",
                 replaces="rwkv_lm_ext_tpu/ops/wkv4.py:23"),
    # its backward: XLA's autodiff of that scan in the JAX package
    "wkv4_bwd": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv4.cu",
                     replaces="rwkv_lm_ext_tpu/ops/wkv4.py:23"),
    # the speculative verify pass's WKV keeping every state: wkv_collect, an
    # XLA lax.scan in the JAX package, not a Pallas kernel
    "wkv6_collect": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_collect.cu",
                         replaces="rwkv_lm_ext_tpu/ops/wkv_reference.py:80"),
}
NO_BACKWARD = {"tmix_prologue_bwd": 0, "wkv6_bwd_forward_pass": 0, "wkv6_bwd_reverse_pass": 0,
               "wkv_bwd_state_pass": 0, "wkv4_bwd": 0}
# the kernels that only rwkv_decode_step(fused_prep=True) and the transposed
# decode step launch: no other path runs them
NO_FUSED = {"att_prep_fused": 0, "ffn_prep_fused": 0, "ffn_block_fused": 0,
            "wkv6_decode_step_transposed": 0}
# launches per forward of the 24-layer model: ln0 + 24 ln2 + ln_out, and one
# prologue and one WKV per layer; a decode step swaps K1 for the decode
# kernel; int8c adds 8 row quantizations a layer (5 att + 3 ffn projections)
PER_FORWARD = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 24,
               "wkv6_decode_step": 0, "quantize_rows": 0, "wkv": 0, "wkv4": 0, "wkv6_collect": 0,
               "quantize_rows_given": 0, **NO_BACKWARD, **NO_FUSED}
PER_STEP = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 0,
            "wkv6_decode_step": 24, "quantize_rows": 0, "wkv": 0, "wkv4": 0, "wkv6_collect": 0,
            "quantize_rows_given": 0, **NO_BACKWARD, **NO_FUSED}
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
PHASE_STARTS = []      # (phase, seconds since T_START)
READINGS = False       # set by main(): --readings adds the reading-only parts


def phase(title: str) -> None:
    """A phase's header, with the script's time so far."""
    now = time.perf_counter() - T_START
    PHASE_STARTS.append((title.split(":")[0], now))
    print(f"{title} [{now:.0f} s]", flush=True)


def phase_seconds() -> str:
    """Each phase's wall seconds, from its header to the next one's (the
    last to now), in the order they ran."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter() - T_START]
    return ", ".join(f"{name} {end - t:.1f}" for (name, t), end in zip(PHASE_STARTS, ends))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ops(fn, reps: int, patient: bool = True) -> list:
    """The device operations that `reps` calls of fn() launch, as
    torch.profiler records them, after one warm-up. The canary of every time
    read from such a trace: the operation that the record holds most often
    must be there for (nearly) every one of the `reps` calls. The profiler
    on an H100 was seen to return no record at all (50 launches of a 10 us
    kernel) and to lose records (19 of 20, and 8 of 10, three traces in a
    row each, and once a third trace with no record after two that lost
    two in ten, and once four traces that lost two in ten and a fifth with
    no record). One record in ten may be missing (one, from 4 calls on); a
    trace that lost more is taken again, six times at most, each time
    waiting longer between the last launch's end and the profiler's stop.
    The seventh trace is taken as it is if it holds the operation for half
    the calls or more (per_call_us works from the records that remain); if
    it holds fewer, the timed calls did not run and the script fails. Not
    `patient` (a time, which per_call_us reads from the records that remain,
    not a count of launches): a trace that holds the operation for half the
    calls or more is taken as the seventh would be as soon as two traces in
    a row held it the same number of times, a loss that retakes were seen
    to repeat (7 of 10 calls, seven traces in a row, in several phases)."""
    fn()
    allowed = 0 if reps < 4 else max(1, reps // 10)
    pauses = (0.0, 0.05, 0.25, 0.5, 1.0, 2.0, 2.0)
    before = None
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
        settled = attempt == len(pauses) - 1 or (not patient and most == before)
        taken = settled and most > 0 and 2 * most >= reps
        print(f"  (a profiler trace held {len(ops)} device operations, the most frequent {most} "
              f"times, for {reps} calls; {'taken as it is' if taken else 'taken again'})")
        if taken:
            return ops
        before = most
    raise AssertionError(f"{len(pauses)} profiler traces in a row held their most frequent device "
                         f"operation "
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
    return per_call_us(device_ops(fn, reps, patient=False), reps) / 1e3


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
    return busy_us(device_ops(fn, reps, patient=False)) / reps / 1e3


def device_ms_by_kernel(fn, reps: int, groups: dict) -> dict:
    """As device_ms, split by kernel name: {group: ms of one call} for the
    device operations whose name holds one of the group's substrings."""
    ops = device_ops(fn, reps, patient=False)
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
    # B.4's given-scale entry at the tp=2 row-parallel shapes (a rank's half
    # of att.output's and ffn.value's inputs, prefill and decode rows): at
    # the whole rows' scales, then at larger ones (another rank's slice)
    for shape in ((B * T, C // 2), (TP_B * TP_T, F // 2), (37, 2050), (TP_B, C // 2)):
        xg = rng.normal(*shape, scale=3.0)
        q, sx = quantize_rows(xg)
        same = all(torch.equal(quantize_rows_given(xg, s_), quantize_rows_given_plain(xg, s_))
                   for s_ in (sx, sx * 1.37))
        same = same and torch.equal(quantize_rows_given(xg, sx), q)
        print(f"  quantize_rows_given {shape}: q {'bit-identical' if same else 'DIFFERS'} to plain "
              f"and to quantize_rows at its scales")
        check(same, f"quantize_rows_given {shape} is not bit-identical to its plain version")
    xg = rng.normal(B * T, C // 2, scale=3.0)
    _, sg = quantize_rows(xg)
    out["quantize_rows_given"] = dict(
        max_abs_err=0.0,
        ms=device_ms(lambda: quantize_rows_given(xg, sg), 20),
        plain_ms=device_ms(lambda: quantize_rows_given_plain(xg, sg), 20),
        # x and a scale a row in, int8 out; one division and a rounding an element
        **roofline(nbytes(xg, sg) + xg.numel(), {"fp32": 2 * xg.numel()}),
    )

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
    # both bodies in turns, both forms
    times = {}
    for body in B5_BODIES:
        times[body] = (device_ms(lambda: tmix_prologue_bwd(*args, cts, weights=False, body=body), 5),
                       device_ms(lambda: tmix_prologue_bwd(*args, cts, body=body), 5))
        print(f"  B.5 at B={TB}, T={T}, bf16, {body}: dx and dshift only (LoRA) "
              f"{times[body][0]:.4f} ms, with the weight gradients {times[body][1]:.4f} ms")
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
        ms=times["tensor_cores"][1],
        plain_ms=device_ms(lambda: tmix_prologue_bwd_plain(*args, cts), 3),
        # reads the forward's inputs and five cotangents, writes a gradient
        # for every input; the forward's two products again and two adjoint
        # products for each, and ~60 fp32 an element of elementwise adjoints
        **roofline(2 * nbytes(*args) + nbytes(*cts),
                   {"bf16 mma": 3 * 2 * 2 * TB * T * C * 5 * D, "fp32": 60 * TB * T * C}),
        dx_only_ms=times["tensor_cores"][0],
        dx_only_bound_ms=dx_only_bound["bound_ms"],
    )
    o = out["tmix_prologue_bwd"]
    print(f"  B.5 with the weight gradients: tensor cores {o['ms']:.4f} ms, CUDA cores "
          f"{times['cuda_cores'][1]:.4f} ms; bound {o['bound_ms']:.4f} ms by {o['bound_by']}: "
          f"{100 * o['bound_ms'] / o['ms']:.1f} %; plain (autograd) {o['plain_ms']:.4f} ms")
    print(f"  B.5 dx-only (LoRA): tensor cores {o['dx_only_ms']:.4f} ms, CUDA cores "
          f"{times['cuda_cores'][0]:.4f} ms; bound {o['dx_only_bound_ms']:.4f} ms by "
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
    # encoder's (gn=False, u, zero state in): both bodies in turns
    args = wkv_case(TB, T, H, N, BF16)
    args = args[:8] + (None, args[9], None)
    r, k, v, w, u, g, lsc, lbi, _, dout, _ = args
    dy = rng.normal(TB, T, H, N, dtype=torch.float32)
    groups = {"B.6": ("wkv6_bwd_forward",), "B.7": ("wkv6_bwd_reverse",)}
    groups_nogn = {"B.6 gn=False": ("wkv6_bwd_state",), "B.7": ("wkv6_bwd_reverse",)}
    times = {}
    for body in WKV_BWD_BODIES:
        fused = device_ms_by_kernel(lambda: wkv6_fused_output_bwd(*args, eps=LN_X_EPS, body=body), 5,
                                    groups)
        nogn = device_ms_by_kernel(lambda: wkv_bwd(r, k, v, w, u, None, dy, None, body=body), 5,
                                   groups_nogn)
        times[body] = dict(fused, **{"B.6 gn=False": nogn["B.6 gn=False"],
                                     "B.7 (gn=False)": nogn["B.7"]})
        print(f"  WKV backward at B={TB}, T={T}, H={H}, N={N}, bf16, {body} body: "
              + ", ".join(f"{n} {ms:.4f} ms" for n, ms in times[body].items()))
    plain = device_ms(lambda: wkv6_fused_output_bwd_plain(*args, eps=LN_X_EPS), 2)
    k1 = device_ms(lambda: wkv6_fused_output(*args[:8], eps=LN_X_EPS), 5)
    chunked = times["chunked"]
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
        print(f"  {key}: chunked {o['ms']:.4f} ms, sequential {times['sequential'][key]:.4f} ms; bound "
              f"{o['bound_ms']:.4f} ms by {o['bound_by']}: chunked at {100 * o['bound_ms'] / o['ms']:.1f} %, "
              f"sequential at {100 * o['bound_ms'] / times['sequential'][key]:.1f} %")
    return out


def synthetic_1b6(cfg, seed: int) -> dict:
    """Seeded full-width weights of cfg's family (RWKV-6, and for phase 18
    RWKV-5.x and RWKV-4: init_rwkv_params follows cfg.version); the
    projections that init zeroes (att.output, ffn.value, ffn.receptance,
    which would make every block a no-op) get small seeded values."""
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
    plain = plain_teacher_forced(reference, [prompt.tolist()], [out])[0]
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
        if not hasattr(self, "proc"):
            self.start()
        return self.url()

    def start(self) -> None:
        """Start the server; url() waits until it serves (a caller may
        start it ahead of its ``with`` block, to load while other work runs;
        then a failure before that block stops it at exit)."""
        self.started = time.perf_counter()
        # a session of its own: stop() can end whatever the server started
        # (the ranks of --tp) even if the server itself dies first
        self.proc = subprocess.Popen(self.cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True,
                                     start_new_session=True)
        atexit.register(self.stop)
        self.lines: "queue.SimpleQueue" = queue.SimpleQueue()

        def pump():
            for line in self.proc.stdout:
                self.lines.put(line)
            self.lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
        self.deadline = time.monotonic() + self.timeout

    def url(self) -> str:
        while True:
            try:
                line = self.lines.get(timeout=max(self.deadline - time.monotonic(), 0.1))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"{' '.join(self.cmd)} printed no 'serving on' line "
                                     f"(exit code {self.proc.poll()})")
            if line.startswith("serving on "):
                return line.split()[-1]

    def __exit__(self, *exc):
        self.stop()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)    # anything the server left


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


def device_launches(fn) -> tuple:
    """(fn()'s result, its device kernel launches by name) from one profiler
    trace: replays of CUDA graphs count each kernel they run, which the
    wrappers' counters (bumped where a kernel is recorded into a graph, at
    capture) do not see."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.25)
    return out, collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)


def int8c_cli_args(path: str) -> list:
    return ["--model", path, "--quant", "int8c", "--platform", DEV, "--port", "0"]


def phase_int8c_cli(path: str, server: "CliServer | None" = None) -> tuple:
    """Serve the saved model with --quant int8c through the CLI: as a
    subprocess (``server``, maybe started already), then built by the same
    CLI code in this process (where the
    launch counts can be reset). The wrappers' counts run from before the
    server's warm-up (which captures the engine's decode graphs) to after
    the /generate requests; then one more blocking /generate under the
    profiler, whose decode blocks are graph replays, gives B.9's and B.4's
    launches on the device, held against steps x layers. Returns (int8c
    model, those device launches by counter name)."""
    args = int8c_cli_args(path)
    server = server or CliServer(args)
    t0 = time.perf_counter()
    with server as base:
        print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli {' '.join(args)}: serving on {base} "
              f"after {time.perf_counter() - server.started:.1f} s "
              f"({time.perf_counter() - t0:.1f} s of it waited for)")
        generate_requests(base)

    service = cli.build_service(cli.parse_args(args))
    model_q = service.engine.model
    check(all(isinstance(blk.ffn.value, QuantLinear) and blk.ffn.value.mode == "int8c"
              for blk in model_q.blocks), "the CLI's model is not int8c")
    greedy = {"prompt": SHORT, "max_tokens": 32, "temperature": 0.0, "token_stop": []}
    reset_launch_counts()
    with Served(service) as base:
        code, out = post(base + "/generate", greedy)
        events = post_sse(base + "/generate", {**greedy, "stream": True})
        counts = launch_counts()
        (code2, again), device = device_launches(lambda: post(base + "/generate", greedy))
    check(code == code2 == 200 and events[-1]["output"] == out["output"] == again["output"],
          "in-process int8c /generate")
    print(f"  in-process CLI build, warm-up + /generate blocking + SSE: wrapper launches {counts}")
    check(all(n > 0 for k, n in counts.items()
              if k not in NO_BACKWARD and k not in NO_FUSED
              and k not in ("wkv", "wkv4", "wkv6_collect", "quantize_rows_given")),
          f"a kernel's wrapper did not run in /generate: {counts}")
    pieces = len(engine_module._chunk_plan(len(WorldTokenizer().encode(SHORT)),
                                           service.engine.chunk_len))
    want = {"wkv6_decode_step": ("wkv6_decode_kernel", 24 * 32),
            "quantize_rows": ("quant_rows", INT8C_PER_LAYER * 24 * (32 + pieces))}
    launches = {}
    for key, (kernel, n) in want.items():
        launches[key] = sum(c for name, c in device.items() if kernel in name)
        # the profiler may lose one record in ten
        check(n * 0.9 <= launches[key] <= n, f"/generate ran {launches[key]} {kernel} on the "
              f"device, not {n} (32 decode steps and {pieces} prefill pieces of 24 layers)")
    print(f"  one more blocking /generate (32 tokens: two 16-step graph replays after a prefill of "
          f"{pieces} pieces) under the profiler: device launches {launches}")
    return model_q, launches


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
    unquantized = plain_teacher_forced(reference, [prompt.tolist()], [out])[0]
    quantize_model(reference, "int8c", weights=weights)
    kern = teacher_forced(model_q, prompt, toks, reference=False)
    plain = plain_teacher_forced(reference, [prompt.tolist()], [out])[0]
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


def eager_blocks():
    """Within it, the engine's and the batcher's decode blocks run their
    private eager bodies on the card in place of the graph replays: the
    other side of the graph-against-eager checks and readings."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(engine_module._Decoder, "_replay",
                                          engine_module._Decoder._block))
    stack.enter_context(mock.patch.object(ContinuousBatcher, "_replay",
                                          lambda self, key, body: body()))
    return stack


def timed_s(fn) -> tuple:
    """(fn()'s result, its wall seconds), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_decode_readings(model, label: str, smi: str) -> None:
    """Decode tok/s: generate_batch at B=64 (16-token prompts, 128 new
    tokens, default sampling without stops) and single-stream generate
    (B=1, 128 tokens, block_size=16), as CUDA-graph blocks twice, in turns
    (host clock around synchronised work), and generate_batch once as eager
    blocks, which must give the graph blocks' tokens (the 64-row decoder's
    graph against its eager blocks; the eager generate's reading is left out
    for the script's time limit: PERF.md §5 has it, and phase 15a holds the
    one-row graph blocks bit-equal to the eager ones); a generate with other
    knobs and a length that is no multiple of 16 (no new capture); then one
    16-step block of
    each alone: its wall time (replay and fetch, synchronised, a mean of
    BLOCK_REPS), and under the profiler its device operations and busy
    time."""
    engine = GenerationEngine(model)
    sp = SamplingParams(token_stop=())
    gen = torch.Generator(device=DEV).manual_seed(7)
    prompts = torch.randint(4, model.cfg.vocab_size, (B, 16), device=DEV, generator=gen).tolist()
    runs = {
        "generate_batch": lambda: engine.generate_batch(prompts, max_tokens=128, sampling=sp, seed=1),
        "generate": lambda: engine.generate(prompts[0], max_tokens=128, sampling=sp,
                                            block_size=16, seed=1),
    }
    rows = {"generate_batch": B, "generate": 1}
    decoders = {"generate_batch": engine._decoder(sp, B, 0),
                "generate": engine._decoder(sp, 1, engine_module.STOP_CAPACITY)}
    outs, secs = {}, collections.defaultdict(list)
    for fn in runs.values():                     # warm-up: the captures
        fn()
    for _ in range(2):
        for name, fn in runs.items():
            outs[name, "graph"], t = timed_s(fn)
            secs[name, "graph"].append(t)
    with eager_blocks():
        eager, t_eager = timed_s(runs["generate_batch"])
    check(eager == outs["generate_batch", "graph"],
          f"generate_batch {label}: graph blocks and eager blocks gave different tokens")
    check(all(len(r) == 128 for r in outs["generate_batch", "graph"])
          and len(outs["generate", "graph"]) == 128, "decode readings: not 128 tokens a row")
    other = SamplingParams(temperature=0.7, top_p=0.5, alpha_presence=0.1, repetition_penalty=1.2,
                           token_stop=())
    graphs = {n: set(d.graphs) for n, d in decoders.items()}
    varied, t_varied = timed_s(lambda: engine.generate(prompts[1], max_tokens=100, sampling=other,
                                                       block_size=16, seed=2))
    check(len(varied) == 100 and {n: set(d.graphs) for n, d in decoders.items()} == graphs
          and len(engine._decoders) == 2, f"{label}: other knobs or length captured a new graph")
    print(f"  reading: generate with other knobs (temperature 0.7, top_p 0.5, penalties) and 100 "
          f"new tokens on the warm engine ({label}): {t_varied * 1e3:.1f} ms, "
          f"{100 / t_varied:.1f} tok/s, no new capture, on {smi}")
    for name, b in rows.items():
        rates = [b * 128 / t for t in secs[name, "graph"]]
        dec = decoders[name]
        with torch.inference_mode():
            _, wall = timed_s(lambda: [dec.run(16, engine._gen).tolist() for _ in range(BLOCK_REPS)])
            ops = device_ops(lambda: dec.run(16, engine._gen), 1)
        busy, wall = busy_us(ops) / 1e3, wall / BLOCK_REPS * 1e3
        graph = " / ".join(f"{r:.1f}" for r in rates)
        eager_rate = (f", eager blocks {b * 128 / t_eager:.1f} tok/s (once, after)"
                      if name == "generate_batch" else "")
        print(f"  reading: {name} (B={b}, 128 new tokens, {label}): graph blocks {graph} tok/s "
              f"(two runs in turns with the other reading){eager_rate}; one "
              f"16-step graph block alone: {wall:.3f} ms wall (replay and fetch, mean of "
              f"{BLOCK_REPS}), {len(ops)} device ops, busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f} % of its wall) on {smi}")


# 16-step blocks timed alone a decode reading
BLOCK_REPS = 5
# the graph-against-eager checks: block sizes and the tokens generated at each
GRAPH_TOKENS = {1: 4, 16: 32}
SAMPLED = SamplingParams(temperature=1.0, top_p=0.9, token_stop=())
SERVE_SLOTS = SERVE_BLOCK = 16
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 32, 16, 64
SERVE_LORA = LoraConfig(r=8, alpha=16.0)


def replay_counts(quantized: bool, fused: bool, k: int) -> dict:
    """Device launches of one k-step block replay by kernel name (as the
    profiler names them): the per-step counts of the route times k."""
    per = ({"layer_norm_kernel": 2, "att_prep_cluster_kernel": 24, "wkv6_decode_kernel": 24,
            "ffn_prep_kernel": 24} if fused else
           {"layer_norm_kernel": 26, "tmix_prologue": 24, "wkv6_decode_kernel": 24})
    if quantized:
        per["quant_rows"] = INT8C_PER_LAYER * 24
    elif fused:
        per["ffn_out_kernel"] = 24
    return {name: n * k for name, n in per.items()}


def check_replay(fn, quantized: bool, fused: bool, k: int, what: str) -> tuple:
    """Profile one call of fn (one block replay): every kernel of the route
    launched k times a step (the profiler may lose one record in ten) and no
    K1. Returns (device ops, busy ms) of the replay."""
    with torch.inference_mode():
        ops = device_ops(fn, 1)
    names = [e.name for e in ops]
    for name, want in replay_counts(quantized, fused, k).items():
        got = sum(name in n for n in names)
        check(want * 0.9 <= got <= want, f"{what}: {got} launches of {name} a replay, not {want}")
    check(not any("wkv6_chunked" in n or "wkv6_sequential" in n for n in names),
          f"{what}: K1 ran in a decode block")
    return len(ops), busy_us(ops) / 1e3


def states_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def phase_graph_blocks(model, label: str) -> None:
    """CUDA-graph decode blocks against the same blocks run eagerly, on both
    routes: generate at K = 1 and 16 (greedy and sampled, 16-token prompt),
    and the batcher at K = 16 with 16 slots (16 requests, greedy and sampled
    rows); tokens and final states bit-equal (torch.equal). One replay of
    each under the profiler for its launches by kernel."""
    quantized = isinstance(model.blocks[0].ffn.key, QuantLinear)
    gen = torch.Generator(device=DEV).manual_seed(21)
    vocab = model.cfg.vocab_size
    prompts = torch.randint(4, vocab, (SERVE_SLOTS, 16), device=DEV, generator=gen).tolist()
    for fused in (False, True):
        route = "fused" if fused else "unfused"
        eng = GenerationEngine(model, fused_prep=fused)
        for k, n in GRAPH_TOKENS.items():
            for name, sp in (("greedy", GREEDY), ("sampled", SAMPLED)):
                sides = []
                for mode in ("graph", "eager"):
                    with eager_blocks() if mode == "eager" else contextlib.nullcontext():
                        sides.append(eng.generate(prompts[0], max_tokens=n, sampling=sp, seed=5,
                                                  block_size=k, return_state=True))
                (out_g, st_g), (out_e, st_e) = sides
                check(len(out_g) == n and out_g == out_e and states_equal(st_g, st_e),
                      f"generate {label} {route} K={k} {name}: graph and eager blocks differ")
        # greedy and sampled, both lengths: one decoder, one graph a length
        dec = eng._decoder(GREEDY, 1, engine_module.STOP_CAPACITY)
        check(len(eng._decoders) == 1 and set(dec.graphs) == set(GRAPH_TOKENS),
              f"generate {label} {route}: graphs {[sorted(d.graphs) for d in eng._decoders.values()]}")
        ops, busy = check_replay(lambda: dec.run(16, eng._gen), quantized, fused, 16,
                                 f"generate {label} {route}")

        def batched():
            batcher = ContinuousBatcher(eng, n_slots=SERVE_SLOTS, sampling=GREEDY,
                                        block_size=SERVE_BLOCK, seed=9)
            rids = [batcher.submit(p, max_tokens=32, sampling=SAMPLED if i % 2 else GREEDY)
                    for i, p in enumerate(prompts)]
            out = batcher.run()
            return [out[r] for r in rids], clone_state(batcher._state), batcher

        toks_g, st_g, batcher = batched()
        with eager_blocks():
            toks_e, st_e, _ = batched()
        check(all(len(t) == 32 for t in toks_g) and toks_g == toks_e and states_equal(st_g, st_e),
              f"batcher {label} {route}: graph and eager blocks differ")
        b_ops, b_busy = check_replay(lambda: batcher._run(SERVE_BLOCK), quantized, fused, 16,
                                     f"batcher {label} {route}")
        print(f"  {label} {route}: generate at K=1 and 16 (greedy, sampled) and the batcher at "
              f"K={SERVE_BLOCK} with {SERVE_SLOTS} slots: graph blocks bit-equal to eager blocks "
              f"(tokens and final state); a 16-step replay: generate (B=1) {ops} device ops, busy "
              f"{busy:.3f} ms; batcher (B={SERVE_SLOTS}) {b_ops} ops, busy {b_busy:.3f} ms; "
              f"launches by kernel {replay_counts(quantized, fused, 16)} a replay")


def write_serving_files(tmp: Path, model) -> dict:
    """Two r=8 LoRA adapters (the reference key layout) and one state-tuning
    checkpoint with its states config, seeded: {"a", "b", "states"} paths."""
    gen = torch.Generator(device=DEV).manual_seed(31)
    files = {}
    for name in ("a", "b"):
        sd = {}
        for key, ab in init_lora_params(model, SERVE_LORA, gen).items():
            B_ = torch.randn(ab["B"].shape, generator=gen, device=DEV) * 0.01
            sd[f"{key}.lora_A"] = ab["A"].t().contiguous().cpu()
            sd[f"{key}.lora_B"] = B_.t().contiguous().cpu()
        files[name] = tmp / f"lora_{name}.pth"
        torch.save(sd, files[name])
    cfg = model.cfg
    states = {f"blocks.{i}.att.time_state":
              0.3 * torch.randn(cfg.n_head, cfg.head_size, cfg.head_size, generator=gen,
                                device=DEV).cpu()
              for i in range(cfg.n_layer)}
    torch.save(states, tmp / "states_sum.pth")
    files["states"] = tmp / "states.json"
    files["states"].write_text(json.dumps(
        {"sum": {"path": str(tmp / "states_sum.pth"), "template": "Summarize: {input}"}}))
    return files


def serving_prompts(tok) -> list:
    """SERVE_REQUESTS texts of exactly SERVE_PROMPT tokens, seeded: words
    that are one token each, drawn until the text encodes to that count."""
    candidates = [" " + w for w in (SHORT + " " + MIXED).split()] + [
        " the", " of", " and", " model", " state", " token", " serving", " graph", " batch",
        " stream", " request", " answer", " north", " river", " light", " small", " green"]
    words = [w for w in candidates if len(tok.encode(w)) == 1]
    rng = np.random.default_rng(33)
    prompts = []
    while len(prompts) < SERVE_REQUESTS:
        text = "".join(rng.choice(words, SERVE_PROMPT))
        if len(tok.encode(text)) == SERVE_PROMPT:
            prompts.append(text)
    return prompts


def teacher_forced_rows(model, prompts: list, outs: list, idx, *, reference: bool) -> torch.Tensor:
    """The batcher's own computation of each row's logits with its output
    fed back: the prompt's prefix prefilled at B = len(prompts) in the
    engine's chunk plan (logits skipped), then one decode step a token from
    the last prompt token on, every row under its adapter (``idx``, for a
    slot-LoRA model). (B, n, V) fp32: the logits each output token was
    picked from."""
    n = len(outs[0])
    with torch.inference_mode():
        if idx is not None:
            set_slot_idx(model, idx)
        prompt = torch.tensor(prompts, device=DEV)
        state, off = None, 0
        for size in engine_module._chunk_plan(prompt.shape[1] - 1, 256):
            _, state = model(prompt[:, off: off + size], state, return_hidden=True,
                             return_logits=False, reference=reference)
            off += size
        feed = torch.cat([prompt[:, -1:], torch.tensor(outs, device=DEV)[:, :-1]], 1)
        rows = []
        for t in range(n):
            lg, state = rwkv_decode_step(model, feed[:, t], state, out=state, reference=reference)
            rows.append(lg.float())
    return torch.stack(rows, 1)


def plain_teacher_forced(model, prompts: list, outs: list, idx=None) -> torch.Tensor:
    """What teacher_forced_rows computes, on the plain route in one forward
    over each prompt and its outputs but the last (phase 4 holds prefill +
    decode steps to one forward): (B, n, V) fp32. The fp32 plain route's
    decode step walks every layer's ops one token at a time, several times
    the cost of this forward."""
    with torch.inference_mode():
        if idx is not None:
            set_slot_idx(model, idx)
        prompt = torch.tensor(prompts, device=DEV)
        seq = torch.cat([prompt, torch.tensor(outs, device=DEV)[:, :-1]], 1)
        logits, _ = model(seq, reference=True)
    return logits[:, prompt.shape[1] - 1:].float()


def serving_stack_server(path: str, files: dict, quantized: bool) -> CliServer:
    """phase_serving_stack's server, not started yet."""
    return CliServer(["--model", path, "--platform", DEV, "--port", "0",
                      "--batcher-slots", str(SERVE_SLOTS), "--batcher-block", str(SERVE_BLOCK),
                      "--prefix-cache", "8", "--slot-adapter", f"a={files['a']}",
                      "--slot-adapter", f"b={files['b']}", "--lora-r", "8", "--lora-alpha", "16",
                      "--states-config", str(files["states"])]
                     + (["--quant", "int8c"] if quantized else []))


def phase_serving_stack(path: str, files: dict, model, label: str, plain, unquantized=None,
                        server: "CliServer | None" = None) -> dict:
    """`python -m rwkv_lm_ext_tpu_torch.serve.cli` with the batcher (16 slots,
    16-step graph blocks), the prefix cache, two slot adapters and a named
    state: SERVE_REQUESTS concurrent /generate requests (prompts of
    SERVE_PROMPT tokens, SERVE_NEW new tokens, adapters base / a / b in turns,
    greedy and sampled in turns), /process_text, GET /, /stats. Every answer
    200 through the batcher. Then the greedy requests again through a batcher
    over the same model built in this process: the same texts; each output
    token is the argmax of the route's teacher-forced logits under its own
    adapter; those logits hold cosine >= 0.999 to the fp32 plain route (bf16),
    or (int8c) lie no farther from the int8c plain route than int8c plain
    lies from the unquantized plain route, as phase 5 holds int8c. ``server``
    is serving_stack_server's, maybe started already (main starts it while
    the phase before runs). Returns the readings."""
    quantized = isinstance(model.blocks[0].ffn.key, QuantLinear)
    tok = WorldTokenizer()
    prompts = serving_prompts(tok)
    adapters = [("base", "a", "b")[i % 3] for i in range(SERVE_REQUESTS)]
    greedy = {"temperature": 0.0, "top_p": 1.0, "alpha_presence": 0.0, "alpha_frequency": 0.0,
              "token_stop": []}
    sampled = {"temperature": 0.8, "top_p": 0.9, "alpha_presence": 0.3, "token_stop": []}
    server = server or serving_stack_server(path, files, quantized)
    answers = [None] * SERVE_REQUESTS
    t0 = time.perf_counter()
    with server as base:
        up, waited = time.perf_counter() - server.started, time.perf_counter() - t0

        def ask(i):
            payload = {"prompt": prompts[i], "max_tokens": SERVE_NEW,
                       **(greedy if i % 2 == 0 else sampled)}
            if adapters[i] != "base":
                payload["adapter"] = adapters[i]
            answers[i] = post(base + "/generate", payload)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(SERVE_REQUESTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        code, text = post(base + "/process_text", {"text": SHORT, "action": "sum"})
        check(code == 200 and text["action"] == "sum" and isinstance(text["output"], str),
              f"/process_text answered {code}: {text}")
        with urllib.request.urlopen(base + "/", timeout=60) as resp:
            page = resp.read()
            check(resp.status == 200 and b"/process_text" in page, "GET / is not the web UI")
        code, stats = post(base + "/stats", {})
    check(all(a is not None and a[0] == 200 and a[1]["backend"] == "batcher" for a in answers),
          f"{label}: a /generate answer was not 200 through the batcher: "
          f"{[a[0] if a else None for a in answers]}")
    check(code == 200 and stats["batcher"]["n_slots"] == SERVE_SLOTS
          and stats["generate_latency_ms"]["batcher"]["count"] == SERVE_REQUESTS
          and stats["adapters"] == ["a", "b", "base"], f"/stats: {stats}")
    tok_s = SERVE_REQUESTS * SERVE_NEW / wall
    print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli {' '.join(server.cmd[5:])}: serving "
          f"after {up:.1f} s ({waited:.1f} s of it waited for); {SERVE_REQUESTS} concurrent /generate answered 200 through the batcher in "
          f"{wall:.2f} s; /process_text 200, GET / the web UI, /stats {stats['batcher']}, latency "
          f"{stats['generate_latency_ms']['batcher']}, prefix cache {stats['prefix_cache']}")

    # the greedy requests again, in this process, for their token ids
    ads = {n: lora_state_dict_to_tree(torch.load(files[n], map_location="cpu", weights_only=True))
           for n in ("a", "b")}
    slot, ids = build_slot_lora(copy.deepcopy(model), ads, SERVE_LORA)
    eng = GenerationEngine(slot, tok, state_cache=PrefixStateCache(8), adapter_ids=ids)
    batcher = ContinuousBatcher(eng, n_slots=SERVE_SLOTS, block_size=SERVE_BLOCK)
    sp = SamplingParams(**{**greedy, "token_stop": ()})
    rows = list(range(0, SERVE_REQUESTS, 2))
    rids = [batcher.submit(prompts[i], max_tokens=SERVE_NEW, sampling=sp,
                           adapter=None if adapters[i] == "base" else adapters[i]) for i in rows]
    got = batcher.run()
    outs = [got[r] for r in rids]
    check(all(tok.decode(o) == answers[i][1]["output"] for o, i in zip(outs, rows)),
          f"{label}: the CLI's greedy answers differ from the same batcher's in this process")
    prompt_ids = [tok.encode(prompts[i]) for i in rows]
    idx = torch.tensor([ids[adapters[i]] for i in rows], device=DEV)
    kern = teacher_forced_rows(slot, prompt_ids, outs, idx, reference=False)
    check(bool((kern.argmax(-1) == torch.tensor(outs, device=DEV)).all()),
          f"{label}: a greedy output is not the argmax of its route's teacher-forced logits")

    def plain_logits(m):
        ref, _ = build_slot_lora(copy.deepcopy(m), ads, SERVE_LORA)
        out = plain_teacher_forced(ref, prompt_ids, outs, idx)
        del ref
        return out

    plain_fp32 = plain_logits(plain)
    cos = min_cosine(kern, plain_fp32)
    if quantized:
        cos_bf16 = min_cosine(kern, teacher_forced_rows(slot, prompt_ids, outs, idx, reference=True))
        floor = min_cosine(plain_fp32, plain_logits(unquantized))
        print(f"  {label}: {len(rows)} greedy outputs ({SERVE_NEW} tokens, adapters base / a / b) are "
              f"the argmax of their route's teacher-forced logits; min per-step logits cosine: "
              f"kernel route vs int8c plain route in bf16 {cos_bf16:.6f}, in fp32 {cos:.6f}; int8c "
              f"plain vs unquantized plain (fp32) {floor:.6f}")
        check(1 - cos_bf16 <= 1 - floor, f"{label}: served int8c departs from its plain route "
              f"({cos_bf16}) by more than int8c departs from unquantized ({floor})")
    else:
        print(f"  {label}: {len(rows)} greedy outputs ({SERVE_NEW} tokens, adapters base / a / b) are "
              f"the argmax of their route's teacher-forced logits; min per-step logits cosine to "
              f"the fp32 plain route {cos:.6f} (limit 0.999)")
        check(cos >= 0.999, f"{label}: served greedy logits vs fp32 plain route cosine {cos}")
    del slot, eng, batcher
    torch.cuda.empty_cache()
    return {"tok_s": tok_s, "wall": wall}


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
    logits) between CUDA events, after 4 warm-up steps, in turns and twice
    (16 steps, for the script's time limit);
    then one step under the profiler for its device operations, busy time
    and split."""
    def step_logits(variant, tok, state):
        if variant in ("step", "step_fused"):
            return rwkv_decode_step(model, tok, state, out=state, fused_prep=variant == "step_fused")
        return spliced_step(model, tok, state, variant)

    def one(variant, tok, state):
        lg, state = step_logits(variant, tok, state)
        return lg.argmax(-1), state

    iters = 16

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


def two_layer_sd(path: str, n_layer: int = 2) -> dict:
    """The first `n_layer` layers (and the embedding, ln_out and head) of
    the saved full-width model."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return {k: v for k, v in sd.items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < n_layer}


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
                 what: str = "one step (remat on)", kernels=((), ())) -> dict:
    """Device time of one train step (or forward) by kernel group
    (torch.profiler, device operations only); idle = the step's CUDA-event
    time less busy. `kernels`: the kernel names the step must run, and those
    it must not. Returns {group: ms}."""
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
    split = split_by_group(ops, groups)
    for g, v in split.items():
        print(f"    {g}: {v:.3f} ms ({100 * v / busy:.1f} %)")
    return split


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
    free()


def sft_jsonl(path: Path, tok) -> None:
    """64 identical rows whose tokenized length falls in the 512 bucket."""
    row = {"instruction": "Repeat the passage.", "input": "The passage is about foxes.",
           "output": " ".join(["The quick brown fox jumps over the lazy dog."] * 30)}
    n = len(encode_sft_example(tok, row["instruction"], row["input"], row["output"])["input_ids"])
    check(256 < n <= 512, f"the SFT row is {n} tokens, not in the 512 bucket")
    path.write_text("".join(json.dumps(row) + "\n" for _ in range(64)))
    print(f"  {path.name}: 64 identical rows of {n} tokens (bucket 512, batch 64 * 64 // 512 = 8)")


def stop_procs(procs: list) -> None:
    """Kill whichever of `procs` still runs (at exit, or when a check
    failed while they ran)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_train_clis(runs: list, logs: Path) -> tuple:
    """Start `python -m rwkv_lm_ext_tpu_torch.train.cli <command> ...` once a
    run (args, command, falling), as concurrent subprocesses, each writing
    its output to a file under `logs`; finish_train_clis waits for them, and
    they are killed at exit if nothing did."""
    logs.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (args, command, _) in enumerate(runs):
        with open(logs / f"{command}-{i}.log", "w") as f:     # the child keeps its own handle
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", command, *args],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    atexit.register(stop_procs, procs)
    return runs, procs, logs, time.perf_counter()


def finish_train_clis(started: tuple) -> list:
    """Wait for the runs of start_train_clis (600 s from their start at
    most); returns each run's logged losses, which must be finite and, with
    `falling`, end below where they began. A failure stops the runs still
    going."""
    runs, procs, logs, t0 = started
    try:
        for proc in procs:
            proc.wait(timeout=max(600 - (time.perf_counter() - t0), 1))
    finally:
        stop_procs(procs)
    wall = time.perf_counter() - t0
    all_losses = []
    for i, ((args, command, falling), proc) in enumerate(zip(runs, procs)):
        text = (logs / f"{command}-{i}.log").read_text()
        check(proc.returncode == 0, f"train.cli {command} {' '.join(args)} exited "
              f"{proc.returncode}:\n{text[-3000:]}")
        steps = [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines()
                 if ln.startswith("step ")]
        losses = [m["loss"] for m in steps]
        shown = " ".join(a for a, b in zip(args, args[1:] + [""])
                         if not a.startswith("/") and not b.startswith("/"))
        print(f"  python -m rwkv_lm_ext_tpu_torch.train.cli {command} {shown}: losses "
              f"{[round(x, 4) for x in losses]}, last logged Kt/s "
              f"{steps[-1].get('Kt/s', float('nan')) if steps else float('nan'):.2f} "
              f"({len(runs)} runs together, {wall:.1f} s from their start)")
        check(len(losses) >= 2 and all(np.isfinite(losses)), f"losses {losses}")
        check(not falling or losses[-1] < losses[0],
              f"the loss did not fall on repeated rows: {losses}")
        all_losses.append(losses)
    return all_losses


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


def start_sft_clis(path: str, tmp: Path) -> tuple:
    """Phase 9's subprocesses on the saved 24-layer model, started: LoRA (8
    steps) and state tuning (4 steps)."""
    data = tmp / "sft.jsonl"
    sft_jsonl(data, WorldTokenizer())
    common = sft_args(path, data)
    return start_train_clis([(common + ["--output-dir", str(tmp / "lora"), *LORA_ARGS], "sft", True),
                             (common + ["--output-dir", str(tmp / "states"), "--train-type",
                                        "states", "--max-steps", "4"], "sft", True)],
                            tmp / "sft_logs")


def phase_train_cli(path: str, tmp: Path, started: tuple) -> dict:
    """The trainer's normal entry point on the saved 24-layer model: the
    LoRA and state-tuning subprocesses of start_sft_clis, their files, the
    merged adapter; then LoRA again in this process, where the launches of
    the training path are counted. Returns those counts."""
    common = sft_args(path, tmp / "sft.jsonl")
    out = tmp / "lora"
    finish_train_clis(started)
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
        for body in WKV_BODIES:
            bodies[body] = (device_ms(lambda: wkv(*fwd, body=body), 10),
                            device_ms(lambda: wkv(*fwd[:4], None, reverse=True, lengths=c["lengths"],
                                                  body=body), 10))
            print(f"  B.8 at B={b}, T={T}, H={H}, N={N}, bf16, {body} body: forward "
                  f"{bodies[body][0]:.4f} ms, reverse over ragged prefixes {bodies[body][1]:.4f} ms")
        split = device_ms_by_kernel(lambda: wkv_bwd(*bwd), 5, {
            "state": ("wkv6_bwd_state",), "reverse": ("wkv6_bwd_reverse",)})
        times[b] = dict(fwd=bodies["chunked"][0], state=split["state"],
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
              f"{100 * bound['bound_ms'] / bodies['sequential'][0]:.1f} %")
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


def fill_mask_args(path: str) -> list:
    return ["--encoder", path, "--platform", DEV, "--port", "0"]


def phase_fill_mask(path: str, n_layer: int, server: CliServer) -> dict:
    """/fill_mask through the normal entry point: the saved encoder of
    `n_layer` layers served by `serve.cli --encoder` in a subprocess
    (`server`, started with fill_mask_args(path)); every answer's
    candidates against the plain route's, computed by the same CLI code in
    this process, where the launches of a request (ENCODER_FORWARD's at that
    depth) are counted. Returns those counts."""
    args = fill_mask_args(path)
    service = cli.build_service(cli.parse_args(args))
    check(service.routes == {"/stats", "/fill_mask"}, f"routes {service.routes}")
    top_k, cutoff = 5, 0.5
    with server as base:
        print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli {' '.join(args)}: serving on {base} "
              f"after {time.perf_counter() - server.started:.1f} s")
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
            # vocabulary), the two bf16 routes' roundings through its layers
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
    want = dict(NO_LAUNCH, layer_norm=2 * n_layer + 2, wkv=2 * n_layer)
    print(f"  in-process CLI build, one /fill_mask request: launches {counts}")
    check(counts == want, f"/fill_mask launch counts {counts} != {want}")
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


def mlm_args(tmp: Path) -> list:
    """The arguments of phase 12's runs but the output directory and steps."""
    return ["--model", str(tmp / "rwkv6_1b6_first_4_layers.pth"), "--train-data",
            str(tmp / "text.jsonl"), "--micro-bsz", "64", "--ctx-len", str(T), "--warmup-steps",
            "0", "--log-every", "1", "--platform", DEV]


def start_mlm_clis(path: str, tmp: Path) -> tuple:
    """Phase 12's subprocesses on the first 4 layers of the saved model (the
    24-layer runs' loads and 6.4 GB saves cost the script's time; phase 11
    holds the 24-layer gradients and phase 13 reads its steps), started:
    `mlm` for 4 steps (fp32 master weights, bf16 compute, B=8, T=512) and
    `mae --dup-mae` for 2 steps."""
    text_jsonl(tmp / "text.jsonl", WorldTokenizer())
    torch.save(two_layer_sd(path, 4), tmp / "rwkv6_1b6_first_4_layers.pth")
    common = mlm_args(tmp)
    return start_train_clis([(["--output-dir", str(tmp / "mlm"), "--max-steps", "4", *common],
                              "mlm", True),
                             (["--dup-mae", "--output-dir", str(tmp / "mae"), "--max-steps", "2",
                               *common], "mae", False)], tmp / "mlm_logs")


def phase_mlm_cli(path: str, tmp: Path, started: tuple) -> tuple:
    """The encoder trainers' normal entry point: the subprocesses of
    start_mlm_clis and the saved encoder, whose /fill_mask server (phase
    10b) then starts; then `mlm` in this process, whose launches are the
    training path's. Returns those counts and the started server."""
    cut = tmp / "rwkv6_1b6_first_4_layers.pth"
    common = mlm_args(tmp)
    out = tmp / "mlm"
    finish_train_clis(started)
    check((out / "train_log.txt").is_file(), "no train_log.txt")
    base = torch.load(cut, map_location="cpu", weights_only=True, mmap=True)
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
    check(cfg == rwkv6_1b6(n_layer=4) and bool(torch.isfinite(hidden).all()),
          "the saved encoder does not load and run")
    print(f"  encoder-step4.pth: the base checkpoint's keys and shapes in fp32, loads with "
          f"load_rwkv_checkpoint and encodes; max |change| of {key} {moved:.2e}")
    del model, hidden
    torch.cuda.empty_cache()
    # phase 10b's server loads while the rest of this phase runs
    server = CliServer(fill_mask_args(str(out / "encoder-step4.pth")))
    server.start()

    out = tmp / "mae"
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
    print(f"  in-process train.cli mlm --max-steps 2 (4 layers): launches {counts}")
    check(counts == want, f"CLI mlm launch counts {counts} != {want}")
    cut.unlink()
    torch.cuda.empty_cache()
    return counts, server


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
    lo, hi, iters = 4, cfg.vocab_size - 4, 2
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
    free()


# ---------------------------------------------------------------------------
# Phase 16: reranking and the contrastive trainers
# ---------------------------------------------------------------------------

CE_GROUPS = 2                # encoder-crossencoder: groups of G = TB // CE_GROUPS documents
RERANK_REL = 1e-2            # bf16 scores against the fp32 plain route, x max|plain|
RERANK_PAIRS = 64            # the pairs/s reading: 64 pairs in the 512 bucket


def full_step_counts(n_layer: int, remat: bool, fields: int) -> dict:
    """Launches of one full-parameter train step of the causal model over
    `fields` forwards (a triplet: 3): each forward's kernels, again under
    remat; B.5 in its full form, B.6 and B.7 in every layer (layer 0's
    prologue inputs and weights train too)."""
    fwd = 2 if remat else 1
    return dict(NO_LAUNCH, layer_norm=fields * ((1 + n_layer) * fwd + 1),
                tmix_prologue=fields * n_layer * fwd, wkv6_fused_output=fields * n_layer * fwd,
                tmix_prologue_bwd=fields * n_layer, wkv6_bwd_forward_pass=fields * n_layer,
                wkv6_bwd_reverse_pass=fields * n_layer)


def forward_counts(n_layer: int) -> dict:
    """Launches of one forward (PER_FORWARD at n_layer layers)."""
    return dict(PER_FORWARD, layer_norm=n_layer + 2, tmix_prologue=n_layer,
                wkv6_fused_output=n_layer)


def ragged_rows(gen, vocab: int, b: int, t: int, end_id: int = EMB_ID) -> torch.Tensor:
    """(b, t) rows of tokens ending in `end_id` at ragged lengths (one row
    full), pads after."""
    tokens = torch.randint(4, vocab, (b, t), device=DEV, generator=gen)
    ends = torch.randint(t // 4, t, (b,), device=DEV, generator=gen)
    ends[0] = t - 1
    pos = torch.arange(t, device=DEV)[None, :]
    tokens[pos == ends[:, None]] = end_id
    tokens[pos > ends[:, None]] = 0
    return tokens


def pair_rows(gen, vocab: int, b: int = TB, t: int = T) -> dict:
    """Cross-encoder rows `q [sep] d [cls]` at ragged lengths, labels 0/1."""
    tokens = ragged_rows(gen, vocab, b, t, end_id=CLS_ID)
    tokens[:, t // 8] = SEP_ID
    return {"input_ids": tokens, "labels": torch.arange(b, device=DEV) % 2}


def triplet_rows(gen, vocab: int, b: int = TB, t: int = T) -> dict:
    return {k: ragged_rows(gen, vocab, b, t) for k in ("query", "positive", "negative")}


def trainable_grads(model, loss_fn, batch, *, reference: bool, skip=("head.weight",)) -> dict:
    """Gradients of every parameter that trains, but `skip` (parameters the
    loss does not reach, whose gradient must stay None); each must exist, be
    fp32 and non-zero."""
    model.zero_grad(set_to_none=True)
    loss_fn(model, batch, reference=reference).backward()
    grads = {}
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if n in skip:
            check(p.grad is None, f"{n} got a gradient the loss cannot give it")
            continue
        check(p.grad is not None and p.grad.dtype == torch.float32 and bool(p.grad.abs().max() > 0),
              f"{n} got no gradient ({'plain' if reference else 'kernel'} route)")
        grads[n] = p.grad.detach().clone()
    model.zero_grad(set_to_none=True)
    return grads


def kernel_vs_plain(what: str, model, loss_fn, batch, zero=(), **kw) -> dict:
    """The kernel route's gradients against the plain route's, each tensor
    within 1e-3 of its largest plain value (fp32). The tensors in `zero` have
    a gradient that is zero analytically (rounding noise on either route):
    both routes' must stay under 1e-6 of the largest gradient. Returns the
    plain ones."""
    k = trainable_grads(model, loss_fn, batch, reference=False, **kw)
    p = trainable_grads(model, loss_fn, batch, reference=True, **kw)
    floor = 1e-6 * max(g.abs().max().item() for g in p.values())
    noise = max([g[n].abs().max().item() for g in (k, p) for n in zero], default=0.0)
    check(noise < floor, f"{what}: the gradient of {zero} is {noise}, not zero")
    rel = {n: (k[n] - p[n]).abs().max().item() / p[n].abs().max().item() for n in p
           if n not in zero}
    worst = max(rel, key=rel.get)
    print(f"  {what}, {len(p)} gradient tensors: max |kernel - plain| / max|plain| = "
          f"{rel[worst]:.3e} ({worst}; limit 1e-3)"
          + (f"; {', '.join(zero)} zero on both routes ({noise:.1e} < {floor:.1e})" if zero else ""))
    check(rel[worst] <= 1e-3, f"{what}: gradient {worst} off by {rel[worst]}")
    return p


def phase_contrastive_grads(path: str) -> dict:
    """A 2-layer full-width model (C=2048) at B=8, T=512, remat on, kernel
    route against plain route: the cross-encoder loss (LoRA r=8 + score
    head, fp32); CoSENT on lasttoken embeddings over every parameter with
    fp32 master weights (B.5's full form), in fp32 and in bf16 compute; the
    group-softmax loss on the bidirectional sentence embedding (B.8, B.6 /
    B.7 with gn=False, fp32). Then the launches of one full-parameter CoSENT
    step, held to full_step_counts. Returns those counts."""
    sd2 = two_layer_sd(path)
    gen = torch.Generator(device=DEV).manual_seed(30)

    def model_of(dtype, param_dtype=""):
        cfg = rwkv6_1b6(n_layer=2, dtype=dtype, param_dtype=param_dtype)
        return load_state_dict_into(RWKV(cfg, device=DEV), sd2)

    m = model_of("float32")
    adapter = init_lora_params(m, LORA, gen)
    for ab in adapter.values():
        ab["B"].normal_(0.0, 0.01, generator=gen)
    apply_lora(m, LORA, adapter)
    m.score = init_classification_head(m.cfg, generator=gen)
    kernel_vs_plain("cross-encoder loss (LoRA r=8 + score head, fp32)", m,
                    functools.partial(cross_encoder_loss_fn, remat=True),
                    pair_rows(gen, m.cfg.vocab_size))
    del m

    cosent = functools.partial(contrastive_loss_fn, loss="cosent", pooling="lasttoken", remat=True)
    triplets = triplet_rows(gen, rwkv6_1b6().vocab_size)
    m32 = model_of("float32")
    p32 = kernel_vs_plain("CoSENT over every parameter (fp32)", m32, cosent, triplets)
    del m32
    m16 = model_of("bfloat16", "float32")
    k16 = trainable_grads(m16, cosent, triplets, reference=False)
    p16 = trainable_grads(m16, cosent, triplets, reference=True)
    margins = {n: cosine(k16[n], p32[n]) - cosine(p16[n], p32[n]) for n in p32}
    worst = min(margins, key=margins.get)
    print(f"  CoSENT, bf16 compute over fp32 masters vs the fp32 plain route, per gradient tensor: "
          f"min cosine kernel route {min(cosine(k16[n], p32[n]) for n in p32):.6f}, plain route in "
          f"bf16 {min(cosine(p16[n], p32[n]) for n in p32):.6f}; worst margin {margins[worst]:+.2e} "
          f"({worst}; the kernel route may trail bf16's own by 1e-3)")
    check(margins[worst] >= -1e-3, f"bf16 kernel-route gradient {worst} trails bf16 itself")
    del k16, p16, p32
    apply_trainable_mask(m16, trainable_mask(m16, "full"))
    step = make_train_step(m16, TrainConfig(lr_init=1e-5, warmup_steps=0, total_steps=10), cosent)
    reset_launch_counts()
    loss = step(triplets)["loss"]
    torch.cuda.synchronize()
    counts, want = launch_counts(), full_step_counts(2, True, 3)
    print(f"  launches in one full-parameter CoSENT train step (2 layers, 3 fields, remat on): "
          f"{counts}; B.5 in its full form {counts['tmix_prologue_bwd']} times")
    check(counts == want and bool(torch.isfinite(loss)), f"CoSENT step counts {counts} != {want}")
    del step, m16

    enc = model_of("float32")
    enc.score = init_classification_head(enc.cfg, generator=gen)
    rows = ragged_rows(gen, enc.cfg.vocab_size, TB, T, end_id=CLS_ID)
    rows[:, T // 8] = SEP_ID
    # the scores' gradients sum to zero in each group: ln_out.bias gets none
    kernel_vs_plain(f"group softmax on encode_sentence (G={TB // CE_GROUPS}, fp32)", enc,
                    functools.partial(encoder_crossencoder_loss_fn, group_size=TB // CE_GROUPS,
                                      remat=True), {"input_ids": rows}, zero=("ln_out.bias",))
    del enc
    torch.cuda.empty_cache()
    return counts


def contrastive_files(tmp: Path) -> dict:
    """One small data file a trainer: 16 rows each, the triplets' and
    pairs' queries in the 64 bucket (batches of micro_bsz * 64 // 64 rows,
    collated to 128 tokens), an AllNLI .tsv and an STS-b .tsv."""
    words = "retrieval ranks the passages that answer a query about rivers mountains and cities".split()

    def text(i, n):
        return " ".join(words[(i * 7 + j) % len(words)] for j in range(n))

    def jsonl(name, rows):
        (tmp / name).write_text("".join(json.dumps(r) + "\n" for r in rows))
        return str(tmp / name)

    files = {
        "triplet": jsonl("triplet.jsonl", [{"query": text(i, 20), "positive": text(i + 1, 40),
                                            "negative": text(i + 2, 40)} for i in range(16)]),
        "pair": jsonl("pair.jsonl", [{"query": text(i, 20), "document": text(i + 3, 80),
                                      "label": i % 2} for i in range(16)]),
        "simcse": jsonl("simcse.jsonl", [{"sentence_a": text(i, 30), "sentence_b": text(i + 1, 30)}
                                         for i in range(16)]),
        "instructor": jsonl("instructor.jsonl", [
            {"instruction": "Represent the passage for retrieval: ", "query": text(i, 20),
             "positive": text(i + 1, 30), "negative": text(i + 2, 30)} for i in range(16)]),
        "documents": jsonl("documents.jsonl", [{"query": text(i, 10),
                                                "documents": [text(i + j, 30) for j in range(4)]}
                                               for i in range(16)]),
        "text": jsonl("text.jsonl", [{"text": text(i, 40)} for i in range(16)]),
    }
    with open(tmp / "allnli.tsv", "w") as f:
        f.write("split\tdataset\tfilename\tsentence1\tsentence2\tlabel\n")
        for i in range(16):
            for label, j in (("entailment", 1), ("contradiction", 2), ("neutral", 3)):
                f.write(f"train\tSNLI\tx\t{text(i, 12)}\t{text(i + j, 12)}\t{label}\n")
    with open(tmp / "sts.tsv", "w") as f:
        f.write("split\tgenre\tdataset\tyear\tsid\tscore\tsentence1\tsentence2\n")
        for i in range(8):
            f.write(f"dev\tmain\tx\t2012\t{i}\t{i % 5}.0\t{text(i, 12)}\t{text(i + 1, 12)}\n")
    files.update(nli=str(tmp / "allnli.tsv"), sts=str(tmp / "sts.tsv"))
    return files


# command, data, its own flags, the files it must write (JAX names)
TRAINER_RUNS = [
    ("bi-encoder", "triplet", [], ["bi-encoder-step2.pth"]),
    ("cross-encoder", "pair", [], ["cross-encoder-step2.pth", "score-step2.pth"]),
    ("simcse", "simcse", [], ["simcse-step2.pth"]),
    ("instructor", "instructor", [], ["instructor-step2.pth"]),
    ("encoder-biencoder", "triplet", [], ["encoder-bi-step2.pth"]),
    ("encoder-crossencoder", "documents", ["--group-size", "4"], ["encoder-cross-step2.pth"]),
    ("mae", "text", ["--uni"], ["encoder-step2.pth"]),
]


def check_trained_file(path: Path, base: dict) -> str:
    """A trainer's output against the JAX package's layout: LoRA factors of
    every target, the score head, or the base keys in fp32 with the heads
    beside them."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    check(all(v.dtype == torch.float32 for v in sd.values()), f"{path.name}: not fp32")
    name, C = path.name, base["emb.weight"].shape[1]
    n_layer = 1 + max(int(k.split(".")[1]) for k in base if k.startswith("blocks."))
    if name.startswith(("bi-encoder", "cross-encoder")):
        check(len(sd) == n_layer * 8 * 2 and sd["blocks.0.att.key.lora_A"].shape == (8, C)
              and sd[f"blocks.{n_layer - 1}.ffn.value.lora_B"].shape == (C, 8),
              f"{name}: not a LoRA file")
        return f"{name} ({len(sd)} LoRA tensors)"
    if name.startswith("score"):
        check(list(sd) == ["score.weight"] and sd["score.weight"].shape == (1, C), f"{name}")
        return f"{name} (score.weight {tuple(sd['score.weight'].shape)})"
    heads = {"instructor": ["dense.weight", "dense.bias", "ln_dense.weight", "ln_dense.bias"],
             "encoder-cross": ["score.weight"]}
    extra = next((v for k, v in heads.items() if name.startswith(k)), [])
    check(sorted(sd) == sorted(list(base) + extra), f"{name}: other keys than the base and {extra}")
    check(all(sd[k].shape == base[k].shape for k in base), f"{name}: a base shape differs")
    return f"{name} (the base's {len(base)} keys{' + ' + ', '.join(extra) if extra else ''})"


# the trainers that hold every parameter, fp32 masters and AdamW state (about
# 30 GB at 1B6, about 10 GB at CUT_LAYERS layers)
FULL_PARAMETER = {"simcse", "instructor", "encoder-biencoder", "encoder-crossencoder", "mae", "nli"}
# Each full-parameter trainer saves the whole model in fp32, 6.4 GB at 24
# layers; the card machine takes at most 45 GiB of writes a call, and the
# earlier phases write about 23 GB. So these six train the first CUT_LAYERS
# layers of the same weights at full width (1.9 GB a file); the LoRA trainers,
# whose files /rerank serves in phase 16c, train all 24.
CUT_LAYERS = 4


def start_cli_jobs(jobs: list, out: Path) -> tuple:
    """Start `python -m rwkv_lm_ext_tpu_torch.train.cli` once a job (label,
    argv), all at once, each logging under `out`; wait_cli_jobs waits for
    them, and they are killed at exit if nothing did."""
    running = []
    out.mkdir(parents=True, exist_ok=True)
    for label, argv in jobs:
        cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", *argv]
        with open(out / f"{label}.log", "w") as f:     # the child keeps its own copy of the handle
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        running.append(((label, argv), time.perf_counter(), proc))
    atexit.register(stop_procs, [proc for _, _, proc in running])
    return running, out


def wait_cli_jobs(started: tuple) -> dict:
    """Wait for the jobs of start_cli_jobs: each must exit 0 within 600 s of
    its start and log 2 finite losses. A failure stops the jobs still
    running. Returns {label: losses}."""
    running, out = started
    running, losses = list(running), {}
    try:
        while running:
            done = next((r for r in running if r[2].poll() is not None), None)
            if done is None:
                for job, t0, proc in running:
                    check(time.perf_counter() - t0 <= 600, f"train.cli {job[0]} ran past 600 s")
                time.sleep(0.5)
                continue
            running.remove(done)
            (label, argv), t0, proc = done
            text = (out / f"{label}.log").read_text()
            check(proc.returncode == 0, f"train.cli {label} exited {proc.returncode}:\n{text[-3000:]}")
            steps = [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines()
                     if ln.startswith("step ")]
            losses[label] = [m["loss"] for m in steps]
            check(len(steps) == 2 and all(np.isfinite(losses[label])), f"{label}: {losses[label]}")
            # the flags, without the paths
            shown = " ".join(a for a, b in zip(argv, argv[1:] + [""])
                             if not a.startswith("/") and not b.startswith("/"))
            print(f"  python -m rwkv_lm_ext_tpu_torch.train.cli {shown}: "
                  f"{time.perf_counter() - t0:.1f} s from its start, losses "
                  f"{[round(x, 4) for x in losses[label]]}")
    finally:
        stop_procs([proc for _, _, proc in running])
    return losses


def run_trainers(models: dict, files: dict, out: Path) -> dict:
    """TRAINER_RUNS through `python -m rwkv_lm_ext_tpu_torch.train.cli` on
    models["full"] (the full-parameter ones, CUT_LAYERS layers: about 10 GB
    each) or models["lora"], all seven subprocesses at once (about 60 GB
    together), 2 steps each. Returns {command: losses}."""
    common = ["--micro-bsz", "4", "--ctx-len", "128", "--max-steps", "2", "--log-every", "1",
              "--warmup-steps", "0", "--platform", DEV]
    jobs = []
    for command, data, flags, _ in TRAINER_RUNS:
        full = command in FULL_PARAMETER
        jobs.append((command, [command, *flags, "--model", models["full" if full else "lora"],
                               "--train-data", files[data], "--output-dir", str(out / command),
                               *common]))
    return wait_cli_jobs(start_cli_jobs(jobs, out))


def phase_contrastive_cli(path: str, tmp: Path) -> dict:
    """The eight trainers: `bi-encoder` and `cross-encoder` on the saved
    24-layer model, the full-parameter ones on its first CUT_LAYERS layers;
    seven through `python -m rwkv_lm_ext_tpu_torch.train.cli`
    (subprocesses), `nli` (with STS-b evaluation) through the same CLI in
    this process, whose launches are B.5's full-form main path; the files
    each writes under the JAX names. Returns nli's launch counts, the
    output directory and phase 16c's server, started on the subprocesses'
    adapters (it loads while nli runs)."""
    files = contrastive_files(tmp)
    out = tmp / "contrastive"
    cut = str(tmp / f"rwkv6_1b6_synthetic_{CUT_LAYERS}_layers.pth")
    torch.save(two_layer_sd(path, CUT_LAYERS), cut)
    run_trainers({"lora": path, "full": cut}, files, out)
    server = CliServer(rerank_server_args(path, out))
    server.start()
    bases = {p: torch.load(p, map_location="cpu", weights_only=True, mmap=True) for p in (path, cut)}
    for command, _, _, names in TRAINER_RUNS:
        base = bases[cut if command in FULL_PARAMETER else path]
        for name in names:
            print(f"  {command}: {check_trained_file(out / command / name, base)}")
    nli = out / "nli"
    args = ["nli", "--model", cut, "--train-data", files["nli"], "--sts-file", files["sts"],
            "--max-seq-len", "64", "--micro-bsz", "4", "--max-steps", "2", "--log-every", "1",
            "--warmup-steps", "0", "--platform", DEV, "--output-dir", str(nli)]
    reset_launch_counts()
    train_cli.main(args)
    torch.cuda.synchronize()
    counts = launch_counts()
    # two steps of 3 fields, then the STS evaluation's two forwards of 8 rows
    want = {k: 2 * n for k, n in full_step_counts(CUT_LAYERS, True, 3).items()}
    for k, n in forward_counts(CUT_LAYERS).items():
        want[k] += 2 * n
    print(f"  in-process train.cli nli --max-steps 2 --sts-file ({CUT_LAYERS} layers): launches "
          f"{counts}")
    check(counts == want, f"CLI nli launch counts {counts} != {want}")
    print(f"  nli: {check_trained_file(nli / 'nli-step2.pth', bases[cut])}")
    rows = (nli / "similarity_evaluation_sts-dev_results.csv").read_text().splitlines()
    check(rows[0].startswith("epoch,steps,cosine_pearson") and len(rows) == 2, f"STS CSV {rows}")
    print(f"  nli: similarity_evaluation_sts-dev_results.csv {rows[1]}")
    del bases
    torch.cuda.empty_cache()
    return {"counts": counts, "out": out, "server": server}


def cls_states(model, batches: list, *, reference: bool) -> torch.Tensor:
    """fp32 hidden states at the first CLS_ID of each row, the state that
    classify_sequences scores."""
    out = []
    with torch.inference_mode():
        for tokens in batches:
            hidden, _ = model(tokens, return_hidden=True, return_logits=False, reference=reference)
            pos = first_token_position(tokens, CLS_ID)
            out.append(hidden[torch.arange(len(tokens), device=DEV), pos].float())
    return torch.cat(out)


def rerank_documents(tok) -> list:
    """Documents of a few lengths about one query (pairs in the 64 ... 512
    buckets)."""
    docs = [SHORT, CJK, MIXED, "Paris is the capital of France. " * 12,
            "RWKV mixes time like a transformer and decodes like an RNN. " * 6,
            "Rerankers score a query against each passage. " * 30]
    check(max(len(tok.encode(d)) for d in docs) < 500, "a rerank document is too long")
    return docs


def rerank_server_args(path: str, out: Path) -> list:
    """serve.cli's arguments for phase 16c: the adapters that phase 16b
    trained under `out`."""
    cross, head = out / "cross-encoder" / "cross-encoder-step2.pth", out / "cross-encoder" / "score-step2.pth"
    bi = out / "bi-encoder" / "bi-encoder-step2.pth"
    return ["--model", path, "--bi-adapter", str(bi), "--cross-adapter", str(cross), "--cross-head",
            str(head), "--platform", DEV, "--port", "0"]


def phase_rerank(path: str, out: Path, server: CliServer) -> dict:
    """/rerank and /embed through `python -m rwkv_lm_ext_tpu_torch.serve.cli
    --bi-adapter --cross-adapter --cross-head` (`server`, a subprocess with
    rerank_server_args, bf16) on the
    adapters that phase 16b trained: scores against a fp32 plain-route
    CrossEncoder on the same merged weights, the ranking, 400 on malformed
    payloads; /embed rows unit-norm; 404 from a server with no
    cross-encoder. Then the same reranker in this process for its launches.
    Returns those counts and the merged bf16 reranker."""
    tok = WorldTokenizer()
    query, docs = "What is the capital of France?", rerank_documents(tok)
    cross, head = out / "cross-encoder" / "cross-encoder-step2.pth", out / "cross-encoder" / "score-step2.pth"
    with server as base:
        print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli --bi-adapter --cross-adapter "
              f"--cross-head: serving on {base} after {time.perf_counter() - server.started:.1f} s")
        code, served = post(base + "/rerank", {"query": query, "documents": docs})
        check(code == 200, f"/rerank answered {code}")
        bad = [post(base + "/rerank", p)[0] for p in
               ({"documents": docs}, {"query": query, "documents": []}, {"query": query},
                {"query": query, "documents": [1]})]
        check(bad == [400] * 4, f"malformed /rerank payloads answered {bad}")
        code, emb = post(base + "/embed", {"texts": [SHORT, CJK, MIXED]})
        norms = np.linalg.norm(np.asarray(emb["embeddings"]), axis=1)
        check(code == 200 and np.allclose(norms, 1.0, atol=1e-3), f"/embed: {code}, norms {norms}")
        code, stats = post(base + "/stats", {})
        check(stats["requests"].get("/rerank") == 5, f"/stats {stats['requests']}")
    print(f"  /rerank: scores {np.round(served['scores'], 4).tolist()}, ranking {served['ranking']}; "
          f"4 malformed payloads 400; /embed through the bi adapter: unit rows (norms "
          f"{norms.min():.6f} .. {norms.max():.6f})")

    sd = torch.load(cross, map_location="cpu", weights_only=True)
    score = score_head_from_state_dict(torch.load(head, map_location="cpu", weights_only=True),
                                       device=DEV)
    model, cfg = load_rwkv_checkpoint(path, device=DEV)
    merge_lora(apply_lora(model, LORA, lora_state_dict_to_tree(sd)))
    f32, _ = load_rwkv_checkpoint(path, device=DEV, dtype="float32")
    merge_lora(apply_lora(f32, LORA, lora_state_dict_to_tree(sd)))
    batches = [torch.from_numpy(a).to(DEV)
               for a in CrossEncoder(model, tok, score).token_batches([(query, d) for d in docs])]
    h16, p16, p32 = (cls_states(m, batches, reference=r)
                     for m, r in ((model, False), (model, True), (f32, True)))
    del f32
    torch.cuda.empty_cache()
    plain16, plain = ((h @ score.weight.detach().float()[0]).cpu().numpy() for h in (p16, p32))
    scores = np.asarray(served["scores"])
    scale = np.abs(plain).max()
    err, err16 = np.abs(scores - plain).max() / scale, np.abs(plain16 - plain).max() / scale
    cos = min_cosine(h16, p32)
    # the ranking where no two scores' deviations from the fp32 route could swap neighbours
    order, tie = np.argsort(-plain), 2 * np.abs(scores - plain).max()
    gaps = -np.diff(plain[order])
    held = [i for i in range(len(order))
            if (i == 0 or gaps[i - 1] > tie) and (i == len(order) - 1 or gaps[i] > tie)]
    agree = all(served["ranking"][i] == order[i] for i in held)
    print(f"  served bf16 scores vs the fp32 plain route on the same merged weights: max |diff| / "
          f"max|plain| = {err:.3e}, the bf16 plain route's {err16:.3e} (the kernel route may trail "
          f"it by {RERANK_REL}); the cls states' min cosine to the fp32 plain route {cos:.6f} "
          f"(limit 0.999); fp32 plain ranking {order.tolist()}, served ranking equal at the "
          f"{len(held)} places whose neighbours differ by more than twice the largest deviation: "
          f"{agree}")
    check(err <= err16 + RERANK_REL and cos >= 0.999 and agree and held,
          "the served reranker is off the plain route")

    with Served(ServingService(bi_encoder=BiEncoder(model, tok))) as base:
        code, _ = post(base + "/rerank", {"query": query, "documents": docs})
        check(code == 404, f"/rerank on a server with no cross-encoder answered {code}")
    print("  /rerank on a server with no cross-encoder: 404")
    rerank = CrossEncoder(model, tok, score)
    pairs = [(query, d) for d in docs]
    n_batches = len(list(rerank.token_batches(pairs)))
    reset_launch_counts()
    got = rerank.score_pairs(pairs)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: n * n_batches for k, n in forward_counts(cfg.n_layer).items()}
    print(f"  in-process CrossEncoder.score_pairs ({len(pairs)} pairs, {n_batches} batch): launches "
          f"{counts}")
    check(counts == want, f"rerank launch counts {counts} != {want}")
    check(np.abs(got - scores).max() <= 1e-6 * max(1.0, np.abs(scores).max()),
          "the in-process reranker scores otherwise than the served one")
    return {"counts": counts, "reranker": rerank}


def rerank_pairs(tok, n: int = RERANK_PAIRS) -> list:
    """`n` (query, document) pairs whose rows land in the 512 bucket."""
    doc = "Rerankers score a query against each passage, one pair at a time. " * 22
    pairs = [(f"query number {i}: which passage explains reranking?", doc) for i in range(n)]
    length = len(pair_ids(tok, *pairs[0]))
    check(256 < length <= 512, f"a rerank pair is {length} tokens, not in the 512 bucket")
    return pairs


def phase_contrastive_readings(path: str, reranker, smi: str) -> None:
    """Readings, not benchmark cells: reranked pairs a second (64 pairs in
    the 512 bucket, bf16, CrossEncoder.score_pairs, host clock over 3 calls
    after a warm-up, busy time of one call); an nli (CoSENT, every parameter
    over fp32 masters) step at B=8, T=512: ms (CUDA events over chained
    steps with a canary), Kt/s, busy and idle share; B.5's full form in the
    nli step, device ms and launches. The cross-encoder LoRA step's reading
    is left out for the script's time limit (PERF.md §5 has its numbers):
    16a holds its gradients to the plain route, 16b trains it through the
    CLI, and the nli step's profile holds the same kernel bodies."""
    tok = WorldTokenizer()
    pairs = rerank_pairs(tok)
    reranker.score_pairs(pairs, batch_size=RERANK_PAIRS)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        scores = reranker.score_pairs(pairs, batch_size=RERANK_PAIRS)
    wall = (time.perf_counter() - t0) / 3
    check(np.isfinite(scores).all(), "non-finite rerank scores")
    busy = busy_us(device_ops(lambda: reranker.score_pairs(pairs, batch_size=RERANK_PAIRS), 1)) / 1e3
    print(f"  reading: {RERANK_PAIRS / wall:.2f} reranked pairs/s ({RERANK_PAIRS} pairs, bucket 512, "
          f"bf16, {wall * 1e3:.1f} ms a call, device busy {busy:.3f} ms) on {smi}")
    del reranker
    torch.cuda.empty_cache()

    gen = torch.Generator(device=DEV).manual_seed(31)
    model, cfg = load_rwkv_checkpoint(path, device=DEV, param_dtype="float32")
    apply_trainable_mask(model, trainable_mask(model, "full"))
    loss_fn = functools.partial(contrastive_loss_fn, loss="cosent", pooling="lasttoken", remat=True)
    step = make_train_step(model, TrainConfig(lr_init=1e-5, warmup_steps=0, total_steps=100), loss_fn)
    batch = triplet_rows(gen, cfg.vocab_size)
    step(batch)      # warm-up; builds the optimizer state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainable = [p for p in model.parameters() if p.requires_grad]
    reset_launch_counts()
    ms, losses, before_last = chained_steps(step, batch, 3, trainable)
    b5 = launch_counts()["tmix_prologue_bwd"] // 3
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(losses).all()), f"non-finite nli losses {losses}")
    train_canary(model, loss_fn, trainable, before_last, batch, triplet_rows(gen, cfg.vocab_size),
                 losses[-1], "nli train steps")
    del before_last
    tokens = 3 * TB * T
    print(f"  reading: nli train step (CoSENT over triplets, every parameter, fp32 master weights, "
          f"bf16 compute) {ms:.2f} ms, {tokens / ms:.2f} Kt/s ({tokens} tokens a step: B={TB} "
          f"triplets of T={T}, remat on, peak {peak:.1f} GiB) on {smi}")
    split = step_profile(step, batch, ms, what="one nli step", kernels=LORA_STEP_KERNELS)
    print(f"  reading: B.5 in its full form (with the weight gradients) in the nli step: {b5} launches "
          f"a step, {split['B.5']:.3f} ms a step, {split['B.5'] / max(b5, 1):.4f} ms a launch on {smi}")
    check(b5 == 3 * cfg.n_layer, f"B.5 ran {b5} times a step, not {3 * cfg.n_layer}")
    del model, step
    free()


TBPTT_CHUNK = T // 4        # phase 17a's chunk_ctx: 4 chunks of 128
QLORA_MODES = ("int8c", "int8", "nf4")


def qlora_step_counts(n_layer: int, remat: bool) -> dict:
    """Launches of one QLoRA int8c step (LoRA r=8 over an int8c base): the
    LoRA step's, and B.4 once a projection a forward (8 a layer), again
    under remat; its straight-through backward launches none."""
    return dict(train_step_counts(n_layer, remat),
                quantize_rows=INT8C_PER_LAYER * n_layer * (2 if remat else 1))


def rel_grads(what: str, got: dict, want: dict, limit: float = 1e-3) -> None:
    """Each tensor of `got` within `limit` of the largest value of `want`'s."""
    rel = {n: (got[n] - want[n]).abs().max().item() / want[n].abs().max().item() for n in want}
    worst = max(rel, key=rel.get)
    print(f"  {what}, {len(want)} gradient tensors: max |a - b| / max|b| = {rel[worst]:.3e} "
          f"({worst}; limit {limit:g})")
    check(rel[worst] <= limit, f"{what}: gradient {worst} off by {rel[worst]}")


def int8c_under_grad() -> None:
    """B.4 under a training step, alone: one int8c projection of an input
    that requires grad, at the QLoRA path's shape ((B*T, C) fp32 and bf16
    against (F, C) weights), through QuantLinear on the kernel route (B.4
    inside the straight-through Function) and on the plain route: the
    outputs and dx bit-equal, B.4 launched once a forward and not in the
    backward."""
    gen = torch.Generator(device=DEV).manual_seed(42)
    w = torch.randn(F, C, device=DEV, generator=gen) * 0.02
    lin = quantize_linear(w, "int8c")
    for dtype in (torch.float32, BF16):
        x = torch.randn(TB * T, C, device=DEV, generator=gen).to(dtype)
        g = torch.randn(TB * T, F, device=DEV, generator=gen).to(dtype)
        outs = []
        for ops in (KERNEL_OPS, PLAIN_OPS):
            xr = x.clone().requires_grad_(True)
            reset_launch_counts()
            y = lin(xr, ops)
            y.backward(g)
            torch.cuda.synchronize()
            outs.append((y.detach(), xr.grad, launch_counts()["quantize_rows"]))
        (yk, dk, nk), (yp, dp, np_) = outs
        print(f"  int8c projection under grad ({TB * T}, {C}) x ({F}, {C}), {dtype}: output and dx "
              f"bit-equal kernel vs plain: {torch.equal(yk, yp)}, {torch.equal(dk, dp)}; B.4 launches "
              f"{nk} (plain route {np_})")
        check(torch.equal(yk, yp) and torch.equal(dk, dp) and (nk, np_) == (1, 0),
              f"int8c under grad, {dtype}: the routes differ, or B.4 launches {(nk, np_)} != (1, 0)")


def route_gap(what: str, k: dict, p: dict, d: dict, against: str, floor: float = 0.0,
              scale: float = 1.0, cap: float = math.inf) -> None:
    """Per gradient tensor, the kernel route (k) no farther from the plain
    route (p), as 1 - cosine, than `scale` times the distance of `d` from
    the plain route, at most `cap` (or than `floor`, whichever is larger)."""
    gap = {n: (1 - cosine(k[n], p[n]), max(floor, min(cap, scale * (1 - cosine(p[n], d[n])))))
           for n in p}
    worst = max(gap, key=lambda n: gap[n][0] / gap[n][1])
    rel = max((k[n] - p[n]).abs().max().item() / p[n].abs().max().item() for n in p)
    print(f"  {what}, {len(p)} gradient tensors: kernel vs plain max |a - b| / max|b| {rel:.3e}; "
          f"1 - cosine kernel vs plain {gap[worst][0]:.3e} against {against} {gap[worst][1]:.3e} "
          f"({worst}, the largest ratio; limit 1)")
    check(all(a <= b for a, b in gap.values()),
          f"{what}: the kernel route departs from the plain route by more than {against} "
          f"({worst}: {gap[worst]})")


def int8c_gradient_drift(model, loss_fn, batch, k: dict, p: dict, label: str) -> None:
    """int8c rounds every projection's input to int8 rows, so the last-bit
    differences between the kernel route's and the plain route's
    activations move roundings across a half, each by 1/127 of a row's
    absmax: no 1e-3 limit holds for its gradients. The kernel route is held
    no farther from the plain route than int8c's rounding moves the plain
    route's gradient from the int8 mode's on the same codes, the rule by
    which phase 5 holds int8c's forward."""
    modes = [m for m in model.modules() if isinstance(m, QuantLinear)]
    for m in modes:
        m.mode = "int8"
    d = trainable_grads(model, loss_fn, batch, reference=True, skip=())
    for m in modes:
        m.mode = "int8c"
    route_gap(f"QLoRA over int8c, {label}", k, p, d, "int8c vs int8 on the plain route")


# PERF.md section 2's bf16 gradient bound (ROADMAP C.24). Two bf16 routes
# whose ops each round their results once (the kernels as the plain ops do:
# phase 20f finds no op where they part) have rounding errors e_k, e_p
# from the fp32 gradient f of about the same size and independent, so for
# small angles 1 - cos(k, p) ~ (1 - cos(k, f)) + (1 - cos(p, f)), about
# twice the bf16 plain route's distance from fp32: the kernel route is held
# within C24_BOUND times it (floor 1e-3). The sum holds only for small
# angles: where the bf16 plain route sits far from fp32 (a cosine of 0.45
# on `full`'s layer 0, an error both routes share), twice its distance
# would pass an uncorrelated gradient, so the allowance stops at C24_CAP.
C24_BOUND = 2.0
C24_CAP = 1e-2


def bf16_gap(what: str, k16: dict, p16: dict, p32: dict) -> None:
    """bf16 over a 4-bit base, over every parameter of the causal loss and
    over the RWKV-5 / RWKV-4 LoRA: PERF.md section 2's margin (the kernel
    route's cosine to the fp32 plain route within 1e-3 of the bf16 plain
    route's) is read, not held: where both bf16 routes sit 1e-2 or more from
    fp32, that margin is itself of the size of the rounding noise (it
    reached -4e-3 on nf4 QLoRA). Held instead: C24_BOUND."""
    margins = {n: cosine(k16[n], p32[n]) - cosine(p16[n], p32[n]) for n in p32}
    worst = min(margins, key=margins.get)
    print(f"  {what}, bf16 vs the fp32 plain route: min cosine kernel route "
          f"{min(cosine(k16[n], p32[n]) for n in p32):.6f}, plain route in bf16 "
          f"{min(cosine(p16[n], p32[n]) for n in p32):.6f}; worst margin {margins[worst]:+.2e} "
          f"({worst}; read)")
    route_gap(f"{what}, bf16", k16, p16, p32,
              "C24_BOUND x the bf16 plain route vs fp32 (at most C24_CAP)",
              floor=1e-3, scale=C24_BOUND, cap=C24_CAP)


def full_sequence_loss_fn(model, batch, *, reference: bool = False) -> torch.Tensor:
    """The causal loss of the whole sequence without L2Wrap: what TBPTT's
    loss equals."""
    logits, _ = model(batch["input_ids"], t1_step=False, remat=True, reference=reference)
    return causal_lm_loss(logits, batch["labels"], l2_wrap=False)


def phase_peft_grads(path: str) -> None:
    """Phase 17a (the module docstring): a 2-layer full-width model, kernel
    route against plain route."""
    sd2 = two_layer_sd(path)
    gen = torch.Generator(device=DEV).manual_seed(40)
    batch = train_batch(gen, rwkv6_1b6().vocab_size)

    def model_of(dtype, param_dtype="", quant=None):
        m = load_state_dict_into(RWKV(rwkv6_1b6(n_layer=2, dtype=dtype, param_dtype=param_dtype),
                                      device=DEV), sd2)
        return quantize_model(m, quant, weights=sd2) if quant else m

    adapter = init_lora_params(model_of("float32"), LORA, gen)
    for ab in adapter.values():
        ab["B"].normal_(0.0, 0.01, generator=gen)
    sft = functools.partial(sft_loss_fn, remat=True)
    int8c_under_grad()
    for mode in QLORA_MODES:
        m32 = apply_lora(model_of("float32", quant=mode), LORA, adapter)
        k32 = trainable_grads(m32, sft, batch, reference=False, skip=())
        p32 = trainable_grads(m32, sft, batch, reference=True, skip=())
        if mode == "int8c":
            int8c_gradient_drift(m32, sft, batch, k32, p32, "fp32")
        else:
            rel_grads(f"QLoRA over {mode}, fp32, kernel vs plain", k32, p32)
        del m32
        m16 = apply_lora(model_of("bfloat16", quant=mode), LORA, adapter)
        k16 = trainable_grads(m16, sft, batch, reference=False, skip=())
        p16 = trainable_grads(m16, sft, batch, reference=True, skip=())
        if mode == "int8c":
            int8c_gradient_drift(m16, sft, batch, k16, p16, "bf16")
        else:
            bf16_gap(f"QLoRA over {mode}", k16, p16, p32)
        if mode != "nf4":
            # int8 dequantizes on use (no B.4); int8c runs B.4 a projection
            step = make_train_step(m16, TrainConfig(lr_init=1e-5, warmup_steps=0, total_steps=10))
            reset_launch_counts()
            loss = step(batch)["loss"]
            torch.cuda.synchronize()
            counts = launch_counts()
            want = qlora_step_counts(2, True) if mode == "int8c" else train_step_counts(2, True)
            print(f"  launches in one QLoRA {mode} step (2 layers, remat on): {counts}")
            check(counts == want and bool(torch.isfinite(loss)),
                  f"QLoRA {mode} counts {counts} != {want}")
            del step
        del m16, k32, p32, k16, p16
        torch.cuda.empty_cache()

    tbptt = functools.partial(tbptt_loss_fn, chunk_ctx=TBPTT_CHUNK, remat=True)
    m = model_of("float32")
    k = trainable_grads(m, tbptt, batch, reference=False, skip=())
    p = trainable_grads(m, tbptt, batch, reference=True, skip=())
    rel_grads(f"TBPTT (chunk_ctx {TBPTT_CHUNK}) over every parameter, fp32, kernel vs plain", k, p)
    whole = trainable_grads(m, full_sequence_loss_fn, batch, reference=False, skip=())
    with torch.no_grad():
        losses = [tbptt(m, batch).item(), full_sequence_loss_fn(m, batch).item()]
    print(f"  TBPTT against the full sequence without L2Wrap, kernel route: losses {losses[0]:.6f} "
          f"and {losses[1]:.6f}")
    check(abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]), f"TBPTT loss {losses}")
    rel_grads("TBPTT vs the full-sequence loss, kernel route, fp32", k, whole)
    del k, p, whole
    apply_trainable_mask(m, trainable_mask(m, "full"))
    step = make_train_step(m, TrainConfig(lr_init=1e-5, warmup_steps=0, total_steps=10,
                                          chunk_ctx=TBPTT_CHUNK))
    reset_launch_counts()
    loss = step(batch)["loss"]
    torch.cuda.synchronize()
    counts, want = launch_counts(), full_step_counts(2, True, T // TBPTT_CHUNK)
    print(f"  launches in one TBPTT step (2 layers, {T // TBPTT_CHUNK} chunks, remat on): {counts}")
    check(counts == want and bool(torch.isfinite(loss)), f"TBPTT counts {counts} != {want}")
    del step, m
    torch.cuda.empty_cache()

    m32 = model_of("float32")
    p32 = kernel_vs_plain("sft --train-type full (causal loss over every parameter, fp32)", m32,
                          sft, batch, skip=())
    del m32
    m16 = model_of("bfloat16", "float32")
    k16 = trainable_grads(m16, sft, batch, reference=False, skip=())
    p16 = trainable_grads(m16, sft, batch, reference=True, skip=())
    bf16_gap("sft --train-type full over fp32 masters", k16, p16, p32)
    del m16, k16, p16, p32
    torch.cuda.empty_cache()

    m = apply_lora(model_of("bfloat16"), LORA, adapter)
    on = trainable_grads(m, sft, batch, reference=False, skip=())
    for policy in ("dots", "dots_nobatch"):
        got = trainable_grads(m, functools.partial(sft_loss_fn, remat=policy), batch,
                              reference=False, skip=())
        check(all(torch.equal(got[n], on[n]) for n in on), f"{policy} gives other gradients")
    print("  LoRA, bf16, kernel route: dots and dots_nobatch give the gradients of remat on, "
          "bit for bit")
    del m, on
    torch.cuda.empty_cache()


def sft_task_jsonl(path: Path, tok) -> None:
    """phase 9's 64 rows in the 512 bucket, tasks "chat" and "kg" in turns."""
    sft_jsonl(path, tok)
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    path.write_text("".join(json.dumps(dict(r, task=("chat", "kg")[i % 2])) + "\n"
                            for i, r in enumerate(rows)))


def start_peft_clis(path: str, tmp: Path) -> tuple:
    """Phase 17b's six `train.cli sft` subprocesses on the first CUT_LAYERS
    layers, started (all at once: about 40 GB of the card together)."""
    tok = WorldTokenizer()
    data, tasks = tmp / "sft.jsonl", tmp / "sft_tasks.jsonl"
    if not data.exists():
        sft_jsonl(data, tok)
    sft_task_jsonl(tasks, tok)
    cut = tmp / f"rwkv6_1b6_synthetic_{CUT_LAYERS}_layers.pth"
    if not cut.exists():
        torch.save(two_layer_sd(path, CUT_LAYERS), cut)
    out = tmp / "peft"
    common = ["--micro-bsz", "64", "--ctx-len", str(T), "--max-steps", "2", "--log-every", "1",
              "--warmup-steps", "0", "--lr-init", "1e-4", "--platform", DEV]
    jobs = [
        ("pissa", ["sft", "--train-type", "pissa", "--model", str(cut), "--train-data", str(data)]),
        ("int8c", ["sft", "--quant", "int8c", "--model", str(cut), "--train-data", str(data)]),
        ("nf4", ["sft", "--quant", "nf4", "--model", str(cut), "--train-data", str(data)]),
        ("slot-lora", ["sft", "--train-type", "slot-lora", "--model", str(cut), "--train-data",
                       str(tasks)]),
        ("lisa", ["sft", "--train-type", "full", "--lisa-k", "2", "--model", str(cut),
                  "--train-data", str(data)]),
        ("tbptt", ["sft", "--train-type", "full", "--chunk-ctx", "128", "--model", str(cut),
                   "--train-data", str(data)]),
    ]
    return start_cli_jobs([(label, argv + ["--output-dir", str(out / label), *common])
                           for label, argv in jobs], out)


def phase_peft_cli(path: str, tmp: Path, started: tuple) -> None:
    """Phase 17b (the module docstring): the runs of start_peft_clis. Each
    run's files are held to the JAX names and layouts; the served PiSSA
    adapter's greedy tokens to its teacher-forced argmax."""
    tok = WorldTokenizer()
    cut = tmp / f"rwkv6_1b6_synthetic_{CUT_LAYERS}_layers.pth"
    out = tmp / "peft"
    wait_cli_jobs(started)
    cfg = rwkv6_1b6(n_layer=CUT_LAYERS)
    for name in ("pissa/init_pissa.pth", "pissa/lora-step2.pth", "int8c/lora-step2.pth",
                 "nf4/lora-step2.pth", "slot-lora/lora-chat-step2.pth",
                 "slot-lora/lora-kg-step2.pth"):
        sd = torch.load(out / name, map_location="cpu", weights_only=True)
        check(len(sd) == cfg.n_layer * 8 * 2 and sd["blocks.0.att.key.lora_A"].shape == (8, C)
              and sd[f"blocks.{cfg.n_layer - 1}.ffn.value.lora_B"].shape == (C, 8)
              and all(v.dtype == torch.float32 for v in sd.values()), f"{name}: not a LoRA file")
    print(f"  LoRA files in the reference layout ({cfg.n_layer * 16} tensors each): init_pissa.pth "
          f"and lora-step2.pth (pissa), lora-step2.pth (int8c, nf4), lora-chat-step2.pth and "
          f"lora-kg-step2.pth (slot-lora)")
    base = torch.load(cut, map_location="cpu", weights_only=True, mmap=True)
    for label in ("lisa", "tbptt"):
        print(f"  {label}: {check_trained_file(out / label / 'model-step2.pth', base)}")
    del base

    args = ["--model", str(cut), "--quant", "nf4", "--chat-adapter", str(out / "pissa/lora-step2.pth"),
            "--pissa-init", str(out / "pissa/init_pissa.pth"), "--platform", DEV]
    prompt = "The passage is about foxes."
    payload = {"prompt": prompt, "max_tokens": 16, "temperature": 0.0, "top_p": 1.0,
               "alpha_presence": 0.0, "alpha_frequency": 0.0, "token_stop": []}
    server = CliServer(args + ["--port", "0"])
    server.start()      # loads while this process builds the same service
    service = cli.build_service(cli.parse_args(args))
    with server as url:
        code, answer = post(url + "/generate", payload)
    check(code == 200 and isinstance(answer.get("output"), str), f"/generate answered {code}")
    model = service.engine.model
    check(model.blocks[0].att.key.mode == "nf4", "the served PiSSA model is not nf4")
    prompt_ids = tok.encode(prompt)
    outs = GenerationEngine(model, None).generate(prompt_ids, max_tokens=16, sampling=GREEDY)
    check(tok.decode(outs) == answer["output"], "the CLI's greedy answer is not the engine's")
    logits = teacher_forced_rows(model, [prompt_ids], [outs], None, reference=False)
    check(bool((logits.argmax(-1) == torch.tensor([outs], device=DEV)).all()),
          "a served PiSSA token is not the argmax of its teacher-forced logits")
    print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli {' '.join(a for a in args if '/' not in a)}: "
          f"/generate 200, {len(outs)} greedy tokens, each the argmax of the served nf4 model's "
          f"teacher-forced logits")
    service.close()
    del service, model
    torch.cuda.empty_cache()


def read_train_step(model, step, loss_fn, batch, other, what: str, smi: str, iters: int = 3,
                    split: bool = False) -> list:
    """A reading of `step` on `batch`: ms over `iters` chained steps (CUDA
    events, after a warm-up) with the train canary, Kt/s, the busy time of
    one step (the union of its kernel intervals), its idle share and the
    peak memory; with `split`, its device time by kernel group. Returns the
    device ops of the profiled step."""
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainable = [p for p in model.parameters() if p.requires_grad]
    ms, losses, before_last = chained_steps(step, batch, iters, trainable)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(losses).all()), f"{what}: non-finite losses {losses}")
    train_canary(model, loss_fn, trainable, before_last, batch, other, losses[-1], what)
    del before_last
    ops = device_ops(lambda: step(batch), 1)
    busy = busy_us(ops) / 1e3
    print(f"  reading: {what}: {ms:.2f} ms, {TB * T / ms:.2f} Kt/s, busy {busy:.3f} ms in "
          f"{len(ops)} device ops, idle {100 * max(ms - busy, 0) / ms:.2f} %, peak {peak:.1f} GiB "
          f"(B={TB}, T={T}) on {smi}")
    if split:
        print("    " + ", ".join(f"{g} {v:.3f}" for g, v in split_by_group(ops, STEP_GROUPS).items()
                                 if v > 0))
    return ops


def kernel_launches(ops: list, name: str) -> int:
    return sum(1 for e in ops if name in e.name)


def phase_peft_readings(path: str, smi: str) -> None:
    """Phase 17c (the module docstring), 24 layers."""
    gen = torch.Generator(device=DEV).manual_seed(41)
    batch, other = train_batch(gen, rwkv6_1b6().vocab_size), train_batch(gen, rwkv6_1b6().vocab_size)
    # the int8 and nf4 modes' readings are left out to keep the script
    # inside its time limit (PERF.md §5 has earlier readings): 17a holds both
    # modes' QLoRA gradients to the plain route and takes an int8 step at 2
    # layers, 17b trains nf4 through the CLI
    for mode in ("int8c",):
        model, cfg = load_rwkv_checkpoint(path, device=DEV, quant=mode)
        apply_lora(model, LORA, init_lora_params(model, LORA, gen))
        if mode == "int8c":
            for remat in (False, True):
                step = make_train_step(model, TrainConfig(lr_init=1e-4, warmup_steps=0,
                                                          total_steps=100, grad_checkpoint=remat))
                reset_launch_counts()
                step(batch)
                torch.cuda.synchronize()
                counts, want = launch_counts(), qlora_step_counts(cfg.n_layer, remat)
                print(f"  launches in one QLoRA int8c step, remat {'on' if remat else 'off'}: "
                      f"B.4 {counts['quantize_rows']}; {counts}")
                check(counts == want, f"QLoRA int8c step counts {counts} != {want}")
        step = make_train_step(model, TrainConfig(lr_init=1e-4, warmup_steps=0, total_steps=100))
        ops = read_train_step(model, step, functools.partial(sft_loss_fn, remat=True), batch, other,
                              f"QLoRA {mode} step (LoRA r=8, remat on)", smi)
        if mode == "int8c":
            # the profiler may lose one record in ten (device_ops)
            b4, want = kernel_launches(ops, "quant_rows"), INT8C_PER_LAYER * cfg.n_layer * 2
            print(f"  B.4 on the device in one QLoRA int8c step (remat on): {b4} launches")
            check(0.9 * want <= b4 <= want, f"B.4 ran {b4} times on the device, not {want}")
        del model, step, ops
        torch.cuda.empty_cache()

    # the LoRA steps under dots and dots_nobatch are left out for the
    # script's time limit (PERF.md §5 has dots' reading): 17a holds both
    # policies' gradients bit-equal to remat on's

    model, cfg = load_rwkv_checkpoint(path, device=DEV, param_dtype="float32")
    apply_trainable_mask(model, trainable_mask(model, "full"))
    tc = dict(lr_init=1e-5, warmup_steps=0, total_steps=100)
    sft = functools.partial(sft_loss_fn, remat=True)
    step = make_train_step(model, TrainConfig(**tc))
    read_train_step(model, step, sft, batch, other,
                    "sft --train-type full step (fp32 masters, bf16 compute)", smi, split=True)
    del step
    torch.cuda.empty_cache()

    # the TBPTT step's reading at 24 layers is left out for the script's time
    # limit: 17a holds a 2-layer TBPTT step's gradients and launches, 17b
    # trains `--chunk-ctx 128` through the CLI, phase 20d reads RWKV-4's
    # TBPTT step at 24 layers (PERF.md §5 has RWKV-6's)

    # the LISA step's reading is left out for time (PERF.md §5 has one; 17b
    # trains `--lisa-k 2` through the CLI)
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 18: RWKV-5.x and RWKV-4 through the serving path
# ---------------------------------------------------------------------------

WKV4_REL = {torch.float32: 1e-4, BF16: 1e-2}    # B.14's y, x max|plain|; its state 1e-4
# phase 18b / 18c's depth (24 before phase 23 needed the script's time)
FAMILY_SERVE_LAYERS = 12
V5_FORWARD = dict(NO_LAUNCH, layer_norm=2 * FAMILY_SERVE_LAYERS + 2,
                  wkv6_fused_output=FAMILY_SERVE_LAYERS)
V5_STEP = dict(NO_LAUNCH, layer_norm=2 * FAMILY_SERVE_LAYERS + 2,
               wkv6_decode_step=FAMILY_SERVE_LAYERS)
V4_FORWARD = V4_STEP = dict(NO_LAUNCH, layer_norm=2 * FAMILY_SERVE_LAYERS + 2,
                            wkv4=FAMILY_SERVE_LAYERS)
FAMILY_NEW = 48                                # greedy tokens of the engine checks


def wkv4_inputs(rng: Inputs, b: int, t: int, dtype, carried: bool) -> tuple:
    """k in [-3, 60] (large k: the running max keeps exp in range), v, the
    decay w = -exp(.) and the bonus u (C,), and a carried state or None (a
    fresh one: pp = -1e38)."""
    f = torch.float32
    k = rng.uniform(b, t, C, lo=-3.0, hi=60.0, dtype=dtype)
    v = rng.normal(b, t, C, dtype=dtype)
    w, u = -torch.exp(rng.normal(C, dtype=f)), rng.normal(C, dtype=f)
    state = None
    if carried:
        state = (rng.normal(b, C, dtype=f), torch.exp(rng.normal(b, C, dtype=f)),
                 rng.normal(b, C, scale=5.0, dtype=f))
    return k, v, w, u, state


def phase_wkv4_kernel(smi: str) -> dict:
    """B.14 against wkv4_plain at B in {1, 64}, T in {1, 17, 512}, fp32 and
    bf16 inputs, from a fresh state and a carried one; in place; then timed
    at the prefill shape (B=64, T=512, bf16) beside its bound, and at the
    decode shape. Returns its entry of the kernels line."""
    rng = Inputs(18)
    errs = []
    for dtype in (torch.float32, BF16):
        for b in (1, B):
            for t in (1, 17, T):
                for carried in (False, True):
                    k, v, w, u, state = wkv4_inputs(rng, b, t, dtype, carried)
                    y, st = wkv4(k, v, w, u, state)
                    py, pst = wkv4_plain(k, v, w, u, state)
                    check(bool(torch.isfinite(y).all()), "wkv4: non-finite y")
                    err = (y - py).abs().max().item()
                    scale = py.abs().max().item()
                    serr = max((a - p).abs().max().item() / p.abs().max().item()
                               for a, p in zip(st, pst))
                    print(f"  wkv4 {'fp32' if dtype == torch.float32 else 'bf16'} B={b} T={t} "
                          f"{'carried' if carried else 'fresh (pp = -1e38)'}: max |kernel - plain| "
                          f"y {err:.3e} (limit {WKV4_REL[dtype] * scale:.3e}), state "
                          f"{serr:.3e} x max|plain| (limit 1e-4)")
                    check(err <= WKV4_REL[dtype] * scale and serr <= 1e-4,
                          f"wkv4 B={b} T={t} {dtype}: y {err}, state {serr}")
                    errs.append(err)
    k, v, w, u, state = wkv4_inputs(rng, B, T, BF16, True)
    y, fresh = wkv4(k, v, w, u, state)
    buf = tuple(s.clone() for s in state)
    y2, out = wkv4(k, v, w, u, buf, out_state=buf)
    check(torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(out, fresh)),
          "wkv4 in place differs from a fresh output")
    buf = tuple(s.clone() for s in state)
    ms = device_ms(lambda: wkv4(k, v, w, u, buf, out_state=buf), 20)
    plain_ms = device_ms(lambda: wkv4_plain(k, v, w, u, state), 2)
    # k and v read, y written in fp32, w and u, the state read and written;
    # a step is 4 exp, a division, 2 max and ~9 adds and products (fp32)
    bound = roofline(nbytes(k, v, y, w, u) + 2 * nbytes(*state), {"fp32": 16 * B * T * C})
    k1, v1, w1, u1, s1 = wkv4_inputs(rng, 1, 1, BF16, True)
    ms1 = device_ms(lambda: wkv4(k1, v1, w1, u1, s1, out_state=s1), 50)
    print(f"  reading: wkv4 B={B}, T={T}, C={C}, bf16: kernel {ms:.4f} ms, bound {bound['bound_ms']:.4f} "
          f"ms ({bound['bound_by']}; {100 * bound['bound_ms'] / ms:.1f} % of it), plain "
          f"{plain_ms:.2f} ms; the decode shape B=1, T=1: {ms1:.4f} ms, on {smi}")
    return {"wkv4": dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, **bound)}


def v5_decay(rng: Inputs, per_head: bool) -> torch.Tensor:
    """A v5 decay (H, N) in [-6, 1] (real RWKV-5 checkpoints), one value a
    head or one a channel."""
    return rng.uniform(H, 1 if per_head else N, lo=-6.0, hi=1.0, dtype=torch.float32).expand(H, N)


def phase_v5_kernels(smi: str) -> None:
    """K1 and B.9 on v5's constant decays, per channel and per head, with a
    silu gate and with ones (v5.0): K1 at B=8, T=512 (out within 1e-2, state
    within 1e-3 of max|plain|, as phase 2 holds K1) and B.9 at B=64 in place
    (out 1e-2, state 1e-5); then K1 at B=64, T=512 with the decay expanded
    over (B, T) (what TimeMixV5 passes; the wrapper makes it contiguous)
    beside a contiguous one."""
    rng = Inputs(19)
    lsc, lbi = rng.normal(H * N, scale=0.1) + 1, rng.normal(H * N, scale=0.1)
    u = rng.normal(H, N, scale=0.5)
    for per_head in (False, True):
        for gate in (True, False):
            label = f"{'per head' if per_head else 'per channel'}, {'gate' if gate else 'ones'}"
            td = v5_decay(rng, per_head)
            r, k, v = (rng.normal(8, T, H, N) for _ in range(3))
            g = torch.nn.functional.silu(rng.normal(8, T, H, N)) if gate else torch.ones_like(r)
            w = td.reshape(1, 1, H, N).expand(8, T, H, N)
            s0 = rng.normal(8, H, N, N, scale=0.1, dtype=torch.float32)
            o, s = wkv6_fused_output(r, k, v, w, u, g, lsc, lbi, s0, eps=LN_X_EPS)
            po, ps = wkv6_fused_output_plain(*f32(r, k, v, w, u, g, lsc, lbi, s0), eps=LN_X_EPS)
            err_line(f"wkv6_fused_output v5 decay ({label}) B=8 T={T} out", o, po, 1e-2)
            err_line(f"wkv6_fused_output v5 decay ({label}) B=8 T={T} state", s, ps, 1e-3)
            rb, kb, vb = (rng.normal(B, C) for _ in range(3))
            gb = torch.nn.functional.silu(rng.normal(B, C)) if gate else torch.ones_like(rb)
            wb = td.reshape(1, C).expand(B, C).contiguous()
            st = rng.normal(B, H, N, N, scale=0.1, dtype=torch.float32)
            po, ps = wkv6_decode_step_plain(*f32(rb, kb, vb, wb, gb, u, lsc, lbi, st), eps=LN_X_EPS)
            o, s = wkv6_decode_step(rb, kb, vb, wb, gb, u, lsc, lbi, st, eps=LN_X_EPS, out_state=st)
            err_line(f"wkv6_decode_step v5 decay ({label}) B={B} out", o, po, 1e-2)
            err_line(f"wkv6_decode_step v5 decay ({label}) B={B} state (in place)", s, ps, 1e-5)
    r, k, v, g = (rng.normal(B, T, H, N) for _ in range(4))
    expanded = v5_decay(rng, False).reshape(1, 1, H, N).expand(B, T, H, N)
    dense = expanded.contiguous()
    s0 = rng.normal(B, H, N, N, scale=0.1, dtype=torch.float32)
    ms_x = device_ms(lambda: wkv6_fused_output(r, k, v, expanded, u, g, lsc, lbi, s0, eps=LN_X_EPS), 10)
    ms_d = device_ms(lambda: wkv6_fused_output(r, k, v, dense, u, g, lsc, lbi, s0, eps=LN_X_EPS), 10)
    print(f"  reading: K1 at B={B}, T={T} with v5's decay expanded over (B, T) {ms_x:.4f} ms, with "
          f"it contiguous {ms_d:.4f} ms: the expansion costs {ms_x - ms_d:.4f} ms a layer "
          f"({nbytes(dense) / 1e6:.0f} MB written and read), on {smi}")


def family_models(cfg_fn, seed: int) -> tuple:
    """The bf16 model at full width (seeded synthetic weights) and the fp32
    plain-route model on the same bf16-rounded weights."""
    model = load_state_dict_into(RWKV(cfg_fn(), device=DEV), synthetic_1b6(cfg_fn(), seed))
    reference = load_state_dict_into(RWKV(cfg_fn(dtype="float32"), device=DEV), model.state_dict())
    return model, reference


def min_cosine_chunked(a: torch.Tensor, b: torch.Tensor, rows: int = 2048) -> float:
    """min_cosine over the positions of two (..., V) tensors, a slice of
    positions at a time (a (64, 512, 65536) logits pair in double would take
    34 GB)."""
    a, b = a.flatten(0, -2), b.flatten(0, -2)
    return min(min_cosine(a[i:i + rows], b[i:i + rows]) for i in range(0, a.shape[0], rows))


def count_launches(fn) -> tuple:
    """(fn()'s result, the launches it made), counters set to 0 before it."""
    reset_launch_counts()
    out = fn()
    return out, launch_counts()


def prefill_decode_against_forward(model, label: str) -> None:
    """Prefill 64 + 16 decode steps against one forward over 80 (B=4), and
    the launches of exactly one decode step (in place)."""
    gen = torch.Generator(device=DEV).manual_seed(22)
    tokens = torch.randint(4, model.cfg.vocab_size, (4, 80), device=DEV, generator=gen)
    with torch.inference_mode():
        full, _ = model(tokens)
        logits, state = model(tokens[:, :64])
        steps = [logits[:, -1]]
        for t in range(64, 79):
            lg, state = rwkv_decode_step(model, tokens[:, t], state, out=state)
            steps.append(lg)
        _, counts = count_launches(lambda: rwkv_decode_step(model, tokens[:, 79], state, out=state))
    cos = min_cosine(torch.stack(steps, 1), full[:, 63:79])
    want = V5_STEP if model.cfg.version >= 5 else V4_STEP
    print(f"  {label}: prefill 64 + 16 decode steps vs one forward over 80 (B=4): min per-position "
          f"logits cosine {cos:.6f} (limit 0.999); launches of one decode step: {counts}")
    check(cos >= 0.999, f"{label}: prefill+decode vs full forward cosine {cos}")
    check(counts == want, f"{label}: decode-step launch counts {counts} != {want}")


def family_generation(model, label: str) -> None:
    """Greedy generate (48 tokens, 16-step blocks): CUDA-graph blocks against
    eager blocks, tokens and final state bit-equal, and every token the
    argmax of the same route's teacher-forced logits."""
    engine = GenerationEngine(model)
    gen = torch.Generator(device=DEV).manual_seed(23)
    prompt = torch.randint(4, model.cfg.vocab_size, (16,), device=DEV, generator=gen)
    run = lambda: engine.generate(prompt.tolist(), max_tokens=FAMILY_NEW, sampling=GREEDY,
                                  block_size=16, return_state=True)
    out, state = run()
    with eager_blocks():
        e_out, e_state = run()
    check(out == e_out and states_equal(state, e_state),
          f"{label}: graph blocks and eager blocks differ")
    toks = torch.tensor(out, device=DEV)
    kern = teacher_forced(model, prompt, toks, reference=False)
    check(len(out) == FAMILY_NEW and bool((kern.argmax(-1) == toks).all()),
          f"{label}: the greedy tokens are not the argmax of the teacher-forced logits")
    print(f"  {label}: greedy generate, {FAMILY_NEW} tokens in 16-step graph blocks: tokens and "
          f"final state bit-equal to eager blocks, each token the argmax of its teacher-forced "
          f"logits")


def v4_batcher(model, label: str) -> None:
    """8 concurrent greedy requests through the continuous batcher (8 slots,
    16-step graph blocks): admission scatters each request's aa, bb and pp
    rows into the pool; every row's tokens are the argmax of its logits
    teacher-forced at B=8 through the batcher's chunk plan."""
    engine = GenerationEngine(model)
    batcher = ContinuousBatcher(engine, n_slots=8, sampling=GREEDY, block_size=16)
    gen = torch.Generator(device=DEV).manual_seed(24)
    prompts = torch.randint(4, model.cfg.vocab_size, (8, 16), device=DEV, generator=gen).tolist()
    rids = [batcher.submit(p, max_tokens=32) for p in prompts]
    results = batcher.run()
    outs = [results[r] for r in rids]
    check(all(len(o) == 32 for o in outs), f"{label}: batcher rows of {[len(o) for o in outs]} tokens")
    with torch.inference_mode():
        prompt, state, off = torch.tensor(prompts, device=DEV), None, 0
        for size in engine_module._chunk_plan(15, engine.chunk_len):
            _, state = model(prompt[:, off: off + size], state)
            off += size
        feed = torch.cat([prompt[:, -1:], torch.tensor(outs, device=DEV)[:, :-1]], 1)
        picks = []
        for t in range(32):
            lg, state = rwkv_decode_step(model, feed[:, t], state, out=state)
            picks.append(lg.argmax(-1))
    check(torch.equal(torch.stack(picks, 1), torch.tensor(outs, device=DEV)),
          f"{label}: batcher tokens are not the argmax of their teacher-forced logits")
    print(f"  {label}: the batcher over 8 concurrent requests (8 slots, 32 tokens each): every "
          f"token the argmax of its row's teacher-forced logits")


def family_decode_readings(model, label: str, smi: str) -> None:
    """Decode tok/s on graph blocks: generate_batch at B=64 (16-token prompts,
    128 new tokens) and generate at B=1 (128 tokens, block_size=16), each
    timed once after a warm-up run (host clock around synchronised work);
    graph against eager blocks is family_generation's check."""
    engine = GenerationEngine(model)
    sp = SamplingParams(token_stop=())
    gen = torch.Generator(device=DEV).manual_seed(27)
    prompts = torch.randint(4, model.cfg.vocab_size, (B, 16), device=DEV, generator=gen).tolist()
    runs = {"generate_batch": (B, lambda: engine.generate_batch(prompts, max_tokens=128, sampling=sp)),
            "generate": (1, lambda: engine.generate(prompts[0], max_tokens=128, sampling=sp,
                                                    block_size=16))}
    for name, (b, fn) in runs.items():
        fn()
        out, seconds = timed_s(fn)
        check(len(out) == b if name == "generate_batch" else len(out) == 128,
              f"{label} {name}: wrong output")
        print(f"  reading: {name} (B={b}, 128 new tokens, {label}): {b * 128 / seconds:.1f} tok/s on "
              f"graph blocks ({seconds * 1e3:.1f} ms) on {smi}")


def chained_rate(step, tokens: torch.Tensor, iters: int = 3) -> tuple:
    """(seconds a call, the last input, the last output) of a data chain of
    `iters` calls after a warm-up: step(tokens) -> (next tokens, output)."""
    with torch.inference_mode():
        tokens, out = step(tokens)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            last_in = tokens
            tokens, out = step(tokens)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters, last_in, out


def phase_v5_serving(smi: str, tmp: Path) -> None:
    """Synthetic RWKV-5-World-1B5 (v5.2: FAMILY_SERVE_LAYERS layers, C=2048,
    H=32, F=7168), bf16: embeddings at B=64, T=512 against the fp32 plain route with the
    launches of the forward; prefill + decode against one forward; greedy
    generation (graph blocks against eager); the 4-layer .pth through
    `python -m rwkv_lm_ext_tpu_torch.serve.cli`; readings."""
    model, reference = family_models(functools.partial(rwkv5_1b5, n_layer=FAMILY_SERVE_LAYERS),
                                      seed=20)
    # the CLI's 4-layer checkpoint first: its server loads while the checks
    # below run
    cfg4 = rwkv5_1b5(n_layer=min(4, model.cfg.n_layer))
    sd4 = {k: v for k, v in model.state_dict().items()
           if not k.startswith("blocks.") or int(k.split(".")[1]) < cfg4.n_layer}
    small = load_state_dict_into(RWKV(cfg4, device=DEV), sd4)
    path = str(tmp / "rwkv5_first_layers.pth")
    save_rwkv_checkpoint(small, path)
    server = CliServer(["--model", path, "--port", "0"])
    server.start()
    gen = torch.Generator(device=DEV).manual_seed(21)
    tokens = torch.randint(4, model.cfg.vocab_size, (B, T), device=DEV, generator=gen)
    tokens[:, -1] = EMB_ID
    with torch.inference_mode():
        emb, counts = count_launches(lambda: embed_sequences(model, tokens, normalize=True))
        ref = embed_sequences(reference, tokens, normalize=True, reference=True)
    cos = float((emb.double() * ref.double()).sum(-1).min())
    print(f"  v5.2 embeddings B={B}, T={T}, bf16 vs the fp32 plain route: min cosine {cos:.6f} "
          f"(limit 0.999); launches of the forward: {counts}")
    check(cos >= 0.999, f"v5 embedding cosine {cos}")
    check(counts == V5_FORWARD, f"v5 forward launch counts {counts} != {V5_FORWARD}")
    del reference
    torch.cuda.empty_cache()
    prefill_decode_against_forward(model, "v5.2")
    family_generation(model, "v5.2")
    if READINGS:
        v5_readings(model, tokens, smi)

    del model
    greedy = {"prompt": SHORT, "max_tokens": 16, "temperature": 0.0, "token_stop": []}
    with server as base:
        code, r = post(base + "/generate", greedy)
    want = GenerationEngine(small, WorldTokenizer()).generate(SHORT, max_tokens=16, sampling=GREEDY)
    print(f"  serve.cli --model on a {cfg4.n_layer}-layer v5.2 .pth ({Path(path).stat().st_size / 2**30:.2f} "
          f"GiB): /generate {code}, backend {r.get('backend')}, output {r.get('output')!r}")
    check(code == 200 and r["backend"] == "engine" and r["output"] == want,
          f"serve.cli v5 /generate answered {code}: {r} (in process: {want!r})")
    Path(path).unlink()


def v5_readings(model, tokens: torch.Tensor, smi: str) -> None:
    """Phase 18b's readings: seq/s embedded over a data chain with its
    canary, the device's busy time, and the decode readings."""
    n_feed = min(T, C)

    def step(tokens):
        tokens = tokens.clone()
        tokens[:, -1] = EMB_ID
        emb = embed_sequences(model, tokens)
        # data chain: the next batch's tokens depend on these embeddings
        tokens[:, :n_feed] = 4 + (tokens[:, :n_feed] + (emb[:, :n_feed] * 100).abs().long()) % 60000
        return tokens, emb

    seconds, last_in, last_out = chained_rate(step, tokens)
    changed = last_in.clone()
    changed[:, 0] = 4 + (changed[:, 0] + 1) % 60000
    chain_canary(lambda t: step(t)[1], last_in, last_out, changed, "v5 embedding chain")
    with torch.inference_mode():
        busy = busy_us(device_ops(lambda: embed_sequences(model, tokens), 1)) / 1e3
    print(f"  reading: v5.2 {B / seconds:.2f} seq/s embedded (B={B}, T={T}, bf16, "
          f"{seconds * 1e3:.1f} ms a batch, device busy {busy:.1f} ms of it) on {smi}")
    family_decode_readings(model, "v5.2 bf16", smi)


def phase_v4_serving(smi: str) -> int:
    """Synthetic RWKV-4-World-1.5B (FAMILY_SERVE_LAYERS layers, C=2048, F=8192),
    bf16: logits
    at B=64, T=512 against the fp32 plain route with the launches of the
    forward; prefill + decode against one forward; greedy generation (graph
    blocks against eager); the batcher over 8 requests; readings. Returns the
    launches of wkv4 in the forward."""
    model, reference = family_models(functools.partial(rwkv4_1b5, n_layer=FAMILY_SERVE_LAYERS),
                                      seed=25)
    gen = torch.Generator(device=DEV).manual_seed(26)
    tokens = torch.randint(4, model.cfg.vocab_size, (B, T), device=DEV, generator=gen)
    with torch.inference_mode():
        (logits, _), counts = count_launches(lambda: model(tokens))
        ref, _ = reference(tokens, reference=True)
        cos = min_cosine_chunked(logits, ref)
    del logits, ref, reference
    torch.cuda.empty_cache()
    print(f"  v4 logits B={B}, T={T}, bf16 vs the fp32 plain route: min per-position cosine "
          f"{cos:.6f} (limit 0.999); launches of the forward: {counts}")
    check(cos >= 0.999, f"v4 logits cosine {cos}")
    check(counts == V4_FORWARD, f"v4 forward launch counts {counts} != {V4_FORWARD}")
    prefill_decode_against_forward(model, "v4")
    family_generation(model, "v4")
    v4_batcher(model, "v4")
    if READINGS:
        v4_readings(model, tokens, smi)
    return counts["wkv4"]


def v4_readings(model, tokens: torch.Tensor, smi: str) -> None:
    """Phase 18c's readings: prefill seq/s over a data chain with its
    canary, and the decode readings."""
    def step(tokens):
        logits, _ = model(tokens)
        tokens = tokens.clone()
        tokens[:, 0] = 4 + logits[:, -1].argmax(-1) % 60000
        return tokens, logits[:, -1]

    seconds, last_in, last_out = chained_rate(step, tokens)
    changed = last_in.clone()
    changed[:, 1] = 4 + (changed[:, 1] + 1) % 60000
    chain_canary(lambda t: step(t)[1], last_in, last_out, changed, "v4 prefill chain")
    print(f"  reading: v4 prefill {B / seconds:.2f} seq/s (B={B}, T={T}, bf16, logits of every "
          f"position, {seconds * 1e3:.1f} ms a batch) on {smi}")
    family_decode_readings(model, "v4 bf16", smi)


# ---------------------------------------------------------------------------
# Phase 20: training RWKV-5.x and RWKV-4, head size 128, simcse
# --dropout-noise, and the C.24 probe
# ---------------------------------------------------------------------------

WKV4_GRAD_REL = {torch.float32: 1e-4, BF16: 2e-2}  # B.14's backward, x max|plain|
WKV4_GRAD_NAMES = ("dk", "dv", "dw", "du", "daa", "dbb", "dpp")
N128 = 128                                          # C = H128 x 128 = 2048
H128 = C // N128


def wkv4_grads(fn, k, v, w, u, state, gy, gs) -> list:
    """The gradients of sum(y gy) + sum(final state x gs) through fn (wkv4
    or wkv4_plain) for k, v, w, u and the initial state."""
    leaves = [t.detach().clone().requires_grad_() for t in (k, v, w, u, *state)]
    y, fs = fn(*leaves[:4], tuple(leaves[4:]))
    ((y * gy).sum() + sum((a * b).sum() for a, b in zip(fs, gs))).backward()
    return [t.grad for t in leaves]


def phase_wkv4_backward(smi: str) -> dict:
    """Phase 20a: B.14's backward kernel against autograd through
    wkv4_plain at B=8, C=2048, T in {1, 15, 17, 512}, from a fresh state
    (pp = -1e38) and a carried one, k up to 60, under gradients of y and of
    the final state: fp32 within 1e-4, bf16 within 2e-2 of max|plain| (the
    initial state's gradient too; at a fresh state it is 0 on both routes),
    two calls bit-equal; then timed at the training shape beside its bound.
    Returns its entry of the kernels line."""
    rng = Inputs(30)
    f32_ = torch.float32
    abs_errs = []
    for dtype in (f32_, BF16):
        for t in (1, 15, 17, T):
            for carried in (False, True):
                k, v, w, u, state = wkv4_inputs(rng, TB, t, dtype, carried)
                state = state or init_wkv4_state(TB, C, DEV)
                gy = rng.normal(TB, t, C, dtype=f32_)
                gs = [rng.normal(TB, C, dtype=f32_) for _ in range(3)]
                got = wkv4_grads(wkv4, k, v, w, u, state, gy, gs)
                again = wkv4_grads(wkv4, k, v, w, u, state, gy, gs)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"wkv4 backward T={t} {dtype}: two calls differ")
                want = wkv4_grads(wkv4_plain, k, v, w, u, state, gy, gs)
                rel, err = {}, {}
                for name, a, b in zip(WKV4_GRAD_NAMES, got, want):
                    check(bool(torch.isfinite(a).all()), f"wkv4 backward: non-finite {name}")
                    scale = b.float().abs().max().item()
                    err[name] = (a.float() - b.float()).abs().max().item()
                    rel[name] = err[name] / scale if scale > 0 else err[name]
                worst = max(rel, key=rel.get)
                print(f"  wkv4 backward {'fp32' if dtype == f32_ else 'bf16'} B={TB} T={t} "
                      f"{'carried' if carried else 'fresh (pp = -1e38)'}: max |kernel - plain| / "
                      f"max|plain| {rel[worst]:.3e} ({worst}; limit {WKV4_GRAD_REL[dtype]:g}); "
                      f"max |kernel - plain| {max(err.values()):.3e}; two calls bit-equal")
                check(rel[worst] <= WKV4_GRAD_REL[dtype], f"wkv4 backward T={t} {dtype}: {rel}")
                abs_errs.append(max(err.values()))
    k, v, w, u, state = wkv4_inputs(rng, TB, T, BF16, True)
    n_ck = (T + wkv4_ops.CHUNK - 1) // wkv4_ops.CHUNK
    ck = torch.empty(3, TB, n_ck, C, device=DEV)
    out_state = tuple(torch.empty(TB, C, device=DEV) for _ in range(3))
    y = wkv4_ops._launch_forward(k, v, w, u, state, out_state, ck)
    gy = rng.normal(TB, T, C, dtype=torch.float32)
    gs = tuple(rng.normal(TB, C, dtype=torch.float32) for _ in range(3))
    ms = device_ms(lambda: wkv4_bwd(k, v, w, u, ck, gy, gs), 20)
    leaves = [t.detach().clone().requires_grad_() for t in (k, v, w, u, *state)]
    py, pfs = wkv4_plain(*leaves[:4], tuple(leaves[4:]))
    plain_loss = (py * gy).sum() + sum((a * b).sum() for a, b in zip(pfs, gs))
    plain_ms = device_ms(lambda: torch.autograd.grad(plain_loss, leaves, retain_graph=True), 2)
    # what the function needs, whatever the kernel saves for itself: reads
    # k, v (bf16), dy (fp32), w, u, the initial state and the final state's
    # gradient; writes dk, dv (bf16), dw and du (C each) and the initial
    # state's gradient; a step recomputes the state (4 exp) and runs its
    # adjoint (4 exp, a division, ~40 products and sums)
    bound = roofline(nbytes(k, v, gy, w, u, *state, *gs) + nbytes(k, v) + nbytes(*state)
                     + nbytes(w, u), {"fp32": 60 * TB * T * C})
    print(f"  reading: wkv4 backward B={TB}, T={T}, C={C}, bf16: kernel {ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; {100 * bound['bound_ms'] / ms:.1f} % of "
          f"it), plain (autograd through the loop) {plain_ms:.2f} ms; the forward that saves the "
          f"chunk entries {device_ms(lambda: wkv4_ops._launch_forward(k, v, w, u, state, out_state, ck), 20):.4f} "
          f"ms, on {smi}")
    del leaves, py, pfs, plain_loss
    torch.cuda.empty_cache()
    return {"wkv4_bwd": dict(max_abs_err=max(abs_errs), ms=ms, plain_ms=plain_ms, **bound)}


def phase_head128_kernels(smi: str) -> None:
    """Phase 20b: K1, B.6 / B.7, B.8 and B.9 at N = 128 (H = 16, C = 2048;
    the sequential bodies, the backward's fp64 tile in dynamic shared memory)
    against their plain versions, fp32 and bf16: outputs within 1e-4 (fp32)
    and 1e-2 (bf16) of max|plain|, gradients 1e-3 and 2e-2; then their
    times at B=8, T=512 (B.9 at B=64) beside their bounds."""
    rng = Inputs(31)
    f32_ = torch.float32

    def case(b, t, dtype):
        r, k, v, g = (rng.normal(b, t, H128, N128, scale=0.5, dtype=dtype) for _ in range(4))
        w = rng.uniform(b, t, H128, N128, lo=-8.0, hi=3.0, dtype=f32_)
        return (r, k, v, w, rng.normal(H128, N128, scale=0.5, dtype=f32_), g,
                rng.normal(C, scale=0.1, dtype=f32_) + 1, rng.normal(C, scale=0.1, dtype=f32_),
                rng.normal(b, H128, N128, N128, scale=0.1, dtype=f32_))

    for dtype in (f32_, BF16):
        rel_out, rel_grad = (1e-4, 1e-3) if dtype == f32_ else (1e-2, 2e-2)
        args = case(TB, T, dtype)
        dout = rng.normal(TB, T, C, dtype=f32_)
        dsT = rng.normal(TB, H128, N128, N128, scale=0.1, dtype=f32_)
        for what, fn, plain, n_args in (("K1 + B.6/B.7", wkv6_fused_output, wkv6_fused_output_plain, 9),
                                        ("B.8 + its backward", wkv, wkv_plain, 6)):
            use = args if n_args == 9 else (args[:5] + (args[8],))
            res = []
            for f in (fn, plain):
                leaves = [t.detach().clone().requires_grad_() for t in use]
                out, sT = f(*leaves, eps=LN_X_EPS) if n_args == 9 else f(*leaves)
                ((out.float() * dout.view(out.shape)).sum() + (sT * dsT).sum()).backward()
                res.append([out.detach(), sT.detach()] + [t.grad for t in leaves])
                del leaves, out, sT
            errs = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                    for a, b in zip(*res)]
            print(f"  {what} N={N128} {'fp32' if dtype == f32_ else 'bf16'} B={TB} T={T}: output "
                  f"{max(errs[:2]):.3e} (limit {rel_out:g}), gradients {max(errs[2:]):.3e} (limit "
                  f"{rel_grad:g}) x max|plain|")
            check(max(errs[:2]) <= rel_out and max(errs[2:]) <= rel_grad,
                  f"{what} N={N128} {dtype}: {errs}")
            del res
        rd, kd, vd, gd = (rng.normal(B, C, scale=0.5, dtype=dtype) for _ in range(4))
        wd = rng.normal(B, C, dtype=f32_)
        st = rng.normal(B, H128, N128, N128, scale=0.1, dtype=f32_)
        u, lsc, lbi = args[4], args[6], args[7]
        po, ps = wkv6_decode_step_plain(rd, kd, vd, wd, gd, u, lsc, lbi, st.clone(), eps=LN_X_EPS)
        ko, ks = wkv6_decode_step(rd, kd, vd, wd, gd, u, lsc, lbi, st, eps=LN_X_EPS, out_state=st)
        e = ((ko.float() - po.float()).abs().max().item() / po.float().abs().max().item(),
             (ks - ps).abs().max().item() / ps.abs().max().item())
        print(f"  B.9 N={N128} {'fp32' if dtype == f32_ else 'bf16'} B={B}, in place: out {e[0]:.3e}, "
              f"state {e[1]:.3e} x max|plain| (limits {WKV4_REL[dtype]:g}, 1e-5)")
        check(e[0] <= WKV4_REL[dtype] and e[1] <= 1e-5, f"B.9 N={N128} {dtype}: {e}")
        torch.cuda.empty_cache()
    args = case(TB, T, BF16)
    r, k, v, w, u, g, lsc, lbi, s0 = args
    dout = rng.normal(TB, T, C, dtype=BF16)
    bthn = r.numel()
    k1 = device_ms(lambda: wkv6_fused_output(*args, eps=LN_X_EPS), 5)
    k1_plain = device_ms(lambda: wkv6_fused_output_plain(*args, eps=LN_X_EPS), 2)
    bwd = device_ms_by_kernel(lambda: wkv6_fused_output_bwd(*args, dout, None, eps=LN_X_EPS), 3,
                              {"B.6": ("wkv6_bwd_forward_kernel",), "B.7": ("wkv6_bwd_reverse_kernel",)})
    b8 = device_ms(lambda: wkv(r, k, v, w, u, s0), 5)
    heads = TB * T * H128
    bounds = {
        # as phase 2's: the inputs read once, out and the two states written;
        # per step y and the state update, 4 N^2 a head
        "K1": roofline(nbytes(*args) + nbytes(g) + nbytes(s0), {"fp32": heads * 4 * N128 * N128}),
        # pass 1 reads r, k, v, g, w, dout, writes dy (fp32), dr' (fp64) and
        # dg, 4 N^2 fp64 a head and step; pass 2 reads r, k, v, w, dy and dr',
        # writes dr, dk, dv, dw, 8 N^2 fp64
        "B.6": roofline(nbytes(r, k, v, g, w, dout) + 4 * bthn + 8 * bthn + nbytes(g),
                        {"fp64": heads * 4 * N128 * N128}),
        "B.7": roofline(nbytes(r, k, v, w) + 12 * bthn + nbytes(r, k, v) + 4 * bthn,
                        {"fp64": heads * 8 * N128 * N128}),
        "B.8": roofline(nbytes(r, k, v, w, u, s0) + 4 * bthn + nbytes(s0),
                        {"fp32": heads * 4 * N128 * N128}),
    }
    rd, kd, vd, gd = (rng.normal(B, C, scale=0.5, dtype=BF16) for _ in range(4))
    wd = rng.normal(B, C, dtype=torch.float32)
    st = rng.normal(B, H128, N128, N128, scale=0.1, dtype=torch.float32)
    b9 = device_ms(lambda: wkv6_decode_step(rd, kd, vd, wd, gd, u, lsc, lbi, st, eps=LN_X_EPS,
                                            out_state=st), 20)
    bounds["B.9"] = roofline(nbytes(rd, kd, vd, wd, gd, st, st, rd), {"fp32": 5 * B * C * N128})
    times = {"K1": k1, "B.6": bwd["B.6"], "B.7": bwd["B.7"], "B.8": b8, "B.9": b9}
    for name, ms in times.items():
        b = bounds[name]
        print(f"  reading: {name} at N={N128} (sequential body), bf16, "
              f"{'B=%d' % B if name == 'B.9' else 'B=%d, T=%d' % (TB, T)}: {ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {100 * b['bound_ms'] / ms:.1f} % of it)"
              + (f"; K1's plain version {k1_plain:.2f} ms" if name == "K1" else "") + f", on {smi}")
    del args
    torch.cuda.empty_cache()


def family_step_counts(version: float, n_layer: int, remat: bool, chunks: int = 1) -> dict:
    """Launches of one train step of an RWKV-5.x or RWKV-4 model (LoRA or
    every parameter: the WKV's inputs need gradients in every layer either
    way) over `chunks` forwards: ln0, ln1 and ln2 of the blocks (again under
    remat) and ln_out through K3; the WKV kernel a layer (again under remat)
    and its backward (K1 with B.6 and B.7 for v5, B.14 and its backward for
    v4). No K2 and no B.5: neither family has the ddlerp prologue."""
    fwd = 2 if remat else 1
    wkv = ({"wkv4": chunks * n_layer * fwd, "wkv4_bwd": chunks * n_layer} if version < 5 else
           {"wkv6_fused_output": chunks * n_layer * fwd, "wkv6_bwd_forward_pass": chunks * n_layer,
            "wkv6_bwd_reverse_pass": chunks * n_layer})
    return dict(NO_LAUNCH, layer_norm=chunks * ((1 + 2 * n_layer) * fwd + 1), **wkv)


FAMILY_STEP_KERNELS = {5.2: {"K1": "wkv6_chunked_kernel", "B.6": "wkv6_bwd_forward_chunked_kernel",
                             "B.7": "wkv6_bwd_reverse_chunked_kernel"},
                       4.0: {"B.14": "wkv4_kernel", "B.14 backward": "wkv4_bwd_kernel"}}


def phase_family_grads() -> None:
    """Phase 20c: 2-layer RWKV-5-World-1B5 (v5.2) and RWKV-4-World-1.5B
    models at full width, B=8, T=512: LoRA gradients kernel route against
    plain route in fp32 (1e-3 of max) and in bf16 (C24_BOUND: no farther
    from the bf16 plain route than twice its distance from fp32), and every
    parameter's gradient under TBPTT (chunks of TBPTT_CHUNK, 128) in fp32
    (1e-3)."""
    for name, cfg_fn, seed in (("v5.2", rwkv5_1b5, 32), ("v4", rwkv4_1b5, 33)):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        sd2 = synthetic_1b6(cfg_fn(n_layer=2), seed)
        batch = train_batch(gen, cfg_fn().vocab_size)

        def model_of(dtype):
            return load_state_dict_into(RWKV(cfg_fn(n_layer=2, dtype=dtype), device=DEV), sd2)

        sft = functools.partial(sft_loss_fn, remat=True)
        adapter = init_lora_params(model_of("float32"), LORA, gen)
        for ab in adapter.values():
            ab["B"].normal_(0.0, 0.01, generator=gen)
        m32 = apply_lora(model_of("float32"), LORA, adapter)
        k32 = trainable_grads(m32, sft, batch, reference=False, skip=())
        p32 = trainable_grads(m32, sft, batch, reference=True, skip=())
        rel_grads(f"{name} LoRA, fp32, kernel vs plain", k32, p32)
        del m32
        m16 = apply_lora(model_of("bfloat16"), LORA, adapter)
        k16 = trainable_grads(m16, sft, batch, reference=False, skip=())
        p16 = trainable_grads(m16, sft, batch, reference=True, skip=())
        bf16_gap(f"{name} LoRA", k16, p16, p32)
        del m16, k16, p16, k32, p32
        m = model_of("float32")
        tbptt = functools.partial(tbptt_loss_fn, chunk_ctx=TBPTT_CHUNK, remat=True)
        kernel_vs_plain(f"{name} TBPTT (chunk_ctx {TBPTT_CHUNK}) over every parameter, fp32", m, tbptt,
                        batch, skip=())
        del m, sd2
        torch.cuda.empty_cache()


FAMILY_READ_LAYERS = 12      # phase 20d's depth


def phase_family_readings(smi: str) -> int:
    """Phase 20d: 12-layer v5.2 and v4 models, B=8, T=512, bf16: a LoRA step
    and a `full` step (fp32 masters), remat on, each with its launches on
    the counters (exact); with --readings also on the device from the
    profile (B.14 and its backward, K1, B.6, B.7), time (CUDA events over
    chained steps with the canary), busy time, idle share and peak memory.
    Returns the backward kernel's launches in the v4 LoRA step."""
    gen = torch.Generator(device=DEV).manual_seed(34)
    bwd_launches = 0
    for name, cfg_fn, seed in (("v5.2", rwkv5_1b5, 35), ("v4", rwkv4_1b5, 36)):
        # half depth since phase 22 went in (the script's time limit)
        cfg_fn = functools.partial(cfg_fn, n_layer=FAMILY_READ_LAYERS)
        cfg = cfg_fn()
        sd = synthetic_1b6(cfg, seed)
        batch, other = train_batch(gen, cfg.vocab_size), train_batch(gen, cfg.vocab_size)
        # the v4 TBPTT step's reading is left out for the script's time limit
        # (PERF.md §5 has it): 20c holds a 2-layer v4 TBPTT step's gradients,
        # 17b trains --chunk-ctx through the CLI
        for what, param_dtype, train_type in (("LoRA", "bfloat16", "lora"),
                                              ("full", "float32", "full")):
            model = load_state_dict_into(RWKV(cfg_fn(param_dtype=param_dtype), device=DEV), sd)
            if train_type == "lora":
                apply_lora(model, LORA, init_lora_params(model, LORA, gen))
            apply_trainable_mask(model, trainable_mask(model, train_type))
            step = make_train_step(model, TrainConfig(lr_init=1e-5, warmup_steps=0, total_steps=100))
            reset_launch_counts()
            step(batch)
            torch.cuda.synchronize()
            counts = launch_counts()
            want = family_step_counts(cfg.version, cfg.n_layer, True)
            check(counts == want, f"{name} {what} step counts {counts} != {want}")
            if cfg.version < 5 and train_type == "lora":
                bwd_launches = counts["wkv4_bwd"]
            print(f"  launches in one {name} {what} step: "
                  f"{', '.join(f'{k} {counts[k]}' for k in counts if counts[k])}")
            if not READINGS:
                del model, step
                torch.cuda.empty_cache()
                continue
            ops = read_train_step(model, step, functools.partial(sft_loss_fn, remat=True), batch,
                                  other, f"{name} {what} step", smi)
            want_dev = {k: (2 if "backward" not in k and k not in ("B.6", "B.7") else 1)
                        * cfg.n_layer for k in FAMILY_STEP_KERNELS[round(cfg.version, 1)]}
            on_device = {k: kernel_launches(ops, n)
                         for k, n in FAMILY_STEP_KERNELS[round(cfg.version, 1)].items()}
            print(f"  launches in one {name} {what} step on the device: {on_device} (the "
                  f"profiler may lose one record in ten)")
            check(all(0.9 * want_dev[k] <= n <= want_dev[k] for k, n in on_device.items()),
                  f"{name} {what}: device launches {on_device}, not {want_dev}")
            del model, step, ops
            torch.cuda.empty_cache()
        del sd
    return bwd_launches


def phase_simcse_dropout(path: str, tmp: Path) -> dict:
    """Phase 20e: `python -m rwkv_lm_ext_tpu_torch.train.cli simcse
    --dropout-noise` (main(argv) in this process) for three steps on the
    first 2 layers of the bf16 model at full width: finite losses, the saved
    file, and the two views of one text under its dropout apart while rate 0
    leaves them bit-equal. Returns the launches of the run."""
    two = tmp / "simcse_2layer.pth"
    sd2 = two_layer_sd(path)
    save_rwkv_checkpoint(load_state_dict_into(RWKV(rwkv6_1b6(n_layer=2), device=DEV), sd2), str(two))
    data = tmp / "simcse_text.jsonl"
    words = "rivers carry stones to the sea where the tides sort them by size".split()
    data.write_text("".join(json.dumps({"text": " ".join(words[(i + j) % len(words)]
                                                          for j in range(40 + i % 9))}) + "\n"
                            for i in range(64)))
    out = tmp / "simcse_dropout"
    seen = {}
    real = train_cli.simcse_loss_fn

    def spy(model, batch, **kw):
        seen.setdefault("model", model)
        seen.setdefault("dropout", kw["dropout"])
        return real(model, batch, **kw)

    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(train_cli, "simcse_loss_fn", spy), contextlib.redirect_stdout(buf):
        train_cli.main(["simcse", "--dropout-noise", "--model", str(two), "--train-data", str(data),
                        "--output-dir", str(out), "--micro-bsz", "8", "--max-steps", "3",
                        "--log-every", "1", "--warmup-steps", "0"])
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [json.loads(ln.split(": ", 1)[1])["loss"] for ln in buf.getvalue().splitlines()
              if ln.startswith("step ")]
    print(f"  simcse --dropout-noise, 3 steps (2 layers, full width, p = "
          f"{seen['dropout'].rate}): losses {losses} in {time.perf_counter() - t0:.1f} s; "
          f"launches {counts}")
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses)
          and (out / "simcse-step3.pth").exists(), f"simcse --dropout-noise: {losses}")
    check(counts["tmix_prologue_bwd"] > 0 and counts["wkv6_bwd_reverse_pass"] > 0,
          f"simcse --dropout-noise launched no backward kernel: {counts}")
    model, dropout = seen["model"], seen["dropout"]
    tokens = torch.randint(4, 60000, (2, 64), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(37))
    tokens[:, -1] = EMB_ID
    with torch.no_grad():
        a = embed_sequences(model, tokens, dropout=dropout)
        b = embed_sequences(model, tokens, dropout=dropout)
        z = [embed_sequences(model, tokens, dropout=Dropout(0.0, torch.Generator(device=DEV)))
             for _ in range(2)]
        n = embed_sequences(model, tokens)
    print(f"  two views under p = {dropout.rate}: 1 - cosine {1 - cosine(a, b):.3e}; rate 0 "
          f"bit-equal to no dropout: {torch.equal(z[0], n) and torch.equal(z[1], n)}")
    check(not torch.equal(a, b) and torch.equal(z[0], n) and torch.equal(z[1], n),
          "simcse views: dropout made no difference, or rate 0 did")
    del seen, model
    torch.cuda.empty_cache()
    return counts


class RecordingOps:
    """The plain route's Ops, each call recorded with its inputs and, in
    the backward, the gradients of its outputs (phase 20f)."""

    def __init__(self):
        self.calls = []

    def ops(self):
        def wrap(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                rec = {"name": name, "args": args, "kw": kw, "grads": [None] * len(outs)}
                for i, o in enumerate(outs):
                    if isinstance(o, torch.Tensor) and o.requires_grad:
                        o.register_hook(lambda g, i=i, rec=rec: rec["grads"].__setitem__(i, g))
                self.calls.append(rec)
                return out
            return call

        return type(PLAIN_OPS)(*(wrap(n, f) for n, f in zip(PLAIN_OPS._fields, PLAIN_OPS)))


def replay(fn, args, kw, grads, dtype) -> list:
    """fn on `args` (bf16 tensors cast to `dtype`), its outputs (in their
    dtype) and, under the recorded output gradients, its inputs' gradients
    (fp32)."""
    leaves = [a.detach().to(dtype if a.dtype == BF16 else a.dtype).requires_grad_(a.requires_grad)
              if isinstance(a, torch.Tensor) else a for a in args]
    out = fn(*leaves, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
    wanted = [t for t in leaves if isinstance(t, torch.Tensor) and t.requires_grad]
    din = torch.autograd.grad([o for o, _ in pairs], wanted, [g.to(o.dtype) for o, g in pairs],
                              allow_unused=True) if pairs and wanted else []
    return [o.detach() for o in outs if isinstance(o, torch.Tensor)], \
        [None if d is None else d.float() for d in din]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(share of elements that differ, largest difference in units of the
    last place of b's largest value) of two bf16 tensors."""
    a, b = a.float(), b.float()
    top = b.abs().max().clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    diff = (a - b).abs()
    return float((diff > 0).float().mean()), float(diff.max() / ulp)


def phase_c24_probe(path: str) -> None:
    """Phase 20f, ROADMAP C.24: where the bf16 kernel route's gradients part
    from the bf16 plain route's, over nf4 QLoRA and `full` (2 layers, full
    width, B=8, T=512, remat off). Layer by layer: the per-layer gradient
    tensors' cosine to the fp32 plain route on each route. Op by op: every
    kernel-backed op the plain route ran (K3, K2, K1 and through autograd
    B.5-B.7), replayed on its recorded bf16 inputs and output gradients by
    the kernel, by the plain op in bf16 and by the plain op in fp32 on the
    same inputs: the kernel's error from fp32 against the bf16 plain op's,
    forward and backward. The routes part at the first op whose kernel
    error exceeds C24_BOUND times the plain op's (and 1e-3 of max)."""
    sd2 = two_layer_sd(path)
    gen = torch.Generator(device=DEV).manual_seed(38)
    batch = train_batch(gen, rwkv6_1b6().vocab_size)
    sft = functools.partial(sft_loss_fn, remat=False)
    for label in ("nf4 QLoRA", "full"):
        def model_of(dtype):
            m = load_state_dict_into(RWKV(rwkv6_1b6(n_layer=2, dtype=dtype,
                                                    param_dtype="float32" if label == "full" else ""),
                                          device=DEV), sd2)
            if label == "full":
                apply_trainable_mask(m, trainable_mask(m, "full"))
                return m
            quantize_model(m, "nf4", weights=sd2)
            return apply_lora(m, LORA, adapter)

        if label != "full":
            adapter = init_lora_params(load_state_dict_into(
                RWKV(rwkv6_1b6(n_layer=2, dtype="float32"), device=DEV), sd2), LORA, gen)
            for ab in adapter.values():
                ab["B"].normal_(0.0, 0.01, generator=gen)
        m32 = model_of("float32")
        p32 = trainable_grads(m32, sft, batch, reference=True, skip=())
        del m32
        m16 = model_of("bfloat16")
        k16 = trainable_grads(m16, sft, batch, reference=False, skip=())
        rec = RecordingOps()
        with mock.patch.object(rwkv_models, "PLAIN_OPS", rec.ops()):
            p16 = trainable_grads(m16, sft, batch, reference=True, skip=())
        by_layer = {}
        for n in p32:
            layer = n.split(".")[1] if n.startswith("blocks.") else "emb/head"
            kc, pc = cosine(k16[n], p32[n]), cosine(p16[n], p32[n])
            lo = by_layer.setdefault(layer, [1.0, 1.0])
            lo[0], lo[1] = min(lo[0], kc), min(lo[1], pc)
        print(f"  C.24 {label}, layer by layer, min cosine to the fp32 plain route (kernel route, "
              f"bf16 plain route): " + "; ".join(f"{l} {a:.6f}, {b:.6f}" for l, (a, b) in by_layer.items()))
        kernel_ops = KERNEL_OPS._asdict()
        parted = None
        for i, c in enumerate(rec.calls):
            fn = kernel_ops[c["name"]]
            plain = getattr(PLAIN_OPS, c["name"])
            ko, kd = replay(fn, c["args"], c["kw"], c["grads"], BF16)
            po, pd = replay(plain, c["args"], c["kw"], c["grads"], BF16)
            fo, fd = replay(plain, c["args"], c["kw"], c["grads"], torch.float32)

            def err(a, b):
                return max([(x.float() - y.float()).abs().max().item()
                            / max(y.float().abs().max().item(), 1e-30)
                            for x, y in zip(a, b) if x is not None and y is not None] or [0.0])

            e = (err(ko, fo), err(po, fo), err(kd, fd), err(pd, fd))
            # the op's bf16 results, kernel against plain: how many differ, by how much
            flips = [bf16_ulps(x, y) for x, y in zip(ko, po) if x.dtype == BF16]
            share = max([f[0] for f in flips] or [0.0])
            ulps = max([f[1] for f in flips] or [0.0])
            print(f"    op {i} {c['name']}: forward kernel {e[0]:.2e}, plain bf16 {e[1]:.2e}; "
                  f"backward kernel {e[2]:.2e}, plain bf16 {e[3]:.2e} (x max|fp32 op|); bf16 "
                  f"outputs kernel vs plain: {100 * share:.2f} % differ, by at most {ulps:.2f} ulp of "
                  f"the largest")
            for ke, pe in ((e[0], e[1]), (e[2], e[3])):
                if parted is None and ke > max(C24_BOUND * pe, 1e-3):
                    parted = (i, c["name"])
        print(f"  C.24 {label}: the first op where the kernel route parts from the bf16 plain "
              f"route beyond C24_BOUND x its rounding: {parted or 'none'}")
        check(parted is None, f"C.24 {label}: the kernel route parts at op {parted}")
        bf16_gap(f"C.24 {label}", k16, p16, p32)
        del m16, k16, p16, p32, rec
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 19: python -m rwkv_lm_ext_tpu_torch.eval.cli and the apps
# ---------------------------------------------------------------------------

# a BEIR task dump cut from a C-MTEB retrieval task's size to fit the run
# (PERF.md §4): queries, documents of 20-400 tokens (the corpus sorted by
# length, so a batch's bucket is close to its texts), STS pairs, rerank rows
EVAL_QUERIES, EVAL_DOCS, EVAL_STS = 64, 512, 256
EVAL_RERANK_ROWS, EVAL_RERANK_DOCS = 64, 8
EVAL_PPL_TEXTS = 16          # 576-992 tokens each: 2 pieces at --ctx-len 512, 32 pieces
EVAL_BATCH = 64
RAG_NEW = 32
# phase 19 runs on the first EVAL_LAYERS layers of the saved model: its fp32
# plain route (parity's gold side and this process's) walks every layer
# sequentially, the largest share of the phase at 24 layers
EVAL_LAYERS = 4              # 8 before phase 23 needed the script's time
# the documents of 19b's dense check on the fp32 plain route: every relevant
# one, then every 4th of the length-sorted corpus (its sequential WKV walks
# each batch's bucket, so the whole corpus would cost as much again as
# parity's gold side, which embeds it in its own process)
EVAL_HELD_DOCS = 128
NLL_CHUNK = 8                # pieces a head + log-softmax in token_logprobs
# ppl: the kernel route's nll_per_token no farther from the fp32 plain
# route's than NLL_SCALE times the bf16 plain route's is, nor than NLL_SCALE
# times that gap's standard error over the corpus's tokens (a bf16 gap whose
# per-token errors cancel by chance sets no limit below a bf16 route's own
# rounding); per token, the kernel route's mean |log p - fp32 log p| at most
# NLL_SCALE times the bf16 plain route's. Both bf16 routes round the same
# tensors at other points, so each is about as far from fp32 (PERF.md §2)
NLL_SCALE = 2.0
EVAL_SENTENCES = (SHORT, MIXED, "Paris is the capital of France and its largest city.",
                  "Dense retrieval encodes queries and documents into one embedding space.",
                  "Rerankers score a query against each passage, one pair at a time.",
                  "Low-rank adapters fine-tune large models with two small matrices a layer.",
                  "The state of a recurrent model has a fixed size, whatever the context.")


def eval_pool(tok) -> tuple:
    """Pieces to draw texts from (words with their leading space, CJK
    characters) and their token counts."""
    pieces = [" " + w for w in " ".join(EVAL_SENTENCES).split()] + [c for c in CJK if c not in "，。"]
    return pieces, [len(tok.encode(p)) for p in pieces]


def eval_text(rng, pool: tuple, lo: int, hi: int, tok, head: list = ()) -> list:
    """Pieces (after `head`) whose text encodes to lo..hi tokens."""
    pieces, counts = pool
    while True:
        out, n, target = list(head), sum(len(tok.encode(p)) for p in head), int(rng.integers(lo, hi + 1))
        while n < target:
            j = int(rng.integers(len(pieces)))
            out.append(pieces[j])
            n += counts[j]
        if lo <= len(tok.encode("".join(out).strip())) <= hi:
            return out


def jsonl(path: Path, rows) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    return str(path)


def write_eval_files(d: Path, tok) -> dict:
    """The files of phase 19, seeded: a BEIR dump (corpus.jsonl,
    queries.jsonl, qrels/test.tsv; each query a span of its first relevant
    document, 1-3 relevant documents), STS pairs, rerank rows, a ppl corpus
    and a score head. Returns their paths and the texts."""
    rng = np.random.default_rng(61)
    pool = eval_pool(tok)
    text = lambda pieces: "".join(pieces).strip()  # noqa: E731
    docs = sorted((eval_text(rng, pool, 20, 400, tok) for _ in range(EVAL_DOCS)),
                  key=lambda p: len(tok.encode(text(p))))
    corpus = [text(p) for p in docs]
    queries, qrels = [], []
    for _ in range(EVAL_QUERIES):
        rel = rng.choice(EVAL_DOCS, size=int(rng.integers(1, 4)), replace=False).tolist()
        start = int(rng.integers(0, max(len(docs[rel[0]]) - 24, 1)))
        queries.append(text(docs[rel[0]][start: start + int(rng.integers(6, 24))]))
        qrels.append(rel)
    task = d / "task"
    jsonl(task / "corpus.jsonl", ({"_id": f"d{i}", "title": "", "text": t}
                                  for i, t in enumerate(corpus)))
    jsonl(task / "queries.jsonl", ({"_id": f"q{i}", "text": t} for i, t in enumerate(queries)))
    (task / "qrels").mkdir()
    (task / "qrels" / "test.tsv").write_text("query-id\tcorpus-id\tscore\n" + "".join(
        f"q{i}\td{j}\t1\n" for i, rel in enumerate(qrels) for j in rel))
    sts = []
    for _ in range(EVAL_STS):
        a = eval_text(rng, pool, 8, 48, tok)
        keep = int(rng.integers(0, len(a) + 1))
        b = eval_text(rng, pool, 8, 48, tok, head=a[:keep])
        sts.append({"sentence1": text(a), "sentence2": text(b),
                    "score": round(5.0 * keep / len(a), 3)})
    rerank = []
    for _ in range(EVAL_RERANK_ROWS):
        q = eval_text(rng, pool, 6, 20, tok)
        labels = [1] * int(rng.integers(1, 3)) + [0] * EVAL_RERANK_DOCS
        labels = rng.permutation(labels[:EVAL_RERANK_DOCS]).tolist()
        documents = [text(eval_text(rng, pool, 20, 120, tok, head=q if rel else ()))
                     for rel in labels]
        rerank.append({"query": text(q), "documents": documents, "labels": labels})
    gen = torch.Generator().manual_seed(62)
    score = d / "score.pth"
    torch.save({"score.weight": torch.randn(1, rwkv6_1b6().n_embd, generator=gen) * 0.05}, score)
    return {
        "task": str(task), "corpus": corpus, "queries": queries, "qrels": qrels,
        "sts": jsonl(d / "sts.jsonl", sts), "rerank": jsonl(d / "rerank.jsonl", rerank),
        "rerank_rows": rerank, "score": str(score),
        # T + 1 to 2T + 1 tokens: two pieces at --ctx-len T, the second padded
        "ppl": jsonl(d / "ppl.jsonl", ({"text": text(eval_text(rng, pool, T + T // 8,
                                                                2 * T - T // 16, tok))}
                                       for _ in range(EVAL_PPL_TEXTS))),
    }


class EvalCli:
    """`python -m rwkv_lm_ext_tpu_torch.eval.cli ...` in the background:
    result() waits for it and returns its JSON, stop() kills it if it still
    runs."""

    def __init__(self, argv: list):
        self.name, self.t0, self.out, self.seconds = argv[0], time.perf_counter(), [], None
        self.proc = subprocess.Popen([sys.executable, "-m", "rwkv_lm_ext_tpu_torch.eval.cli", *argv],
                                     cwd=ROOT, stdout=subprocess.PIPE, text=True,
                                     env=dict(os.environ,
                                              PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))

        def pump():
            self.out.append(self.proc.stdout.read())
            self.proc.wait()
            self.seconds = time.perf_counter() - self.t0

        self.thread = threading.Thread(target=pump, daemon=True)
        self.thread.start()

    def result(self, timeout: float = 600.0) -> dict:
        self.thread.join(timeout)
        check(not self.thread.is_alive(), f"eval.cli {self.name} ran past {timeout} s")
        check(self.proc.returncode == 0, f"eval.cli {self.name} exited {self.proc.returncode}")
        return json.loads(self.out[0])

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def eval_cli_json(model, argv: list) -> dict:
    """`eval.cli main(argv)` in this process on `model` (its loader
    returns it: no load of the 3.2 GB file), its printed JSON."""
    buf = io.StringIO()
    with mock.patch.object(eval_cli, "load_rwkv_checkpoint",
                           lambda path, *, device: (model, model.cfg)), \
            contextlib.redirect_stdout(buf):
        eval_cli.main(argv)
    return json.loads(buf.getvalue())


def held_rows(plain: np.ndarray, kern: np.ndarray, relevant: list, k: int) -> list:
    """Phase 16c's rule for metrics: the rows whose top-k relevance pattern
    no score's deviation could change. A score moves by at most d = max|kern
    - plain|, so items more than tie = 2d apart keep their order, and an
    item below the k-th best by more than tie stays out of the top k: a row
    is held when, among its candidates (within tie of the k-th best or
    above), every relevant item lies more than tie from every other one."""
    tie = 2 * float(np.abs(kern - plain).max())
    held = []
    for i, rel in enumerate(relevant):
        s, rel = plain[i], set(rel)
        kth = np.sort(s)[::-1][min(k, len(s)) - 1]
        cand = np.nonzero(s >= kth - tie)[0]
        r = [s[j] for j in cand if j in rel]
        x = [s[j] for j in cand if j not in rel]
        if all(abs(a - b) > tie for a in r for b in x):
            held.append(i)
    return held


def token_logprobs(model, data: dict, tok, *, reference: bool) -> torch.Tensor:
    """The log-probability of each target of the ppl corpus as cmd_ppl
    computes it (each piece of T + 1 tokens padded with 0, its n_valid
    targets, an fp32 log-softmax), fp64: the 32 pieces in one forward, the
    head and the log-softmax NLL_CHUNK pieces at a time, so that no
    (32, T, V) tensor is held."""
    pieces, n_valid = [], []
    for row in map(json.loads, Path(data["ppl"]).read_text().splitlines()):
        ids = tok.encode(row["text"])
        for s in range(0, max(len(ids) - 1, 1), T):
            piece = ids[s: s + T + 1]
            n_valid.append(len(piece) - 1)
            pieces.append(piece + [0] * (T + 1 - len(piece)))
    tokens = torch.tensor(pieces, device=DEV)
    out = []
    with torch.inference_mode():
        hidden, _ = model(tokens[:, :-1], return_hidden=True, return_logits=False,
                          reference=reference)
        for i in range(0, len(pieces), NLL_CHUNK):
            logp = torch.log_softmax(model.head(hidden[i: i + NLL_CHUNK]).float(), dim=-1)
            gold = logp.gather(-1, tokens[i: i + NLL_CHUNK, 1:, None])[..., 0]
            out += [g[:n].double() for g, n in zip(gold, n_valid[i: i + NLL_CHUNK])]
    return torch.cat(out)


def held_docs(qrels: list) -> list:
    """The documents of 19b's dense check on the fp32 plain route
    (EVAL_HELD_DOCS), in corpus order."""
    rel = {j for q in qrels for j in q}
    fill = [j for j in range(0, EVAL_DOCS, 4) if j not in rel]
    return sorted(rel | set(fill[: max(EVAL_HELD_DOCS - len(rel), 0)]))


def free_gib() -> float:
    """The card's free memory, all processes counted."""
    return torch.cuda.mem_get_info()[0] / 2**30


def memo(encode):
    """`encode` (texts -> embeddings) computed once a list of texts."""
    seen = {}

    def encode_once(texts):
        key = tuple(texts)
        if key not in seen:
            seen[key] = encode(texts)
        return seen[key]

    return encode_once


def engine_teacher_forced(engine, prompt: list, tokens: list) -> torch.Tensor:
    """The engine's own route with its output fed back: the prompt through
    its chunked prefill, then a decode step a token. (n, V) fp32."""
    with torch.inference_mode():
        logits, state = engine.prefill(prompt)
        rows = [logits.float()]
        for t in tokens[:-1]:
            lg, state = rwkv_decode_step(engine.model, torch.tensor([t], device=DEV), state,
                                         out=state)
            rows.append(lg[0].float())
    return torch.stack(rows)


def phase_eval(path: str, tmp: Path, files: dict, smi: str) -> dict:
    """Phase 19 (the module docstring) on the first EVAL_LAYERS layers of
    the saved bf16 model, with the named state of `files` cut to them.
    Returns the launches of the eval path's in-process commands."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    path, files = cut_eval_files(path, files, tmp / "eval_cut")
    print(f"  this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB of device memory")
    tok = WorldTokenizer()
    data = write_eval_files(tmp / "eval", tok)
    lengths = [len(tok.encode(t)) for t in data["corpus"]]
    print(f"  data: {EVAL_QUERIES} queries, {EVAL_DOCS} documents of {min(lengths)}-{max(lengths)} "
          f"tokens, {EVAL_STS} STS pairs, {EVAL_RERANK_ROWS} rerank rows of {EVAL_RERANK_DOCS}, "
          f"{EVAL_PPL_TEXTS} ppl texts ({time.perf_counter() - t_phase:.1f} s)")
    common = ["--model", path, "--batch-size", str(EVAL_BATCH), "--platform", DEV]
    clis = []
    try:
        clis.append(EvalCli(["parity", *common, "--task-dir", data["task"], "--max-texts", "256"]))
        clis.append(EvalCli(["retrieval-task", *common, "--task-dir", data["task"], "--score-head",
                             data["score"], "--rerank-top-k", "10"]))
        counts = eval_in_process(path, files, data, tok, clis, smi)
    finally:
        for c in clis:
            c.stop()
    print(f"  reading: phase 19 took {time.perf_counter() - t_phase:.1f} s (wall) on {smi}")
    return counts


def cut_eval_files(path: str, files: dict, d: Path) -> tuple:
    """The first EVAL_LAYERS layers of the checkpoint at `path` and of the
    named states of `files`, written under `d`: (checkpoint path, files)."""
    d.mkdir(parents=True, exist_ok=True)
    cut = d / f"rwkv6_1b6_synthetic_{EVAL_LAYERS}_layers.pth"
    torch.save(two_layer_sd(path, EVAL_LAYERS), cut)
    out = dict(files)
    spec = json.loads(files["states"].read_text())
    for name, entry in spec.items():
        states = torch.load(entry["path"], map_location="cpu", weights_only=True)
        entry["path"] = str(d / Path(entry["path"]).name)
        torch.save({k: v for k, v in states.items() if int(k.split(".")[1]) < EVAL_LAYERS},
                   entry["path"])
    out["states"] = d / "states.json"
    out["states"].write_text(json.dumps(spec))
    return str(cut), out


def eval_in_process(path: str, files: dict, data: dict, tok, clis: list, smi: str) -> dict:
    """Phase 19's work in this process (the module docstring) while `clis`
    run: the kernel route's answers, then the fp32 plain route's; then
    `clis`'s answers, then the readings alone on the device. Returns the
    launches of its eval.cli commands. Its lines end with the seconds since
    the subprocesses started."""
    at = lambda: f"[+{time.perf_counter() - clis[0].t0:.1f} s]"  # noqa: E731
    model, cfg = load_rwkv_checkpoint(path, device=DEV)
    f32, _ = load_rwkv_checkpoint(path, device=DEV, dtype="float32")
    print(f"  loaded the model in bf16 and in fp32 {at()}")
    common = ["--model", path, "--batch-size", str(EVAL_BATCH), "--platform", DEV]
    head = score_head_from_state_dict(torch.load(data["score"], weights_only=True), device=DEV)

    # 19b: sts and rerank through main(argv) in this process, their launches
    reset_launch_counts()
    sts = eval_cli_json(model, ["sts", *common, "--data", data["sts"]])
    rerank = eval_cli_json(model, ["rerank", *common, "--data", data["rerank"], "--score-head",
                                   data["score"]])
    torch.cuda.synchronize()
    counts = launch_counts()
    forwards = 2 * -(-EVAL_STS // EVAL_BATCH) + EVAL_RERANK_ROWS
    want = {k: forwards * n for k, n in forward_counts(cfg.n_layer).items()}
    print(f"  eval.cli sts (in process): cosine_spearman {sts['cosine_spearman']:.4f}; rerank: "
          f"{rerank}; launches of their {forwards} forwards: {counts} {at()}")
    check(counts == want, f"eval path launch counts {counts} != {want}")
    check(all(np.isfinite(v) and -1 <= v <= 1 for v in sts.values()), f"sts answered {sts}")

    # the same forward on the device: the tensor-core / chunked bodies, by name
    tokens = torch.from_numpy(next(BiEncoder(model, tok).token_batches(
        data["corpus"][-EVAL_BATCH:], batch_size=EVAL_BATCH))).to(DEV)
    # the profiler loses a record or two a trace (ROADMAP C.15): as many
    # layers traced as two 24-layer forwards, so the 0.9 rule sees the same
    # counts at any depth
    calls = max(2, 48 // cfg.n_layer)
    with torch.inference_mode():
        ops = device_ops(lambda: embed_sequences(model, tokens, normalize=True), calls)
    on_device = {name: kernel_launches(ops, name) / calls for name in (
        "wkv6_chunked_kernel", "tmix_prologue_tc_kernel", "layer_norm_kernel",
        "wkv6_sequential_kernel", "tmix_prologue_simt_kernel")}
    print(f"  one eval forward (B={EVAL_BATCH}, bucket {tokens.shape[1]}) on the device: "
          f"launches by kernel {on_device} {at()}")
    check(on_device["wkv6_chunked_kernel"] >= 0.9 * cfg.n_layer
          and on_device["tmix_prologue_tc_kernel"] >= 0.9 * cfg.n_layer
          and on_device["layer_norm_kernel"] >= 0.9 * (cfg.n_layer + 2)
          and on_device["wkv6_sequential_kernel"] == on_device["tmix_prologue_simt_kernel"] == 0,
          f"the eval forward ran other kernels than K1's chunked, K2's tensor-core and K3's")

    # the kernel route's rerank scores (the CLI's metrics), dense and
    # reranked retrieval metrics
    ce = CrossEncoder(model, tok, head)
    rows = data["rerank_rows"]
    kern = np.stack([ce.score_pairs([(r["query"], d) for d in r["documents"]]) for r in rows])
    labels = [r["labels"] for r in rows]
    check(rerank_metrics(list(kern), labels) == rerank,
          "the in-process reranker scores otherwise than eval.cli rerank")
    task = RetrievalTask.load(data["task"])
    be = BiEncoder(model, tok)
    enc = memo(lambda texts: be.encode_texts(texts, batch_size=EVAL_BATCH))
    dense = run_retrieval_task(task, enc)
    reranked = run_retrieval_task(task, enc, rerank_fn=ce.score_pairs, rerank_top_k=10)

    # 19c: RAG over the corpus, generation through the engine's graph blocks;
    # KG extraction through a named state
    engine = GenerationEngine(model, tok)
    retriever = LocalRetriever(BiEncoder(model, tok), data["corpus"])
    question = data["queries"][0]
    answer, sources = RagChat(engine, retriever, top_k=2).answer(question, max_tokens=RAG_NEW,
                                                                 sampling=GREEDY)
    prompt = tok.encode(RAG_TEMPLATE.format(context="\n".join(sources), question=question))
    out = GenerationEngine(model).generate(prompt, max_tokens=RAG_NEW, sampling=GREEDY)
    check(len(out) == RAG_NEW and tok.decode(out) == answer,
          "RagChat's answer is not the engine's greedy tokens on its prompt")
    kern_tf = engine_teacher_forced(engine, prompt, out)
    argmax = bool((kern_tf.argmax(-1) == torch.tensor(out, device=DEV)).all())
    check(argmax, "the RAG answer's tokens are not the argmax of its teacher-forced logits")
    states = StatesRegistry(cfg, device=DEV)
    for name, spec in json.loads(files["states"].read_text()).items():
        states.register_pth(name, spec["path"], spec["template"])
    record = KGExtractor(engine, states, action="sum", max_tokens=64).extract(
        "Alice works for ACME in Paris; the road to the plant is 3 km long.", sampling=GREEDY)
    print(f"  KGExtractor.extract through the named state 'sum': {record} {at()}")
    check(set(record) == {"entities", "relations"}
          and all(isinstance(v, list) for v in record.values()),
          f"KGExtractor returned {record}")

    # the fp32 plain route: rerank and dense retrieval by phase 16c's rule,
    # the RAG answer's logits, the ppl corpus's log-probabilities (and the
    # bf16 plain route's); its sequential WKV walks T steps a batch, so it
    # runs the texts sorted by length. The card's free memory is sampled
    # after each step, the subprocesses running
    low = [free_gib()]
    pairs = [(r["query"], d) for r in rows for d in r["documents"]]
    order = sorted(range(len(pairs)), key=lambda i: len(pair_ids(tok, *pairs[i])))
    batches = [torch.from_numpy(a).to(DEV) for a in ce.token_batches(
        [pairs[i] for i in order], batch_size=EVAL_BATCH)]
    plain = np.empty(len(pairs))
    plain[order] = (cls_states(f32, batches, reference=True)
                    @ head.weight.detach().float()[0]).cpu().numpy()
    plain = plain.reshape(len(rows), -1)
    del batches
    relevant = [[j for j, lab in enumerate(r) if lab] for r in labels]
    held = held_rows(plain, kern, relevant, EVAL_RERANK_DOCS)
    pick = lambda s: [s[i] for i in held]  # noqa: E731
    agree = rerank_metrics(pick(kern), pick(labels)) == rerank_metrics(pick(plain), pick(labels))
    dev = np.abs(kern - plain).max() / np.abs(plain).max()
    print(f"  rerank scores vs the fp32 plain route: max |diff| / max|plain| {dev:.3e}; metrics "
          f"equal on the {len(held)} of {len(rows)} rows no deviation could reorder: {agree} "
          f"(fp32 plain over all rows: {rerank_metrics(list(plain), labels)}) {at()}")
    check(agree and held, "eval.cli rerank's metrics are off the fp32 plain route's")
    low.append(free_gib())

    docs = held_docs(data["qrels"])
    qrels = [[docs.index(j) for j in q] for q in data["qrels"]]
    gold_be = BiEncoder(f32, tok, reference=True)
    qp, cp = (gold_be.encode_texts(texts, batch_size=EVAL_BATCH)
              for texts in (data["queries"], [data["corpus"][j] for j in docs]))
    sims_k, sims_p = enc(data["queries"]) @ enc(data["corpus"])[docs].T, qp @ cp.T
    held = held_rows(sims_p, sims_k, qrels, 10)
    agree = (metrics_from_sims(sims_k[held], [qrels[i] for i in held])
             == metrics_from_sims(sims_p[held], [qrels[i] for i in held]))
    print(f"  dense retrieval over the corpus, kernel route {dense}; over {len(docs)} of its "
          f"documents (every relevant one, then every 4th), kernel route "
          f"{metrics_from_sims(sims_k, qrels)}, fp32 plain route {metrics_from_sims(sims_p, qrels)}; "
          f"max |sim diff| {np.abs(sims_k - sims_p).max():.3e}; metrics equal on the {len(held)} of "
          f"{EVAL_QUERIES} queries no deviation could reorder: {agree} {at()}")
    check(agree and held, "dense retrieval metrics are off the fp32 plain route's")
    low.append(free_gib())

    cos = min_cosine(kern_tf, teacher_forced(f32, torch.tensor(prompt, device=DEV),
                                             torch.tensor(out, device=DEV), reference=True))
    print(f"  RagChat.answer: {len(sources)} sources (similarities "
          f"{[round(s, 4) for s, _ in retriever.retrieve(question, 2)]}), a {len(prompt)}-token "
          f"prompt, {RAG_NEW} greedy tokens in 16-step graph blocks, each the argmax of the engine "
          f"route's teacher-forced logits: {argmax}; min per-step logits cosine to the fp32 plain "
          f"route {cos:.6f} (limit 0.999) {at()}")
    check(cos >= 0.999, "the RAG answer's logits are off the fp32 plain route's")
    low.append(free_gib())

    lp32 = token_logprobs(f32, data, tok, reference=True)
    low.append(free_gib())
    del f32
    torch.cuda.empty_cache()
    lp16 = token_logprobs(model, data, tok, reference=True)
    lpk = token_logprobs(model, data, tok, reference=False)
    print(f"  the ppl corpus's log-probabilities on the fp32 and bf16 plain routes and the kernel "
          f"route {at()}")

    # 19a and 19b's subprocesses
    parity, task_out = (c.result() for c in clis)
    ref_op = parity["reference_wkv_op"]
    print(f"  python -m rwkv_lm_ext_tpu_torch.eval.cli parity ({clis[0].seconds:.1f} s): "
          f"{parity['n_texts']} texts, cosine drift mean {parity['cosine_drift_mean']:.3e}, max "
          f"{parity['cosine_drift_max']:.3e} (target {parity['target']}), pass {parity['pass']}; "
          f"scores_gold {parity['scores_gold']}, score_delta {parity['score_delta']}; "
          f"reference_wkv_op {ref_op}")
    check(parity["pass"] and parity["cosine_drift_max"] <= 1e-3 and "score_delta" in parity,
          "eval.cli parity does not pass its 1e-3 drift target")
    check("skipped" in ref_op or ref_op["rel_err"] < 1e-5, f"reference WKV op: {ref_op}")
    check(parity["scores_fast"] == dense,
          f"eval.cli parity's fast scores {parity['scores_fast']}, this process {dense}")
    print(f"  python -m rwkv_lm_ext_tpu_torch.eval.cli retrieval-task --score-head --rerank-top-k 10 "
          f"({clis[1].seconds:.1f} s): {task_out}")
    check(task_out == reranked, f"eval.cli retrieval-task answered {task_out}, this process "
          f"{reranked} on the same route")

    # readings, the subprocesses done: ppl through main(argv), the corpus's encode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppl, ppl_counts = count_launches(lambda: eval_cli_json(
        model, ["ppl", *common, "--data", data["ppl"], "--ctx-len", str(T)]))
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    pieces = 2 * EVAL_PPL_TEXTS
    want = {k: pieces * n for k, n in forward_counts(cfg.n_layer).items()}
    check(ppl_counts == want, f"ppl launch counts {ppl_counts} != {want}")
    k, p32, p16 = ppl["nll_per_token"], -lp32.mean().item(), -lp16.mean().item()
    d16 = lp16 - lp32
    se16 = d16.std().item() / d16.numel() ** 0.5
    limit = NLL_SCALE * max(abs(p16 - p32), se16)
    tok_k, tok_16 = (lpk - lp32).abs().mean().item(), d16.abs().mean().item()
    print(f"  eval.cli ppl (in process, --ctx-len {T}, {pieces} pieces, launches {ppl_counts}): "
          f"{ppl}; nll_per_token of the fp32 plain route {p32:.6f}, the bf16 plain route "
          f"{p16:.6f} (gap {abs(p16 - p32):.3e}, its standard error {se16:.3e}); the CLI's gap "
          f"{abs(k - p32):.3e} (limit {limit:.3e}); mean |log p - fp32 log p| a token: kernel "
          f"route {tok_k:.3e}, bf16 plain route {tok_16:.3e} (limit {NLL_SCALE:g}x)")
    check(ppl["tokens"] == lp32.numel() and abs(k - p32) <= limit,
          "ppl's nll_per_token is off the fp32 plain route's")
    check(tok_k <= NLL_SCALE * tok_16, "the kernel route's log-probabilities are off the fp32 "
          "plain route's")
    piece = torch.tensor(tok.encode(json.loads(Path(data["ppl"]).read_text().splitlines()[0])
                                    ["text"])[: T + 1], device=DEV)
    with torch.inference_mode():
        ops = device_ops(lambda: torch.log_softmax(model(piece[None, :-1])[0][0].float(), -1), 3)
    ppl_busy = busy_us(ops) / 3e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be.encode_texts(data["corpus"], batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    docs_s = EVAL_DOCS / (time.perf_counter() - t0)
    print(f"  reading: {docs_s:.1f} documents embedded a second (BiEncoder.encode_texts as "
          f"retrieval-task runs it, batches of {EVAL_BATCH}, the corpus sorted by length, "
          f"tokenizing included, host clock); ppl {ppl['tokens'] / ppl_s:.1f} tokens a second "
          f"({pieces} forwards at B=1, T={T}, host clock; {ppl_s / pieces * 1e3:.1f} ms a piece, the "
          f"device busy {ppl_busy:.1f} ms of it) on {smi}")
    total = torch.cuda.mem_get_info()[1] / 2**30
    print(f"  reading: device memory: this process's peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved; the card's "
          f"least free memory of {total:.2f} GiB, sampled after each fp32 step (the eval.cli "
          f"subprocesses beside it), {min(low):.2f} GiB ({', '.join(f'{x:.2f}' for x in low)})")
    return {key: counts[key] + ppl_counts[key] for key in counts}


# ---------------------------------------------------------------------------
# Phase 21: speculative decoding
# ---------------------------------------------------------------------------

COLLECT_REL = {torch.float32: 1e-4, BF16: 1e-2}   # B.15's gated output, x max|plain|
SPEC_GAMMA = 8
SPEC_DRAFT_LAYERS = 4
SPEC_NEW = 16                # tokens of the in-process checks (32 before phase 23)
SPEC_READ_NEW = 32           # tokens of the single-stream readings (64 before phase 23)
SPEC_SMALL_LAYERS = 4        # depth of the fp32 identity and the RWKV-5.2 / RWKV-4 targets


def phase_collect_kernel() -> dict:
    """B.15 against its plain version (wkv_collect + K1's GroupNorm-gate
    epilogue) at T in {1, 5, 9, 17, 33}, B in {1, 4}, N in {64, 128} (H =
    C / N), fp32 and bf16, and on v5's constant decay: the gated output within
    COLLECT_REL and every state within 1e-4 of max|plain|; then timed at the
    verify pass's shape (B=1, T = gamma + 1 = 9, H=32, N=64, bf16) beside its
    bound (each input once, the output and the whole state stack once)."""
    rng = Inputs(21)

    def args_of(b, t, n, dtype, v5=False):
        h = C // n
        r, k, v = (rng.normal(b, t, h, n, scale=0.5, dtype=dtype) for _ in range(3))
        g = torch.nn.functional.silu(rng.normal(b, t, h, n, dtype=dtype))
        if v5:
            w = rng.uniform(h, n, lo=-6.0, hi=1.0, dtype=torch.float32).expand(b, t, h, n)
        else:
            w = rng.uniform(b, t, h, n, lo=-6.0, hi=1.0, dtype=torch.float32)
        return (r, k, v, w, rng.normal(h, n, scale=0.5, dtype=torch.float32), g,
                rng.normal(h * n, scale=0.1, dtype=torch.float32) + 1,
                rng.normal(h * n, scale=0.1, dtype=torch.float32),
                rng.normal(b, h, n, n, scale=0.1, dtype=torch.float32))

    worst = {torch.float32: 0.0, BF16: 0.0}
    for dtype in (torch.float32, BF16):
        for n in (64, 128):
            for b in (1, 4):
                for t in (1, 5, 9, 17, 33):
                    args = args_of(b, t, n, dtype)
                    out, states = wkv6_collect(*args, eps=LN_X_EPS)
                    out_p, states_p = wkv6_collect_plain(*f32(*args), eps=LN_X_EPS)
                    for got, want, rel, what in ((out, out_p, COLLECT_REL[dtype], "out"),
                                                 (states, states_p, 1e-4, "states")):
                        err = (got.float() - want).abs().max().item()
                        limit = rel * want.abs().max().item()
                        check(err <= limit, f"wkv6_collect {dtype} N={n} B={b} T={t} {what}: error "
                              f"{err} above {limit}")
                        if what == "out":
                            worst[dtype] = max(worst[dtype], err)
        for b in (1, 4):
            args = args_of(b, 9, 64, dtype, v5=True)
            out, states = wkv6_collect(*args, eps=LN_X_EPS)
            out_p, states_p = wkv6_collect_plain(*f32(*args), eps=LN_X_EPS)
            err_line(f"wkv6_collect {dtype} v5 decay B={b} T=9 out", out, out_p, COLLECT_REL[dtype])
            err_line(f"wkv6_collect {dtype} v5 decay B={b} T=9 states", states, states_p, 1e-4)
    print(f"  wkv6_collect against its plain version at T in (1, 5, 9, 17, 33), B in (1, 4), N in "
          f"(64, 128), fp32 and bf16: out within {COLLECT_REL[torch.float32]:g} / "
          f"{COLLECT_REL[BF16]:g} x max|plain| (largest error {worst[torch.float32]:.3e} / "
          f"{worst[BF16]:.3e}), every state within 1e-4 x max|plain|")
    args = args_of(1, SPEC_GAMMA + 1, N, BF16)
    stack = torch.empty(SPEC_GAMMA + 1, 1, H, N, N, device=DEV)
    out, _ = wkv6_collect(*args, eps=LN_X_EPS, out_states=stack)
    ms = device_ms(lambda: wkv6_collect(*args, eps=LN_X_EPS, out_states=stack), 50)
    plain_ms = device_ms(lambda: wkv6_collect_plain(*args, eps=LN_X_EPS), 5)
    b, t = 1, SPEC_GAMMA + 1
    row = dict(
        max_abs_err=worst[BF16], ms=ms, plain_ms=plain_ms,
        # every input once, the gated output and the state after every step;
        # per step and head the two products of the recurrence and the decay
        # of the state (~5 N^2) and the GroupNorm (~10 N) on fp32 FMAs
        **roofline(nbytes(*args) + nbytes(out, stack), {"fp32": b * t * H * (5 * N * N + 10 * N)}),
    )
    print(f"  wkv6_collect at the verify pass's shape (B=1, T={t}, H={H}, N={N}, bf16): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), {100 * row['bound_ms'] / ms:.1f} % of bound")
    return {"wkv6_collect": row}


def eager_rounds():
    """Within it, the speculative engine's rounds and rollbacks run their
    eager bodies on the card in place of the graph replays."""
    return mock.patch.object(speculative._Rounds, "_replay",
                             lambda self, name, body, warmup, gen: body())


def spec_run(spec, prompt, n, sampling=None):
    """(tokens, stats, the final static target and draft states)."""
    out, stats = spec.generate(prompt, max_tokens=n, token_stop=(), sampling=sampling, seed=4,
                               return_stats=True)
    rounds = spec._rounds_for(sampling if sampling is not None and sampling.temperature > 0
                              else None)
    return out, stats, clone_state(rounds.t_state), clone_state(rounds.d_state)


SPEC_SAMPLED = SamplingParams(temperature=1.0, top_p=0.9, alpha_presence=0.0, alpha_frequency=0.0,
                              token_stop=())


def replay_equals_eager(model, draft, prompt, label: str) -> None:
    """Greedy and sampled speculative generation as graph replays and as
    eager rounds: the same tokens, stats and final states, bit for bit."""
    for sp in (None, SPEC_SAMPLED):
        graph = spec_run(SpeculativeEngine(model, draft, gamma=SPEC_GAMMA), prompt, SPEC_NEW, sp)
        with eager_rounds():
            eager = spec_run(SpeculativeEngine(model, draft, gamma=SPEC_GAMMA), prompt, SPEC_NEW,
                             sp)
        check(graph[0] == eager[0] and graph[1] == eager[1] and states_equal(graph[2], eager[2])
              and states_equal(graph[3], eager[3]) and len(graph[0]) == SPEC_NEW,
              f"{label}: replayed speculative rounds differ from eager rounds ({sp})")
        print(f"  {label}, {'greedy' if sp is None else 'sampled'}: {SPEC_NEW} tokens as graph "
              f"replays bit-equal to eager rounds (tokens, stats, final target and draft states); "
              f"acceptance {graph[1].acceptance:.3f}, {graph[1].tokens_per_target_pass:.2f} tokens "
              f"a target pass")


def collect_against_prefix(model, label: str) -> None:
    """The collect forward over 9 tokens after a 16-token prefill (B=1)
    against the forward: logits cosine >= 0.999 (the drift bound) and
    states[j] against the state of a prefix forward, row cosines >=
    STATE_COS (j = 0, 4, 8)."""
    gen = torch.Generator(device=DEV).manual_seed(61)
    tokens = torch.randint(4, model.cfg.vocab_size, (1, 25), device=DEV, generator=gen)
    with torch.inference_mode():
        _, st = model(tokens[:, :16])
        logits, states = rwkv_forward_collect(model, tokens[:, 16:], st)
        full, _ = model(tokens[:, 16:], st, t1_step=False)
        worst = 1.0
        for j in (0, 4, 8):
            _, want = model(tokens[:, 16:17 + j], st, t1_step=False)
            got = select_state(states, torch.tensor([j], device=DEV))
            for key in want:
                rows = [t.flatten(0, -3).flatten(1) if key == "wkv" else t.flatten(0, -2)
                        for t in (got[key], want[key])]
                worst = min(worst, min_cosine(*rows))
    cos = min_cosine(logits[0], full[0])
    print(f"  {label}: collect forward vs forward over 9 tokens after 16: min logits cosine "
          f"{cos:.6f} (limit 0.999); states[j] vs the prefix forward's (j = 0, 4, 8): min row "
          f"cosine {worst:.6f} (limit {STATE_COS[False]})")
    check(cos >= 0.999 and worst >= STATE_COS[False],
          f"{label}: collect forward vs prefix forward: logits {cos}, states {worst}")


def greedy_identity(model, draft, label: str) -> None:
    """fp32: the speculative greedy tokens equal the engine's penalty-free
    greedy tokens; the one exception allowed is a first divergence where the
    engine's top-2 logit gap is within twice the measured deviation of the
    two routes' logits there (phase 16c's rule: no deviation could swap
    them)."""
    gen = torch.Generator(device=DEV).manual_seed(62)
    prompt = torch.randint(4, model.cfg.vocab_size, (16,), device=DEV, generator=gen)
    want = GenerationEngine(model).generate(prompt.tolist(), max_tokens=SPEC_NEW, sampling=GREEDY)
    got, stats = SpeculativeEngine(model, draft, gamma=SPEC_GAMMA).generate(
        prompt.tolist(), max_tokens=SPEC_NEW, token_stop=(), return_stats=True)
    toks = torch.tensor(want, device=DEV)
    engine_logits = teacher_forced(model, prompt, toks, reference=False)
    with torch.inference_mode():
        first, st = model(prompt[None])
        if collect_supported(model.cfg):
            rest, _ = rwkv_forward_collect(model, toks[None, :-1], st)
        else:
            rest, _ = model(toks[None, :-1], st)
    verify_logits = torch.cat([first[0, -1:], rest[0]]).float()
    dev = (verify_logits - engine_logits).abs().max().item()
    same = got == want
    i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    gap = None
    if not same and i is not None:
        top2 = engine_logits[i].topk(2).values
        gap = (top2[0] - top2[1]).item()
    print(f"  {label}: speculative greedy ({SPEC_NEW} tokens, acceptance {stats.acceptance:.3f}) "
          f"{'equals' if same else f'departs at token {i} from'} the engine's penalty-free greedy; "
          f"the routes' logits differ by {dev:.3e} at most"
          + ("" if same else f", the engine's top-2 gap there {gap:.3e}"))
    check(same or (i is not None and got[:i] == want[:i] and gap <= 2 * dev),
          f"{label}: speculative greedy tokens depart from the engine's beyond the routes' deviation")


def spec_requests(base: str, label: str) -> dict:
    """A greedy and a sampled /generate on a speculative server, a penalized
    one (the engine's), /stats."""
    greedy = {"max_tokens": 32, "temperature": 0.0, "top_p": 1.0, "alpha_presence": 0.0,
              "alpha_frequency": 0.0, "token_stop": []}
    code, a = post(base + "/generate", {"prompt": SHORT, **greedy})
    check(code == 200 and a["backend"] == "speculative", f"{label}: greedy /generate {code} {a}")
    code, b = post(base + "/generate", {"prompt": CJK, **greedy, "temperature": 0.8, "top_p": 0.9})
    check(code == 200 and b["backend"] == "speculative", f"{label}: sampled /generate {code} {b}")
    code, c = post(base + "/generate", {"prompt": SHORT, "max_tokens": 8})
    check(code == 200 and c["backend"] == "engine", f"{label}: penalized /generate {code} {c}")
    code, stats = post(base + "/stats", {})
    spec = stats.get("speculative", {})
    check(code == 200 and spec.get("rounds", 0) > 0 and 0.0 <= spec["acceptance"] <= 1.0,
          f"{label}: /stats {stats}")
    print(f"  python -m rwkv_lm_ext_tpu_torch.serve.cli {label}: greedy and sampled /generate "
          f"answered 200 by \"speculative\", a penalized one by \"engine\"; /stats speculative "
          f"{spec}")
    return a


def phase_speculative(model, path: str, tmp: Path, smi: str) -> int:
    """Phase 21 (the module docstring). Returns B.15's launches in one
    speculative /generate on a fresh engine (its counters from 0)."""
    tok = WorldTokenizer()
    d_cfg = rwkv6_1b6(n_layer=12, n_embd=768)
    draft_path = str(tmp / "rwkv6_draft_12x768.pth")
    draft_model = load_state_dict_into(RWKV(d_cfg, device=DEV), synthetic_1b6(d_cfg, seed=70))
    save_rwkv_checkpoint(draft_model, draft_path)
    servers = {
        f"--draft-layers {SPEC_DRAFT_LAYERS} --gamma {SPEC_GAMMA}":
            CliServer(["--model", path, "--platform", DEV, "--port", "0", "--draft-layers",
                       str(SPEC_DRAFT_LAYERS), "--gamma", str(SPEC_GAMMA)]),
        "--draft (12 layers, C=768)":
            CliServer(["--model", path, "--platform", DEV, "--port", "0", "--draft", draft_path]),
    }
    with contextlib.ExitStack() as stack:
        # the two servers start while the in-process checks run
        for server in servers.values():
            server.start()
            stack.callback(server.__exit__)
        draft = truncated_draft(model, SPEC_DRAFT_LAYERS)
        collect_against_prefix(model, f"1B6 bf16, {model.cfg.n_layer} layers")
        gen = torch.Generator(device=DEV).manual_seed(63)
        prompt = torch.randint(4, model.cfg.vocab_size, (16,), device=DEV, generator=gen).tolist()
        replay_equals_eager(model, draft, prompt, f"1B6 bf16, draft of {SPEC_DRAFT_LAYERS} layers")
        # the main path's launches: a fresh engine, counters from 0
        spec = SpeculativeEngine(model, draft, tok, gamma=SPEC_GAMMA)
        reset_launch_counts()
        spec.generate(SHORT, max_tokens=32, token_stop=())
        launches = launch_counts()["wkv6_collect"]
        rounds = spec._rounds_for(None)
        with torch.inference_mode():
            ops = device_ops(lambda: rounds.run(spec._gen), 4)
            _, wall = timed_s(lambda: [rounds.run(spec._gen) for _ in range(10)])
        per_round = kernel_launches(ops, "wkv6_collect_kernel") / 4
        L = model.cfg.n_layer
        print(f"  B.15 launches: {launches} in one /generate's capture and warm-up (counters from "
              f"0), {per_round:g} a replayed round on the device ({L} a verify pass); a greedy "
              f"round's replay and fetch {wall / 10 * 1e3:.3f} ms wall (mean of 10), "
              f"{len(ops) / 4:.0f} device ops and {busy_us(ops) / 4 / 1e3:.3f} ms busy a round "
              f"(gamma {SPEC_GAMMA} draft steps of {SPEC_DRAFT_LAYERS} layers and the verify "
              f"pass) on {smi}")
        check(launches > 0 and 0.9 * L <= per_round <= L,
              f"B.15 launched {launches} times, {per_round} a replayed round")
        del spec, rounds

        # fp32 at reduced depth: the greedy identity with the engine
        small = two_layer_sd(path, SPEC_SMALL_LAYERS)
        m32 = load_state_dict_into(RWKV(rwkv6_1b6(n_layer=SPEC_SMALL_LAYERS, dtype="float32"),
                                        device=DEV), small)
        greedy_identity(m32, truncated_draft(m32, 1), f"1B6 fp32, {SPEC_SMALL_LAYERS} layers")
        del m32, small
        # RWKV-5.2 through the collect forward, RWKV-4 through the re-prefill rollback
        v5_cfg = rwkv5_1b5(n_layer=SPEC_SMALL_LAYERS)
        v5 = load_state_dict_into(RWKV(v5_cfg, device=DEV), synthetic_1b6(v5_cfg, 64))
        collect_against_prefix(v5, f"RWKV-5.2 1B5 widths bf16, {SPEC_SMALL_LAYERS} layers")
        replay_equals_eager(v5, truncated_draft(v5, 1), prompt, f"RWKV-5.2 bf16, {SPEC_SMALL_LAYERS} "
                            "layers, draft of 1")
        del v5
        v4_cfg = rwkv4_1b5(n_layer=SPEC_SMALL_LAYERS, dtype="float32")
        v4 = load_state_dict_into(RWKV(v4_cfg, device=DEV), synthetic_1b6(v4_cfg, 65))
        check(not SpeculativeEngine(v4, v4).collect, "an RWKV-4 target took the collect forward")
        greedy_identity(v4, truncated_draft(v4, 1), f"RWKV-4 1.5B widths fp32, {SPEC_SMALL_LAYERS} "
                        "layers, the re-prefill rollback")
        del v4
        torch.cuda.empty_cache()

        for label, server in servers.items():
            spec_requests(server.url(), label)
    del draft_model
    if READINGS:
        spec_readings(model, draft, prompt, smi)
    return launches


def spec_readings(model, draft, prompt: list, smi: str) -> None:
    """Phase 21's readings, its servers stopped: the verify pass alone (CUDA
    events) and single-stream generation against the engine's, in turns."""
    spec = SpeculativeEngine(model, draft, gamma=SPEC_GAMMA)
    engine = GenerationEngine(model)
    with torch.inference_mode():
        _, st = model(torch.tensor([prompt], device=DEV))
        feed = torch.tensor([prompt[:SPEC_GAMMA + 1]], device=DEV)
        rwkv_forward_collect(model, feed, st)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            rwkv_forward_collect(model, feed, st)
        end.record()
        torch.cuda.synchronize()
    verify_ms = start.elapsed_time(end) / 10
    runs = {"speculative": lambda: spec.generate(prompt, max_tokens=SPEC_READ_NEW, token_stop=(),
                                                 return_stats=True),
            "engine": lambda: (engine.generate(prompt, max_tokens=SPEC_READ_NEW, sampling=GREEDY),
                               None)}
    for fn in runs.values():
        fn()
    secs = collections.defaultdict(list)
    for name in ("engine", "speculative", "speculative", "engine"):
        (out, stats), t = timed_s(runs[name])
        check(len(out) == SPEC_READ_NEW, f"{name}: {len(out)} tokens")
        secs[name].append(t)
        if stats is not None:
            spec_stats = stats
    rate = {n: " / ".join(f"{SPEC_READ_NEW / t:.1f}" for t in ts) for n, ts in secs.items()}
    print(f"  reading: the verify pass ({model.cfg.n_layer} layers, T={SPEC_GAMMA + 1}, B=1, bf16, eager) "
          f"{verify_ms:.3f} ms (CUDA events, mean of 10) on {smi}")
    print(f"  reading: single-stream greedy, {SPEC_READ_NEW} tokens (B=1, bf16, draft of "
          f"{SPEC_DRAFT_LAYERS} layers, gamma {SPEC_GAMMA}): speculative {rate['speculative']} tok/s, "
          f"the engine's generate {rate['engine']} tok/s (in turns: engine, speculative, "
          f"speculative, engine); acceptance {spec_stats.acceptance:.3f}, "
          f"{spec_stats.tokens_per_target_pass:.2f} tokens a target pass, {spec_stats.rounds} rounds "
          f"on {smi}")
    del spec, engine
    torch.cuda.empty_cache()


TP = 2                       # phase 22's ranks
TP_LAYERS = 12               # its model's depth (24 before the script's time limit needed it)
TP_B, TP_T = 4, 512          # its prefill
TP_NEW = 16                  # fp32 greedy tokens against the single-process engine
TP_NEW_Q = 8                 # bf16 and int8c greedy tokens (each rank decodes at ~6 tok/s)
# (32 and 16 before phase 23 needed the script's time)
TP_BUSY_NEW = 4              # tokens of the traced generate (each rank's busy ms; 8 before)
# fp32 tp logits are held to the single-process kernel route within the
# single-process fp32 plain route's own distance from it: the same run's
# rounding gap, which 24 layers of seeded weights grow to ~1e-3 x max (PERF.md)
# bf16 tp logits against the fp32 plain route, per position: the mean cosine
# at least this (BASELINE.md's drift rule), the worst position no more than
# twice as far as the single-process bf16 route's worst (a row-parallel sum
# rounds each rank's partial to bf16, then the sum: one more rounding)
TP_BF16_MEAN_COS = 0.999
TP_CLI_LAYERS = 4            # depth of the CLI's checkpoint (full width)
TP_CLI_SLOTS = 4
TP_RANK_TIMEOUT_S = 420
TP_KERNELS = ("layer_norm", "tmix_prologue", "wkv6_fused_output", "wkv6_decode_step")
TP_PROMPTS = (SHORT, CJK, MIXED, "Paris is the capital of France.", "数据 1 2 3",
              "The quick brown fox", "RWKV-6 World", "Tensor parallelism splits the heads.")


def rank_busy_ms(timed) -> tuple:
    """(this rank's device busy ms over timed(), its wall seconds under the
    trace): ``timed`` returns (result, seconds). Every rank runs it in
    lockstep; each traces only its own process's card work."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, seconds = timed()
        torch.cuda.synchronize()
    return busy_us([e for e in prof.events() if e.device_type == DeviceType.CUDA]) / 1e3, seconds


def tp_rank(rank: int, rendezvous: str, out_dir: str, readings: bool = False) -> None:
    """One rank of phase 22, a process of its own (``python3 -c "import
    chip_smoke; chip_smoke.tp_rank(...)"``): the seeded 1B6 at TP_LAYERS
    layers cut over TP ranks (gloo where they share the card, NCCL where
    each has one) in fp32, bf16 and int8c, each rank's kernel launches, and
    on rank 0 the same calls on the whole model (the single-process route)
    to hold them against; with `readings`, each rank's busy time. Every
    check raises; the results go to out_dir/tp-<rank>.json."""
    global DEV, READINGS
    READINGS = readings
    init_distributed(rendezvous, TP, rank, platform="cuda", timeout=TP_RANK_TIMEOUT_S)
    try:
        DEV = str(rank_device("cuda"))
        torch.cuda.set_device(DEV)
        res = _tp_rank_checks(make_mesh(dp=1, tp=TP), rank == 0)
    finally:
        shutdown()
    Path(out_dir, f"tp-{rank}.json").write_text(json.dumps(res))


def _tp_rank_checks(mesh, main: bool) -> dict:
    res = {"seconds": {}}
    start = time.perf_counter()

    def lap(name):
        res["seconds"][name] = round(time.perf_counter() - start - sum(res["seconds"].values()), 1)

    cfg32 = rwkv6_1b6(n_layer=TP_LAYERS, dtype="float32")
    cfg16 = rwkv6_1b6(n_layer=TP_LAYERS)
    sd = synthetic_1b6(cfg32, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(22)
    tokens = torch.randint(4, cfg32.vocab_size, (TP_B, TP_T), device=DEV, generator=gen)
    prompt = torch.randint(4, cfg32.vocab_size, (16,), device=DEV, generator=gen).tolist()

    def tp_engine(cfg, quant=None):
        model = load_state_dict_into(RWKV(cfg, device=DEV), sd)
        return GenerationEngine(quantize_model(model, quant, weights=sd) if quant else model,
                                mesh=mesh)

    def single(cfg, quant=None):
        model = load_state_dict_into(RWKV(cfg, device=DEV), sd)
        return quantize_model(model, quant, weights=sd) if quant else model

    def timed_generate(engine, n=TP_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(prompt, max_tokens=n, sampling=GREEDY)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # fp32: logits and greedy tokens against the single-process kernel route
    engine = tp_engine(cfg32)
    res["route"] = engine.route()
    reset_launch_counts()
    with torch.inference_mode():
        logits, state = engine.model(tokens)
    out32, _ = timed_generate(engine)
    res["counts_fp32"] = launch_counts()
    check(all(res["counts_fp32"][k] > 0 for k in TP_KERNELS),
          f"rank {mesh.rank}: a kernel of the tp path ran no time: {res['counts_fp32']}")
    heads = (cfg32.n_layer, TP_B, cfg32.n_head // TP, cfg32.head_size, cfg32.head_size)
    check(tuple(state["wkv"].shape) == heads,
          f"rank {mesh.rank}'s state {tuple(state['wkv'].shape)} is not its heads' {heads}")
    del engine, state
    plain32 = None
    if main:
        whole = single(cfg32)
        with torch.inference_mode():
            want, _ = whole(tokens)
            plain32, _ = whole(tokens, reference=True)
        scale = want.abs().max()
        res["fp32_err"] = float((logits - want).abs().max() / scale)
        res["fp32_plain_gap"] = float((plain32 - want).abs().max() / scale)
        res["fp32_single_tokens"] = GenerationEngine(whole).generate(
            prompt, max_tokens=TP_NEW, sampling=GREEDY)
        check(res["fp32_err"] <= res["fp32_plain_gap"], f"tp fp32 logits {res['fp32_err']:.3e} x "
              f"max from the single-process kernel route, further than its fp32 plain route "
              f"({res['fp32_plain_gap']:.3e})")
        check(out32 == res["fp32_single_tokens"], "tp fp32 greedy tokens differ from the "
              "single-process engine's")
        del whole, want
    res["fp32_tokens"] = out32
    del logits
    torch.cuda.empty_cache()
    lap("fp32")

    # bf16: logits against the fp32 plain route, greedy tokens by teacher
    # forcing on the same (tp) route, readings
    engine = tp_engine(cfg16)
    with torch.inference_mode():
        logits16, _ = engine.model(tokens)
    if main:
        # the single-process bf16 kernel route on the same tokens is the
        # yardstick: at T=512 a few early positions of seeded weights sit near
        # cosine 0.98 for it too (PERF.md)
        with torch.inference_mode():
            want16, _ = single(cfg16)(tokens)
        cos_tp = position_cosines(logits16.float(), plain32)
        cos_single = position_cosines(want16.float(), plain32)
        res["bf16_cos"] = [float(cos_tp.min()), float(cos_tp.mean())]
        res["bf16_single_cos"] = [float(cos_single.min()), float(cos_single.mean())]
        del want16, cos_tp, cos_single
        check(res["bf16_cos"][1] >= TP_BF16_MEAN_COS
              and 1 - res["bf16_cos"][0] <= 2 * (1 - res["bf16_single_cos"][0]),
              f"tp bf16 logits cosine (min, mean) {res['bf16_cos']} to the fp32 plain route: the "
              f"mean under {TP_BF16_MEAN_COS} or the min more than twice as far as the "
              f"single-process bf16 route's {res['bf16_single_cos']}")
    del logits16, plain32
    out16, res["decode_s"] = timed_generate(engine, TP_NEW_Q)
    tf = teacher_forced(engine.model, torch.tensor(prompt, device=DEV),
                        torch.tensor(out16, device=DEV), reference=False)
    check(bool((tf.argmax(-1).cpu() == torch.tensor(out16)).all()), f"rank {mesh.rank}: tp bf16 "
          "greedy tokens are not the argmax of the same route's teacher-forced logits")
    res["bf16_tokens"] = out16
    if READINGS:
        # each rank traces its own card work over the same short generate
        res["busy_ms"], res["busy_wall_s"] = rank_busy_ms(lambda: timed_generate(engine,
                                                                                 TP_BUSY_NEW))
    del engine
    torch.cuda.empty_cache()
    lap("bf16")

    # int8c: codes, scales, the row-parallel product and the logits bit for
    # bit against the single-process int8c route
    engine = tp_engine(cfg16, "int8c")
    reset_launch_counts()
    with torch.inference_mode():
        logits_q, _ = engine.model(tokens)
    outq, _ = timed_generate(engine, TP_NEW_Q)
    res["counts_int8c"] = launch_counts()
    check(all(res["counts_int8c"][k] > 0 for k in TP_KERNELS + ("quantize_rows",
                                                                 "quantize_rows_given")),
          f"rank {mesh.rank}: a kernel of the tp int8c path ran no time: {res['counts_int8c']}")
    x = Inputs(23).normal(TP_B * TP_T, cfg32.n_embd)
    lin = engine.model.blocks[0].att.output.inner
    codes = {}
    with torch.inference_mode():
        y = row_parallel_int8c(x.chunk(mesh.tp, -1)[mesh.rank], lin.q, lin.scale, mesh,
                               codes=codes)
        q, sx = quantize_rows(x)
    res["int8c_codes_equal"] = (torch.equal(codes["sx"], sx)
                                and torch.equal(codes["q"], q.chunk(mesh.tp, -1)[mesh.rank]))
    check(res["int8c_codes_equal"], f"rank {mesh.rank}: tp int8c codes or scales differ from B.4 "
          "on the whole rows")
    if main:
        whole = single(cfg16, "int8c")
        with torch.inference_mode():
            want_q, _ = whole(tokens)
            want_y = whole.blocks[0].att.output(x)
        res["int8c_product_equal"] = torch.equal(y, want_y)
        res["int8c_logits_equal"] = torch.equal(logits_q, want_q)
        res["int8c_logits_err"] = float((logits_q.float() - want_q.float()).abs().max()
                                        / want_q.float().abs().max())
        res["int8c_single_tokens"] = GenerationEngine(whole).generate(
            prompt, max_tokens=TP_NEW_Q, sampling=GREEDY)
        check(res["int8c_product_equal"], "tp int8c att.output product differs from the "
              "single-process one")
        check(res["int8c_logits_equal"], f"tp int8c logits are not bit-equal to single-process "
              f"int8c ({res['int8c_logits_err']:.3e} x max)")
        check(outq == res["int8c_single_tokens"], "tp int8c greedy tokens differ")
    lap("int8c")
    return res


def write_tp_cli_files(d: Path) -> list:
    """A TP_CLI_LAYERS-layer fp32 checkpoint at full width and a seeded
    bi-encoder LoRA for it; returns the CLI's arguments."""
    cut = rwkv6_1b6(n_layer=TP_CLI_LAYERS, dtype="float32")
    sd = synthetic_1b6(cut, seed=7)
    model = load_state_dict_into(RWKV(cut, device=DEV), sd)
    save_rwkv_checkpoint(model, str(d / "cut.pth"))
    gen = torch.Generator(device=DEV).manual_seed(24)
    adapter = init_lora_params(model, SERVE_LORA, gen)
    for ab in adapter.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=DEV) * 0.02
    torch.save(lora_state_dict(apply_lora(model, SERVE_LORA, adapter)), d / "bi.pth")
    return ["--model", str(d / "cut.pth"), "--bi-adapter", str(d / "bi.pth"),
            "--lora-r", str(SERVE_LORA.r), "--lora-alpha", str(SERVE_LORA.alpha),
            "--dtype", "float32", "--batcher-slots", str(TP_CLI_SLOTS), "--platform", DEV,
            "--port", "0"]


def phase_tp(tmp: Path, smi: str) -> dict:
    """Phase 22: the tp ranks (tp_rank) and `serve.cli --tp 2` on a cut
    checkpoint, beside the single-process CLI's answers made in this
    process meanwhile. Returns rank 0's launches of the tp path's kernels."""
    d = tmp / "tp"
    d.mkdir()
    args = write_tp_cli_files(d)
    torch.cuda.empty_cache()
    rendezvous = "file://" + str(d / "rendezvous")
    logs = [open(d / f"rank{r}.log", "w") for r in range(TP)]
    ranks = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.tp_rank("
                               f"{r}, {rendezvous!r}, {str(d)!r}, {READINGS})"],
                              cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(TP)]
    server = CliServer([*args, "--tp", str(TP)])
    server.start()
    try:
        service = cli.build_service(cli.parse_args(args))
        service.warmup()
        greedy = {"max_tokens": TP_NEW, "temperature": 0.0, "token_stop": []}
        want = [service.handle("/generate", {"prompt": p, **greedy})["output"] for p in TP_PROMPTS]
        want_emb = np.asarray(service.handle("/embed", {"texts": list(TP_PROMPTS[:3])})["embeddings"])
        service.close()
        del service
        torch.cuda.empty_cache()
        deadline = time.monotonic() + TP_RANK_TIMEOUT_S
        for proc in ranks:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except BaseException:
        for proc in ranks:
            proc.kill()
        server.stop()
        raise
    finally:
        for f in logs:
            f.close()
    for r, proc in enumerate(ranks):
        if proc.returncode != 0:
            server.stop()
            tail = (d / f"rank{r}.log").read_text()[-4000:]
            raise AssertionError(f"tp rank {r} exited {proc.returncode}:\n{tail}")
    res = [json.loads((d / f"tp-{r}.json").read_text()) for r in range(TP)]
    r0 = res[0]
    print(f"  route: {json.dumps(r0['route'])}")
    print(f"  fp32, B={TP_B}, T={TP_T}: tp logits {r0['fp32_err']:.3e} x max from the "
          f"single-process kernel route (limit: its fp32 plain route's {r0['fp32_plain_gap']:.3e}); "
          f"{TP_NEW} greedy tokens equal the single-process engine's on both ranks")
    check(all(r["fp32_tokens"] == r0["fp32_tokens"] for r in res), "the ranks' tokens differ")
    print(f"  bf16: logits cosine to the fp32 plain route min {r0['bf16_cos'][0]:.6f}, mean "
          f"{r0['bf16_cos'][1]:.6f} (the single-process bf16 route's {r0['bf16_single_cos'][0]:.6f}, "
          f"{r0['bf16_single_cos'][1]:.6f}); greedy tokens the argmax of the tp route's "
          f"teacher-forced logits on each rank")
    print(f"  int8c: B.4 codes and scales bit-equal on each rank, att.output product bit-equal, "
          f"logits bit-equal {r0['int8c_logits_equal']}, greedy tokens equal")
    for r, rr in enumerate(res):
        print(f"  rank {r} launches: fp32 prefill + {TP_NEW} steps "
              f"{ {k: rr['counts_fp32'][k] for k in TP_KERNELS} }; int8c "
              f"{ {k: rr['counts_int8c'][k] for k in TP_KERNELS + ('quantize_rows', 'quantize_rows_given')} }")
    print(f"  each rank's seconds by part: {[rr['seconds'] for rr in res]}")
    busy = (f"; busy ms over one {TP_BUSY_NEW}-token generate: "
            + ", ".join(f"rank {r} {rr['busy_ms']:.1f} of {rr['busy_wall_s'] * 1e3:.1f} wall"
                        for r, rr in enumerate(res)) + " (traced)" if READINGS else "")
    print(f"  reading: tp={TP} bf16 greedy decode {TP_NEW_Q / r0['decode_s']:.1f} tok/s at B=1 "
          f"({r0['route']['blocks']}, {r0['route']['backend']}, {TP_LAYERS} layers){busy}, on {smi}")

    with server as base:
        results = [None] * len(TP_PROMPTS)

        def one(i):
            results[i] = post(base + "/generate", {"prompt": TP_PROMPTS[i], **greedy})

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(TP_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(all(r is not None and r[0] == 200 and r[1]["backend"] == "batcher" for r in results),
              f"tp CLI /generate answered {[r and r[0] for r in results]}")
        same = [r[1]["output"] == w for r, w in zip(results, want)]
        code, emb = post(base + "/embed", {"texts": list(TP_PROMPTS[:3])})
        emb = np.asarray(emb["embeddings"])
        code_stats, stats = post(base + "/stats", {})
        code_big, big = post(base + "/embed", {"texts": ["x" * 200_000]})
        code_after, after = post(base + "/similarity", {"texts_a": [SHORT], "texts_b": [SHORT]})
    print(f"  serve.cli --tp {TP} --batcher-slots {TP_CLI_SLOTS} (fp32, {TP_CLI_LAYERS} layers): "
          f"{sum(same)} of {len(same)} concurrent greedy answers equal the single-process CLI's; "
          f"/embed norms {np.linalg.norm(emb, axis=-1).round(6).tolist()}, max |tp - single| "
          f"{np.abs(emb - want_emb).max():.2e}; /stats route {stats.get('route')}; a 200 KB /embed "
          f"{code_big} ({big.get('error', '')[:60]}), then /similarity {code_after}")
    check(all(same), "tp CLI greedy answers differ from the single-process CLI's")
    check(code == 200 and np.allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-4)
          and np.abs(emb - want_emb).max() <= 1e-4, "tp CLI /embed")
    check(code_stats == 200 and stats["route"]["tp"] == TP, f"tp CLI /stats: {stats}")
    check(code_big == 400 and code_after == 200 and abs(after["similarity"][0][0] - 1) < 1e-4,
          "an oversized request did not fail alone")
    return {k: r0["counts_int8c"][k] for k in ("quantize_rows_given",)}


# ---------------------------------------------------------------------------
# phase 23: multi-process training (dp with the ZeRO AdamW, tp, GPipe pp)
# ---------------------------------------------------------------------------

MP = 2                       # phase 23's ranks
MP_B, MP_T = 8, 512          # the global batch
MP_FULL_LAYERS = 8           # dp `full` over fp32 masters in fp32 (the ZeRO AdamW)
MP_TP_LORA_LAYERS = 12       # tp LoRA in fp32 (24 before the script's time limit needed it)
MP_N_MICRO = 4
MP_CLI_LAYERS = 2            # the CLIs' checkpoint (full width, fp32)
MP_CLI_STEPS = 2
MP_RANK_TIMEOUT_S = 420
MP_LORA_STEPS = 2
MP_TC = dict(lr_init=1e-3, warmup_steps=0, total_steps=8, lr_schedule="constant")
MP_KERNELS = ("layer_norm", "tmix_prologue", "wkv6_fused_output", "tmix_prologue_bwd",
              "wkv6_bwd_forward_pass", "wkv6_bwd_reverse_pass")
# dp `full` in fp32: the ranks' gradients against the single-process kernel
# route's sum over the same halves of the rows (each half's loss over the
# global counts: the ranks' decomposition in one process) differ by the order
# of the sums only, x max of each tensor. Against the whole batch's they
# differ by more: GEMMs of another M round apart, and seeded layers amplify
# that (3.2e-4 x max on time_faaaa at 8 layers, 3 x the fp32 plain route's
# distance, read on an H100); the script prints both
MP_FULL_REL = 1e-5
# tp and pp in fp32 on the whole batch (tp LoRA at MP_TP_LORA_LAYERS; tp `full` and
# pp at MP_FULL_LAYERS, beside dp `full` on the one single-process
# reference): each gradient tensor within this 1 - cosine of the
# single-process fp32 kernel route's. Seeded layers amplify rounding in
# another order: on all 8 rows tp LoRA read 8.572e-05 at 24 layers, but tp
# `full` 3.8e-2 at 24 layers (blocks.0's time_faaaa, where the plain route
# sat ~2e-2 away: the bonus's gradient cancels; on the first 4 rows tp
# `full` 9.310e-05, pp 2.367e-05; read on an H100). A lost partial sum, a tp
# rank's missing share or a stage's missing gradient moves a tensor by 1e-1
# or more, and a scale error fails MP_NORM. The CPU tests hold the same
# paths at 1e-4 of max against JAX on a well-conditioned model. In bf16 the seeded 24-layer model's LoRA gradients are too noisy to
# hold tp to: the single-process bf16 route sits 0.34 from fp32 on blocks.1's
# att.key factor, tp's 1.07 (read on an H100)
MP_FP32_COS = 1e-2
# `train.cli sft --dp 2` against the single-process CLI, fp32 LoRA at 4
# layers: the logged losses within 1e-5 and each adapter tensor's update
# (trained - init) within this 1 - cosine. Not elementwise: the card's fp32
# gradients of seeded full-width layers part by ~3e-4 x max between the two
# row splits (dp full above), which flips Adam's sign step on the elements
# whose gradient is that close to zero (a flip moves one by 2 lr: 34 x the
# elementwise bound, read on an H100). The CPU test holds the
# files elementwise on a well-conditioned model (tests/test_torch_dp.py)
MP_CLI_COS = 1e-2
# cosine ignores scale: the whole gradient's norm within this share of the
# reference's too (| |g| / |ref| - 1 |), and each tensor's within the noise
# its cosine shows (rounding noise of |d| / |g| = r leaves 1 - cosine ~ r^2 /
# 2: twice sqrt(2 (1 - cos)), floor this; tp LoRA's noisiest tensor read a
# norm gap of 7.8e-3 at 1 - cos below 6e-5, read on an H100), so that a gradient
# summed twice, a lost rank's share or a wrong global count (x 2 or x 1/2)
# fails. bf16
# against fp32 (dp LoRA): each tensor within the rounding noise its cosine
# bound admits, the whole gradient's norm within C24_BOUND x the
# single-process bf16 route's gap from fp32 (floor MP_NORM) and within
# MP_BF16_NORM of that route's. The CLIs' logged grad_norm within
# MP_CLI_NORM of the single-process run's (Adam's update hides a gradient's
# scale)
MP_NORM = 1e-2
MP_CLI_NORM = 1e-3
# the bf16 routes' whole gradient sits ~46 % from fp32's in norm (seeded
# LoRA factors: rounding noise inflates it), the dp ranks' 3.1 % from the
# single-process bf16 route's (read on an H100): held within this
MP_BF16_NORM = 0.1
# bf16 (dp LoRA; the module docstring): each tensor's gradient no farther
# from the single-process fp32 route, as 1 - cosine, than C24_BOUND times the
# single-process bf16 route is (floor 1e-3). Not C.24's capped form between
# two bf16 routes: a rank's bf16 rounding is not the single-process route's,
# so their mutual distance is about the sum of their distances from fp32,
# and the single-process bf16 route sits 0.15-0.31 from fp32 on LoRA factors
# of layers 3 and 18 (read on an H100), far beyond C24_CAP


def mp_batch(vocab: int) -> dict:
    """The global batch, the same on every rank: the first half of the rows
    (dp rank 0's) with fewer unmasked labels than the second."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    batch = train_batch(gen, vocab, MP_B, MP_T)
    batch["labels"][: MP_B // 2, : MP_T // 3] = -100
    return batch


def mp_model(sd: dict, cfg, train_type: str):
    """A model of cfg on sd with train_type's trainables (LoRA seeded, its B
    filled so that every gradient is non-zero)."""
    model = load_state_dict_into(RWKV(cfg, device=DEV), sd)
    if train_type == "lora":
        gen = torch.Generator(device=DEV).manual_seed(24)
        adapter = init_lora_params(model, LORA, gen)
        for ab in adapter.values():
            ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=DEV) * 0.02
        apply_lora(model, LORA, adapter)
    apply_trainable_mask(model, trainable_mask(model, train_type))
    return model


def first_grads(step) -> dict:
    """Have `step` keep its first call's gradients, as the optimizer sees
    them (the ZeRO optimizer's after its collectives; a tp slice as it
    is), in the dict returned."""
    opt = step.optimizer
    seen = {}
    if hasattr(opt, "reduce"):
        reduce = opt.reduce

        def keep():
            reduce()
            if not seen:
                seen.update({n: g.detach().clone() for n, g in opt.named_grads().items()})

        opt.reduce = keep
    else:
        inner = opt.step

        def keep(keep=None):
            if not seen:
                seen.update({n: p.grad.detach().clone() for n, p in zip(opt.names, opt.params)})
            return inner(keep)

        opt.step = keep
    return seen


def free() -> None:
    """Give the card back what dropped objects held: first_grads' closures
    make reference cycles through the optimizer (its flat buffers), which
    only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def whole_grads_on_rank0(grads: dict, model, mesh, main: bool):
    """The tp ranks' gradient slices joined on rank 0 (the other ranks of
    dp index 0 send theirs in name order); None elsewhere."""
    if mesh.dp_rank != 0:       # another dp replica of the same gradients
        return None
    named = dict(model.named_parameters())
    cut = sorted(n for n in grads if getattr(named[n], "tp_axis", None) is not None)
    if not main:
        sends = [distributed.isend(grads[n], 0) for n in cut]
        for work in sends:
            work.wait()
        return None
    for n in cut:
        parts = [grads[n]] + [distributed.recv(torch.empty_like(grads[n]), r)
                              for r in range(1, mesh.tp)]
        grads[n] = torch.cat(parts, named[n].tp_axis)
    return grads


def mp_timed_step(step, batch) -> dict:
    """One step's loss, norm, wall ms, this rank's busy ms (traced) and the
    collectives it issued."""
    calls, nbytes = distributed.STATS["calls"], distributed.STATS["bytes"]
    out = {}

    def timed():
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        out.update(loss=float(m["loss"]), norm=float(m["grad_norm"]))
        return m, time.perf_counter() - t0

    out["busy_ms"], wall = rank_busy_ms(timed)
    out.update(wall_ms=wall * 1e3, calls=distributed.STATS["calls"] - calls,
               mbytes=(distributed.STATS["bytes"] - nbytes) / 2**20)
    return out


def mp_rank(rank: int, rendezvous: str, out_dir: str, world: int = MP) -> None:
    """One rank of phase 23, a process of its own (``python3 -c "import
    chip_smoke; chip_smoke.mp_rank(...)"``): gloo where the ranks share the
    card, NCCL where each has one. Every check raises; the results go to
    out_dir/mp-<rank>.json."""
    global DEV
    init_distributed(rendezvous, world, rank, platform="cuda", timeout=MP_RANK_TIMEOUT_S)
    try:
        DEV = str(rank_device("cuda"))
        torch.cuda.set_device(DEV)
        res = _mp_rank_checks(rank, world)
    finally:
        shutdown()
    Path(out_dir, f"mp-{rank}.json").write_text(json.dumps(res))


def norm_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """| |a| / |b| - 1 |: what a cosine does not see (MP_NORM)."""
    na, nb = a.double().norm().item(), b.double().norm().item()
    return abs(na / nb - 1) if nb > 0 else (0.0 if na == 0 else math.inf)


def _mp_rank_checks(rank: int, world: int) -> dict:
    res = {"seconds": {}, "backend": distributed.backend()}
    start = time.perf_counter()
    main = rank == 0

    def lap(name):
        res["seconds"][name] = round(time.perf_counter() - start - sum(res["seconds"].values()), 1)
        print(f"  rank {rank} seconds by part: {res['seconds']}", flush=True)

    cfg16, cfg32 = rwkv6_1b6(), rwkv6_1b6(dtype="float32")
    # the weights wait in host memory: two ranks' models, flat buffers and
    # rank 0's references share the card
    sd = {k: v.cpu() for k, v in synthetic_1b6(cfg32, seed=0).items()}
    batch = mp_batch(cfg32.vocab_size)
    tc = TrainConfig(grad_checkpoint=True, **MP_TC)
    lora_loss = functools.partial(sft_loss_fn, remat=True)
    # JAX's pipeline loss has no L2Wrap: dp and tp `full` train the same
    # cross entropy, so that one single-process reference serves all three
    ce_loss = functools.partial(sft_loss_fn, remat=True, l2_wrap=False)
    refs = {}

    def reference(key, cfg, train_type, loss_fn, moments=False, weights=None, split=False):
        """The single-process kernel route's gradients and loss on the whole
        batch (rank 0); with `moments`, one step of the single-process
        optimizer, whose Adam moment bytes are read; with `split`, the sum
        over the dp ranks' halves of the rows."""
        if key not in refs:
            model = mp_model(sd if weights is None else weights, cfg, train_type)
            if moments:
                step = make_train_step(model, tc, loss_fn)
                grads = first_grads(step)
                loss = float(step(batch)["loss"])
                nbytes = sum(t.numel() * t.element_size()
                             for st in step.optimizer.opt.state.values()
                             for k, t in st.items() if k.startswith("exp_avg"))
                del step
            elif split:
                # the dp ranks' decomposition in one process: each half's loss
                # over the global batch's counts, the gradients summed
                loss, nbytes = 0.0, None
                counts = GlobalBatch(MP_B, {"labels": (batch["labels"] != -100).sum().reshape(1)})
                for half in range(MP):
                    rows = {k: v.chunk(MP)[half] for k, v in batch.items()}
                    value = loss_fn(model, rows, counts=counts)
                    value.backward()
                    loss += value.item()
            else:
                value = loss_fn(model, batch)
                value.backward()
                loss, nbytes = value.item(), None
            if not moments:
                grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
            refs[key] = {"grads": grads, "losses": [loss], "moment_bytes": nbytes}
            del model
            torch.cuda.empty_cache()
        return refs[key]

    def against(what, got, key16, key32):
        """This route's bf16 gradients no farther from the single-process fp32
        route than the single-process bf16 route is: 1 - cosine per tensor
        within C24_BOUND times its (floor 1e-3; the comment above
        MP_FULL_REL), each tensor's norm gap within the rounding noise that
        cosine bound admits (a noise of |d| / |g| = r leaves 1 - cosine ~
        r^2 / 2, so r = sqrt(2 x the bound)), and the norm of the whole
        gradient within C24_BOUND times the bf16 route's gap (floor MP_NORM)
        and within MP_BF16_NORM of that route's: a scale error moves every
        tensor alike."""
        p16, p32 = refs[key16]["grads"], refs[key32]["grads"]
        gap = {n: (1 - cosine(got[n], p32[n]), max(1e-3, C24_BOUND * (1 - cosine(p16[n], p32[n]))),
                   1 - cosine(got[n], p16[n])) for n in p32}
        size = {n: (norm_gap(got[n], p32[n]), math.sqrt(2 * gap[n][1])) for n in p32}

        def total(grads):
            return torch.stack([g.double().norm() for g in grads.values()]).norm()

        whole = (norm_gap(total(got), total(p32)),
                 max(MP_NORM, C24_BOUND * norm_gap(total(p16), total(p32))),
                 norm_gap(total(got), total(p16)))
        worst = max(gap, key=lambda n: gap[n][0] / gap[n][1])
        far = max(gap, key=lambda n: gap[n][2])
        big = max(size, key=lambda n: size[n][0] / size[n][1])
        print(f"  {what}, {len(gap)} gradient tensors: 1 - cosine to the single-process fp32 route "
              f"{gap[worst][0]:.3e} against C24_BOUND x the single-process bf16 route's "
              f"{gap[worst][1]:.3e} ({worst}, the largest ratio; limit 1); a tensor's norm gap "
              f"{size[big][0]:.3e} against {size[big][1]:.3e} ({big}, the largest ratio); the "
              f"whole gradient's norm gap {whole[0]:.3e} against {whole[1]:.3e}, from the "
              f"single-process bf16 route's {whole[2]:.3e} (limit {MP_BF16_NORM:g}); farthest from the "
              f"single-process bf16 route: {far} {gap[far][2]:.3e} (its own distance from fp32 "
              f"{gap[far][1] / C24_BOUND:.3e})", flush=True)
        check(all(a <= b for a, b, _ in gap.values()),
              f"{what}: the gradients depart from the fp32 route by more than C24_BOUND x the "
              f"single-process bf16 route ({worst}: {gap[worst]})")
        check(all(a <= b for a, b in size.values()) and whole[0] <= whole[1]
              and whole[2] <= MP_BF16_NORM,
              f"{what}: a gradient's norm departs from the fp32 route's ({big}: {size[big]}; the "
              f"whole gradient's {whole})")

    def close32(what, got, key, loss):
        """fp32 gradients against the single-process fp32 kernel route's
        (``key``), as hold_fp32_grads holds them."""
        hold_fp32_grads(what, got, refs[key]["grads"], loss, refs[key]["losses"][0])

    if world == MP * MP:
        res.update(_mp_dp_tp(rank, sd, cfg32, batch, tc, lora_loss))
        if main:
            reference("lora32", cfg32, "lora", lora_loss)
            close32(f"dp={MP} x tp={MP} lora, 24 layers, fp32", res.pop("grads"), "lora32",
                    res["losses"][0])
        res.pop("grads", None)
        lap("dp x tp")
        return res

    # dp=2 lora, 24 layers, bf16: two steps on the rank's half of the rows
    mesh = make_mesh(dp=MP, tp=1)
    model = mp_model(sd, cfg16, "lora")
    step = make_train_step(model, tc, lora_loss, mesh=mesh)
    grads = first_grads(step)
    rows = {k: v.chunk(MP)[mesh.dp_rank] for k, v in batch.items()}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = [mp_timed_step(step, rows) for _ in range(MP_LORA_STEPS)]
    res["dp_lora"] = {"steps": steps, "launches": launch_counts(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "moment_bytes": step.optimizer.moment_elements() * 4,
                      "flat_bytes": 2 * step.optimizer.flat.numel() * 4}
    check(all(res["dp_lora"]["launches"][k] > 0 for k in MP_KERNELS),
          f"rank {rank}: a kernel of the dp path ran no time: {res['dp_lora']['launches']}")
    del model, step
    free()
    if main:
        reference("lora16", cfg16, "lora", lora_loss)
        reference("lora32", cfg32, "lora", lora_loss)
        against(f"dp={MP} lora, 24 layers, bf16, B={MP_B}, T={MP_T}", grads, "lora16", "lora32")
        res["dp_lora"]["single_loss"] = refs.pop("lora16")["losses"][0]
        check(abs(steps[0]["loss"] - res["dp_lora"]["single_loss"])
              <= 1e-3 * res["dp_lora"]["single_loss"],
              f"dp lora loss {steps[0]['loss']} != single-process {res['dp_lora']['single_loss']}")
    lap("dp lora")

    # dp=2 full, 8 layers, the fp32 route, the ZeRO AdamW
    cut = rwkv6_1b6(n_layer=MP_FULL_LAYERS, dtype="float32", param_dtype="float32")
    sd8 = {k: v for k, v in sd.items()
           if not k.startswith("blocks.") or int(k.split(".")[1]) < MP_FULL_LAYERS}
    model = mp_model(sd8, cut, "full")
    step = make_train_step(model, tc, ce_loss, mesh=mesh)
    grads = first_grads(step)
    torch.cuda.reset_peak_memory_stats()
    res["dp_full"] = {"steps": [mp_timed_step(step, rows)],
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "moment_bytes": step.optimizer.moment_elements() * 4,
                      "flat_bytes": 2 * step.optimizer.flat.numel() * 4}
    del model, step
    free()
    if main:
        ref = reference("full8", cut, "full", ce_loss, moments=True, weights=sd8)
        halves = reference("full8_halves", cut, "full", ce_loss, weights=sd8, split=True)

        def rel(a, b):
            return max(float((a[n] - b[n]).abs().max() / b[n].abs().max()) for n in b)

        res["dp_full"].update(err=rel(grads, halves["grads"]), whole=rel(grads, ref["grads"]),
                              halves_whole=rel(halves["grads"], ref["grads"]),
                              single_moment_bytes=ref["moment_bytes"])
        check(res["dp_full"]["err"] <= MP_FULL_REL,
              f"dp full fp32 gradients {res['dp_full']['err']:.3e} x max from the single-process "
              f"sum over the same halves")
        # and against the whole batch, as tp and pp are held
        close32(f"dp={MP} full, {MP_FULL_LAYERS} layers, fp32, B={MP_B}, against the whole batch",
                grads, "full8", res["dp_full"]["steps"][0]["loss"])
        refs.pop("full8_halves")
    del grads
    lap("dp full")

    # tp=2: lora at MP_TP_LORA_LAYERS, full at MP_FULL_LAYERS, fp32, the whole batch
    refs.pop("lora32", None)
    mesh = make_mesh(dp=1, tp=MP)
    cut12 = rwkv6_1b6(n_layer=MP_TP_LORA_LAYERS, dtype="float32")
    sd12 = {k: v for k, v in sd.items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < MP_TP_LORA_LAYERS}
    for kind, loss_fn, cfg, weights, key in (("lora", lora_loss, cut12, sd12, "lora12"),
                                             ("full", ce_loss, cut, sd8, "full8")):
        model = mp_model(weights, cfg, kind)
        shard_for_training(model, mesh)
        step = make_train_step(model, tc, loss_fn, mesh=mesh)
        grads = first_grads(step)
        reset_launch_counts()
        res[f"tp_{kind}"] = {"steps": [mp_timed_step(step, batch)], "launches": launch_counts()}
        check(all(res[f"tp_{kind}"]["launches"][k] > 0 for k in MP_KERNELS),
              f"rank {rank}: a kernel of the tp path ran no time")
        grads = whole_grads_on_rank0(grads, model, mesh, main)
        del model, step
        free()
        if main:
            reference(key, cfg, kind, loss_fn, weights=weights)
            close32(f"tp={MP} {kind}, {cfg.n_layer} layers, fp32, B={MP_B}", grads, key,
                    res[f"tp_{kind}"]["steps"][0]["loss"])
        del grads
        refs.pop("lora12", None)
        free()
        lap(f"tp {kind}")

    # pp=2, n_micro=4, full, MP_FULL_LAYERS, fp32: the stages' gradients and the loss
    pmesh = make_pp_mesh(dp=1, pp=MP)
    model = mp_model(sd8, cut, "full")
    step = make_pp_train_step(model, tc, pmesh, n_micro=MP_N_MICRO)
    grads = first_grads(step)
    reset_launch_counts()
    res["pp"] = {"steps": [mp_timed_step(step, batch)], "launches": launch_counts(),
                 "stage": pmesh.stage}
    check(all(res["pp"]["launches"][k] > 0 for k in MP_KERNELS),
          f"rank {rank}: a kernel of the pp path ran no time")
    del model, step
    free()
    # the other stage's gradients to rank 0, tensor by tensor in name order
    if not main:
        sends = [distributed.isend(grads[n], 0) for n in sorted(grads)]
        for work in sends:
            work.wait()
    if main:
        got = dict(grads)
        want = refs["full8"]["grads"]
        for n in sorted(set(want) - set(grads)):
            got[n] = distributed.recv(torch.empty_like(want[n]), 1)
        close32(f"pp={MP}, n_micro={MP_N_MICRO}, full, {MP_FULL_LAYERS} layers, fp32, B={MP_B}",
                got, "full8", res["pp"]["steps"][0]["loss"])
        res["pp"]["single_loss"] = refs["full8"]["losses"][0]
    lap("pp")
    return res


def _mp_dp_tp(rank, sd, cfg, batch, tc, loss_fn) -> dict:
    """dp=2 x tp=2 lora (the four-card run): two steps, the first step's
    whole gradients and the readings."""
    mesh = make_hybrid_mesh(dp=MP, tp=MP)
    model = mp_model(sd, cfg, "lora")
    shard_for_training(model, mesh)
    step = make_train_step(model, tc, loss_fn, mesh=mesh)
    grads = first_grads(step)
    rows = {k: v.chunk(MP)[mesh.dp_rank] for k, v in batch.items()}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = [mp_timed_step(step, rows) for _ in range(MP_LORA_STEPS)]
    grads = whole_grads_on_rank0(grads, model, mesh, rank == 0)
    out = {"steps": steps, "launches": launch_counts(), "losses": [s["loss"] for s in steps],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "moment_bytes": step.optimizer.moment_elements() * 4, "grads": grads}
    check(all(out["launches"][k] > 0 for k in MP_KERNELS), f"rank {rank}: a kernel ran no time")
    return out


def mp_readings(label: str, rr: list) -> str:
    return "; ".join(
        f"rank {r}: step wall {', '.join(f'{s['wall_ms']:.0f}' for s in x['steps'])} ms, busy "
        f"{', '.join(f'{s['busy_ms']:.0f}' for s in x['steps'])} ms, "
        f"{x['steps'][0]['calls']} collectives ({x['steps'][0]['mbytes']:.0f} MiB) a step"
        + (f", peak {x['peak_gib']:.1f} GiB" if "peak_gib" in x else "")
        + (f", Adam moments {x['moment_bytes'] / 2**20:.1f} MiB" if "moment_bytes" in x else "")
        for r, x in enumerate(rr))


def mp_rank_command(r: int, rendezvous: str, d: Path, world: int) -> list:
    return [sys.executable, "-c", f"import chip_smoke; chip_smoke.mp_rank({r}, {rendezvous!r}, "
                                  f"{str(d)!r}, {world})"]


def run_mp_ranks(d: Path, world: int, during=None) -> list:
    """Start `world` ranks of phase 23, run `during(ranks)` in this process
    while they work, and return its result and theirs; a rank that fails
    stops the others."""
    rendezvous = "file://" + str(d / "rendezvous")
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    ranks = [subprocess.Popen(mp_rank_command(r, rendezvous, d, world), cwd=ROOT,
                              stdout=logs[r], stderr=subprocess.STDOUT, start_new_session=True)
             for r in range(world)]
    try:
        out = during(ranks) if during is not None else None
        deadline = time.monotonic() + MP_RANK_TIMEOUT_S
        while any(p.poll() is None for p in ranks):
            failed = [p for p in ranks if p.poll() not in (None, 0)]
            check(not failed and time.monotonic() < deadline, f"a phase 23 rank failed or overran "
                  f"(exit codes {[p.poll() for p in ranks]})")
            time.sleep(0.5)
    except BaseException:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for r in range(world):
            print(f"  rank {r} log: {(d / f'rank{r}.log').read_text()[-3000:]}")
        raise
    finally:
        for f in logs:
            f.close()
    for r, proc in enumerate(ranks):
        check(proc.returncode == 0, f"phase 23 rank {r} exited {proc.returncode} (ranks: "
              f"{[p.returncode for p in ranks]}):\n"
              f"{(d / f'rank{r}.log').read_text()[-4000:]}")
    return out, [json.loads((d / f"mp-{r}.json").read_text()) for r in range(world)]


def mp_cli_files(d: Path) -> list:
    """A MP_CLI_LAYERS-layer full-width fp32 checkpoint and SFT rows; the
    arguments of the CLI runs but the output directory."""
    cut = rwkv6_1b6(n_layer=MP_CLI_LAYERS, dtype="float32")
    model = load_state_dict_into(RWKV(cut, device=DEV), synthetic_1b6(cut, seed=7))
    save_rwkv_checkpoint(model, str(d / "cut.pth"))
    del model
    data = d / "sft.jsonl"
    sft_jsonl(data, WorldTokenizer())
    return ["--model", str(d / "cut.pth"), "--train-data", str(data), "--micro-bsz", "64",
            "--ctx-len", str(T), "--lr-init", "1e-3", "--lr-schedule", "constant",
            "--warmup-steps", "0", "--log-every", "1", "--dtype", "float32", "--train-type",
            "lora", "--lora-r", "8", "--lora-alpha", "32", "--max-steps", str(MP_CLI_STEPS),
            "--platform", "cuda"]


def start_train_cli(args: list, out: Path, log: Path, command: str = "sft") -> subprocess.Popen:
    """`python -m rwkv_lm_ext_tpu_torch.train.cli <command> <args>` into
    `out`, its output to `log`, in a session of its own (its ranks with it)."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", command,
                                 *args, "--output-dir", str(out)], cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT, start_new_session=True)


def train_cli_here(args: list, out: Path, no_l2wrap: bool = False, command: str = "sft") -> str:
    """The single-process `train.cli <command> <args>` in this process (what
    it printed); `no_l2wrap`: the loss without L2Wrap, as JAX's pipeline
    has."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.ExitStack() as stack:
        if no_l2wrap:
            stack.enter_context(mock.patch.object(
                train_loop, "sft_loss_fn", functools.partial(sft_loss_fn, l2_wrap=False)))
        train_cli.main([command, *args, "--output-dir", str(out), "--dp", "1"])
    return buf.getvalue()


def wait_train_clis(procs: list) -> None:
    """Wait for the CLI runs (MP_RANK_TIMEOUT_S in all); kill what is left."""
    deadline = time.monotonic() + MP_RANK_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def logged_steps(text: str) -> list:
    return [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines() if ln.startswith("step ")]


def cli_against_single(what: str, log: str, want_log: str, got_pth: Path, want_pth: Path,
                       init: dict, noise=(), later_rtol: float = 1e-5) -> None:
    """A multi-process CLI run against the single-process one: rank 0 alone
    logs, the logged losses within 1e-5 (after the first step within
    `later_rtol`) and grad norms within MP_CLI_NORM,
    and each tensor of the file moved as the single-process run's did (the
    updates from `init` within 1 - cosine MP_CLI_COS; MP_CLI_COS says why
    not elementwise), but the tensors of `noise`, whose gradient is zero
    but for rounding (Adam's first steps move them by lr whatever the
    noise's direction), which are only printed."""
    got_s, want_s = logged_steps(log), logged_steps(want_log)
    check(log.count("step 0:") == 1 and len(got_s) == len(want_s) == MP_CLI_STEPS
          and all(abs(a["loss"] - b["loss"]) <= (1e-5 if i == 0 else later_rtol) * abs(b["loss"])
                  and abs(a["grad_norm"] - b["grad_norm"]) <= MP_CLI_NORM * b["grad_norm"]
                  for i, (a, b) in enumerate(zip(got_s, want_s))),
          f"{what}: logged {got_s} against the single-process CLI's {want_s}:\n{log[-2000:]}")
    got = torch.load(got_pth, map_location=DEV, weights_only=True)
    want = torch.load(want_pth, map_location=DEV, weights_only=True)
    check(sorted(got) == sorted(want), f"{what}: the file's keys differ")
    init = {k: init[k].to(DEV).reshape(want[k].shape) for k in want}
    # a tensor that neither run moved (the untied head under the MLM loss,
    # without weight decay) has no direction to compare: it must stay put
    gap = {k: 1 - cosine(got[k] - init[k], want[k] - init[k])
           if (want[k] != init[k]).any() or (got[k] != init[k]).any() else 0.0 for k in want}
    noisy = {k: gap.pop(k) for k in noise}
    rel = {k: (got[k] - want[k]).abs().max().item() / want[k].abs().max().item() for k in want}
    worst, far = max(gap, key=gap.get), max(rel, key=rel.get)
    print(f"  {what}: both ranks exited 0; losses {[s['loss'] for s in got_s]} against "
          f"{[s['loss'] for s in want_s]}, grad norms {[s['grad_norm'] for s in got_s]} against "
          f"{[s['grad_norm'] for s in want_s]}; {got_pth.name}'s updates against the "
          f"single-process CLI's: 1 - cosine at most {gap[worst]:.2e} ({worst}; limit "
          f"{MP_CLI_COS:g}), max |a - b| / max|b| {rel[far]:.2e} ({far})"
          + (f"; rounding-noise tensors, not held: {noisy}" if noisy else ""))
    check(gap[worst] <= MP_CLI_COS, f"{what}: the updates part from the single-process CLI's: "
          f"{worst} {gap[worst]:.2e}")


def phase_multiprocess(tmp: Path, smi: str) -> None:
    """Phase 23 (the module docstring): the ranks (mp_rank) and, once they
    are past their dp parts, `train.cli sft` with --dp 2 and --tp 2 (LoRA)
    and --pp 2 (`full`) together, beside the single-process CLI runs made in
    this process meanwhile."""
    d = tmp / "mp"
    d.mkdir()
    cli = {}

    def during(ranks):
        """The CLIs, once the ranks are past their dp parts: beside those
        (rank 0's references at B=8) the five processes outgrew the card's
        memory."""
        args = mp_cli_files(d)      # while the ranks start
        torch.cuda.empty_cache()
        cli["args"] = args
        while "'dp full'" not in (d / "rank0.log").read_text():
            check(all(p.poll() in (None, 0) for p in ranks), "a phase 23 rank failed")
            time.sleep(1)
        t0 = time.perf_counter()
        full = [*args, "--train-type", "full"]      # the last --train-type wins
        procs = {"dp": start_train_cli([*args, "--dp", str(MP)], d / "dp", d / "dp.log"),
                 "tp": start_train_cli([*args, "--tp", str(MP)], d / "tp", d / "tp.log"),
                 "pp": start_train_cli([*full, "--pp", str(MP), "--n-micro", str(MP_N_MICRO)],
                                       d / "pp", d / "pp.log")}
        try:
            cli["single"] = train_cli_here(args, d / "single")
            torch.cuda.empty_cache()
            cli["single_full"] = train_cli_here(full, d / "single_full", no_l2wrap=True)
            torch.cuda.empty_cache()
        finally:
            wait_train_clis(list(procs.values()))
        cli.update((mode, proc.returncode) for mode, proc in procs.items())
        return time.perf_counter() - t0

    cli_wall, res = run_mp_ranks(d, MP, during)
    for mode in ("dp", "tp", "pp"):
        check(cli[mode] == 0, f"train.cli sft --{mode} {MP} exited {cli[mode]}:\n"
              f"{(d / f'{mode}.log').read_text()[-3000:]}")
    r0 = res[0]
    # rank 0's gradient checks, as it printed them
    print("\n".join(ln for ln in (d / "rank0.log").read_text().splitlines()
                    if ln.startswith("  ")))
    print(f"  backend {r0['backend']} ({'ranks share the card: each rank time-shares it, so '
                                          'these are not dp speeds' if r0['backend'] == 'gloo'
                                          else 'a card a rank'})")
    print(f"  dp={MP} lora, 24 layers, bf16, B={MP_B} (rows {MP_B // MP} a rank, token counts "
          f"apart), T={MP_T}: losses {[round(s['loss'], 5) for s in r0['dp_lora']['steps']]} "
          f"(single-process {r0['dp_lora']['single_loss']:.5f}); launches a rank over "
          f"{MP_LORA_STEPS} steps { {k: r0['dp_lora']['launches'][k] for k in MP_KERNELS} }")
    print(f"  reading dp lora, {smi}: {mp_readings('dp lora', [r['dp_lora'] for r in res])}")
    f = r0["dp_full"]
    print(f"  dp={MP} full, {MP_FULL_LAYERS} layers, fp32, ZeRO AdamW: gradients {f['err']:.3e} x "
          f"max from the single-process kernel route's sum over the same halves of the rows "
          f"(limit {MP_FULL_REL:g}); from its whole-batch gradients {f['whole']:.3e} (the halves' "
          f"sum itself {f['halves_whole']:.3e}: seeded layers amplify the GEMMs' other M); Adam "
          f"moments a rank "
          f"{[round(r['dp_full']['moment_bytes'] / 2**30, 3) for r in res]} GiB against "
          f"{f['single_moment_bytes'] / 2**30:.3f} GiB single-process")
    check(all(r["dp_full"]["moment_bytes"] <= -(-r0["dp_full"]["single_moment_bytes"] // MP)
              for r in res), "a dp rank holds more than its share of the Adam moments")
    print(f"  reading dp full, {smi}: {mp_readings('dp full', [r['dp_full'] for r in res])}")
    for kind in ("lora", "full"):
        print(f"  reading tp {kind}, {smi}: {mp_readings('tp', [r[f'tp_{kind}'] for r in res])}")
    print(f"  pp={MP}, n_micro={MP_N_MICRO}: stage losses "
          f"{[round(r['pp']['steps'][0]['loss'], 5) for r in res]} (single-process, no L2Wrap, "
          f"{r0['pp']['single_loss']:.5f}); launches a stage "
          f"{[{k: r['pp']['launches'][k] for k in MP_KERNELS} for r in res]}")
    print(f"  reading pp, {smi}: {mp_readings('pp', [r['pp'] for r in res])}")
    print(f"  each rank's seconds by part: {[r['seconds'] for r in res]}")

    # the CLIs against the single-process CLI runs (their init: the LoRA
    # adapter of --seed 0, the checkpoint's weights)
    print(f"  python -m rwkv_lm_ext_tpu_torch.train.cli sft --dtype float32, {MP_CLI_LAYERS} layers "
          f"at full width, {MP_CLI_STEPS} steps: --dp {MP} and --tp {MP} (lora) and --pp {MP} "
          f"--n-micro {MP_N_MICRO} (full) together, beside the single-process runs in this "
          f"process, {cli_wall:.1f} s in all (beside the ranks' tp and pp parts)")
    model, _ = load_rwkv_checkpoint(str(d / "cut.pth"), device=DEV, dtype="float32")
    init = lora_state_dict(apply_lora(model, LoraConfig(r=8, alpha=32.0), init_lora_params(
        model, LoraConfig(r=8, alpha=32.0), torch.Generator(device=DEV).manual_seed(0))))
    del model
    lora_pth = f"lora-step{MP_CLI_STEPS}.pth"
    for mode in ("dp", "tp"):
        cli_against_single(f"--{mode} {MP} (lora)", (d / f"{mode}.log").read_text(), cli["single"],
                           d / mode / lora_pth, d / "single" / lora_pth, init)
    del init
    init = torch.load(d / "cut.pth", map_location=DEV, weights_only=True)
    full_pth = f"model-step{MP_CLI_STEPS}.pth"
    cli_against_single(f"--pp {MP} --n-micro {MP_N_MICRO} (full, against the single-process run "
                       f"without L2Wrap)", (d / "pp.log").read_text(), cli["single_full"],
                       d / "pp" / full_pth, d / "single_full" / full_pth, init)
    del init
    torch.cuda.empty_cache()


def dp_tp_run() -> None:
    """dp=2 x tp=2 LoRA on four ranks (phase 23's checks, the module
    docstring): ``python3 -c "import chip_smoke; chip_smoke.dp_tp_run()"`` on
    a host of four cards (NCCL), or of fewer (gloo, ranks sharing card 0)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print("\n".join(smi))
    _lib.library()
    with tempfile.TemporaryDirectory() as tmp:
        _, res = run_mp_ranks(Path(tmp), MP * MP)
        print("\n".join(ln for ln in (Path(tmp) / "rank0.log").read_text().splitlines()
                        if ln.startswith("  ")))
    r0 = res[0]
    print(f"  dp={MP} x tp={MP} lora, 24 layers, fp32, B={MP_B}, T={MP_T}, backend "
          f"{r0['backend']}: losses {[round(x, 5) for x in r0['losses']]}; launches a rank "
          f"{[{k: r['launches'][k] for k in MP_KERNELS} for r in res]}")
    print(f"  reading dp x tp lora, {smi[0]}: {mp_readings('dp x tp', res)}")
    print(f"  each rank's seconds: {[r['seconds'] for r in res]}")


# ---------------------------------------------------------------------------
# phase 24: sequence parallelism and the other trainers under --dp
# ---------------------------------------------------------------------------

SP = 2                       # phase 24's ranks
SP_T = 8192                  # the sequence, SP_T // SP tokens a rank
SP_LAYERS = 24               # the forward's depth (fp32 and bf16)
SP_GRAD_LAYERS = 8           # the backward's (fp32)
SP_RANK_TIMEOUT_S = 300
SP_KERNELS = ("layer_norm", "wkv", "wkv_bwd_state_pass", "wkv6_bwd_reverse_pass")
# the sp WKV against one B.8 call over the whole T (bf16 inputs, both fp32
# out): two B.8 runs in another order, each within its own limit (1e-4 x
# max|plain|, phase 2) of the exact result
SP_WKV_REL = 2e-4
# B.8 against the plain tiled decomposition (ops/wkv_chunked.py): B.8's own limit
SP_TILED_REL = 1e-4
SP_BF16_MEAN_COS = 0.999
# wkv4_parallel against B.14 (both fp32): the tree's summation order
SP_WKV4_REL = 1e-4
SP_CLI_RUNS = [            # (command, data, extra flags, the file both runs write)
    ("bi-encoder", "triplet", ["--loss", "infonce"], "bi-encoder-step2.pth"),
    ("encoder-crossencoder", "documents", ["--group-size", "4"], "encoder-cross-step2.pth"),
    ("mlm", "text", [], "encoder-step2.pth"),
]
# ln_out.bias shifts every row's sentence embedding alike, and the group
# softmax's score gradients sum to zero over each group's rows: its gradient
# is zero but for rounding, which Adam's first steps turn into moves of lr
# in no set direction (1 - cosine 0.145 between the two runs on the CPU at
# 2 layers, C=128)
SP_CLI_NOISE = {"encoder-crossencoder": ("ln_out.bias",)}
# the loss after the first step, x its value: both runs start from the same
# parameters, so the first step's loss is held at 1e-5 (a missing gather or
# a global count off by dp shows there); after it, Adam's sign flips on the
# elements whose clipped gradient is near eps (MP_CLI_COS) move the full
# `encoder-crossencoder` model (a first gradient norm of 12,269, clipped to
# 1) enough that its second loss read 1.3e-5 apart on an H100: held as the
# grad norms are
SP_CLI_LATER_RTOL = {"encoder-crossencoder": MP_CLI_NORM}


def sp_rank(rank: int, rendezvous: str, out_dir: str, readings: bool = False) -> None:
    """One rank of phase 24, a process of its own (``python3 -c "import
    chip_smoke; chip_smoke.sp_rank(...)"``): gloo where the ranks share the
    card, NCCL where each has one. Every check raises; the results go to
    out_dir/sp-<rank>.json."""
    global DEV, READINGS
    READINGS = readings
    init_distributed(rendezvous, SP, rank, platform="cuda", timeout=SP_RANK_TIMEOUT_S)
    try:
        DEV = str(rank_device("cuda"))
        torch.cuda.set_device(DEV)
        res = _sp_rank_checks(make_sp_mesh(SP), rank == 0)
    finally:
        shutdown()
    Path(out_dir, f"sp-{rank}.json").write_text(json.dumps(res))


def _sp_rank_checks(mesh, main: bool) -> dict:
    res = {"seconds": {}, "backend": distributed.backend()}
    start = time.perf_counter()

    def lap(name):
        res["seconds"][name] = round(time.perf_counter() - start - sum(res["seconds"].values()), 1)

    n = SP_T // SP
    shard = slice(mesh.rank * n, (mesh.rank + 1) * n)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    # the sp WKV at the 1B6's heads, bf16, against one B.8 call over the whole T
    cfg16, cfg32 = rwkv6_1b6(), rwkv6_1b6(dtype="float32")
    H, N = cfg32.n_head, cfg32.head_size
    rng = Inputs(24)
    r, k, v = (rng.normal(1, SP_T, H, N, scale=0.5) for _ in range(3))
    w = rng.uniform(1, SP_T, H, N, lo=-6.0, hi=0.5, dtype=torch.float32)
    u = rng.normal(H, N, scale=0.5, dtype=torch.float32)
    reset_launch_counts()
    y, s = wkv6_sequence_parallel(r[:, shard], k[:, shard], v[:, shard], w[:, shard], u,
                                  mesh=mesh)
    res["wkv_counts"] = launch_counts()["wkv"]
    y_want, s_want = wkv(r, k, v, w, u)
    res["wkv_err"] = [rel(y, y_want[:, shard]), rel(s, s_want)]
    check(max(res["wkv_err"]) <= SP_WKV_REL and res["wkv_counts"] == 1,
          f"rank {mesh.rank}: the sp WKV (y, state) {res['wkv_err']} x max from B.8 over the "
          f"whole T (limit {SP_WKV_REL:g}), B.8 launched {res['wkv_counts']} times")
    if main:
        # B.8 against the plain tiled decomposition on this shard
        args = (r[:, shard], k[:, shard], v[:, shard], w[:, shard], u)
        with torch.no_grad():
            yp, sp_ = wkv_tiled_plain(*args, remat=False)
        y8, s8 = wkv(*args)
        res["tiled_err"] = [rel(y8, yp), rel(s8, sp_)]
        check(max(res["tiled_err"]) <= SP_TILED_REL, f"B.8 (y, state) {res['tiled_err']} x max "
              f"from wkv_chunked's plain version (limit {SP_TILED_REL:g})")
        res["tiled_ms"] = [device_ms(lambda: wkv(*args), 5),
                           device_ms(lambda: wkv_tiled_plain(*args, remat=False), 2)]
        del yp, sp_, y8, s8
    del r, k, v, w, y, s, y_want, s_want
    lap("wkv")

    # the 24-layer forward, fp32 and bf16
    model32 = load_state_dict_into(RWKV(cfg32, device=DEV), synthetic_1b6(cfg32, seed=0))
    model16 = load_state_dict_into(RWKV(cfg16, device=DEV), model32.state_dict())
    tokens = torch.randint(4, cfg32.vocab_size, (1, SP_T), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(24))
    mine = tokens[:, shard]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    calls = distributed.STATS["calls"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits32 = rwkv_forward_sequence_parallel(model32, mine, mesh=mesh)
    torch.cuda.synchronize()
    res["forward"] = {"wall_ms": (time.perf_counter() - t0) * 1e3, "counts": launch_counts(),
                      "collectives": distributed.STATS["calls"] - calls,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    with torch.no_grad():
        logits16 = rwkv_forward_sequence_parallel(model16, mine, mesh=mesh)
    if READINGS:
        def timed():
            t0 = time.perf_counter()
            with torch.no_grad():
                out = rwkv_forward_sequence_parallel(model16, mine, mesh=mesh)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        res["forward"]["busy_ms_bf16"], wall = rank_busy_ms(timed)
        res["forward"]["wall_ms_bf16"] = wall * 1e3
    # rank 1's logits to rank 0, which holds both against the single-process routes
    if not main:
        for t in (logits32, logits16):
            distributed.isend(t.contiguous(), 0).wait()
    else:
        got32 = torch.cat([logits32, distributed.recv(torch.empty_like(logits32), 1)], 1)
        got16 = torch.cat([logits16, distributed.recv(torch.empty_like(logits16), 1)], 1)
        with torch.no_grad():
            want, _ = model32(tokens)
            plain, _ = model32(tokens, reference=True)
        scale = want.abs().max()
        res["fp32_err"] = float((got32 - want).abs().max() / scale)
        res["fp32_plain_gap"] = float((plain - want).abs().max() / scale)
        check(res["fp32_err"] <= res["fp32_plain_gap"], f"sp fp32 logits {res['fp32_err']:.3e} x "
              f"max from the single-process kernel route, further than its fp32 plain route "
              f"({res['fp32_plain_gap']:.3e})")
        del want
        cos = position_cosines(got16.float(), plain)
        res["bf16_cos"] = [float(cos.min()), float(cos.mean())]
        check(res["bf16_cos"][1] >= SP_BF16_MEAN_COS, f"sp bf16 logits cosine (min, mean) "
              f"{res['bf16_cos']} to the fp32 plain route, the mean under {SP_BF16_MEAN_COS}")
        del got32, got16, plain, cos
    del logits32, logits16, model16
    torch.cuda.empty_cache()
    lap("forward")

    # one backward of the causal-LM loss at SP_GRAD_LAYERS, fp32: the ranks'
    # gradients summed over the group against the single-process kernel route
    cut = rwkv6_1b6(n_layer=SP_GRAD_LAYERS, dtype="float32")
    sd8 = {k_: v_ for k_, v_ in model32.state_dict().items()
           if not k_.startswith("blocks.") or int(k_.split(".")[1]) < SP_GRAD_LAYERS}
    del model32
    model = load_state_dict_into(RWKV(cut, device=DEV), sd8)
    labels = torch.full_like(tokens, -100)
    labels[:, :-1] = tokens[:, 1:]
    count = (labels != -100).sum()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = rwkv_forward_sequence_parallel(model, mine, mesh=mesh)
    loss = causal_lm_loss(logits, labels[:, shard], l2_wrap=False, count=count)
    loss.backward()
    grads = {name: distributed.all_reduce(p.grad.clone(), mesh.group)
             for name, p in model.named_parameters()}
    loss_sum = float(distributed.all_reduce(loss.detach().clone().reshape(1), mesh.group))
    torch.cuda.synchronize()
    res["backward"] = {"wall_ms": (time.perf_counter() - t0) * 1e3, "counts": launch_counts(),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    check(all(res["backward"]["counts"][k_] > 0 for k_ in SP_KERNELS),
          f"rank {mesh.rank}: a kernel of the sp path ran no time: {res['backward']['counts']}")
    del model, logits, loss
    free()
    if main:
        ref = load_state_dict_into(RWKV(cut, device=DEV), sd8)
        ref_loss = causal_lm_loss(ref(tokens, remat=True)[0], labels, l2_wrap=False)
        ref_loss.backward()
        want = {name: p.grad for name, p in ref.named_parameters()}
        res["grad"] = hold_fp32_grads(
            f"sp={SP} backward, {SP_GRAD_LAYERS} layers, fp32, T={SP_T}", grads, want, loss_sum,
            ref_loss.item())
        del ref, want
    del grads, sd8
    free()
    lap("backward")
    return res


def hold_fp32_grads(what: str, got: dict, want: dict, loss: float, want_loss: float) -> dict:
    """fp32 gradients against the single-process fp32 kernel route's: per
    tensor within 1 - cosine MP_FP32_COS and within the norm gap its own
    cosine's noise admits (twice sqrt(2 (1 - cos)), floor MP_NORM), the
    whole gradient's norm within MP_NORM, and the loss within 1e-5. Prints
    and returns what it read."""
    gap = {n: 1 - cosine(got[n], want[n]) for n in want}
    size = {n: norm_gap(got[n], want[n]) / max(MP_NORM, 2 * math.sqrt(2 * max(gap[n], 0.0)))
            for n in want}
    whole = norm_gap(torch.stack([got[n].double().norm() for n in want]).norm(),
                     torch.stack([want[n].double().norm() for n in want]).norm())
    rel = {n: float((got[n] - want[n]).abs().max() / want[n].abs().max()) for n in want}
    top = sorted(gap, key=gap.get, reverse=True)[:3]
    far, big = max(rel, key=rel.get), max(size, key=size.get)
    loss_err = abs(loss - want_loss) / want_loss
    print(f"  {what}, {len(want)} gradient tensors: 1 - cosine to the single-process fp32 "
          f"kernel route at most (limit {MP_FP32_COS:g}): "
          + "; ".join(f"{n} {gap[n]:.3e}" for n in top)
          + f"; a tensor's norm gap at most {size[big]:.2e} of its limit ({big}); the whole "
          f"gradient's {whole:.3e} (limit {MP_NORM:g}); max |a - b| / max|b| {rel[far]:.3e} "
          f"({far}); loss {loss:.6f}, {loss_err:.2e} from it", flush=True)
    check(gap[top[0]] <= MP_FP32_COS and size[big] <= 1 and whole <= MP_NORM
          and loss_err <= 1e-5,
          f"{what}: gradient {top[0]} at 1 - cosine {gap[top[0]]:.3e}, {big} at "
          f"{size[big]:.3f} of its norm limit, the whole gradient's norm gap {whole:.3e}, "
          f"loss off by {loss_err:.2e}")
    return {"cos_gap": gap[top[0]], "norm_share": size[big], "whole_norm_gap": whole,
            "loss_err": loss_err}


def sp_rank_command(r: int, rendezvous: str, d: Path) -> list:
    return [sys.executable, "-c", f"import chip_smoke; chip_smoke.sp_rank({r}, {rendezvous!r}, "
                                  f"{str(d)!r}, {READINGS})"]


def phase_wkv4_parallel(smi: str) -> dict:
    """wkv4_parallel (the associative scan, plain PyTorch ops) against B.14
    at B=8, T=512, C=2048, fp32, from a fresh state: y and the state's next
    output within SP_WKV4_REL x max; both timed."""
    B_, T_, C_ = TB, T, rwkv4_1b5().n_embd
    rng = Inputs(25)
    k = rng.normal(B_, T_, C_, scale=2.0, dtype=torch.float32)
    v = rng.normal(B_, T_, C_, dtype=torch.float32)
    w = -torch.exp(rng.normal(C_, dtype=torch.float32))
    u = rng.normal(C_, dtype=torch.float32)
    with torch.no_grad():
        y, state = wkv4_parallel(k, v, w, u)
        y_want, s_want = wkv4(k, v, w, u)
        k1, v1 = k[:, :1].contiguous(), v[:, :1].contiguous()
        nxt, nxt_want = (wkv4(k1, v1, w, u, st)[0] for st in (state, s_want))
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in ((y, y_want), (nxt, nxt_want))]
    ms = device_ms(lambda: wkv4(k, v, w, u), 10)
    par_ms = device_ms(lambda: wkv4_parallel(k, v, w, u), 3)
    print(f"  wkv4_parallel against B.14 at B={B_}, T={T_}, C={C_}, fp32: y {errs[0]:.3e}, the "
          f"state's next output {errs[1]:.3e} x max (limit {SP_WKV4_REL:g}); reading: "
          f"wkv4_parallel {par_ms:.4f} ms, B.14 {ms:.4f} ms, on {smi}")
    check(max(errs) <= SP_WKV4_REL, f"wkv4_parallel {errs} x max from B.14")
    return {"errs": errs, "ms": ms, "parallel_ms": par_ms}


def sp_cli_files(d: Path) -> tuple:
    """A 2-layer full-width fp32 checkpoint, the contrastive data and the
    arguments of the CLI runs but the command, its data and the output
    directory."""
    cut = rwkv6_1b6(n_layer=MP_CLI_LAYERS, dtype="float32")
    model = load_state_dict_into(RWKV(cut, device=DEV), synthetic_1b6(cut, seed=9))
    save_rwkv_checkpoint(model, str(d / "cut.pth"))
    del model
    args = ["--model", str(d / "cut.pth"), "--micro-bsz", "4", "--ctx-len", "128",
            "--lr-init", "1e-3", "--lr-schedule", "constant", "--warmup-steps", "0",
            "--log-every", "1", "--dtype", "float32", "--max-steps", str(MP_CLI_STEPS),
            "--platform", "cuda"]
    return contrastive_files(d), args


def sp_cli_init(d: Path, command: str) -> dict:
    """What the trained file of `command` held before its first step: the
    LoRA adapter of --seed 0, the checkpoint's weights (and the score head
    of --seed 0)."""
    if command == "bi-encoder":
        model, _ = load_rwkv_checkpoint(str(d / "cut.pth"), device=DEV, dtype="float32")
        lc = LoraConfig(r=8, alpha=32.0)
        return lora_state_dict(apply_lora(model, lc, init_lora_params(
            model, lc, torch.Generator(device=DEV).manual_seed(0))))
    init = torch.load(d / "cut.pth", map_location=DEV, weights_only=True)
    if command == "encoder-crossencoder":
        cfg = rwkv6_1b6(n_layer=MP_CLI_LAYERS, dtype="float32")
        init["score.weight"] = init_classification_head(
            cfg, generator=torch.Generator(device=DEV).manual_seed(1)).weight.detach()
    return init


def phase_sequence_parallel(tmp: Path, smi: str) -> dict:
    """Phase 24 (the module docstring): the two sp ranks (sp_rank), the
    `--dp 2` CLIs of SP_CLI_RUNS started beside them, and in this process the
    single-process CLI runs and wkv4_parallel against B.14."""
    d = tmp / "sp"
    d.mkdir()
    t0 = time.perf_counter()
    files, args = sp_cli_files(d)
    procs = {command: start_train_cli([*args, "--train-data", files[fmt], *extra, "--dp", str(SP)],
                                      d / f"{command}-dp", d / f"{command}-dp.log", command)
             for command, fmt, extra, _ in SP_CLI_RUNS}
    rendezvous = "file://" + str(d / "rendezvous")
    logs = [open(d / f"rank{r}.log", "w") for r in range(SP)]
    ranks = [subprocess.Popen(sp_rank_command(r, rendezvous, d), cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT, start_new_session=True)
             for r in range(SP)]
    single = {}
    try:
        wkv4_res = phase_wkv4_parallel(smi)
        for command, fmt, extra, _ in SP_CLI_RUNS:
            single[command] = train_cli_here([*args, "--train-data", files[fmt], *extra],
                                             d / f"{command}-single", command=command)
            torch.cuda.empty_cache()
        wait_train_clis(list(procs.values()))
        deadline = time.monotonic() + SP_RANK_TIMEOUT_S
        while any(p.poll() is None for p in ranks):
            check(all(p.poll() in (None, 0) for p in ranks) and time.monotonic() < deadline,
                  f"a phase 24 rank failed or overran (exit codes {[p.poll() for p in ranks]})")
            time.sleep(0.5)
    except BaseException:
        for proc in [*ranks, *procs.values()]:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        for r in range(SP):
            print(f"  rank {r} log: {(d / f'rank{r}.log').read_text()[-3000:]}")
        raise
    finally:
        for f in logs:
            f.close()
    for r, proc in enumerate(ranks):
        check(proc.returncode == 0, f"phase 24 rank {r} exited {proc.returncode}:\n"
              f"{(d / f'rank{r}.log').read_text()[-4000:]}")
    res = [json.loads((d / f"sp-{r}.json").read_text()) for r in range(SP)]
    r0 = res[0]
    print("\n".join(ln for ln in (d / "rank0.log").read_text().splitlines() if ln.startswith("  ")))
    print(f"  backend {r0['backend']}; the sp WKV, bf16, H={rwkv6_1b6().n_head}, "
          f"N={rwkv6_1b6().head_size}, T={SP_T} ({SP_T // SP} a rank), (y, state) x max from one "
          f"B.8 call over the whole T: {[r['wkv_err'] for r in res]} (limit {SP_WKV_REL:g}); B.8 "
          f"against wkv_chunked's plain version on one shard: {r0['tiled_err']} (limit "
          f"{SP_TILED_REL:g}); reading: B.8 {r0['tiled_ms'][0]:.4f} ms, the plain version "
          f"{r0['tiled_ms'][1]:.2f} ms, on {smi}")
    print(f"  rwkv_forward_sequence_parallel, {SP_LAYERS} layers, T={SP_T}: fp32 logits "
          f"{r0['fp32_err']:.3e} x max from the single-process kernel route (its fp32 plain "
          f"route {r0['fp32_plain_gap']:.3e}); bf16 cosine (min, mean) to the fp32 plain route "
          f"{r0['bf16_cos']}; launches a rank {[r['forward']['counts'] for r in res][:1]}")
    for r, x in enumerate(res):
        check(x["forward"]["counts"]["layer_norm"] == 2 * SP_LAYERS + 2
              and x["forward"]["counts"]["wkv"] == SP_LAYERS,
              f"rank {r}: the sp forward's launches {x['forward']['counts']}")
        check(all(x["backward"]["counts"][k] > 0 for k in SP_KERNELS),
              f"rank {r}: a kernel of the sp backward ran no time: {x['backward']['counts']}")
    print(f"  the backward ({SP_GRAD_LAYERS} layers, fp32): {r0['grad']}; launches a rank "
          f"{[{k: x['backward']['counts'][k] for k in SP_KERNELS} for x in res]}")
    busy = [f", busy {x['forward']['busy_ms_bf16']:.0f} ms (bf16, wall "
            f"{x['forward']['wall_ms_bf16']:.0f})" if "busy_ms_bf16" in x["forward"] else ""
            for x in res]
    print(f"  reading sp forward ({SP_LAYERS} layers, fp32, T={SP_T // SP} a rank), {smi}: "
          + "; ".join(f"rank {r}: wall {x['forward']['wall_ms']:.0f} ms{busy[r]}, "
                      f"{x['forward']['collectives'] / SP_LAYERS:.2f} collectives a layer, peak "
                      f"{x['forward']['peak_gib']:.1f} GiB; backward wall "
                      f"{x['backward']['wall_ms']:.0f} ms, peak {x['backward']['peak_gib']:.1f} GiB"
                      for r, x in enumerate(res)))
    print(f"  each rank's seconds by part: {[r['seconds'] for r in res]}")
    for command, _, _, name in SP_CLI_RUNS:
        check(procs[command].returncode == 0, f"train.cli {command} --dp {SP} exited "
              f"{procs[command].returncode}:\n{(d / f'{command}-dp.log').read_text()[-3000:]}")
        cli_against_single(f"{command} --dp {SP}", (d / f"{command}-dp.log").read_text(),
                           single[command], d / f"{command}-dp" / name,
                           d / f"{command}-single" / name, sp_cli_init(d, command),
                           SP_CLI_NOISE.get(command, ()), SP_CLI_LATER_RTOL.get(command, 1e-5))
    torch.cuda.empty_cache()
    print(f"  phase 24's seconds: {time.perf_counter() - t0:.1f}")
    return {"forward": r0["forward"]["counts"], "backward": r0["backward"]["counts"],
            "wkv4_parallel": wkv4_res}


def main() -> None:
    """With no arguments the whole check; with --readings the check and the
    reading phases it leaves out (the module docstring); with
    --merge-calibration only the readings behind the merged-adapter budgets
    (merge_calibration)."""
    if sys.argv[1:] not in ([], ["--readings"], ["--merge-calibration"]):
        sys.exit("usage: python3 chip_smoke.py [--readings | --merge-calibration]")
    global READINGS
    calibrate = sys.argv[1:] == ["--merge-calibration"]
    readings = READINGS = sys.argv[1:] == ["--readings"]
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
    kernels, part_s = {}, {}
    for part in (phase_card_rates, phase_kernels, phase_backward_kernels, phase_wkv_kernels,
                 phase_fused_kernels, phase_collect_kernel):
        t0 = time.perf_counter()
        kernels.update(part() or {})
        part_s[part.__name__] = round(time.perf_counter() - t0, 1)
    print(f"  phase 2's seconds by part: {part_s}")
    torch.cuda.empty_cache()

    phase(f"phase 22: tensor-parallel serving, tp={TP} ranks on this host's card(s): the "
          f"{TP_LAYERS}-layer 1B6 in fp32 / bf16 / int8c, python -m rwkv_lm_ext_tpu_torch.serve.cli "
          f"--tp {TP}")
    with tempfile.TemporaryDirectory() as tp_tmp:
        tp_launches = phase_tp(Path(tp_tmp), smi)
    torch.cuda.empty_cache()

    phase(f"phase 23: multi-process training, {MP} ranks on this host's card(s): dp (ZeRO "
          f"AdamW), tp and GPipe pp at the 1B6 widths; python -m rwkv_lm_ext_tpu_torch.train.cli "
          f"sft --dp {MP}")
    with tempfile.TemporaryDirectory() as mp_tmp:
        phase_multiprocess(Path(mp_tmp), smi)
    torch.cuda.empty_cache()

    phase(f"phase 24: sequence parallelism, sp={SP} ranks on this host's card(s), T={SP_T} at "
          f"the 1B6 widths; python -m rwkv_lm_ext_tpu_torch.train.cli bi-encoder | "
          f"encoder-crossencoder | mlm --dp {SP}; wkv4_parallel against B.14")
    with tempfile.TemporaryDirectory() as sp_tmp:
        phase_sequence_parallel(Path(sp_tmp), smi)
    torch.cuda.empty_cache()

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
        files = write_serving_files(tmp, model)
        # the CLI servers of 15b, 5 and 15d load while in-process phases
        # before their own run (15a, 15c: launch counts and bit-equality, no
        # reading)
        server = serving_stack_server(path, files, quantized=False)
        server.start()
        server_q = CliServer(int8c_cli_args(path))
        server_q.start()
        server_qs = serving_stack_server(path, files, quantized=True)
        server_qs.start()
        phase("phase 15a: CUDA-graph decode blocks against eager blocks, bf16")
        phase_graph_blocks(model, "bf16")
        phase("phase 15b: the serving stack through the CLI (batcher, slot adapters, prefix "
              "cache, named states), bf16")
        serving = {"bf16": phase_serving_stack(path, files, model, "bf16", reference,
                                               server=server)}

        phase("phase 5: int8c through the serving CLI")
        model_q, generate_counts = phase_int8c_cli(path, server_q)
        prompt_q = phase_int8c_checks(model_q, reference, weights=model.state_dict())
        phase_int8c_embeddings(model_q, reference, unquantized)

        phase(f"phase 14b: fused decode, 24 layers, int8c, B={B}")
        fused_counts_q = phase_fused_decode(model_q, reference, prompt_q, "int8c", seed=19)
        phase("phase 15c: CUDA-graph decode blocks against eager blocks, int8c")
        phase_graph_blocks(model_q, "int8c")
        phase("phase 15d: the serving stack through the CLI, int8c")
        full = load_state_dict_into(RWKV(rwkv6_1b6(dtype="float32"), device=DEV), model.state_dict())
        serving["int8c"] = phase_serving_stack(path, files, model_q, "int8c", reference, full,
                                               server=server_qs)
        del reference, full
        for label, r in serving.items():
            print(f"  reading: the batcher through the CLI ({label}, {SERVE_SLOTS} slots, "
                  f"{SERVE_BLOCK}-step graph blocks, {SERVE_REQUESTS} concurrent requests of "
                  f"{SERVE_NEW} new tokens): {r['tok_s']:.1f} tok/s aggregate ({r['wall']:.2f} s) "
                  f"on {smi}")

        if readings:
            phase("phase 6: serving readings (not benchmark cells)")
            phase_throughput(model, cfg, "bf16", smi)
            phase_decode_readings(model, "bf16", smi)
            phase("phase 14c: decode-step ablation, bf16 (readings)")
            # the spliced variants (step_attprep, step_ffnblk) are left out to
            # keep the script inside its time limit (PERF.md §5 has their
            # readings): call phase_decode_ablation(model, "bf16", smi) for all four
            phase_decode_ablation(model, "bf16", smi, variants=("step", "step_fused"))
        phase(f"phase 21: speculative decoding, 24 layers, bf16: python -m "
              f"rwkv_lm_ext_tpu_torch.serve.cli --draft-layers {SPEC_DRAFT_LAYERS} | --draft, "
              f"SpeculativeEngine, the collect forward (B.15)")
        collect_launches = phase_speculative(model, path, tmp, smi)
        del model
        # int8c's decode-step ablation (phase 14d) is left out to keep the
        # script inside its time limit (PERF.md §5 has earlier readings)
        if readings:
            phase_throughput(model_q, cfg, "int8c", smi)
        del model_q
        phase("phase 14e: the decode step on a transposed state, op-level comparison (readings)")
        bench_counts = phase_transposed_bench(smi)
        torch.cuda.empty_cache()

        if readings:
            phase(f"phase 8: LoRA train steps of the 24-layer model (B={TB}, T={T}, bf16)")
            phase_train_readings(path, smi)

        # the train.cli subprocesses of phases 9 and 12 run beside phases 7,
        # 11 and 9 (checks, no reading)
        print("  phases 9 and 12: their train.cli subprocesses start")
        sft_clis = start_sft_clis(path, tmp)
        mlm_clis = start_mlm_clis(path, tmp)
        phase(f"phase 7: training gradients, kernel route vs plain route (2 layers, full width, "
              f"B={TB}, T={T})")
        phase_train_grads(path)

        phase(f"phase 11: full-parameter mlm gradients over fp32 master weights, kernel route vs "
              f"plain route (2 layers, full width, B={TB}, T={T})")
        phase_mlm_grads(path)

        phase("phase 9: training through python -m rwkv_lm_ext_tpu_torch.train.cli sft")
        train_counts = phase_train_cli(path, tmp, sft_clis)

        phase("phase 12: training through python -m rwkv_lm_ext_tpu_torch.train.cli mlm | mae")
        mlm_counts, fill_mask_server = phase_mlm_cli(path, tmp, mlm_clis)

        phase("phase 10b: /fill_mask through python -m rwkv_lm_ext_tpu_torch.serve.cli --encoder, "
              "on the encoder that phase 12 trained")
        fill_mask_counts = phase_fill_mask(str(tmp / "mlm" / "encoder-step4.pth"), n_layer=4,
                                           server=fill_mask_server)

        if readings:
            phase("phase 13: encoder readings (not benchmark cells)")
            phase_encoder_readings(path, smi)

        phase(f"phase 16a: reranking and contrastive gradients, kernel route vs plain route (2 "
              f"layers, full width, B={TB}, T={T})")
        phase_contrastive_grads(path)
        phase("phase 16b: the contrastive and reranking trainers through python -m "
              "rwkv_lm_ext_tpu_torch.train.cli")
        trained = phase_contrastive_cli(path, tmp)
        phase("phase 16c: /rerank through python -m rwkv_lm_ext_tpu_torch.serve.cli "
              "--cross-adapter, on the adapters that phase 16b trained")
        rerank = phase_rerank(path, trained["out"], trained.pop("server"))
        reranker = rerank.pop("reranker")
        if readings:
            phase("phase 16d: reranking and contrastive training readings (not benchmark cells)")
            phase_contrastive_readings(path, reranker, smi)
        del reranker

        phase(f"phase 17a: PEFT gradients, kernel route vs plain route (QLoRA int8c / int8 / nf4, TBPTT, "
              f"full, dots; 2 layers, full width, B={TB}, T={T})")
        # phase 17b's train.cli subprocesses run beside phase 17a (checks, no reading)
        peft_clis = start_peft_clis(path, tmp)
        phase_peft_grads(path)
        phase("phase 17b: python -m rwkv_lm_ext_tpu_torch.train.cli sft --train-type pissa | "
              "slot-lora | full --lisa-k | --chunk-ctx, --quant int8c | nf4; serve.cli --pissa-init")
        phase_peft_cli(path, tmp, peft_clis)
        if readings:
            phase("phase 17c: PEFT training readings (not benchmark cells)")
            phase_peft_readings(path, smi)
        torch.cuda.empty_cache()

        phase("phase 18a: B.14 (wkv4) against its plain version; K1 and B.9 on RWKV-5 decays")
        kernels.update(phase_wkv4_kernel(smi))
        phase_v5_kernels(smi)
        phase(f"phase 18b: synthetic RWKV-5-World-1B5 (v5.2, {FAMILY_SERVE_LAYERS} layers, bf16): "
              "embeddings, generation, python -m rwkv_lm_ext_tpu_torch.serve.cli")
        phase_v5_serving(smi, tmp)
        torch.cuda.empty_cache()
        phase(f"phase 18c: synthetic RWKV-4-World-1.5B ({FAMILY_SERVE_LAYERS} layers, bf16): logits, "
              "generation, the batcher")
        v4_launches = phase_v4_serving(smi)
        torch.cuda.empty_cache()

        phase("phase 19: python -m rwkv_lm_ext_tpu_torch.eval.cli parity | retrieval-task | sts | "
              f"rerank | ppl and the apps (RagChat, KGExtractor) on the bf16 model's first "
              f"{EVAL_LAYERS} layers")
        eval_counts = phase_eval(path, tmp, files, smi)
        torch.cuda.empty_cache()

        phase("phase 20a: B.14's backward kernel against autograd through wkv4_plain")
        kernels.update(phase_wkv4_backward(smi))
        phase(f"phase 20b: K1, B.6/B.7, B.8 and B.9 at head size {N128}")
        phase_head128_kernels(smi)
        phase(f"phase 20c: RWKV-5.2 and RWKV-4 training gradients, kernel route vs plain route (2 "
              f"layers, full width, B={TB}, T={T})")
        phase_family_grads()
        phase(f"phase 20d: RWKV-5.2 and RWKV-4 LoRA and full steps ({FAMILY_READ_LAYERS} layers, "
              f"B={TB}, T={T}, bf16)")
        v4_bwd_launches = phase_family_readings(smi)
        phase("phase 20e: python -m rwkv_lm_ext_tpu_torch.train.cli simcse --dropout-noise")
        phase_simcse_dropout(path, tmp)
        phase("phase 20f: C.24, where the bf16 kernel route's gradients part from the bf16 plain "
              "route's (nf4 QLoRA, full)")
        phase_c24_probe(path)

    # each kernel's launches on a main path that runs it (B.14's backward: a
    # 12-layer v4 LoRA step, phase 20d; B.4's given-scale entry: rank 0 of
    # phase 22's int8c tp engine): embedding serving,
    # int8c generation (on the device: its decode blocks are graph replays),
    # LoRA training, the nli trainer (B.5's full form), /fill_mask, the mlm
    # trainer, and the fused decode route on the bf16 model (B.10, B.12) and
    # the int8c one (B.11); /rerank's own launches are checked in phase 16c,
    # the eval CLI's (K1-K3) in phase 19
    launches = {k: embed_counts[k] for k in ("layer_norm", "tmix_prologue", "wkv6_fused_output")}
    launches.update({k: generate_counts[k] for k in ("wkv6_decode_step", "quantize_rows")})
    launches.update({k: train_counts[k] for k in NO_BACKWARD if k != "wkv4_bwd"})
    launches["tmix_prologue_bwd"] = trained["counts"]["tmix_prologue_bwd"]
    launches.update(wkv=fill_mask_counts["wkv"], wkv_bwd_state_pass=mlm_counts["wkv_bwd_state_pass"])
    launches.update({k: fused_counts[k] for k in ("att_prep_fused", "ffn_block_fused")})
    launches.update(ffn_prep_fused=fused_counts_q["ffn_prep_fused"],
                    wkv6_decode_step_transposed=bench_counts["wkv6_decode_step_transposed"],
                    wkv4=v4_launches, wkv4_bwd=v4_bwd_launches, wkv6_collect=collect_launches,
                    **tp_launches)
    check(all(n > 0 for n in launches.values()) and mlm_counts["wkv"] > 0
          and mlm_counts["wkv6_bwd_reverse_pass"] > 0 and fill_mask_counts["layer_norm"] > 0
          and train_counts["tmix_prologue_bwd"] > 0
          and all(rerank["counts"][k] > 0 and eval_counts[k] > 0
                  for k in ("layer_norm", "tmix_prologue", "wkv6_fused_output")),
          f"a kernel was launched no time on its main path: {launches}")
    print(f"seconds a phase: {phase_seconds()}")
    print(f"whole script: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", **KERNELS[k], launches=launches[k], **kernels[k])
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
