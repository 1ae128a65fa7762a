#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:
  1. the device (name and nvidia-smi's power limit) and the kernel build
     (one nvcc per source, all started together);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at the main paths' shapes, and both timed by their device time
     (torch.profiler, host overhead excluded): K1-K3 at
     B=64, T=512; the int8 row quantizer B.4 (bit-identical) at the
     prefill and decode shapes; the decode step B.9 at B=64 and B=1, also
     against K1 at T=1; the backward kernels B.5 (ddlerp prologue) and
     B.6 + B.7 (fused WKV) at the training shape B=8, T=512 and ragged
     shapes, fp32 and bf16, against autograd through their plain versions,
     each called twice and held bit-equal;
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
  6. serving readings (not benchmark cells): embedded seq/s at B=64, T=512,
     decode tok/s of generate_batch at B=64, single-stream tok/s of
     generate, bf16 and int8c;
  7. training gradients of a 2-layer full-width model at B=8, T=512, kernel
     route against plain route: LoRA A/B in fp32 and in bf16, remat on
     against off, and state tuning's time_state;
  8. LoRA train steps of the 24-layer model at B=8, T=512: the launch
     counts of one step (remat on and off), step time and Kt/s readings,
     and a profile of one step;
  9. training through `python -m rwkv_lm_ext_tpu_torch.train.cli sft` on the
     saved model (LoRA 8 steps, state tuning 4 steps, subprocesses): falling
     losses, the adapter files, the merged adapter against the unfused
     forward; then the same CLI in this process, whose launch counts are
     the training path's.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result. Without a CUDA device it exits non-zero
before doing anything.
"""
from __future__ import annotations

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
from rwkv_lm_ext_tpu_torch.config import EMB_ID, TrainConfig, rwkv6_1b6
from rwkv_lm_ext_tpu_torch.data.sft import encode_sft_example
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS, RWKV
from rwkv_lm_ext_tpu_torch.models.state import init_model_state
from rwkv_lm_ext_tpu_torch.ops import _lib, launch_counts, reset_launch_counts
from rwkv_lm_ext_tpu_torch.ops.ddlerp import (
    tmix_prologue,
    tmix_prologue_bwd,
    tmix_prologue_bwd_plain,
    tmix_prologue_plain,
)
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import wkv6_decode_step, wkv6_decode_step_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    wkv6_fused_output,
    wkv6_fused_output_bwd,
    wkv6_fused_output_bwd_plain,
    wkv6_fused_output_plain,
)
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http
from rwkv_lm_ext_tpu_torch.train import cli as train_cli
from rwkv_lm_ext_tpu_torch.train.loop import make_train_step
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
BF16 = torch.bfloat16
# main-path geometry of RWKV-6-World-1B6 at the headline batch
B, T, C, H, N, D, F = 64, 512, 2048, 32, 64, 32, 7168
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
}
NO_BACKWARD = {"tmix_prologue_bwd": 0, "wkv6_bwd_forward_pass": 0, "wkv6_bwd_reverse_pass": 0}
# launches per forward of the 24-layer model: ln0 + 24 ln2 + ln_out, and one
# prologue and one WKV per layer; a decode step swaps K1 for the decode
# kernel; int8c adds 8 row quantizations a layer (5 att + 3 ffn projections)
PER_FORWARD = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 24,
               "wkv6_decode_step": 0, "quantize_rows": 0, **NO_BACKWARD}
PER_STEP = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 0,
            "wkv6_decode_step": 24, "quantize_rows": 0, **NO_BACKWARD}


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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ms(fn, reps: int) -> float:
    """Device time of one fn() call: the summed durations of the device
    operations that `reps` calls launch, as torch.profiler records them,
    after one warm-up. Host launch overhead and the gaps between launches do
    not count, so a kernel of a few microseconds is not read as the time its
    Python wrapper takes to launch it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(ops), "the profiler recorded no device operations")
    return sum(e.self_device_time_total for e in ops) / reps / 1e3


def device_ms_by_kernel(fn, reps: int, groups: dict) -> dict:
    """As device_ms, split by kernel name: {group: ms of one call} for the
    device operations whose name holds one of the group's substrings."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {g: sum(e.self_device_time_total for e in ops if any(k in e.name for k in keys))
           / reps / 1e3 for g, keys in groups.items()}
    check(all(v > 0 for v in out.values()), f"the profiler recorded no kernel of a group: {out}")
    return out


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
    )

    def prologue_args(b):
        return (rng.normal(b, T, C), rng.normal(b, C), sc, bi,
                rng.uniform(6, C, lo=0.0, hi=1.0), rng.normal(C, 5 * D, scale=0.1),
                rng.normal(5, D, C, scale=0.1))

    args = prologue_args(8)
    got, want = tmix_prologue(*args), tmix_prologue_plain(*f32(*args))
    names = ("xw", "xk", "xv", "xr", "xg", "xln")
    err = max(err_line(f"tmix_prologue B=8 T={T} {n}", g, w, 1e-2)
              for n, g, w in zip(names, got, want))
    args = prologue_args(B)
    out["tmix_prologue"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: tmix_prologue(*args), 10),
        plain_ms=device_ms(lambda: tmix_prologue_plain(*args), 5),
    )
    args1 = prologue_args(B)
    args1 = (args1[0][:, :1].contiguous(),) + args1[1:]
    print(f"  tmix_prologue at T=1, B={B} (the decode step's call): "
          f"kernel {device_ms(lambda: tmix_prologue(*args1), 20):.4f} ms, "
          f"plain {device_ms(lambda: tmix_prologue_plain(*args1), 20):.4f} ms")

    def wkv_args(b, t):
        r, k, v, g = (rng.normal(b, t, H, N) for _ in range(4))
        w = rng.uniform(b, t, H, N, lo=-8.0, hi=2.5, dtype=torch.float32)
        return (r, k, v, w, rng.normal(H, N, scale=0.5), g, rng.normal(H * N, scale=0.1) + 1,
                rng.normal(H * N, scale=0.1), rng.normal(b, H, N, N, scale=0.1, dtype=torch.float32))

    errs = []
    for t in (T, 37):
        args = wkv_args(8, t)
        (o, s) = wkv6_fused_output(*args, eps=LN_X_EPS)
        (ro, rs) = wkv6_fused_output_plain(*f32(*args), eps=LN_X_EPS)
        errs.append(err_line(f"wkv6_fused_output B=8 T={t} out", o, ro, 1e-2))
        err_line(f"wkv6_fused_output B=8 T={t} state", s, rs, 1e-3)
    args = wkv_args(B, T)
    out["wkv6_fused_output"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: wkv6_fused_output(*args, eps=LN_X_EPS), 10),
        plain_ms=device_ms(lambda: wkv6_fused_output_plain(*args, eps=LN_X_EPS), 3),
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
    out["wkv6_decode_step"] = dict(max_abs_err=max(errs), ms=times[B][0], plain_ms=times[B][1])
    for name, r in out.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (main-path shape)")
    return out


BWD_REL = {torch.float32: 5e-4, BF16: 2e-2}        # B.5, x max|plain|
WKV_BWD_REL = {torch.float32: 1e-4, BF16: 2e-2}    # B.6 + B.7
TB = 8                                             # the training batch


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
    main_err = 0.0
    for b, t in ((TB, T), (3, 37)):
        for dtype in (torch.float32, BF16):
            args, cts = prologue_case(b, t, dtype)
            got = tmix_prologue_bwd(*args, cts)
            check(bit_equal(got, tmix_prologue_bwd(*args, cts)), f"B.5 ({b}, {t}) {dtype}: two calls differ")
            dx_only = tmix_prologue_bwd(*args, cts, weights=False)
            check(bit_equal(dx_only[:2], got[:2]) and dx_only[2:] == (None,) * 5,
                  "B.5 without weight gradients differs in dx/dshift")
            want = tmix_prologue_bwd_plain(*f32(*args), [None if c is None else c.float() for c in cts])
            errs = [err_line(f"B.5 (B,T,C,D)=({b},{t},{C},{D}) {str(dtype)[6:]} {n}", g, w, BWD_REL[dtype])
                    for n, g, w in zip(names, got, want)]
            if (b, t, dtype) == (TB, T, BF16):
                main_err = max(errs)
    args, cts = prologue_case(TB, T, BF16)
    out["tmix_prologue_bwd"] = dict(
        max_abs_err=main_err,
        ms=device_ms(lambda: tmix_prologue_bwd(*args, cts), 5),
        plain_ms=device_ms(lambda: tmix_prologue_bwd_plain(*args, cts), 3),
    )
    print(f"  B.5 at B={TB}, T={T}, bf16: kernel {out['tmix_prologue_bwd']['ms']:.4f} ms with the "
          f"weight gradients, {device_ms(lambda: tmix_prologue_bwd(*args, cts, weights=False), 5):.4f} "
          f"ms dx and dshift only (LoRA), plain {out['tmix_prologue_bwd']['plain_ms']:.4f} ms; "
          f"forward K2 {device_ms(lambda: tmix_prologue(*args), 5):.4f} ms")

    def wkv_case(b, t, h, n, dtype):
        r, k, v, g = (rng.normal(b, t, h, n, dtype=dtype) for _ in range(4))
        w = rng.uniform(b, t, h, n, lo=-8.0, hi=3.0, dtype=torch.float32)   # decays 1 .. e^-20
        return (r, k, v, w, rng.normal(h, n, scale=0.5, dtype=dtype), g,
                rng.normal(h * n, scale=0.1, dtype=dtype) + 1, rng.normal(h * n, scale=0.1, dtype=dtype),
                rng.normal(b, h, n, n, scale=0.1, dtype=torch.float32),
                rng.normal(b, t, h * n, dtype=dtype), rng.normal(b, h, n, n, scale=0.1, dtype=torch.float32))

    names = ("dr", "dk", "dv", "dw", "du", "ds0", "dg", "dln_scale", "dln_bias")
    main_errs = {}
    for shape in ((TB, T, H, N), (3, 37, 4, 32), (1, 1, H, N)):
        for dtype in (torch.float32, BF16):
            args = wkv_case(*shape, dtype)
            got = wkv6_fused_output_bwd(*args, eps=LN_X_EPS)
            check(bit_equal(got, wkv6_fused_output_bwd(*args, eps=LN_X_EPS)),
                  f"B.6 + B.7 {shape} {dtype}: two calls differ")
            want = wkv6_fused_output_bwd_plain(*f32(*args), eps=LN_X_EPS)
            errs = {n: err_line(f"B.6+B.7 (B,T,H,N)={shape} {str(dtype)[6:]} {n}", g, w, WKV_BWD_REL[dtype])
                    for n, g, w in zip(names, got, want)}
            if shape == (TB, T, H, N) and dtype == BF16:
                main_errs = errs
    # the LoRA path's call: no initial state, the final state unused
    args = wkv_case(TB, T, H, N, BF16)
    args = args[:8] + (None, args[9], None)
    split = device_ms_by_kernel(lambda: wkv6_fused_output_bwd(*args, eps=LN_X_EPS), 5,
                                {"B.6": ("wkv6_bwd_forward",), "B.7": ("wkv6_bwd_reverse",)})
    whole = device_ms(lambda: wkv6_fused_output_bwd(*args, eps=LN_X_EPS), 5)
    plain = device_ms(lambda: wkv6_fused_output_bwd_plain(*args, eps=LN_X_EPS), 2)
    k1 = device_ms(lambda: wkv6_fused_output(*args[:8], eps=LN_X_EPS), 5)
    print(f"  B.6 + B.7 at B={TB}, T={T}, H={H}, N={N}, bf16: B.6 {split['B.6']:.4f} ms, B.7 "
          f"{split['B.7']:.4f} ms, whole backward wrapper {whole:.4f} ms; plain (autograd through "
          f"the sequential reference) {plain:.4f} ms; forward K1 {k1:.4f} ms")
    out["wkv6_bwd_forward_pass"] = dict(
        max_abs_err=max(main_errs[n] for n in ("dg", "dln_scale", "dln_bias")),
        ms=split["B.6"], plain_ms=plain)
    out["wkv6_bwd_reverse_pass"] = dict(
        max_abs_err=max(main_errs[n] for n in ("dr", "dk", "dv", "dw", "du", "ds0")),
        ms=split["B.7"], plain_ms=plain)
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


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


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


def phase_generate_bf16(model, reference) -> None:
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
    check(all(n > 0 for k, n in counts.items() if k not in NO_BACKWARD),
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


def phase_int8c_checks(model_q, reference, weights) -> None:
    """The int8c kernel route against the int8c plain route. Per layer
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
            tokens, emb = step(tokens)
            checksum += emb.float().sum()
        end.record()
        torch.cuda.synchronize()
    check(bool(torch.isfinite(checksum)), "non-finite embeddings in the throughput chain")
    seconds = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  reading: {B * iters / seconds:.2f} seq/s embedded (B={B}, T={T}, {label}, "
          f"{seconds / iters * 1e3:.1f} ms/batch, peak {peak:.1f} GiB) on {smi}")


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
    "K1 forward": ("wkv6_fused_kernel",), "K2 forward": ("tmix_prologue_kernel",),
    "K3 forward": ("layer_norm_kernel",),
    "B.5": ("prologue_bwd_chain", "prologue_bwd_ln", "atb_kernel"),
    "B.6": ("wkv6_bwd_forward",), "B.7": ("wkv6_bwd_reverse",),
    "partial sums": ("sum_partials",),
    "GEMMs": ("gemm", "nvjet", "xmma", "cutlass"),
    "optimizer (multi-tensor)": ("multi_tensor_apply",),
}


def step_profile(step, batch, step_ms: float) -> None:
    """Device time of one train step by kernel group (torch.profiler,
    device operations only); idle = the step's CUDA-event time less busy."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    split = {g: 0.0 for g in STEP_GROUPS}
    split["elementwise, reductions, copies"] = 0.0
    for e in ops:
        name = e.name.lower()
        group = next((g for g, keys in STEP_GROUPS.items() if any(k.lower() in name for k in keys)),
                     "elementwise, reductions, copies")
        split[group] += e.self_device_time_total / 1e3
    print(f"  profile of one step (remat on): {len(ops)} device ops, busy {busy:.3f} ms of "
          f"{step_ms:.3f} ms, idle {100 * max(step_ms - busy, 0) / step_ms:.2f} %")
    for g, v in split.items():
        print(f"    {g}: {v:.3f} ms ({100 * v / busy:.1f} %)")


def phase_train_readings(path: str, smi: str) -> None:
    """LoRA r=8 train steps of the 24-layer bf16 model at B=8, T=512: the
    launches of one step (remat on and off), then step time and Kt/s over
    steps that chain through the optimizer's updates (CUDA events, after
    warm-up), and a profile of one step."""
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
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses = [step(batch)["loss"] for _ in range(iters)]
        end.record()
        torch.cuda.synchronize()
        losses = torch.stack(losses)
        check(bool(torch.isfinite(losses).all()), f"non-finite train losses {losses}")
        ms = start.elapsed_time(end) / iters
        print(f"  reading: LoRA train step {ms:.2f} ms, {TB * T / ms:.2f} Kt/s (r=8, B={TB}, T={T}, "
              f"bf16, remat {'on' if remat else 'off'}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, losses "
              f"{losses[0].item():.4f} .. {losses[-1].item():.4f}) on {smi}")
        if remat:
            step_profile(step, batch, ms)
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


def run_train_cli(args) -> list:
    """`python -m rwkv_lm_ext_tpu_torch.train.cli sft ...` as a subprocess;
    returns the logged losses."""
    cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", "sft", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    steps = [json.loads(ln.split(": ", 1)[1]) for ln in proc.stdout.splitlines()
             if ln.startswith("step ")]
    losses = [m["loss"] for m in steps]
    shown = " ".join(a for a in args if not a.startswith("/"))
    print(f"  python -m rwkv_lm_ext_tpu_torch.train.cli sft {shown}: "
          f"{time.perf_counter() - t0:.1f} s, losses {[round(x, 4) for x in losses]}, last "
          f"logged Kt/s {steps[-1].get('Kt/s', float('nan')):.2f}")
    check(len(losses) >= 2 and all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall on repeated rows: {losses}")
    return losses


def phase_train_cli(path: str, tmp: Path) -> dict:
    """The trainer's normal entry point on the saved 24-layer model: LoRA (8
    steps) and state tuning (4 steps) as subprocesses, their files, the
    merged adapter; then LoRA again in this process, where the launches of
    the training path are counted. Returns those counts."""
    tok = WorldTokenizer()
    data = tmp / "sft.jsonl"
    sft_jsonl(data, tok)
    common = ["--model", path, "--train-data", str(data), "--micro-bsz", "64", "--ctx-len", str(T),
              "--lr-init", "1e-3", "--warmup-steps", "0", "--log-every", "1", "--platform", DEV]
    out = tmp / "lora"
    run_train_cli(common + ["--output-dir", str(out), "--train-type", "lora", "--lora-r", "8",
                            "--lora-alpha", "32", "--max-steps", "8"])
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
    adapter = lora_state_dict_to_tree(sd)
    tokens = torch.randint(4, cfg.vocab_size, (2, 128), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(10))
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model, _ = load_rwkv_checkpoint(path, device=DEV, dtype=dtype)
        apply_lora(model, LORA, adapter)
        with torch.inference_mode():
            logits[dtype, "unfused"] = model(tokens)[0].float()
            logits[dtype, "merged"] = merge_lora(model)(tokens)[0].float()
        del model
    ref = logits["float32", "unfused"]
    cos32 = min_cosine(logits["float32", "merged"], ref)
    cos_m, cos_u = (min_cosine(logits["bfloat16", k], ref) for k in ("merged", "unfused"))
    print(f"  lora-step8.pth: {len(sd)} keys in the reference layout (lora_A (8, in), lora_B "
          f"(out, 8), fp32); min per-position logits cosine to the unfused LoRA forward in fp32: "
          f"merged in fp32 {cos32:.6f} (limit 0.999); in bf16 merged {cos_m:.6f}, unfused "
          f"{cos_u:.6f} (merged may trail unfused by 1e-3)")
    check(cos32 >= 0.999, f"merged adapter logits cosine {cos32} in fp32")
    check(cos_m >= cos_u - 1e-3, f"bf16 merged adapter cosine {cos_m} trails unfused {cos_u}")
    del logits, ref
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU")
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1: device {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    t0 = time.perf_counter()
    _lib.library()
    print(f"  built and loaded the kernels in {time.perf_counter() - t0:.1f} s")

    print("phase 2: kernels vs their plain versions")
    kernels = phase_kernels()
    kernels.update(phase_backward_kernels())

    print("phase 3: synthetic RWKV-6-World-1B6, bf16, embeddings served over HTTP")
    cfg = rwkv6_1b6()
    sd = synthetic_1b6(cfg, seed=0)
    phase_roundtrip(sd)
    model = load_state_dict_into(RWKV(cfg, device=DEV), sd)
    del sd
    # the plain route in fp32 on the same (bf16-rounded) weights
    reference = load_state_dict_into(RWKV(rwkv6_1b6(dtype="float32"), device=DEV), model.state_dict())
    embed_counts = phase_serve(model, cfg, reference)

    print("phase 4: generation, bf16")
    phase_generate_bf16(model, reference)

    print("phase 5: int8c through the serving CLI")
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
        phase_int8c_checks(model_q, reference, weights=model.state_dict())
        phase_int8c_embeddings(model_q, reference, unquantized)
        del reference

        print("phase 6: serving readings (not benchmark cells)")
        phase_throughput(model, cfg, "bf16", smi)
        phase_decode_readings(model, "bf16", smi)
        del model
        phase_throughput(model_q, cfg, "int8c", smi)
        phase_decode_readings(model_q, "int8c", smi)
        del model_q
        torch.cuda.empty_cache()

        print(f"phase 7: training gradients, kernel route vs plain route (2 layers, full width, "
              f"B={TB}, T={T})")
        phase_train_grads(path)

        print(f"phase 8: LoRA train steps of the 24-layer model (B={TB}, T={T}, bf16)")
        phase_train_readings(path, smi)

        print("phase 9: training through python -m rwkv_lm_ext_tpu_torch.train.cli sft")
        train_counts = phase_train_cli(path, tmp)

    launches = {k: embed_counts[k] for k in ("layer_norm", "tmix_prologue", "wkv6_fused_output")}
    launches.update({k: generate_counts[k] for k in ("wkv6_decode_step", "quantize_rows")})
    launches.update({k: train_counts[k] for k in NO_BACKWARD})
    print(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", **KERNELS[k], launches=launches[k], **kernels[k])
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
