#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:
  1. the device (name and nvidia-smi's power limit) and the kernel build
     (one nvcc per source, all started together);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at the main paths' shapes, and both timed by their device time
     (torch.profiler, host overhead excluded): K1-K3 at
     B=64, T=512; the int8 row quantizer B.4 (bit-identical) at the
     prefill and decode shapes; the decode step B.9 at B=64 and B=1, also
     against K1 at T=1;
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
  6. readings (not benchmark cells): embedded seq/s at B=64, T=512, decode
     tok/s of generate_batch at B=64, single-stream tok/s of generate, bf16
     and int8c.
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

from rwkv_lm_ext_tpu_torch.adapters.quant import QuantLinear, quantize_model
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_rwkv_checkpoint,
    load_state_dict_into,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.config import EMB_ID, rwkv6_1b6
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
from rwkv_lm_ext_tpu_torch.ops.ddlerp import tmix_prologue, tmix_prologue_plain
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import wkv6_decode_step, wkv6_decode_step_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import wkv6_fused_output, wkv6_fused_output_plain
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http

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
}
# launches per forward of the 24-layer model: ln0 + 24 ln2 + ln_out, and one
# prologue and one WKV per layer; a decode step swaps K1 for the decode
# kernel; int8c adds 8 row quantizations a layer (5 att + 3 ffn projections)
PER_FORWARD = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 24,
               "wkv6_decode_step": 0, "quantize_rows": 0}
PER_STEP = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 0,
            "wkv6_decode_step": 24, "quantize_rows": 0}
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
    check(all(n > 0 for n in counts.values()), f"a kernel did not run in /generate: {counts}")
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU")
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
        path = str(Path(tmp) / "rwkv6_1b6_synthetic.pth")
        t0 = time.perf_counter()
        save_rwkv_checkpoint(model, path)
        print(f"  saved the bf16 model ({Path(path).stat().st_size / 2**30:.2f} GiB) "
              f"in {time.perf_counter() - t0:.1f} s")
        model_q, generate_counts = phase_int8c_cli(path)
    phase_int8c_checks(model_q, reference, weights=model.state_dict())
    phase_int8c_embeddings(model_q, reference, unquantized)
    del reference

    print("phase 6: readings (not benchmark cells)")
    phase_throughput(model, cfg, "bf16", smi)
    phase_decode_readings(model, "bf16", smi)
    del model
    phase_throughput(model_q, cfg, "int8c", smi)
    phase_decode_readings(model_q, "int8c", smi)

    launches = {k: embed_counts[k] for k in ("layer_norm", "tmix_prologue", "wkv6_fused_output")}
    launches.update({k: generate_counts[k] for k in ("wkv6_decode_step", "quantize_rows")})
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", **KERNELS[k], launches=launches[k], **kernels[k])
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
