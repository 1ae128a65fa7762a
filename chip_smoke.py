#!/usr/bin/env python3
"""Drive the PyTorch port's embedding-serving path once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:
  1. the device (name and nvidia-smi's power limit) and the kernel build;
  2. each hand-written kernel against its plain PyTorch version on the card
     (fp32 plain on the same bf16-rounded inputs), and both timed at the
     main path's shape (B=64, T=512) with CUDA events;
  3. a synthetic RWKV-6-World-1B6 (24 layers, C=2048, bf16, seeded weights)
     served over HTTP: /embed and /similarity answers, the kernels' launch
     counts, and the served embeddings against the plain fp32 route; plus a
     2-layer full-width checkpoint round trip through torch.save and
     load_rwkv_checkpoint;
  4. an embedding-throughput reading at B=64, T=512 (a data chain: each
     batch's tokens depend on the previous embeddings).
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result. Without a CUDA device it exits non-zero
before doing anything.
"""
from __future__ import annotations

import json
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

from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_rwkv_checkpoint,
    load_state_dict_into,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.config import EMB_ID, rwkv6_1b6
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.ops import _lib, launch_counts, reset_launch_counts
from rwkv_lm_ext_tpu_torch.ops.ddlerp import tmix_prologue, tmix_prologue_plain
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import wkv6_fused_output, wkv6_fused_output_plain
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http

DEV = "cuda"
BF16 = torch.bfloat16
# main-path geometry of RWKV-6-World-1B6 at the headline batch
B, T, C, H, N, D = 64, 512, 2048, 32, 64, 32
LN_X_EPS = 6.4e-4

KERNELS = {
    "layer_norm": dict(source="rwkv_lm_ext_tpu_torch/csrc/ln.cu",
                       replaces="rwkv_lm_ext_tpu/ops/ln_pallas.py:21"),
    "tmix_prologue": dict(source="rwkv_lm_ext_tpu_torch/csrc/ddlerp.cu",
                          replaces="rwkv_lm_ext_tpu/ops/ddlerp_pallas.py:35"),
    "wkv6_fused_output": dict(source="rwkv_lm_ext_tpu_torch/csrc/wkv_fused.cu",
                              replaces="rwkv_lm_ext_tpu/ops/wkv_pallas.py:743"),
}
# launches per forward of the 24-layer model: ln0 + 24 ln2 + ln_out, and one
# prologue and one WKV per layer
PER_FORWARD = {"layer_norm": 26, "tmix_prologue": 24, "wkv6_fused_output": 24}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    path's shape. Returns {kernel: {max_abs_err, ms, plain_ms}}."""
    rng = Inputs(1)
    out = {}

    x = rng.normal(B * T, C, scale=2.0)
    sc, bi = rng.normal(C, scale=0.2) + 1, rng.normal(C, scale=0.2)
    err = err_line(f"layer_norm ({B * T}, {C})", layer_norm(x, sc, bi),
                   layer_norm_plain(*f32(x, sc, bi)), 1e-2)
    out["layer_norm"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: layer_norm(x, sc, bi), 20),
        plain_ms=cuda_ms(lambda: layer_norm_plain(x, sc, bi), 20),
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
        ms=cuda_ms(lambda: tmix_prologue(*args), 10),
        plain_ms=cuda_ms(lambda: tmix_prologue_plain(*args), 5),
    )

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
        ms=cuda_ms(lambda: wkv6_fused_output(*args, eps=LN_X_EPS), 10),
        plain_ms=cuda_ms(lambda: wkv6_fused_output_plain(*args, eps=LN_X_EPS), 3),
    )
    for name, r in out.items():
        print(f"  {name} at B={B} T={T}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
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


def phase_serve(model, cfg) -> dict:
    """Serve the bf16 model over HTTP; returns the launch counts of the
    served requests."""
    tok = WorldTokenizer()
    bi = BiEncoder(model, tok)
    server = serve_http(ServingService(bi_encoder=bi), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    short = "RWKV is an RNN with transformer-level performance."
    cjk = "北京是中华人民共和国的首都，也是全国的政治和文化中心。"
    mixed = "Embeddings 向量 🚀 for retrieval and reranking."
    long = " ".join(f"token{i} 数据{i % 7}" for i in range(120))
    try:
        reset_launch_counts()
        code, r1 = post(base + "/embed", {"texts": [short, cjk, mixed]})
        check(code == 200, f"/embed answered {code}")
        code, r2 = post(base + "/similarity", {"texts_a": [short, cjk], "texts_b": [short, mixed]})
        check(code == 200, f"/similarity answered {code}")
        code, r3 = post(base + "/embed", {"texts": [long, short]})
        check(code == 200, f"/embed (long) answered {code}")
        bad = post(base + "/embed", b"{not json")[0], post(base + "/embed", {"text": short})[0]
        check(bad == (400, 400), f"malformed payloads answered {bad}")
        check(post(base + "/generate", {"prompt": short})[0] == 404, "unknown route not 404")
        counts = launch_counts()
        code, stats = post(base + "/stats", {})
        check(code == 200, f"/stats answered {code}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    forwards = 4   # /embed, /similarity (two), /embed
    print(f"  answers: /embed 200, /similarity 200, /embed(long) 200, malformed 400, "
          f"unknown 404; stats {stats['requests']}")
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

    # the plain route in fp32 on the same (bf16-rounded) weights
    reference = RWKV(rwkv6_1b6(dtype="float32"), device=DEV)
    load_state_dict_into(reference, model.state_dict())
    worst = 1.0
    with torch.inference_mode():
        for texts, e in (([short, cjk, mixed], served[0]), ([long, short], served[1])):
            for arr in bi.token_batches(texts):
                ref = embed_sequences(reference, torch.from_numpy(arr).to(DEV),
                                      normalize=True, reference=True).cpu().numpy()
                worst = min(worst, float(np.min(np.sum(ref * e, axis=1))))
    del reference
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


def phase_throughput(model, cfg, smi: str) -> None:
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
    print(f"  reading: {B * iters / seconds:.2f} seq/s embedded (B={B}, T={T}, bf16, "
          f"{seconds / iters * 1e3:.1f} ms/batch, peak {peak:.1f} GiB) on {smi}")


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

    print("phase 3: synthetic RWKV-6-World-1B6, bf16, served over HTTP")
    cfg = rwkv6_1b6()
    sd = synthetic_1b6(cfg, seed=0)
    phase_roundtrip(sd)
    model = load_state_dict_into(RWKV(cfg, device=DEV), sd)
    del sd
    counts = phase_serve(model, cfg)

    print("phase 4: throughput reading (not a benchmark cell)")
    phase_throughput(model, cfg, smi)

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", **KERNELS[k], launches=counts[k], **kernels[k])
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
