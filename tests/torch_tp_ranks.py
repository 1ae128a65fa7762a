"""The ranks of the tensor-parallel CPU tests (tests/test_torch_tp*.py).

``Pair(job, d)`` starts two processes, ``python tests/torch_tp_ranks.py
<job> <rank> <d>`` (or another ``script`` with the same command line), which join a gloo group through a file rendezvous in
``d`` (no TCP port, so pytest-xdist workers never collide), run ``job`` on
the inputs the test wrote to ``d`` and save their results to
``d/<job>-<rank>.pt``; ``results()`` waits for them (``run_pair`` does both).
The pair has a time limit of its own: a hang fails one test, not the suite. The ranks import the port only
(torch), not JAX; the tests hold their results against the JAX package.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
PAIR_TIMEOUT_S = 120
TP = 2

GREEDY = dict(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0, token_stop=())
PROMPT = [5, 9, 23]
BATCH_PROMPTS = [[5, 9, 23], [77, 3], [14, 60, 2]]
RERANK = {"query": "what is rwkv", "documents": ["an RNN", "数据 and text", "a b c"]}


class Pair:
    """Two rank processes of ``job`` on the inputs in ``d`` (``ranks`` of
    them where given: the script then gets the count as a fourth argument),
    started at once; ``results()`` waits for them (the test computes its
    references meanwhile)."""

    def __init__(self, job: str, d: Path, script: str = __file__, ranks: int = TP):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.job, self.d, self.ranks = job, d, ranks
        extra = [] if ranks == TP else [str(ranks)]
        self.procs = [subprocess.Popen([sys.executable, script, job, str(r), str(d), *extra],
                                       cwd=REPO, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(ranks)]
        self.logs = [[] for _ in self.procs]
        self.pumps = [threading.Thread(target=lambda p=p, log=log: log.extend(p.stdout),
                                       daemon=True)
                      for p, log in zip(self.procs, self.logs)]
        for t in self.pumps:
            t.start()
        self.deadline = time.monotonic() + PAIR_TIMEOUT_S

    def results(self) -> list:
        """The ranks' results ([rank 0's, rank 1's, ...]); fails on a rank's
        error, exit code or time limit, and leaves no process behind."""
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for t in self.pumps:
                t.join(timeout=10)
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{''.join(self.logs[r])}"
        return [torch.load(self.d / f"{self.job}-{r}.pt", weights_only=False)
                for r in range(self.ranks)]


def run_pair(job: str, d: Path) -> list:
    return Pair(job, d).results()


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _model(sd, quant=None, **overrides):
    from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
    from rwkv_lm_ext_tpu_torch.checkpoint.convert import checkpoint_config, load_state_dict_into
    from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV

    cfg = checkpoint_config(sd, dtype="float32", **overrides)
    model = load_state_dict_into(RWKV(cfg, device="cpu"), sd)
    return quantize_model(model, quant) if quant else model


def job_engine(mesh, d: Path) -> dict:
    """tp=2 logits, greedy generation, the batcher, int8 / nf4 engines,
    int8c bit for bit and an RWKV-5.2 model; rank 0 also runs the same
    calls on the whole model (the single-process port)."""
    from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
    from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows
    from rwkv_lm_ext_tpu_torch.parallel.tp import row_parallel_int8c

    inputs = torch.load(d / "inputs.pt")
    sd, tokens = inputs["sd"], inputs["tokens"]
    sp = SamplingParams(**GREEDY)
    main = mesh.rank == 0
    out = {}
    with torch.inference_mode():
        for label, quant in (("fp32", None), ("int8", "int8"), ("nf4", "nf4"), ("int8c", "int8c")):
            engine = GenerationEngine(_model(sd, quant), mesh=mesh)
            logits, state = engine.model(tokens)
            out[label] = {"logits": logits, "wkv_shape": tuple(state["wkv"].shape),
                          "greedy": engine.generate(PROMPT, max_tokens=8, sampling=sp),
                          "route": engine.route()}
            if label == "fp32":
                batcher = ContinuousBatcher(engine, n_slots=2, sampling=sp, block_size=4)
                rids = [batcher.submit(p, max_tokens=4) for p in BATCH_PROMPTS]
                done = batcher.run()
                out[label]["batcher"] = [done[r] for r in rids]
            if main:
                whole = GenerationEngine(_model(sd, quant))
                out[label]["single"] = {
                    "logits": whole.model(tokens)[0],
                    "greedy": whole.generate(PROMPT, max_tokens=8, sampling=sp)}
        # B.4 on a row-parallel input: the rank's codes and scales against
        # the whole row's
        x = torch.randn(6, 64, generator=torch.Generator().manual_seed(4))
        engine = GenerationEngine(_model(sd, "int8c"), mesh=mesh)
        lin = engine.model.blocks[0].att.output.inner
        codes = {}
        y = row_parallel_int8c(x.chunk(mesh.tp, -1)[mesh.rank], lin.q, lin.scale, mesh,
                               codes=codes)
        q, sx = quantize_rows(x)
        out["int8c_codes"] = {"q": codes["q"], "sx": codes["sx"], "y": y,
                              "want_q": q.chunk(mesh.tp, -1)[mesh.rank], "want_sx": sx}
        if main:
            whole = _model(sd, "int8c").blocks[0].att.output
            out["int8c_codes"]["want_y"] = whole(x)
        # RWKV-5.2 through the same layout (time_decay (H, N), no decay low-rank)
        sd5 = inputs["sd_v5"]
        engine = GenerationEngine(_model(sd5), mesh=mesh)
        out["v5"] = {"logits": engine.model(tokens)[0],
                     "greedy": engine.generate(PROMPT, max_tokens=8, sampling=sp)}
        if main:
            whole = GenerationEngine(_model(sd5))
            out["v5"]["single"] = {"logits": whole.model(tokens)[0],
                                   "greedy": whole.generate(PROMPT, max_tokens=8, sampling=sp)}
    return out


def job_lockstep(mesh, d: Path) -> dict:
    """A batcher, a bi-encoder and a cross-encoder behind
    LockstepBatcherDriver: rank 0 sends three /generate submits
    (concurrently), an /embed and a /rerank call, an oversized call and one
    more call; rank 1 replays the stream. Both report what their batchers
    finished; rank 0 also the single-process service's answers."""
    from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
    from rwkv_lm_ext_tpu_torch.infer.continuous import (
        ContinuousBatcher,
        LockstepBatcherDriver,
        PayloadTooLarge,
    )
    from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder, CrossEncoder
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
    from rwkv_lm_ext_tpu_torch.models.heads import ScoreHead
    from rwkv_lm_ext_tpu_torch.parallel.tp import shard_model
    from rwkv_lm_ext_tpu_torch.serve.api import ServingService

    sd = torch.load(d / "inputs.pt")["sd"]
    tok = WorldTokenizer()
    sp = SamplingParams(**GREEDY)

    score = ScoreHead(64, device="cpu")
    with torch.no_grad():
        score.weight.copy_(torch.randn(1, 64, generator=torch.Generator().manual_seed(9)))

    def service(tp_mesh):
        def part():
            return _model(sd) if tp_mesh is None else shard_model(_model(sd), tp_mesh)

        engine = GenerationEngine(_model(sd), tok, mesh=tp_mesh)
        batcher = ContinuousBatcher(engine, n_slots=2, sampling=sp, block_size=4)
        return ServingService(engine=engine, bi_encoder=BiEncoder(part(), tok),
                              cross_encoder=CrossEncoder(part(), tok, score), tokenizer=tok,
                              batcher=batcher, driver_factory=lambda b: None)

    prompts = ["Hello world", "RWKV is an RNN", "一二三"]
    svc = service(mesh)
    svc.warmup()
    out = {}
    if mesh.rank != 0:
        LockstepBatcherDriver(svc.batcher, svc_handle=svc.handle).worker_loop()
        return {"finished": svc.batcher._finished}
    driver = LockstepBatcherDriver(svc.batcher, svc_handle=svc.handle)
    answers = [None] * len(prompts)

    def submit(i):
        answers[i] = driver.submit_and_wait(prompts[i], max_tokens=6, sampling=sp)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    out["embed"] = driver.call("/embed", {"texts": ["a b c", "数据"]})["embeddings"]
    out["rerank"] = driver.call("/rerank", RERANK)["scores"]
    for t in threads:
        t.join(timeout=60)
    out["answers"] = answers
    try:
        driver.call("/embed", {"texts": ["x" * 200_000]})
        out["oversized"] = None
    except PayloadTooLarge as e:
        out["oversized"] = str(e)
    out["after"] = driver.call("/similarity", {"texts_a": ["a"], "texts_b": ["a"]})["similarity"]
    out["finished"] = dict(svc.batcher._finished)
    driver.close()
    single = service(None)
    with torch.inference_mode():
        out["single_embed"] = single.bi.encode_texts(["a b c", "数据"]).tolist()
    out["single_rerank"] = single.handle("/rerank", RERANK)["scores"]
    rids = [single.batcher.submit(p, max_tokens=6) for p in prompts]
    done = single.batcher.run()
    out["single_answers"] = [done[r] for r in rids]
    return out


JOBS = {"engine": job_engine, "lockstep": job_lockstep}


def main(job: str, rank: int, d: Path) -> None:
    from rwkv_lm_ext_tpu_torch.parallel.distributed import init_distributed, shutdown
    from rwkv_lm_ext_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    init_distributed("file://" + str(d / f"{job}.rendezvous"), TP, rank, platform="cpu",
                     timeout=PAIR_TIMEOUT_S)
    try:
        result = JOBS[job](make_mesh(dp=1, tp=TP), d)
    finally:
        shutdown()
    torch.save(result, d / f"{job}-{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]))
