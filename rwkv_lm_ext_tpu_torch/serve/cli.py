"""Serving CLI: one command from a checkpoint to an HTTP server.

Counterpart of rwkv_lm_ext_tpu/serve/cli.py:38-131, 134-285, 286-325 and
328-436 with the generation engine, its LoRA adapters (merged and per request), named
states, the continuous batcher, speculative decoding, the prefix cache, the
bi- and cross-encoders and the bidirectional encoder:

  python -m rwkv_lm_ext_tpu_torch.serve.cli --model m.pth [--quant int8c|nf4] \
      [--chat-adapter chat.pth [--pissa-init init_pissa.pth]] \
      [--slot-adapter a=a.pth --slot-adapter b=b.pth] \
      [--lora-r 8 --lora-alpha 32] [--states-config states.json] \
      [--batcher-slots 16 --batcher-block 16] [--prefix-cache 8] \
      [--draft d.pth | --draft-layers K] [--gamma 8] \
      [--bi-adapter bi.pth [--bi-pooling weightedmean]] \
      [--cross-adapter cross.pth [--cross-head score.pth]]
  python -m rwkv_lm_ext_tpu_torch.serve.cli --encoder enc.pth

states.json maps action names to state-tuning checkpoints and templates:
  {"summarize": {"path": "states/sum.pth", "template": "sum: {input}"}}

``--model`` serves /generate; ``--encoder`` (a bidirectional encoder's .pth,
as ``train.cli mlm`` writes it) serves /fill_mask; one of the two is needed.

``--quant`` quantizes the generation base's block projections (int8, nf4
and fp4: dequantized on use; int8c: int8 products with dynamic per-row
activation quantization). ``--chat-adapter`` merges a LoRA into the base
before that; with ``--pissa-init`` (the ``init_pissa.pth`` that ``train.cli
sft --train-type pissa`` writes) the adapter is a PiSSA one and merges
against the original base, W + A @ B - A_init @ B_init (``merge_pissa``).
The JAX CLI builds that merge's config without ``pissa=True`` and so stops
at merge_pissa's assertion (ROADMAP C.20); the port gives it the PiSSA
config (scale 1). Each ``--slot-adapter NAME=PATH`` is served per request (/generate
{"adapter": NAME}) on the same base, unmerged, so requests under different
adapters share the batcher's step. ``--bi-adapter`` serves /embed and
/similarity, ``--cross-adapter`` /rerank, each from its own copy of the
checkpoint's weights with the LoRA merged in, unquantized whatever --quant
says (as the JAX CLI merges them into its base before quantizing the
generation weights); the reranker's ``score.weight`` comes from the adapter
file or from ``--cross-head``, and without one the command refuses to
start. ``--platform`` is the torch device: ``cuda`` by default, ``cpu`` only
when asked. ``--draft`` (a smaller checkpoint of the same vocabulary, loaded
unquantized in the served dtype) or ``--draft-layers K`` (the served model's
own first K layers) puts a speculative engine with ``--gamma`` drafted tokens
a round beside the engine: penalty-free /generate requests without an adapter
run on it; ``--batcher-slots`` takes precedence and leaves them out, as in
the JAX CLI.

``--tp N`` serves one model cut over N ranks (head-parallel tensor
parallelism, parallel/tp.py): torch.distributed has one rank a process, so on
one host this process is rank 0, starts the N - 1 others itself (the same
arguments with ``--coordinator file://…``, ``--num-processes N`` and
``--process-id r``) and alone binds the HTTP port. Across hosts, run the
command on every host with ``--coordinator host:port --num-processes N
--process-id r`` (or RWKV_COORDINATOR / RWKV_NUM_PROCESSES / RWKV_PROCESS_ID
with ``RWKV_DIST=1``); ``--tp`` is then the number of processes (serving
takes dp = 1). The backend is NCCL where every rank has a card of its own,
else gloo (ranks sharing a card, or the CPU), and decode blocks are CUDA
graphs only under NCCL; the choice is printed at start-up and /stats reports
it. Two modes, as in the JAX CLI: with ``--batcher-slots`` process 0 turns
the batcher's inputs and every other endpoint's requests into one op stream
that the others replay (infer.continuous.LockstepBatcherDriver; /generate
streams too); without, each request goes on the stream and every process runs
it on the engine (no streaming). A request over
``infer.continuous.MAX_REQUEST_BYTES`` gets 400 and the server goes on. A
process whose rank 0 is gone exits at its next collective. Under ``--tp`` the
engine (any ``--quant``, a merged ``--chat-adapter``, ``--pissa-init``), the
batcher, ``--bi-adapter`` and ``--cross-adapter`` run on RWKV-6 and RWKV-5.x
models; ``--draft``/``--draft-layers`` (as in the JAX CLI), ``--slot-adapter``,
``--states-config``, ``--prefix-cache``, ``--encoder`` and RWKV-4 models are
refused by name (ROADMAP A.12).

``--model`` takes RWKV-6, RWKV-5.x (5.0, 5.1, 5.2) and RWKV-4 checkpoints.
``--tokenizer-json`` reads an HF tokenizer.json in place of the world
vocabulary: RWKV-4 Pile and Raven pair with the GPT-NeoX
``20B_tokenizer.json`` (RWKV-4-World with the world vocabulary). An RWKV-4
model serves /generate only: it gives no hidden states, so ``--bi-adapter``,
``--cross-adapter`` and ``--states-config`` refuse it by name (the JAX CLI
builds them and stops at an assertion of rwkv_forward or of init_model_state
when they are used). A model with ``head_qk``, ``tiny_att_dim`` or
``my_pos_emb`` is refused by name (ROADMAP C.21).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile

import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    lora_state_dict_to_tree,
    merge_lora,
    merge_pissa,
)
from rwkv_lm_ext_tpu_torch.adapters.quant import MODES, quantize_model
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import build_slot_lora
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    checkpoint_config,
    load_rwkv_checkpoint,
    score_head_from_state_dict,
)
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.data.tokenizer_json import JsonTokenizer
from rwkv_lm_ext_tpu_torch.infer.continuous import (
    ContinuousBatcher,
    LockstepBatcherDriver,
    PayloadTooLarge,
)
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder, CrossEncoder
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine, refuse_chunk_dependent
from rwkv_lm_ext_tpu_torch.infer.speculative import SpeculativeEngine, truncated_draft
from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache
from rwkv_lm_ext_tpu_torch.infer.states_registry import StatesRegistry
from rwkv_lm_ext_tpu_torch.parallel.distributed import (
    init_distributed,
    is_main_process,
    leave_within,
    process_count,
    rank_device,
)
from rwkv_lm_ext_tpu_torch.parallel.mesh import make_mesh
from rwkv_lm_ext_tpu_torch.parallel.tp import shard_model
from rwkv_lm_ext_tpu_torch.serve.api import BadRequest, ServingService, serve_http
from rwkv_lm_ext_tpu_torch.utils.device import resolve_device

# flags whose backends are not ported under --tp, refused by name
TP_REFUSED = ("--draft", "--draft-layers", "--slot-adapter", "--states-config", "--prefix-cache",
              "--encoder")
# seconds rank 0 waits for the processes it started to leave at shutdown,
# and seconds any rank gives leaving the process group before it exits
# regardless (a peer gone mid-teardown can stall NCCL's); together under the
# 30 s a supervisor such as chip_smoke.CliServer grants after SIGTERM
WORKER_EXIT_S = 15.0
TEARDOWN_S = 10.0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="rwkv_lm_ext_tpu_torch.serve.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--model", default=None, help="RWKV-4/5/6 .pth for generation")
    p.add_argument("--encoder", default=None,
                   help="bidirectional encoder .pth for /fill_mask")
    p.add_argument("--vocab", default=None, help="world-vocabulary path")
    p.add_argument("--tokenizer-json", default=None,
                   help="HF tokenizer.json instead of the world vocabulary (e.g. "
                        "20B_tokenizer.json for RWKV-4 Pile / Raven)")
    p.add_argument("--dtype", default=None, help="compute dtype override (e.g. float32)")
    p.add_argument("--quant", default=None, choices=MODES,
                   help="quantize the generation base's block projections")
    p.add_argument("--chat-adapter", default=None,
                   help="LoRA .pth merged into the generation base")
    p.add_argument("--pissa-init", default=None,
                   help="init_pissa.pth for a PiSSA chat adapter (merged against the original "
                        "base)")
    p.add_argument("--slot-adapter", action="append", default=None, metavar="NAME=PATH",
                   help="repeatable: a named LoRA served per request on the same base "
                        '(/generate {"adapter": NAME}), not merged; uses --lora-r/--lora-alpha')
    p.add_argument("--lora-r", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=32.0)
    p.add_argument("--bi-adapter", default=None,
                   help="LoRA .pth for the bi-encoder (/embed, /similarity)")
    p.add_argument("--bi-pooling", default="weightedmean")
    p.add_argument("--cross-adapter", default=None,
                   help="LoRA .pth for the cross-encoder (/rerank); its score.weight (or "
                        "--cross-head's) is the scoring head")
    p.add_argument("--cross-head", default=None,
                   help=".pth holding score.weight if the adapter does not")
    p.add_argument("--states-config", default=None,
                   help="JSON: name -> {path, template} of state-tuned tasks (/process_text)")
    p.add_argument("--batcher-slots", type=int, default=0,
                   help="continuous batching for /generate with this many slots")
    p.add_argument("--batcher-block", type=int, default=16,
                   help="decode steps a batcher block (one CUDA graph replay); 1 = per-token ticks")
    p.add_argument("--batcher-adaptive", action="store_true",
                   help="shorten the block (powers of two >= 8) when a slot nears its budget")
    p.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                   help="LRU prompt-prefix state cache with N entries")
    p.add_argument("--draft", default=None,
                   help="smaller RWKV .pth: speculative decoding for penalty-free /generate "
                        "(single-stream latency; ignored when --batcher-slots is set)")
    p.add_argument("--draft-layers", type=int, default=0,
                   help="early-exit self-draft from the target's first K layers instead of a "
                        "separate --draft ckpt")
    p.add_argument("--gamma", type=int, default=8, help="speculative lookahead length")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="torch device to serve on")
    p.add_argument("--tp", type=int, default=1,
                   help="head-parallel tensor parallelism over this many processes (see above)")
    p.add_argument("--coordinator", default=None,
                   help="host:port (or file://path) of the process group's rendezvous "
                        "(multi-process runs)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    return p.parse_args(argv)


def refuse_under_tp(args: argparse.Namespace) -> None:
    """Exit, by name, on a flag whose backend is not ported under --tp."""
    given = [flag for flag in TP_REFUSED if getattr(args, flag[2:].replace("-", "_"))]
    if given:
        raise SystemExit(f"multi-process (--tp) serving does not support {', '.join(given)} "
                         "(ROADMAP A.12)")


def build_service(args: argparse.Namespace, mesh=None) -> ServingService:
    """Load the checkpoint and assemble the service (no port is bound).
    With ``mesh`` (tp > 1) every model is cut into this rank's part on the
    rank's device."""
    device = resolve_device(args.platform)
    if mesh is not None:
        device = rank_device(args.platform)
    if not (args.model or args.encoder):
        raise SystemExit("need --model and/or --encoder")

    def shard(model):
        try:
            return model if mesh is None else shard_model(model, mesh)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    overrides = {"dtype": args.dtype} if args.dtype else {}
    tok = JsonTokenizer(args.tokenizer_json) if args.tokenizer_json else WorldTokenizer(args.vocab)
    engine = encoder = batcher = states = bi = cross = spec = None
    if (args.bi_adapter or args.cross_adapter) and not args.model:
        raise SystemExit("--bi-adapter and --cross-adapter need --model")
    if args.model:
        cfg = _config(args.model, overrides)
        try:
            refuse_chunk_dependent(cfg, "serve.cli")
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if cfg.version < 5 and (args.bi_adapter or args.cross_adapter or args.states_config):
            raise SystemExit(
                "--bi-adapter, --cross-adapter and --states-config need an RWKV-5/6 model: this "
                "checkpoint is RWKV-4, which gives logits only and has no (H, N, N) WKV state")
        lc = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)

        def merged(path):
            """The checkpoint's weights with the LoRA at `path` merged in,
            unquantized, and the adapter file's state dict."""
            sd = _load(path)
            model, _ = load_rwkv_checkpoint(args.model, device=device, **overrides)
            return merge_lora(apply_lora(model, lc, lora_state_dict_to_tree(sd))), sd

        if args.bi_adapter:
            bi = BiEncoder(shard(merged(args.bi_adapter)[0]), tok, pooling_type=args.bi_pooling)
        if args.cross_adapter:
            cross_model, sd = merged(args.cross_adapter)
            head = score_head_from_state_dict(sd, device=device)
            if head is None and args.cross_head:
                head = score_head_from_state_dict(_load(args.cross_head), device=device)
            if head is None:
                raise SystemExit("--cross-adapter needs score.weight (in the adapter or via "
                                 "--cross-head)")
            cross = CrossEncoder(shard(cross_model), tok, head)
        if args.pissa_init and not args.chat_adapter:
            raise SystemExit("--pissa-init needs --chat-adapter")
        if args.chat_adapter:
            # merged into the checkpoint's weights, then quantized
            model, cfg = load_rwkv_checkpoint(args.model, device=device, **overrides)
            if args.pissa_init:
                merge_pissa(model, _adapter(args.chat_adapter), _adapter(args.pissa_init),
                            LoraConfig(r=args.lora_r, alpha=args.lora_alpha, pissa=True))
            else:
                merge_lora(apply_lora(model, lc, _adapter(args.chat_adapter)))
            if args.quant:
                quantize_model(model, args.quant)
        else:
            model, cfg = load_rwkv_checkpoint(args.model, device=device, quant=args.quant,
                                              **overrides)
        adapter_ids = None
        if args.slot_adapter:
            named = {}
            for spec in args.slot_adapter:
                name, _, path = spec.partition("=")
                if not name or not path:
                    raise SystemExit(f"--slot-adapter expects NAME=PATH, got {spec!r}")
                named[name] = _adapter(path)
            model, adapter_ids = build_slot_lora(model, named, lc)
        cache = PrefixStateCache(capacity=args.prefix_cache) if args.prefix_cache else None
        try:
            engine = GenerationEngine(model, tok, state_cache=cache, adapter_ids=adapter_ids,
                                      mesh=mesh)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if args.states_config:
            states = StatesRegistry(cfg, device=device)
            with open(args.states_config) as f:
                for name, spec in json.load(f).items():
                    states.register_pth(name, spec["path"], spec.get("template", "{input}"))
        if args.batcher_slots:
            batcher = ContinuousBatcher(engine, n_slots=args.batcher_slots,
                                        block_size=args.batcher_block,
                                        adaptive_block=args.batcher_adaptive)
        elif args.draft or args.draft_layers:
            try:
                draft = (load_rwkv_checkpoint(args.draft, device=device, **overrides)[0]
                         if args.draft else truncated_draft(model, args.draft_layers))
                spec = SpeculativeEngine(model, draft, tok, gamma=args.gamma)
            except ValueError as e:
                raise SystemExit(f"speculative decoding: {e}") from None
    elif args.draft or args.draft_layers:
        raise SystemExit("--draft and --draft-layers need --model")
    if args.encoder:
        encoder, _ = load_rwkv_checkpoint(args.encoder, device=device, **overrides)
    return ServingService(engine=engine, bi_encoder=bi, cross_encoder=cross, encoder=encoder,
                          tokenizer=tok, batcher=batcher, states_registry=states,
                          spec_engine=spec)


def _config(path: str, overrides: dict):
    """The checkpoint's config, read without loading its tensors where the
    file allows a memory map (files that torch.save wrote)."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:
        sd = _load(path)
    return checkpoint_config(sd, **overrides)


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _adapter(path: str):
    """A LoRA .pth (reference or peft keys) as an adapter dict."""
    return lora_state_dict_to_tree(_load(path))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if (args.tp > 1 or args.coordinator or args.num_processes
            or os.environ.get("RWKV_DIST") == "1"):
        serve_multiprocess(args, argv)
        return
    service = build_service(args)
    server = serve_http(service, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


def _start_workers(args: argparse.Namespace, argv: list) -> tuple:
    """On one host: the tp - 1 other ranks as processes of this command
    with a file rendezvous in a fresh directory. Returns (processes,
    directory)."""
    tmp = tempfile.mkdtemp(prefix="rwkv_tp_")
    args.coordinator = "file://" + os.path.join(tmp, "rendezvous")
    args.num_processes, args.process_id = args.tp, 0
    workers = [
        subprocess.Popen([sys.executable, "-m", "rwkv_lm_ext_tpu_torch.serve.cli", *argv,
                          "--coordinator", args.coordinator, "--num-processes", str(args.tp),
                          "--process-id", str(rank)])
        for rank in range(1, args.tp)]
    return workers, tmp


def serve_multiprocess(args: argparse.Namespace, argv: list) -> None:
    """One rank of the tensor-parallel server (module docstring): rank 0
    serves HTTP, the others replay its op stream. Rank 0 started by ``--tp``
    alone starts the others and, at shutdown (also on SIGTERM), stops the
    stream and waits for them (killing one that outstays WORKER_EXIT_S)."""
    refuse_under_tp(args)
    local = (args.tp > 1 and args.coordinator is None and args.num_processes is None
             and not os.environ.get("RWKV_COORDINATOR"))
    workers, tmp = _start_workers(args, argv) if local else ([], None)
    signal.signal(signal.SIGTERM, _exit_on_signal)
    try:
        init_distributed(args.coordinator, args.num_processes, args.process_id,
                         platform=args.platform)
        if args.tp != process_count():
            raise SystemExit(f"--tp {args.tp} must be the number of processes "
                             f"({process_count()}): serving takes dp = 1")
        mesh = make_mesh(dp=1, tp=args.tp)
        service = build_service(args, mesh=mesh)
        if is_main_process():
            _serve_rank0(service, args)
        else:
            service.driver_factory = lambda batcher: None
            service.warmup()
            LockstepBatcherDriver(service.batcher, svc_handle=service.handle).worker_loop()
    finally:
        for w in workers:
            try:
                w.wait(timeout=WORKER_EXIT_S)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        _leave_group()


def _leave_group() -> None:
    """Leave the process group, or exit at once if that takes more than
    TEARDOWN_S: no rank outlives its server."""
    leave_within(TEARDOWN_S)


def _exit_on_signal(signum, frame):
    raise SystemExit(128 + signum)


def _serve_rank0(service: ServingService, args: argparse.Namespace) -> None:
    """Warm up (every rank runs the same warm-up), start the op stream and
    serve: /generate through the batcher's lockstep driver (or, without a
    batcher, on the stream like every other endpoint), /stats and unknown
    routes locally."""
    inner = service.handle
    if service.batcher is not None:
        service.driver_factory = lambda batcher: LockstepBatcherDriver(batcher, svc_handle=inner)
    server = serve_http(service, host=args.host, port=args.port)
    driver = service._driver
    if driver is None:
        driver = LockstepBatcherDriver(None, svc_handle=inner)

        def refuse_stream(payload):
            raise BadRequest("streaming needs --batcher-slots in multi-process serving")

        service.generate_sse = refuse_stream

    def handle(route, payload):
        if route == "/stats" or route not in service.routes or (
                route == "/generate" and service.batcher is not None):
            return inner(route, payload)
        try:
            return driver.call(route, payload)
        except PayloadTooLarge as e:
            raise BadRequest(str(e)) from None

    service.handle = handle
    print(f"route: {json.dumps(service.engine.route() if service.engine else {})}", flush=True)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        driver.close()


if __name__ == "__main__":
    main()
