"""Serving CLI: one command from a checkpoint to an HTTP server.

Counterpart of rwkv_lm_ext_tpu/serve/cli.py:38-121, 134-227 and 286-325
with the generation engine, its LoRA adapters (merged and per request),
named states, the continuous batcher, the prefix cache and the
bidirectional encoder:

  python -m rwkv_lm_ext_tpu_torch.serve.cli --model m.pth [--quant int8c] \
      [--chat-adapter chat.pth] [--slot-adapter a=a.pth --slot-adapter b=b.pth] \
      [--lora-r 8 --lora-alpha 32] [--states-config states.json] \
      [--batcher-slots 16 --batcher-block 16] [--prefix-cache 8]
  python -m rwkv_lm_ext_tpu_torch.serve.cli --encoder enc.pth

states.json maps action names to state-tuning checkpoints and templates:
  {"summarize": {"path": "states/sum.pth", "template": "sum: {input}"}}

``--model`` serves /generate; ``--encoder`` (a bidirectional encoder's .pth,
as ``train.cli mlm`` writes it) serves /fill_mask; one of the two is needed.

``--quant`` quantizes the generation base's block projections (int8:
dequantized on use; int8c: int8 products with dynamic per-row activation
quantization). ``--chat-adapter`` merges a LoRA into the base before
that; each ``--slot-adapter NAME=PATH`` is served per request (/generate
{"adapter": NAME}) on the same base, unmerged, so requests under different
adapters share the batcher's step. ``--platform`` is the torch device:
``cuda`` by default, ``cpu`` only when asked. ``--draft`` (speculative
decoding), ``--tp``, ``--pissa-init``, ``--tokenizer-json``, the bi- and
cross-encoders and multi-host serving wait for later slices.
"""
from __future__ import annotations

import argparse
import json

import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    lora_state_dict_to_tree,
    merge_lora,
)
from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import build_slot_lora
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache
from rwkv_lm_ext_tpu_torch.infer.states_registry import StatesRegistry
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="rwkv_lm_ext_tpu_torch.serve.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--model", default=None, help="RWKV-6 .pth for generation")
    p.add_argument("--encoder", default=None,
                   help="bidirectional encoder .pth for /fill_mask")
    p.add_argument("--vocab", default=None, help="world-vocabulary path")
    p.add_argument("--dtype", default=None, help="compute dtype override (e.g. float32)")
    p.add_argument("--quant", default=None, choices=("int8", "int8c"),
                   help="quantize the generation base's block projections")
    p.add_argument("--chat-adapter", default=None,
                   help="LoRA .pth merged into the generation base")
    p.add_argument("--slot-adapter", action="append", default=None, metavar="NAME=PATH",
                   help="repeatable: a named LoRA served per request on the same base "
                        '(/generate {"adapter": NAME}), not merged; uses --lora-r/--lora-alpha')
    p.add_argument("--lora-r", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=32.0)
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
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="torch device to serve on")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    return p.parse_args(argv)


def build_service(args: argparse.Namespace) -> ServingService:
    """Load the checkpoint and assemble the service (no port is bound)."""
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda: no CUDA device (use --platform cpu for a CPU run)")
    if not (args.model or args.encoder):
        raise SystemExit("need --model and/or --encoder")
    overrides = {"dtype": args.dtype} if args.dtype else {}
    device = torch.device(args.platform)
    tok = WorldTokenizer(args.vocab)
    engine = encoder = batcher = states = None
    if args.model:
        lc = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
        if args.chat_adapter:
            # merged into the checkpoint's weights, then quantized
            model, cfg = load_rwkv_checkpoint(args.model, device=device, **overrides)
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
        engine = GenerationEngine(model, tok, state_cache=cache, adapter_ids=adapter_ids)
        if args.states_config:
            states = StatesRegistry(cfg, device=device)
            with open(args.states_config) as f:
                for name, spec in json.load(f).items():
                    states.register_pth(name, spec["path"], spec.get("template", "{input}"))
        if args.batcher_slots:
            batcher = ContinuousBatcher(engine, n_slots=args.batcher_slots,
                                        block_size=args.batcher_block,
                                        adaptive_block=args.batcher_adaptive)
    if args.encoder:
        encoder, _ = load_rwkv_checkpoint(args.encoder, device=device, **overrides)
    return ServingService(engine=engine, encoder=encoder, tokenizer=tok, batcher=batcher,
                          states_registry=states)


def _adapter(path: str):
    """A LoRA .pth (reference or peft keys) as an adapter dict."""
    return lora_state_dict_to_tree(torch.load(path, map_location="cpu", weights_only=True))


def main(argv=None) -> None:
    args = parse_args(argv)
    service = build_service(args)
    server = serve_http(service, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
