"""Serving CLI: one command from a checkpoint to an HTTP generation server.

Counterpart of rwkv_lm_ext_tpu/serve/cli.py:38-121, 134-227 and 305-325
with the plain generation engine:

  python -m rwkv_lm_ext_tpu_torch.serve.cli --model m.pth [--quant int8c]

``--quant`` quantizes the generation base's block projections (int8:
dequantized on use; int8c: int8 products with dynamic per-row activation
quantization). ``--platform`` is the torch device: ``cuda`` by default,
``cpu`` only when asked. The flags for LoRA adapters, states, encoders, the
continuous batcher, speculative decoding, tensor parallelism and multi-host
serving wait for later slices.
"""
from __future__ import annotations

import argparse

import torch

from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="rwkv_lm_ext_tpu_torch.serve.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--model", required=True, help="RWKV-6 .pth for generation")
    p.add_argument("--vocab", default=None, help="world-vocabulary path")
    p.add_argument("--dtype", default=None, help="compute dtype override (e.g. float32)")
    p.add_argument("--quant", default=None, choices=("int8", "int8c"),
                   help="quantize the generation base's block projections")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="torch device to serve on")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    return p.parse_args(argv)


def build_service(args: argparse.Namespace) -> ServingService:
    """Load the checkpoint and assemble the service (no port is bound)."""
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda: no CUDA device (use --platform cpu for a CPU run)")
    overrides = {"dtype": args.dtype} if args.dtype else {}
    model, _ = load_rwkv_checkpoint(
        args.model, device=torch.device(args.platform), quant=args.quant, **overrides
    )
    tok = WorldTokenizer(args.vocab)
    return ServingService(engine=GenerationEngine(model, tok))


def main(argv=None) -> None:
    args = parse_args(argv)
    server = serve_http(build_service(args), host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
