"""Embedding, generation and fill-mask service over JSON HTTP.

Counterpart of rwkv_lm_ext_tpu/serve/api.py:42-451 and 454-590 with a
bi-encoder, a generation engine and a bidirectional encoder:

- POST /embed {"texts": [...]}, POST /similarity {"texts_a", "texts_b"};
- POST /fill_mask {"text", "top_k", "cumulative_prob"}: the text is split at
  each ``[MASK]``, encoded with an emb terminator, padded to a bucket of
  32 ... 2048 and run through the bidirectional encoder and its tied MLM
  head; every mask slot answers its candidates in descending probability
  until their sum reaches the cutoff, at most top_k;
- POST /generate {"prompt", "max_tokens", sampling knobs}: blocking, or with
  "stream": true as text/event-stream, one ``data: {"token": piece}`` event
  per UTF-8-safe piece and a final ``data: {"done": true, "output": ...,
  "backend": "engine"}``; a client that disconnects cancels the generation;
- POST /stats: request counts per route and ``generate_latency_ms``.

A route whose backend is not configured answers 404, like an unknown one,
and neither is counted. A malformed payload answers 400. Transport: the
standard library's ThreadingHTTPServer; one lock serialises the model's
work. The blocking /generate fetches tokens every 16 decode steps; the
stream fetches every step, so each token streams as it is produced.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.config import EMB_ID, MASK_ID
from rwkv_lm_ext_tpu_torch.infer.encoders import bucketize, pad_batch
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.models.bidirectional import encoder_forward
from rwkv_lm_ext_tpu_torch.models.heads import mlm_logits

MASK_TOKEN = "[MASK]"

# decode steps between host fetches for a blocking /generate; a stream
# takes 1 so that every token goes out as soon as it exists
BLOCKING_BLOCK_SIZE = 16
# sampling knobs a /generate request may set (serve/api.py:126-129)
PER_REQUEST_KNOBS = (
    "temperature", "top_p", "alpha_presence", "alpha_frequency",
    "alpha_decay", "repetition_penalty", "token_stop",
)


class UnknownRoute(Exception):
    pass


class BadRequest(Exception):
    pass


class _ClientDisconnected(Exception):
    """Raised inside a streaming callback to stop a generation whose client
    went away."""


def _texts(payload: Dict, field: str) -> List[str]:
    if field not in payload:
        raise BadRequest(f"missing field {field!r}")
    texts = payload[field]
    if (
        not isinstance(texts, list)
        or not texts
        or not all(isinstance(t, str) and t for t in texts)
    ):
        # an empty text pools over zero tokens (a division by zero)
        raise BadRequest(f"{field!r} must be a non-empty list of non-empty strings")
    return texts


def _sse(obj: Dict) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


class ServingService:
    def __init__(self, *, engine=None, bi_encoder=None, encoder=None, tokenizer=None,
                 mask_id: int = MASK_ID):
        """``encoder`` is an RWKV module served as the bidirectional encoder
        behind /fill_mask; it needs ``tokenizer``."""
        if encoder is not None and tokenizer is None:
            raise ValueError("an encoder needs a tokenizer")
        self.engine = engine
        self.bi = bi_encoder
        self.encoder = encoder
        self.tokenizer = tokenizer
        self.mask_id = mask_id
        self._lock = threading.Lock()          # one model call at a time
        self._stats_lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        # /generate latencies in seconds per backend, the last 512
        self._latencies: Dict[str, deque] = {}
        self.routes = {"/stats"}
        if bi_encoder is not None:
            self.routes |= {"/embed", "/similarity"}
        if engine is not None:
            self.routes.add("/generate")
        if encoder is not None:
            self.routes.add("/fill_mask")

    def warmup(self) -> None:
        """Run one short request per backend from the calling thread, so
        the kernel library is built before the first client arrives."""
        if self.bi is not None:
            self.bi.encode_texts(["warmup"])
        if self.engine is not None:
            self.engine.generate("warmup", max_tokens=2)
        if self.encoder is not None:
            self.fill_mask(f"warm {MASK_TOKEN} up")

    def embed(self, texts: List[str]) -> Dict:
        with self._lock:
            e = self.bi.encode_texts(texts)
        return {"embeddings": e.tolist()}

    def similarity(self, texts_a: List[str], texts_b: List[str]) -> Dict:
        with self._lock:
            ea = self.bi.encode_texts(texts_a)
            eb = self.bi.encode_texts(texts_b)
        return {"similarity": (ea @ eb.T).tolist()}

    def fill_mask(self, text: str, *, top_k: int = 10, cumulative_prob: float = 0.95,
                  reference: bool = False) -> Dict:
        """``[MASK]`` slots -> {"masks": [[{"token", "token_id", "prob"},
        ...], ...]}, one candidate list a slot. ``reference`` runs the
        kernels' plain versions."""
        parts = text.split(MASK_TOKEN)
        ids: List[int] = []
        mask_positions: List[int] = []
        for i, part in enumerate(parts):
            ids.extend(self.tokenizer.encode(part) if part else [])
            if i < len(parts) - 1:
                mask_positions.append(len(ids))
                ids.append(self.mask_id)
        ids.append(EMB_ID)   # emb terminator
        tokens = torch.from_numpy(pad_batch([ids], bucketize([ids])))
        with self._lock, torch.inference_mode():
            tokens = tokens.to(self.encoder.emb.weight.device)
            hidden = encoder_forward(self.encoder, tokens, reference=reference)
            probs_dev = torch.softmax(mlm_logits(self.encoder, hidden), dim=-1)
        probs = probs_dev[0].cpu().numpy().astype(np.float64)
        results = []
        for pos in mask_positions:
            p = probs[pos]
            cands, acc = [], 0.0
            for tok in np.argsort(-p)[:top_k]:
                cands.append({"token": self.tokenizer.decode([int(tok)]),
                              "token_id": int(tok), "prob": float(p[tok])})
                acc += float(p[tok])
                if acc >= cumulative_prob:
                    break
            results.append(cands)
        return {"masks": results}

    def _fill_mask_args(self, payload: Dict) -> Dict:
        text = payload.get("text")
        if not isinstance(text, str):
            raise BadRequest("'text' must be a string")
        try:
            return dict(text=text, top_k=int(payload.get("top_k", 10)),
                        cumulative_prob=float(payload.get("cumulative_prob", 0.95)))
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad fill_mask option: {e}") from e

    def _generate_args(self, payload: Dict):
        """Validate a /generate payload: (prompt, max_tokens,
        SamplingParams). Unknown options answer 400."""
        prompt = payload.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise BadRequest("'prompt' must be a non-empty string")
        opts = {k: v for k, v in payload.items() if k not in ("prompt", "stream")}
        unknown = set(opts) - {"max_tokens", *PER_REQUEST_KNOBS}
        if unknown:
            raise BadRequest(f"unsupported generate options: {sorted(unknown)}")
        try:
            max_tokens = int(opts.pop("max_tokens", 128))
            if "token_stop" in opts:
                opts["token_stop"] = tuple(int(t) for t in opts["token_stop"])
            knobs = {k: (v if k == "token_stop" else float(v)) for k, v in opts.items()}
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad generate option: {e}") from e
        if max_tokens < 0:
            raise BadRequest("'max_tokens' must be >= 0")
        return prompt, max_tokens, SamplingParams(**knobs)

    def generate(self, payload: Dict, *, stream_cb=None, cancel_event=None) -> Dict:
        """Run one /generate request. ``stream_cb(piece)`` receives text
        pieces as they are produced (one decode step between fetches);
        ``cancel_event``, once set, stops the generation at its next piece
        and the answer carries "cancelled": true."""
        prompt, max_tokens, sampling = self._generate_args(payload)
        t0 = time.perf_counter()
        callback = stream_cb
        if cancel_event is not None and stream_cb is not None:
            def callback(piece):
                if cancel_event.is_set():
                    raise _ClientDisconnected()
                stream_cb(piece)
        result = {"backend": "engine"}
        try:
            with self._lock:
                result["output"] = self.engine.generate(
                    prompt, max_tokens=max_tokens, sampling=sampling, callback=callback,
                    block_size=1 if stream_cb is not None else BLOCKING_BLOCK_SIZE,
                )
        except _ClientDisconnected:
            result.update(output=None, cancelled=True)
        with self._stats_lock:
            self._latencies.setdefault("engine", deque(maxlen=512)).append(
                time.perf_counter() - t0)
        return result

    def generate_sse(self, payload: Dict) -> Iterator[bytes]:
        """Server-sent events of a streaming /generate. Validates first, so
        a bad request raises BadRequest before the first byte; a failure
        mid-stream is sent as a final {"error": ...} event. Closing the
        iterator (the client went away) cancels the generation."""
        self._generate_args(payload)
        self._count("/generate")
        pieces: "queue.SimpleQueue" = queue.SimpleQueue()
        client_gone = threading.Event()

        def worker():
            try:
                result = self.generate(
                    payload, stream_cb=lambda piece: pieces.put(("token", piece)),
                    cancel_event=client_gone,
                )
                pieces.put(("done", result))
            except Exception as e:  # noqa: BLE001 - reported to the client
                pieces.put(("error", str(e)))

        def events():
            thread = threading.Thread(target=worker, daemon=True)
            thread.start()
            try:
                while True:
                    kind, value = pieces.get()
                    if kind == "token":
                        yield _sse({"token": value})
                    elif kind == "done":
                        yield _sse({"done": True, **value})
                        return
                    else:
                        yield _sse({"error": value})
                        return
            finally:
                client_gone.set()

        return events()

    def stats(self) -> Dict:
        with self._stats_lock:
            out: Dict = {"requests": dict(self._counts)}
            lat = {k: list(v) for k, v in self._latencies.items()}
        if lat:
            out["generate_latency_ms"] = {
                backend: {
                    "count": len(xs),
                    **{f"p{q}": round(float(np.percentile(xs, q)) * 1e3, 1) for q in (50, 95, 99)},
                }
                for backend, xs in lat.items()
            }
        return out

    def _count(self, route: str) -> None:
        with self._stats_lock:
            self._counts[route] = self._counts.get(route, 0) + 1

    def handle(self, route: str, payload: Dict) -> Dict:
        if route not in self.routes:
            # not counted: the paths clients send are unbounded
            raise UnknownRoute(route)
        self._count(route)
        if not isinstance(payload, dict):
            raise BadRequest("payload must be a JSON object")
        if route == "/stats":
            return self.stats()
        if route == "/embed":
            return self.embed(_texts(payload, "texts"))
        if route == "/similarity":
            return self.similarity(_texts(payload, "texts_a"), _texts(payload, "texts_b"))
        if route == "/fill_mask":
            return self.fill_mask(**self._fill_mask_args(payload))
        if payload.get("stream"):
            raise BadRequest("stream=true needs the SSE transport (serve_http)")
        return self.generate(payload)


def serve_http(
    service: ServingService,
    host: str = "0.0.0.0",
    port: int = 8000,
) -> ThreadingHTTPServer:
    """Warm the service up, then build the JSON HTTP server (port=0 picks a
    free port). Run it with ``serve_forever()`` and stop it with
    ``shutdown()`` from another thread."""
    service.warmup()

    class Handler(BaseHTTPRequestHandler):
        def _payload(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # bad length, JSON or UTF-8
                raise BadRequest(f"malformed request body: {e}") from e

        def _stream(self, events) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for chunk in events:
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except OSError:
                pass  # the client went away; closing the events cancels
            finally:
                events.close()

        def do_POST(self):
            try:
                payload = self._payload()
                if (self.path == "/generate" and self.path in service.routes
                        and isinstance(payload, dict) and payload.get("stream")):
                    self._stream(service.generate_sse(payload))
                    return
                result = service.handle(self.path, payload)
                body = json.dumps(result).encode()
                self.send_response(200)
            except UnknownRoute:
                body = b'{"error": "unknown route"}'
                self.send_response(404)
            except BadRequest as e:
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
            except Exception as e:  # noqa: BLE001 - the server keeps serving
                self.log_error("request failed: %r", e)
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_request(self, *args):
            pass  # errors still reach stderr through log_error

    return ThreadingHTTPServer((host, port), Handler)
