"""Embedding, reranking, generation and fill-mask service over JSON HTTP.

Counterpart of rwkv_lm_ext_tpu/serve/api.py:40-495 and 554-609 with a
bi-encoder, a cross-encoder, a generation engine (alone or behind a
continuous batcher or beside a speculative engine), a states registry and a
bidirectional encoder:

- POST /embed {"texts": [...]}, POST /similarity {"texts_a", "texts_b"};
- POST /rerank {"query", "documents": [...]}: {"scores": one a document,
  "ranking": the documents' indices by descending score} (JAX
  serve/api.py:404-413);
- POST /fill_mask {"text", "top_k", "cumulative_prob"}: the text is split at
  each ``[MASK]``, encoded with an emb terminator, padded to a bucket of
  32 ... 2048 and run through the bidirectional encoder and its tied MLM
  head; every mask slot answers its candidates in descending probability
  until their sum reaches the cutoff, at most top_k;
- POST /generate {"prompt", "max_tokens", "adapter", sampling knobs}:
  blocking, or with "stream": true as text/event-stream, one ``data:
  {"token": piece}`` event per UTF-8-safe piece and a final ``data: {"done":
  true, "output": ..., "backend": ...}``; a client that disconnects cancels
  the generation. With a batcher the request joins its pool through a
  BatcherDriver (``"backend": "batcher"``); else, with a speculative engine,
  a request without an adapter and without occurrence or repetition
  penalties runs on it (``"backend": "speculative"``, JAX serve/api.py:232-258);
  else the engine runs it under the service's lock (``"backend": "engine"``);
  the per-request knobs mean the same on all three. ``adapter`` names a
  slot-LoRA adapter (400 for an unknown one);
- POST /process_text {"text", "action"}: generation from the named
  state-tuned state ``action`` of the states registry, on its template;
- POST /stats (and GET /stats): request counts per route, the engine's
  route (its device, graph or eager decode blocks and, under tensor
  parallelism, tp, rank and backend), per-backend
  ``generate_latency_ms`` percentiles, the batcher's occupancy, the
  speculative engine's rounds, proposed and accepted tokens and acceptance,
  the prefix cache's counts and the adapters served;
- GET /: the browser chat page (serve/webui.py).

``make_fastapi_app`` (JAX :591-609) wraps the same routes in FastAPI, which is
imported only there and is not a dependency.

A route whose backend is not configured answers 404, like an unknown one,
and neither is counted. A malformed payload answers 400. Transport: the
standard library's ThreadingHTTPServer; one lock serialises the model's
work; the batcher's thread takes the engine's own lock. The blocking
engine /generate fetches tokens every 16 decode steps; its stream fetches
every step, so each token streams as it is produced.
"""
from __future__ import annotations

import dataclasses
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
from rwkv_lm_ext_tpu_torch.infer.continuous import BatcherDriver
from rwkv_lm_ext_tpu_torch.infer.encoders import bucketize, pad_batch
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.models.bidirectional import encoder_forward
from rwkv_lm_ext_tpu_torch.models.heads import mlm_logits
from rwkv_lm_ext_tpu_torch.serve.webui import INDEX_HTML

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


def _token_pieces(tok, stream_cb, cancel_event=None):
    """(callback, finish) that turn emitted token ids into UTF-8-safe text
    pieces for ``stream_cb``, or (None, None) without one. ``callback``
    raises _ClientDisconnected once ``cancel_event`` is set (the speculative
    loop runs in the request's thread; the batcher's cancels by its event)."""
    if stream_cb is None:
        return None, None
    decoder = tok.streaming_decoder()

    def callback(t: int) -> None:
        if cancel_event is not None and cancel_event.is_set():
            raise _ClientDisconnected()
        piece = decoder.push(t)
        if piece:
            stream_cb(piece)

    def finish() -> None:
        tail = decoder.flush()
        if tail:
            stream_cb(tail)

    return callback, finish


class ServingService:
    def __init__(self, *, engine=None, bi_encoder=None, cross_encoder=None, encoder=None,
                 tokenizer=None, mask_id: int = MASK_ID, batcher=None, states_registry=None,
                 spec_engine=None, driver_factory=None):
        """``cross_encoder`` (infer.encoders.CrossEncoder) serves /rerank.
        ``encoder`` is an RWKV module served as the bidirectional encoder
        behind /fill_mask; it needs ``tokenizer``. ``batcher`` (a
        ContinuousBatcher over ``engine``) serves /generate once ``warmup``
        has started its driver; ``states_registry`` serves /process_text;
        ``spec_engine`` (infer.speculative.SpeculativeEngine over the
        engine's model) serves the penalty-free /generate requests without an
        adapter when there is no batcher. ``driver_factory`` (batcher ->
        driver, JAX serve/api.py:56) makes the batcher's driver at warm-up:
        BatcherDriver by default; the multi-process server passes
        infer.continuous.LockstepBatcherDriver on process 0 and a factory
        of no driver on the others."""
        if encoder is not None and tokenizer is None:
            raise ValueError("an encoder needs a tokenizer")
        if (batcher is not None or states_registry is not None
                or spec_engine is not None) and engine is None:
            raise ValueError("a batcher, a states registry or a speculative engine needs the "
                             "engine")
        self.engine = engine
        self.bi = bi_encoder
        self.cross = cross_encoder
        self.encoder = encoder
        self.tokenizer = tokenizer
        self.mask_id = mask_id
        self.batcher = batcher
        self.states = states_registry
        self.spec = spec_engine
        self.driver_factory = driver_factory
        self._driver = None
        self._lock = threading.Lock()          # one model call at a time
        self._stats_lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        # /generate latencies in seconds per backend, the last 512
        self._latencies: Dict[str, deque] = {}
        self._spec_totals = {"rounds": 0, "proposed": 0, "accepted": 0}
        self.routes = {"/stats"}
        if bi_encoder is not None:
            self.routes |= {"/embed", "/similarity"}
        if cross_encoder is not None:
            self.routes.add("/rerank")
        if engine is not None:
            self.routes.add("/generate")
        if states_registry is not None:
            self.routes.add("/process_text")
        if encoder is not None:
            self.routes.add("/fill_mask")

    def warmup(self) -> None:
        """Run one short request per backend from the calling thread, so
        the kernel library is built (and the engine's and the batcher's
        graphs captured) before the first client arrives; then start the
        batcher's driver."""
        if self.bi is not None:
            self.bi.encode_texts(["warmup"])
        if self.cross is not None:
            self.cross.score_pairs([("warm", "up")])
        if self.engine is not None:
            for block in (BLOCKING_BLOCK_SIZE, 1):     # blocking, streaming
                self.engine.generate("warmup", max_tokens=2, block_size=block)
        if self.spec is not None and self.batcher is None:
            # a greedy round and its rollback: captures both graphs
            self.spec.generate([0], max_tokens=2, token_stop=())
        if self.encoder is not None:
            self.fill_mask(f"warm {MASK_TOKEN} up")
        if self.batcher is not None and self._driver is None:
            self.batcher.warmup()
            self._driver = (self.driver_factory or BatcherDriver)(self.batcher)

    def close(self) -> None:
        """Stop the batcher's driver thread, if one runs."""
        if self._driver is not None:
            self._driver.close()
            self._driver = None

    def embed(self, texts: List[str]) -> Dict:
        with self._lock:
            e = self.bi.encode_texts(texts)
        return {"embeddings": e.tolist()}

    def similarity(self, texts_a: List[str], texts_b: List[str]) -> Dict:
        with self._lock:
            ea = self.bi.encode_texts(texts_a)
            eb = self.bi.encode_texts(texts_b)
        return {"similarity": (ea @ eb.T).tolist()}

    def rerank(self, query: str, documents: List[str]) -> Dict:
        """Scores of (query, document) pairs and the documents' indices by
        descending score."""
        with self._lock:
            scores = self.cross.score_pairs([(query, d) for d in documents])
        return {"scores": scores.tolist(), "ranking": np.argsort(-scores).tolist()}

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
        """Validate a /generate payload: (prompt, max_tokens, the sampling
        knobs it sets, adapter). Unknown options and adapters answer 400."""
        prompt = payload.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise BadRequest("'prompt' must be a non-empty string")
        opts = {k: v for k, v in payload.items() if k not in ("prompt", "stream")}
        unknown = set(opts) - {"max_tokens", "adapter", *PER_REQUEST_KNOBS}
        if unknown:
            raise BadRequest(f"unsupported generate options: {sorted(unknown)}")
        adapter = opts.pop("adapter", None)
        if adapter is not None and not isinstance(adapter, str):
            raise BadRequest("'adapter' must be a string")
        try:
            max_tokens = int(opts.pop("max_tokens", 128))
            if "token_stop" in opts:
                opts["token_stop"] = tuple(int(t) for t in opts["token_stop"])
            knobs = {k: (v if k == "token_stop" else float(v)) for k, v in opts.items()}
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad generate option: {e}") from e
        try:
            self.engine.adapter_id(adapter)
        except ValueError as e:
            raise BadRequest(f"{e}; serving {sorted(self.engine.adapter_ids or {}) or ['base']}"
                             ) from e
        if max_tokens < 0:
            raise BadRequest("'max_tokens' must be >= 0")
        return prompt, max_tokens, knobs, adapter

    def generate(self, payload: Dict, *, stream_cb=None, cancel_event=None) -> Dict:
        """Run one /generate request. ``stream_cb(piece)`` receives text
        pieces as they are produced (one decode step between fetches on the
        engine, one block on the batcher); ``cancel_event``, once set, stops
        the generation and the answer carries "cancelled": true."""
        prompt, max_tokens, knobs, adapter = self._generate_args(payload)
        t0 = time.perf_counter()
        if self._driver is not None:
            result = self._generate_batched(prompt, max_tokens, knobs, adapter, stream_cb,
                                            cancel_event)
        elif self._speculative(knobs, adapter):
            result = self._generate_speculative(prompt, max_tokens, knobs, stream_cb,
                                                cancel_event)
        else:
            result = self._generate_engine(prompt, max_tokens, knobs, adapter, stream_cb,
                                           cancel_event)
        with self._stats_lock:
            self._latencies.setdefault(result["backend"], deque(maxlen=512)).append(
                time.perf_counter() - t0)
        return result

    def _generate_batched(self, prompt, max_tokens, knobs, adapter, stream_cb, cancel_event):
        """Through the batcher's driver: concurrent requests, also with
        different adapters, share its batched decode."""
        sampling = dataclasses.replace(self.batcher.sampling, **knobs) if knobs else None
        tok = self.engine.tokenizer
        callback, finish = _token_pieces(tok, stream_cb)
        try:
            ids = self._driver.submit_and_wait(prompt, max_tokens=max_tokens, sampling=sampling,
                                               callback=callback, adapter=adapter,
                                               cancel=cancel_event)
        except ValueError as e:        # refused by submit (e.g. too many stop tokens)
            raise BadRequest(str(e)) from e
        if finish is not None:
            finish()
        result = {"output": tok.decode(ids), "backend": "batcher"}
        if cancel_event is not None and cancel_event.is_set():
            result["cancelled"] = True
        return result

    def _speculative(self, knobs, adapter) -> bool:
        """Whether a request goes to the speculative engine: there is one, the
        request names no adapter, sets no occurrence or repetition penalty
        (the defaults carry the presence and frequency penalties) and is not
        a greedy one with a ``token_ban`` (greedy rounds verify by the raw
        argmax, so the engine serves that)."""
        if self.spec is None or adapter is not None:
            return False
        sp = SamplingParams(**knobs)
        return (sp.alpha_presence == 0.0 and sp.alpha_frequency == 0.0
                and sp.repetition_penalty == 1.0
                and not (sp.temperature == 0.0 and sp.token_ban))

    def _generate_speculative(self, prompt, max_tokens, knobs, stream_cb, cancel_event):
        """On the speculative engine under the service's lock, streaming
        UTF-8-safe pieces of the emitted ids."""
        sp = SamplingParams(**knobs)
        callback, finish = _token_pieces(self.spec.tokenizer, stream_cb, cancel_event)
        result = {"backend": "speculative"}
        try:
            with self._lock:
                result["output"], st = self.spec.generate(
                    prompt, max_tokens=max_tokens, sampling=sp, return_stats=True,
                    callback=callback)
        except _ClientDisconnected:
            result.update(output=None, cancelled=True)
            return result
        if finish is not None:
            finish()
        with self._stats_lock:
            for key in self._spec_totals:
                self._spec_totals[key] += getattr(st, key)
        return result

    def _generate_engine(self, prompt, max_tokens, knobs, adapter, stream_cb, cancel_event):
        """On the engine under the service's lock."""
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
                    prompt, max_tokens=max_tokens, sampling=SamplingParams(**knobs),
                    callback=callback, adapter=adapter,
                    block_size=1 if stream_cb is not None else BLOCKING_BLOCK_SIZE,
                )
        except _ClientDisconnected:
            result.update(output=None, cancelled=True)
        return result

    def process_text(self, payload: Dict) -> Dict:
        """/process_text: {"text", "action"} -> generation from the named
        state ``action`` (default "default") on its template."""
        text, action = payload.get("text"), payload.get("action", "default")
        if not isinstance(text, str) or not text:
            raise BadRequest("'text' must be a non-empty string")
        if action not in self.states.names():
            raise BadRequest(f"unknown action {action!r}; serving {self.states.names()}")
        with self._lock:
            out = self.states.generate(self.engine, action, text)
        return {"action": action, "output": out}

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
        if self.engine is not None:
            out["route"] = self.engine.route()
        if lat:
            out["generate_latency_ms"] = {
                backend: {
                    "count": len(xs),
                    **{f"p{q}": round(float(np.percentile(xs, q)) * 1e3, 1) for q in (50, 95, 99)},
                }
                for backend, xs in lat.items()
            }
        if self.batcher is not None:
            out["batcher"] = self.batcher.stats()
        if self.spec is not None:
            with self._stats_lock:
                t = dict(self._spec_totals)
            out["speculative"] = dict(
                t, acceptance=t["accepted"] / t["proposed"] if t["proposed"] else 0.0)
        if self.engine is not None and self.engine.state_cache is not None:
            out["prefix_cache"] = self.engine.state_cache.stats()
        if self.engine is not None and self.engine.adapter_ids:
            out["adapters"] = sorted(self.engine.adapter_ids)
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
        if route == "/rerank":
            query = payload.get("query")
            if not isinstance(query, str):
                raise BadRequest("'query' must be a string")
            docs = payload.get("documents")
            if not isinstance(docs, list) or not docs or not all(isinstance(d, str) for d in docs):
                raise BadRequest("'documents' must be a non-empty list of strings")
            return self.rerank(query, docs)
        if route == "/fill_mask":
            return self.fill_mask(**self._fill_mask_args(payload))
        if route == "/process_text":
            return self.process_text(payload)
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

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body, kind = INDEX_HTML.encode(), "text/html; charset=utf-8"
                self.send_response(200)
            elif self.path == "/stats":
                body, kind = json.dumps(service.stats()).encode(), "application/json"
                self.send_response(200)
            else:
                body, kind = b'{"error": "unknown route"}', "application/json"
                self.send_response(404)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_request(self, *args):
            pass  # errors still reach stderr through log_error

    return ThreadingHTTPServer((host, port), Handler)


def make_fastapi_app(service: ServingService):
    """The service's routes as a FastAPI app (JAX serve/api.py:591-609): POST
    to any route, a streaming /generate as server-sent events; an unknown
    route answers 404 and a malformed payload 400, as over ``serve_http``.
    FastAPI is imported here only; without it this raises ImportError."""
    try:
        from fastapi import FastAPI, Request
        from fastapi.responses import JSONResponse, StreamingResponse
    except ImportError as e:
        raise ImportError("make_fastapi_app needs the fastapi package, which is not installed; "
                          "serve_http serves the same routes without it") from e

    app = FastAPI(title="rwkv_lm_ext_tpu_torch")

    @app.post("/{route:path}")
    async def dispatch(route: str, request: Request):
        try:
            payload = await request.json()
            if route == "generate" and isinstance(payload, dict) and payload.get("stream"):
                return StreamingResponse(service.generate_sse(payload),
                                         media_type="text/event-stream")
            return service.handle("/" + route, payload)
        except UnknownRoute:
            return JSONResponse({"error": "unknown route"}, status_code=404)
        except (BadRequest, ValueError) as e:
            return JSONResponse({"error": str(e)}, status_code=400)

    return app
