"""Embedding service over JSON HTTP.

Counterpart of rwkv_lm_ext_tpu/serve/api.py:42-83, 390-402, 454-495 and
502-590, with a bi-encoder only: POST /embed {"texts": [...]},
POST /similarity {"texts_a": [...], "texts_b": [...]} and POST /stats
(request counts per route). A malformed payload answers 400, an unknown
route 404. Transport: the standard library's ThreadingHTTPServer; one lock
serialises the model's forwards.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

ROUTES = ("/embed", "/similarity", "/stats")


class UnknownRoute(Exception):
    pass


class BadRequest(Exception):
    pass


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


class ServingService:
    def __init__(self, *, bi_encoder):
        self.bi = bi_encoder
        self._lock = threading.Lock()          # one forward at a time
        self._stats_lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def warmup(self) -> None:
        """Run one short request from the calling thread, so the kernel
        library is built before the first client arrives."""
        self.bi.encode_texts(["warmup"])

    def embed(self, texts: List[str]) -> Dict:
        with self._lock:
            e = self.bi.encode_texts(texts)
        return {"embeddings": e.tolist()}

    def similarity(self, texts_a: List[str], texts_b: List[str]) -> Dict:
        with self._lock:
            ea = self.bi.encode_texts(texts_a)
            eb = self.bi.encode_texts(texts_b)
        return {"similarity": (ea @ eb.T).tolist()}

    def stats(self) -> Dict:
        with self._stats_lock:
            return {"requests": dict(self._counts)}

    def handle(self, route: str, payload: Dict) -> Dict:
        if route not in ROUTES:
            # not counted: the paths clients send are unbounded
            raise UnknownRoute(route)
        with self._stats_lock:
            self._counts[route] = self._counts.get(route, 0) + 1
        if not isinstance(payload, dict):
            raise BadRequest("payload must be a JSON object")
        if route == "/stats":
            return self.stats()
        if route == "/embed":
            return self.embed(_texts(payload, "texts"))
        return self.similarity(_texts(payload, "texts_a"), _texts(payload, "texts_b"))


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

        def do_POST(self):
            try:
                result = service.handle(self.path, self._payload())
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
