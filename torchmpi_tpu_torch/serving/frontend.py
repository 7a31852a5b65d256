"""The serving request plane: HTTP frontend over the hardened wire.

The port's copy of ``torchmpi_tpu/serving/frontend.py``: the same routes,
status codes and JSON bodies.  One :class:`ServeFrontend` per replica, in
front of a :class:`~torchmpi_tpu_torch.serving.engine.ServeEngine`:

- ``POST /generate`` — submit a request.  Admission control is a
  queue-depth + KV-headroom gate; a rejected request gets a **typed**
  503 (``reason=queue_full|kv_pressure|draining``) with a
  ``Retry-After`` hint instead of unbounded buffering — backpressure is
  the client's problem to respect and the server's to signal.
  Per-request deadlines ride the body; past-deadline requests come back
  as a typed shed (``reason=deadline``).  Every admitted request gets a
  correlation id that flows through the span tracer
  (``serve.request`` → ``serve.prefill`` → ``serve.generate``), so an
  exported trace joins the frontend wait to the engine's work by that
  id.
- ``GET /serve`` — live scheduler/KV/latency stats (the router's
  observability surface).
- ``POST /drain`` — the roll-restart handshake: flips the replica's
  health to ``draining`` (via :func:`obs.serve.begin_drain` semantics)
  **before** the engine stops admitting, so the router's probe sees the
  handoff window on ``/healthz``.  Body ``{"resume": true}`` rejoins.

The handler mirrors ``obs/serve.py``'s endpoint discipline: HTTP/1.1
keep-alive, bodies drained before responding, a 404 that lists every
route.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple
from urllib.parse import urlparse

from ..runtime import config
from .engine import AdmissionRejected, ServeEngine


def _encode_prompt(prompt: Any) -> list:
    """Accept a token list or a string (bytes mod 256 — the tiny vocab)."""
    if isinstance(prompt, str):
        return [b % 256 for b in prompt.encode()] or [0]
    return [int(t) for t in prompt] or [0]


class _Handler(BaseHTTPRequestHandler):
    server_version = "tmpi-serve/1"
    protocol_version = "HTTP/1.1"
    # Bound broken/stalled clients: a socket that goes quiet mid-request
    # frees its handler thread instead of leaking it.
    timeout = 30.0

    def log_message(self, *args: Any) -> None:  # silence per-request noise
        pass

    def _send_json(self, code: int, obj: Any,
                   retry_after_ms: Optional[int] = None) -> None:
        body = json.dumps(obj, indent=1).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if retry_after_ms is not None:
            self.send_header("Retry-After",
                             str(max(1, int(retry_after_ms / 1000.0 + 0.5))))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        parsed = urlparse(self.path)
        if parsed.path == "/serve":
            eng: ServeEngine = self.server.tmpi_engine
            doc = eng.stats()
            doc["replica"] = self.server.tmpi_replica
            health = self.server.tmpi_health
            if health is not None:
                doc["health_draining"] = bool(health.draining)
            self._send_json(200, doc)
        else:
            self._send_json(404, {"error": f"no route {parsed.path}",
                                  "routes": ["/serve",
                                             "POST /generate",
                                             "POST /drain"]})

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        # Drain the body BEFORE responding (obs/serve.py's keep-alive
        # discipline): unread bytes would be parsed as the next request
        # line on a reused connection.
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            length = 0
        body = bytearray()
        while length > 0:
            chunk = self.rfile.read(min(length, 1 << 16))
            if not chunk:
                break
            if len(body) < (1 << 20):
                body += chunk
            length -= len(chunk)
        parsed = urlparse(self.path)
        if parsed.path == "/generate":
            self._generate(bytes(body))
        elif parsed.path == "/drain":
            self._drain(bytes(body))
        else:
            self._send_json(404, {"error": f"no route POST {parsed.path}"})

    # -- routes ------------------------------------------------------------
    def _generate(self, body: bytes) -> None:
        try:
            doc = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            doc = None
        if not isinstance(doc, dict) or "prompt" not in doc:
            self._send_json(400, {"error": "body must be a JSON object "
                                           "with a 'prompt'"})
            return
        eng: ServeEngine = self.server.tmpi_engine
        from ..obs import tracer

        correlation = tracer.new_correlation() if config.get("obs_trace") \
            else 0
        deadline_ms = int(doc.get("deadline_ms") or 0)
        with tracer.span("serve.request", correlation=correlation,
                         replica=self.server.tmpi_replica):
            try:
                req = eng.submit(
                    _encode_prompt(doc["prompt"]),
                    max_new=int(doc.get("max_new") or 0),
                    deadline_ms=deadline_ms,
                    correlation=correlation,
                    request_id=str(doc.get("request_id") or ""))
            except AdmissionRejected as e:
                # Typed admission shed + Retry-After: the backpressure
                # signal.  503 (not 429): the replica, not the client,
                # is out of capacity.
                self._send_json(503, {
                    "error": "admission",
                    "reason": e.reason,
                    "detail": e.detail,
                    "replica": self.server.tmpi_replica,
                }, retry_after_ms=eng.cfg["default_deadline_ms"] // 4)
                return
            # The engine sheds at the deadline itself; the extra slack
            # only covers scheduler wake-up, so the wait cannot hang.
            req.done.wait(max(0.1, req.deadline - time.monotonic()) + 2.0)
        if req.state == "done":
            self._send_json(200, {
                "request_id": req.id,
                "tokens": list(req.tokens),
                "correlation": correlation,
                "latency_ms": req.latency_ms(),
                "ttft_ms": req.ttft_s * 1000.0 if req.ttft_s >= 0 else None,
                "replica": self.server.tmpi_replica,
            })
            return
        if req.state != "shed":          # scheduler wedged past slack
            eng._shed(req, "deadline")   # type it rather than hang
        self._send_json(503, {
            "error": "shed",
            "reason": req.shed_reason or "deadline",
            "request_id": req.id,
            "generated": len(req.tokens),
            "correlation": correlation,
            "replica": self.server.tmpi_replica,
        })

    def _drain(self, body: bytes) -> None:
        try:
            doc = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            doc = {}
        if not isinstance(doc, dict):
            doc = {}
        front: Optional["ServeFrontend"] = self.server.tmpi_frontend()
        if front is None:                # dropped without close()
            self._send_json(503, {"error": "closed",
                                  "replica": self.server.tmpi_replica})
            return
        if doc.get("resume"):
            front.resume()
            self._send_json(200, {"draining": False,
                                  "replica": self.server.tmpi_replica})
            return
        front.begin_drain()
        self._send_json(200, {"draining": True,
                              "replica": self.server.tmpi_replica})


class _ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # http.server's default listen backlog is 5 — a couple hundred
    # clients connecting at once overflow it and see connection resets
    # before admission control ever runs.  Backpressure must be a TYPED
    # 503, not a dropped SYN.
    request_queue_size = 512

    def handle_error(self, request, client_address) -> None:
        # A client that resets/abandons its socket mid-request is
        # expected chaos at this endpoint — shed silently.  Anything else is a real bug and
        # keeps the default traceback.
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return
        super().handle_error(request, client_address)


class ServeFrontend:
    """One replica's request endpoint: ``ThreadingHTTPServer`` + engine.

    ``health`` is the replica's :class:`obs.serve.HealthState` (the
    process singleton by default; several replicas in one process pass
    private instances) — :meth:`begin_drain` flips it so ``/healthz`` on the
    replica's obs endpoint reads ``draining`` during the handoff window.
    """

    def __init__(self, engine: ServeEngine, bind: str = "127.0.0.1",
                 port: int = 0, health=None, replica: str = "r0"):
        self.engine = engine
        self.replica = str(replica)
        if health is None:
            from ..obs import serve as obs_serve
            health = obs_serve.health
        self.health = health
        self._httpd = _ServeHTTPServer((bind, int(port)), _Handler)
        self._httpd.tmpi_engine = engine
        self._httpd.tmpi_health = health
        self._httpd.tmpi_replica = self.replica
        # Weak: a strong reference would close a cycle frontend -> server
        # -> frontend that keeps the engine, its runner and the runner's
        # weights and KV on the card after close() until the cyclic
        # collector runs.
        self._httpd.tmpi_frontend = weakref.ref(self)
        self._drainer: Optional[threading.Thread] = None
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"tmpi-serve-http-{self.port}")
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    # -- drain/handoff -----------------------------------------------------
    def begin_drain(self) -> None:
        """Enter the handoff window: health first (the router's probe must
        see ``draining`` before admission closes), then the engine drain
        in the background so the POST returns immediately."""
        self.health.set_draining(True)
        from ..obs import journal as journal_mod

        journal_mod.emit("serve.drain", phase="begin",
                         replica=self.replica)
        if self._drainer is None or not self._drainer.is_alive():
            self._drainer = threading.Thread(
                target=self.engine.drain, daemon=True,
                name=f"tmpi-serve-drain-{self.replica}")
            self._drainer.start()

    def resume(self) -> None:
        """Leave the drain state (replica rejoined after roll-restart)."""
        self.engine.undrain()
        self.health.set_draining(False)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
