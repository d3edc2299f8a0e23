"""Zero-framework threaded HTTP layer (counterpart of
`llm_mcp_tpu/api/http.py`): route table, JSON and SSE helpers on the
stdlib ThreadingHTTPServer, one thread per connection — what blocking
token streams from the engine want. Tracing and fault injection come with
telemetry, in a later slice.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import urlparse

log = logging.getLogger("api")

MAX_BODY = 10 * 1024 * 1024  # 10MB request body cap


class Request:
    def __init__(self, handler: "_Handler"):
        self._h = handler
        self.headers = handler.headers
        self._body: bytes | None = None
        self.consumed = 0

    def body(self) -> bytes:
        if self._body is None:
            length = int(self.headers.get("Content-Length") or 0)
            self._body = self._h.rfile.read(min(length, MAX_BODY)) if length else b""
            self.consumed = len(self._body)
        return self._body

    def json(self) -> Any:
        raw = self.body()
        return json.loads(raw) if raw else {}


class Response:
    """Write-side helper bound to one connection."""

    def __init__(self, handler: "_Handler"):
        self._h = handler
        self.started = False
        # headers every write_* below adds (a 429's Retry-After)
        self.extra_headers: dict[str, str] = {}

    def _send_extra(self) -> None:
        for k, v in self.extra_headers.items():
            self._h.send_header(k, v)

    def write_json(self, obj: Any, status: int = 200) -> None:
        data = json.dumps(obj).encode("utf-8")
        h = self._h
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        self._send_extra()
        h.end_headers()
        h.wfile.write(data)
        self.started = True

    def write_error(self, message: str, status: int = 400, code: str = "") -> None:
        self.write_json({"error": {"message": message, "code": code or str(status)}}, status)

    def start_sse(self) -> None:
        h = self._h
        # no Content-Length: the stream ends when the connection closes
        h.close_connection = True
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("X-Accel-Buffering", "no")
        self._send_extra()
        h.end_headers()
        self.started = True

    def sse_data(self, payload: Any) -> bool:
        """Send one `data:` frame (JSON-encoding non-strings). False when the
        client disconnected."""
        data = payload if isinstance(payload, str) else json.dumps(payload)
        try:
            self._h.wfile.write(f"data: {data}\n\n".encode("utf-8"))
            self._h.wfile.flush()
            return True
        except (BrokenPipeError, ConnectionResetError, OSError):
            return False


HandlerFn = Callable[[Request, Response], None]


class HTTPApi:
    def __init__(self):
        self._routes: dict[tuple[str, str], HandlerFn] = {}  # (method, path)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def route(self, method: str, path: str, fn: HandlerFn) -> None:
        self._routes[(method.upper(), path)] = fn

    @staticmethod
    def _drain(handler: "_Handler", consumed: int) -> None:
        """Consume an unread request body so a keep-alive connection's next
        request parses cleanly; oversized bodies close the connection."""
        try:
            length = int(handler.headers.get("Content-Length") or 0)
        except (TypeError, ValueError):
            length = 0
        remaining = length - consumed
        if remaining <= 0:
            return
        if remaining > MAX_BODY:
            handler.close_connection = True
            return
        try:
            handler.rfile.read(remaining)
        except OSError:
            handler.close_connection = True

    def dispatch(self, handler: "_Handler") -> None:
        path = urlparse(handler.path).path
        method = handler.command
        fn = self._routes.get((method, path))
        if fn is None:
            self._drain(handler, 0)
            known = any(p == path for _, p in self._routes)
            Response(handler).write_error(
                "method not allowed" if known else "not found", 405 if known else 404
            )
            return
        req = Request(handler)
        resp = Response(handler)
        try:
            fn(req, resp)
        except json.JSONDecodeError:
            if not resp.started:
                resp.write_error("invalid JSON body", 400)
        except (BrokenPipeError, ConnectionResetError):
            handler.close_connection = True
        except Exception as e:  # noqa: BLE001 — handler crash → 500
            log.exception("handler error %s %s", method, path)
            if not resp.started:
                resp.write_error(f"internal error: {e}", 500)
        finally:
            self._drain(handler, req.consumed)

    def serve(self, host: str, port: int) -> ThreadingHTTPServer:
        api = self

        class _Bound(_Handler):
            _api = api

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 256

        self._server = _Server((host, port), _Bound)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="http-api", daemon=True
        )
        self._thread.start()
        return self._server

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    def shutdown(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class _Handler(BaseHTTPRequestHandler):
    _api: HTTPApi
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s %s", self.address_string(), fmt % args)

    def _handle(self) -> None:
        self._api.dispatch(self)

    do_GET = _handle
    do_POST = _handle
