"""Shared threaded JSON-over-HTTP scaffold.

One definition of the send-JSON / route-dispatch / daemon-thread plumbing
the small service servers (watch, VC keymanager) build on, so fixes like
Content-Length handling or 500-instead-of-reset apply in one place. The
beacon API server keeps its own handler (SSZ bodies, SSE streaming)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Quiet handler with JSON helpers; subclasses implement do_* using
    `route`, `read_json_body`, and `send_json`."""

    def log_message(self, *args):
        pass

    @property
    def route(self) -> str:
        return self.path.split("?")[0]

    def read_json_body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def send_json(self, obj, code: int = 200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class JsonHttpServer:
    """Owns the ThreadingHTTPServer + daemon thread lifecycle."""

    def __init__(self, handler_cls, port: int = 0, name: str = "json-http"):
        self._server = ThreadingHTTPServer(("127.0.0.1", port), handler_cls)
        self.port = self._server.server_port
        self._name = name
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name=self._name
        )
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
