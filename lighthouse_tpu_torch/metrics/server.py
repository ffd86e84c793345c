"""Standalone Prometheus metrics server.

The beacon_node/http_metrics analog (272 LoC crate): a tiny HTTP server
exposing the process-global registry's text exposition at /metrics, a
liveness probe at /health, and the lighthouse operator endpoints —
trace trees at /lighthouse/traces (+ /lighthouse/traces/<id> as Chrome
trace-event JSON), profiler output at /lighthouse/profile (collapsed
stacks / speedscope JSON), and process vitals at /lighthouse/health —
independent of the Beacon API server so operators can firewall the two
separately (the reference binds them on different ports for the same
reason). The Beacon API serves the same /lighthouse/* routes through
`serve_lighthouse_path`."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from . import REGISTRY
from .trace_collector import COLLECTOR


def serve_trace_path(path: str):
    """Shared /lighthouse/traces router (MetricsServer + Beacon API):
    returns (status, json-able body) or None when the path is not a
    trace endpoint."""
    if path == "/lighthouse/traces":
        return 200, COLLECTOR.index_json()
    if path.startswith("/lighthouse/traces/"):
        trace_id = path.rsplit("/", 1)[1]
        chrome = COLLECTOR.chrome_json(trace_id)
        if chrome is None:
            return 404, {"message": f"trace {trace_id} not held (ring/reservoir evicted?)"}
        return 200, chrome
    return None


def serve_lighthouse_path(path: str, query: str = "", chain=None):
    """Shared router for every /lighthouse/* operator endpoint (traces,
    profile, health), used verbatim by the MetricsServer and the Beacon
    API. Returns (status, content_type, body_bytes) or None when the
    path is not a lighthouse endpoint. `chain` (the serving node's
    BeaconChain, when the caller has one) adds the per-node `chain`
    block to /lighthouse/health — the single read the testnet scenario
    oracle asserts its invariants from."""
    traced = serve_trace_path(path)
    if traced is not None:
        code, obj = traced
        return code, "application/json", json.dumps(obj).encode()
    if path == "/lighthouse/profile":
        from .profiler import PROFILER

        q = parse_qs(query)
        root = q.get("root", [None])[0]
        fmt = q.get("format", ["speedscope"])[0]
        if not PROFILER.running and PROFILER.samples_total == 0:
            return (
                503,
                "application/json",
                json.dumps(
                    {
                        "message": (
                            "profiler disabled — set LIGHTHOUSE_TPU_PROFILE=1 "
                            "(sampler arms at server start)"
                        )
                    }
                ).encode(),
            )
        if fmt == "collapsed":
            return (
                200,
                "text/plain; charset=utf-8",
                PROFILER.collapsed(root).encode(),
            )
        return (
            200,
            "application/json",
            json.dumps(PROFILER.speedscope(root)).encode(),
        )
    if path == "/lighthouse/health":
        from .system_health import process_health

        return (
            200,
            "application/json",
            json.dumps({"data": process_health(chain=chain)}).encode(),
        )
    return None


class _Handler(BaseHTTPRequestHandler):
    registry = REGISTRY
    chain = None  # bound when the MetricsServer serves a specific node

    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):
        from .system_health import observe_system_health

        path, _, query = self.path.partition("?")
        content_type = "text/plain"
        served = serve_lighthouse_path(path, query, chain=self.chain)
        if served is not None:
            code, content_type, body = served
            self.send_response(code)
        elif path == "/metrics":
            # refresh host gauges at scrape time, as the reference's
            # gather() does per scrape — into the registry being served
            observe_system_health(self.registry)
            body = self.registry.expose().encode()
            content_type = "text/plain; version=0.0.4; charset=utf-8"
            self.send_response(200)
        elif path == "/health":
            body = b"OK"
            self.send_response(200)
        else:
            body = b"not found"
            self.send_response(404)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsServer:
    """http_metrics/src/lib.rs analog."""

    def __init__(self, port: int = 0, registry=REGISTRY, chain=None):
        handler = type(
            "_BoundHandler", (_Handler,), {"registry": registry, "chain": chain}
        )
        self._server = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self._server.server_port
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        from .profiler import maybe_start_profiler

        maybe_start_profiler()  # no-op (and no thread) unless armed by env
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="http-metrics"
        )
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
