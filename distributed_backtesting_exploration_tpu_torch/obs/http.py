"""Tiny stdlib HTTP exposure: ``/metrics`` (Prometheus text) + ``/stats.json``.

One daemon thread per server; ``port=0`` binds an ephemeral port (the bound
port is on ``MetricsServer.port``). No external deps — the scrape surface
must exist on any box the dispatcher or a worker lands on.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import trace
from .registry import Registry, get_registry

log = logging.getLogger("dbx.obs.http")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Recent-span window shipped by /stats.json and GetStats obs_json: enough
# to cover a poll-cycle of batches without bloating every scrape (the full
# ring stays readable in-process via obs.recent_spans()).
STATS_SPAN_WINDOW = 128


def stats_payload(registry: Registry) -> dict:
    """The ``/stats.json`` document: the registry snapshot plus the tail of
    the process-wide completed-span ring under ``dbx_spans_recent`` —
    shaped like a metric family (``{"type": "spans", "values": [...]}``) so
    snapshot consumers that dispatch on ``type`` skip it untouched."""
    snap = registry.snapshot()
    snap["dbx_spans_recent"] = {"type": "spans",
                                "values": trace.recent_spans(
                                    STATS_SPAN_WINDOW)}
    return snap


class MetricsServer:
    """Serves a registry over HTTP; ``start()``/``stop()`` lifecycle."""

    def __init__(self, port: int = 0, *, registry: Registry | None = None,
                 bind: str = "0.0.0.0", routes: dict | None = None):
        self.registry = registry or get_registry()
        self._bind = bind
        self._requested_port = port
        # Extra JSON document routes: path -> zero-arg callable returning
        # a JSON-able dict, evaluated per request (the dispatcher mounts
        # its FleetView snapshot as /fleet.json here).
        self._routes = dict(routes or {})
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port: int | None = None

    def start(self) -> "MetricsServer":
        reg = self.registry
        routes = self._routes

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802 (stdlib API)
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = reg.render_prometheus().encode()
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif path == "/stats.json":
                    # default=str: ring span records carry arbitrary
                    # span attrs, same guard as the JSONL event writer.
                    body = json.dumps(stats_payload(reg),
                                      default=str).encode()
                    ctype = "application/json"
                elif path in routes:
                    try:
                        doc = routes[path]()
                    except Exception:
                        log.exception("route %s provider failed", path)
                        self.send_error(500)
                        return
                    body = json.dumps(doc, default=str).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):     # scrapes are not news
                pass

        self._httpd = ThreadingHTTPServer((self._bind, self._requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dbx-metrics-http",
            daemon=True)
        self._thread.start()
        log.info("metrics endpoint on http://%s:%d/metrics", self._bind,
                 self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def start_metrics_server(port: int, *,
                         registry: Registry | None = None) -> MetricsServer:
    """Start a /metrics endpoint on ``port`` (0 = ephemeral)."""
    return MetricsServer(port, registry=registry).start()
