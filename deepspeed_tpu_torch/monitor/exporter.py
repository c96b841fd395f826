"""Standalone Prometheus exposition endpoint (the scrape half): the port
of ``deepspeed_tpu/monitor/exporter.py``.

A training run, a bench or an embedded engine publishes the
process-global registry through a tiny threaded ``http.server``:

- ``GET /metrics`` — Prometheus text exposition
  (:meth:`MetricsRegistry.to_prometheus`), with the flight recorder's
  ring-loss gauges (``events/dropped``/``events/capacity``) refreshed
  per scrape. The ``serving/phase_ms`` ledger renders with OpenMetrics
  exemplars (``# {rid="..."} v``) so a p99 bucket links straight to the
  request in a merged fleet trace;
- ``GET /healthz`` — 200 while serving, for scrape-target liveness.

Config: ``telemetry.metrics_port`` (the training engine starts/stops one
around its lifetime); or construct :class:`MetricsExporter` directly.

Cost discipline: a scrape renders host-side registry state — **zero
device work**: nothing here imports torch. Handler threads only read
under the registry lock, so a scrape can stall a hot-path ``observe``
for at most one text render.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

#: the classic text-format content type scrapers expect
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
#: the OpenMetrics content type — the only format exemplars are legal in
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def wants_openmetrics(accept_header: Optional[str]) -> bool:
    """Did the scraper's ``Accept`` header negotiate OpenMetrics?"""
    return "application/openmetrics-text" in (accept_header or "")


def render_exposition(registry=None,
                      openmetrics: bool = False) -> Tuple[str, str]:
    """One exposition body as ``(text, content_type)`` — THE rendering
    path of the standalone exporter (and of the serving front-end's
    ``/metrics`` route once async serving is ported): recorder-loss gauges refreshed, then the
    registry's text format. Exemplars are emitted only under
    ``openmetrics`` (they are illegal in the 0.0.4 format — a strict
    scraper would reject the entire body), which also appends the
    ``# EOF`` terminator the OpenMetrics grammar requires."""
    if registry is None:
        from deepspeed_tpu_torch.monitor.metrics import get_registry
        registry = get_registry()
    from deepspeed_tpu_torch.monitor.events import export_recorder_metrics
    export_recorder_metrics(registry)
    text = registry.to_prometheus(exemplars=openmetrics)
    if openmetrics:
        text += "# EOF\n"
        return text, OPENMETRICS_CONTENT_TYPE
    return text, PROM_CONTENT_TYPE


class MetricsExporter:
    """Serve ``/metrics`` for one registry on a background thread.

    ``port=0`` binds an ephemeral port (read it back from
    :attr:`address` / :attr:`url` after :meth:`start`)."""

    def __init__(self, registry=None, host: str = "127.0.0.1",
                 port: int = 0):
        if registry is None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self.registry = registry
        self._host = host
        self._port = int(port)
        self._server = None
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ---- #

    def start(self) -> Tuple[str, int]:
        """Bind and serve; returns ``(host, port)`` (idempotent)."""
        if self._server is not None:
            return self.address
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):    # scrapes are not console news
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    text, ctype = render_exposition(
                        exporter.registry,
                        openmetrics=wants_openmetrics(
                            self.headers.get("Accept")))
                    payload = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                elif self.path == "/healthz":
                    payload = b'{"status": "ok"}'
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    payload = f'{{"error": "no route {self.path}"}}'.encode()
                    self.send_response(404)
                    self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((self._host, self._port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="ds-metrics-exporter",
                                        daemon=True)
        self._thread.start()
        return self.address

    def render(self, openmetrics: bool = False) -> str:
        """One exposition body (the scrape handler's work, callable
        directly); see :func:`render_exposition`."""
        return render_exposition(self.registry, openmetrics=openmetrics)[0]

    @property
    def address(self) -> Tuple[str, int]:
        if self._server is None:
            return (self._host, self._port)
        return self._server.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}/metrics"

    def stop(self) -> None:
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(5)

    def __enter__(self) -> "MetricsExporter":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
