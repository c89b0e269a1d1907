"""One pull-based Prometheus/OpenMetrics endpoint for every metrics class.

Copy of ``torchkafka_tpu/obs/exporter.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

Before this module each metrics set (``StreamMetrics``, ``ServeMetrics``,
``FleetMetrics``, ``ResilienceMetrics``, the SLO tracer) had its own
``render_prometheus`` and no transport — operators had to wire their own
scrape path per class. ``MetricsExporter`` registers any number of
sources and serves their concatenated expositions from a single stdlib
``http.server`` endpoint (opt-in, daemon thread, ephemeral port by
default so tests never collide):

    exporter = MetricsExporter()
    exporter.add(stream.metrics)                       # any render_prometheus
    exporter.add(lambda: fleet.metrics.render_prometheus(
        replicas=fleet.replicas))                      # or a callable
    exporter.add(tracer)                               # the SLO tracer
    exporter.start()
    # curl http://127.0.0.1:{exporter.port}/metrics

No new dependencies: the exposition text format is what the shared
renderer (``utils.metrics.render_exposition``) already produces, and the
conformance test in tests/test_obs.py pins every source to it.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

_logger = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Aggregates metric sources and serves GET /metrics.

    A *source* is anything with a zero-argument ``render_prometheus()``
    method, or a zero-argument callable returning exposition text (use a
    lambda to bind arguments, e.g. FleetMetrics' ``replicas=``). Sources
    render at scrape time — no caching — and a raising source is skipped
    with a comment line rather than failing the whole scrape (one broken
    metrics class must not blind the operator to the others)."""

    def __init__(self, sources=(), *, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self._sources: list[Callable[[], str]] = []
        for s in sources:
            self.add(s)
        self._host = host
        self._port = port
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def add(self, source) -> "MetricsExporter":
        render = getattr(source, "render_prometheus", None)
        if render is None:
            if not callable(source):
                raise TypeError(
                    "exporter sources need a render_prometheus() method or "
                    f"must be zero-arg callables, got {type(source).__name__}"
                )
            render = source
        self._sources.append(render)
        return self

    def render(self) -> str:
        """The concatenated exposition of every registered source."""
        parts = []
        for render in self._sources:
            try:
                text = render()
            except Exception as exc:  # noqa: BLE001 - scrape must survive
                _logger.exception("metrics source failed to render")
                parts.append(f"# source error: {type(exc).__name__}\n")
                continue
            if text and not text.endswith("\n"):
                text += "\n"
            parts.append(text)
        return "".join(parts)

    # ---------------------------------------------------------------- http

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("exporter not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}/metrics"

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib contract
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = exporter.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # quiet scrapes
                pass

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tk-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
