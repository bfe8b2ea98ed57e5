"""Optional plain-HTTP ``/metrics`` listener.

gRPC-native scrapers can use the ``GetMetrics`` RPC; a stock Prometheus
server speaks plain HTTP, so controller and learner can additionally bind
this tiny stdlib listener (federation config ``telemetry.http_port`` /
learner ``--metrics-port``). Serves the process registry's text
exposition at ``/metrics`` (and ``/``); anything else is 404.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from metisfl_tpu_torch.telemetry import metrics as _metrics

logger = logging.getLogger("metisfl_tpu_torch.telemetry")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """A daemon-threaded scrape endpoint; ``close()`` unbinds the port."""

    def __init__(self, port: int, host: str = "0.0.0.0", registry=None):
        registry = registry or _metrics.registry()

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = registry.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrapes are not app logs
                logger.debug("metrics http: " + fmt, *args)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        logger.info("metrics http listener on %s:%d", host, self.port)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def start_metrics_http(port: int, host: str = "0.0.0.0",
                       registry=None) -> Optional[MetricsHTTPServer]:
    """Bind a /metrics listener; port 0 or failure → None (metrics stay
    reachable over the GetMetrics RPC — a taken port must not kill the
    federation process)."""
    if port <= 0:
        return None
    try:
        return MetricsHTTPServer(port, host=host, registry=registry)
    except OSError as exc:
        logger.warning("metrics http listener on port %d failed: %s",
                       port, exc)
        return None
