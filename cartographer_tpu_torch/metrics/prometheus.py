"""Prometheus metrics sink: text exposition + scrape endpoint.

Port of cartographer_tpu/metrics/prometheus.py.

Reference: cloud/metrics/prometheus/family_factory.cc and the server's
monitoring port (cloud/internal/map_builder_server.cc) — the reference
exposes all registered metric families over prometheus-cpp's HTTP
exposer. Here the real FamilyFactory registry is rendered in the standard
Prometheus text exposition format (version 0.0.4) and served by a tiny
stdlib HTTP endpoint; no external dependency is needed.
"""

from __future__ import annotations

import http.server
import threading
from typing import Optional

from cartographer_tpu_torch import metrics


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def text_exposition(factory: Optional[metrics.FamilyFactory] = None) -> str:
    """Render every metric in the factory's registry in the Prometheus
    text format: counters and gauges as single samples, histograms as
    cumulative `_bucket{le=...}` samples plus `_sum` and `_count`."""
    factory = factory or metrics._factory
    lines = []
    for name, metric in sorted(factory.registry().items()):
        kind, description = factory.meta(name)
        pname = _sanitize(name)
        if description:
            lines.append(f"# HELP {pname} {description}")
        if isinstance(metric, metrics.HistogramMetric):
            lines.append(f"# TYPE {pname} histogram")
            boundaries = getattr(metric, "_boundaries", [])
            counts = (
                metric.counts()
                if hasattr(metric, "counts")
                else [0] * (len(boundaries) + 1)
            )
            total = 0
            for b, c in zip(boundaries, counts):
                total += c
                lines.append(f'{pname}_bucket{{le="{b:g}"}} {total}')
            total += counts[-1] if counts else 0
            lines.append(f'{pname}_bucket{{le="+Inf"}} {total}')
            lines.append(f"{pname}_sum {getattr(metric, '_sum', 0.0):g}")
            lines.append(f"{pname}_count {total}")
        elif isinstance(metric, metrics.Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {metric.value():g}")
        else:
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {metric.value():g}")
    return "\n".join(lines) + "\n"


class PrometheusExporter:
    """Serves text_exposition() on /metrics (prometheus-cpp Exposer
    analog). Runs a daemon thread; `close()` stops it."""

    def __init__(self, port: int, factory: Optional[metrics.FamilyFactory] = None):
        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = text_exposition(exporter._factory).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._factory = factory
        self._server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
