"""Dashboard — read-only web UI over engine and evaluation instances.

Port of ``predictionio_tpu/server/dashboard.py`` (reference:
tools/.../tools/dashboard/Dashboard.scala): an HTML listing of engine
instances (status, times, params) and completed evaluations with their
metric scores.  JSON endpoints for tooling: ``GET
/engine_instances.json``, ``GET /evaluation_instances.json``, plus the
shared observability views ``GET /metrics`` / ``GET /traces.json`` /
``GET /timeline.json``.

Fleet telemetry: ``GET /fleet.json`` scrapes a configured list of
instance base URLs (``PIO_FLEET_INSTANCES`` or the ``fleet`` constructor
argument), merges ``/metrics`` type-correctly (counters sum, histogram
buckets add, gauges keep an ``instance`` label), and carries each
instance's SLO and batcher state and timeline summary; ``GET
/quality.json`` is the fleet-merged model-quality view.
"""

from __future__ import annotations

import html
import json
import logging
import threading
from typing import List, Optional, Tuple

from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.obs.fleet import (
    FleetAggregator,
    fleet_instances_from_env,
)
from predictionio_tpu_torch.server.http import (
    BaseHandler,
    PROMETHEUS_CTYPE,
    ThreadingHTTPServer,
    timeline_payload,
    traces_payload,
    param_bool,
)
from predictionio_tpu_torch.version import __version__

logger = logging.getLogger(__name__)

__all__ = ["DashboardServer"]


def _fmt_time(t) -> str:
    return t.isoformat(timespec="seconds") if t else "-"


class DashboardServer:
    def __init__(self, storage: Optional[Storage] = None, host: str = "127.0.0.1",
                 port: int = 9000, fleet: Optional[List[str]] = None):
        self.storage = storage or get_storage()
        self.host = host
        self.port = port
        self.registry = get_registry()
        self._requests = self.registry.counter(
            "pio_dashboard_requests_total",
            "Dashboard requests by HTTP status.", ("status",))
        self._latency = self.registry.histogram(
            "pio_dashboard_request_latency_ms",
            "Dashboard request handling latency.")
        instances = fleet if fleet is not None else fleet_instances_from_env()
        self.fleet: Optional[FleetAggregator] = (
            FleetAggregator(instances) if instances else None)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- payloads -----------------------------------------------------------

    def _engine_rows(self):
        rows = self.storage.get_engine_instances().get_all()
        return sorted(rows, key=lambda r: r.start_time or 0, reverse=True)

    def _eval_rows(self):
        rows = self.storage.get_evaluation_instances().get_all()
        return sorted(rows, key=lambda r: r.start_time or 0, reverse=True)

    def _index_html(self) -> str:
        eng = "".join(
            f"<tr><td>{html.escape(r.id or '')}</td>"
            f"<td>{html.escape(r.engine_factory)}</td>"
            f"<td>{html.escape(r.engine_variant)}</td>"
            f"<td>{html.escape(r.status)}</td>"
            f"<td>{_fmt_time(r.start_time)}</td><td>{_fmt_time(r.end_time)}</td></tr>"
            for r in self._engine_rows()
        )
        ev = "".join(
            f"<tr><td>{html.escape(r.id or '')}</td>"
            f"<td>{html.escape(r.evaluation_class)}</td>"
            f"<td>{html.escape(r.status)}</td>"
            f"<td>{_fmt_time(r.start_time)}</td>"
            f"<td><pre>{html.escape(r.evaluator_results or '-')}</pre></td></tr>"
            for r in self._eval_rows()
        )
        return f"""<!doctype html><html><head><title>PredictionIO-TPU Dashboard</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #ccc;padding:4px 8px;text-align:left}}</style></head>
<body><h1>PredictionIO-TPU Dashboard <small>v{__version__}</small></h1>
<h2>Engine instances</h2>
<table><tr><th>ID</th><th>Factory</th><th>Variant</th><th>Status</th>
<th>Start</th><th>End</th></tr>{eng}</table>
<h2>Evaluation instances</h2>
<table><tr><th>ID</th><th>Evaluation</th><th>Status</th><th>Start</th>
<th>Results</th></tr>{ev}</table></body></html>"""

    def handle(self, method: str, path: str,
               params: Optional[dict] = None) -> Tuple[int, str, str]:
        if method != "GET":
            return 404, "application/json", json.dumps({"message": "Not Found"})
        if path == "/":
            return 200, "text/html; charset=UTF-8", self._index_html()
        if path == "/metrics":
            return 200, PROMETHEUS_CTYPE, self.registry.render(
                exemplars=param_bool(params, "exemplars"))
        if path == "/traces.json":
            return 200, "application/json", json.dumps(
                traces_payload(params or {}))
        if path == "/timeline.json":
            return 200, "application/json", json.dumps(
                timeline_payload(params or {}))
        if path == "/fleet.json":
            if self.fleet is None:
                return 200, "application/json", json.dumps({
                    "instances": [],
                    "message": "no fleet configured — set "
                               "PIO_FLEET_INSTANCES or `pio dashboard "
                               "--fleet URL,URL`"})
            return 200, "application/json", json.dumps(self.fleet.scrape())
        if path == "/quality.json":
            # Fleet-merged model-quality view: per-instance
            # /quality.json docs + the union-of-keys merge.
            if self.fleet is None:
                return 200, "application/json", json.dumps({
                    "enabled": False,
                    "message": "no fleet configured — set "
                               "PIO_FLEET_INSTANCES or `pio dashboard "
                               "--fleet URL,URL`"})
            doc = self.fleet.scrape()
            return 200, "application/json", json.dumps({
                "merged": doc["merged"].get("quality"),
                "instances": [
                    {"instance": row["instance"], "stale": row["stale"],
                     "quality": row.get("quality")}
                    for row in doc["instances"]],
            })
        if path == "/engine_instances.json":
            rows = [
                {"id": r.id, "status": r.status,
                 "engineFactory": r.engine_factory,
                 "variant": r.engine_variant,
                 "startTime": _fmt_time(r.start_time),
                 "endTime": _fmt_time(r.end_time)}
                for r in self._engine_rows()
            ]
            return 200, "application/json", json.dumps(rows)
        if path == "/evaluation_instances.json":
            rows = [
                {"id": r.id, "status": r.status,
                 "evaluationClass": r.evaluation_class,
                 "startTime": _fmt_time(r.start_time),
                 "results": r.evaluator_results,
                 "resultsJson": r.evaluator_results_json}
                for r in self._eval_rows()
            ]
            return 200, "application/json", json.dumps(rows)
        return 404, "application/json", json.dumps({"message": "Not Found"})

    # -- HTTP ---------------------------------------------------------------

    def _make_handler(server_self):
        class Handler(BaseHandler):
            server_log_name = "dashboard"
            trace_server_name = "dashboard"

            def pio_handle(self, method, path, params, body):
                status, ctype, payload = server_self.handle(method, path,
                                                            params)
                return status, payload, ctype

            def pio_on_complete(self, method, path, status, ms, body,
                                params):
                server_self._requests.inc(status=str(status))
                server_self._latency.observe(ms)
                return None

            def do_GET(self):  # noqa: N802
                self.dispatch("GET")

        return Handler

    def start(self, block: bool = False) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        logger.info("Dashboard listening on %s:%d", self.host, self.port)
        if block:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
