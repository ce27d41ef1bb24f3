"""Server plugin seam — injected request-level instrumentation.

Port of ``predictionio_tpu/server/plugins.py``; the same
``module:factory`` specs load in either package.  Reference: ``EngineServerPlugin`` (core/.../workflow/) and
``EventServerPlugin`` (data/.../data/api/) per SURVEY.md §5.1: the
reference's engine and event servers discover plugin implementations at
startup (ServiceLoader-style) and invoke them around requests.  Here
discovery is env-driven (matching this rebuild's storage-registry
convention): a comma-separated list of ``module:factory`` specs in

- ``PIO_EVENTSERVER_PLUGINS``  — loaded by every EventServer
- ``PIO_ENGINESERVER_PLUGINS`` — loaded by every EngineServer

Each factory is imported and called with no arguments and must return a
:class:`ServerPlugin` (or any object with its methods).  Plugins see
every request of the python HTTP frontends.

A plugin must never take the server down: exceptions from plugin hooks
are logged and swallowed, and header names/values are sanitized against
CRLF header injection before they reach a response.
"""

from __future__ import annotations

import importlib
import logging
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["ServerPlugin", "PluginManager", "MetricsPlugin",
           "make_metrics_plugin"]


class ServerPlugin:
    """Base class for server plugins (subclassing is optional — any
    object with these methods works).

    - :meth:`start` runs once at server startup with the server object.
    - :meth:`on_request` runs per request with the route
      (``"METHOD /path"``), response status, and handling time; it may
      return a dict of response headers to inject.
    - :meth:`stop` runs at server shutdown.
    """

    name = "plugin"

    def start(self, server) -> None:  # pragma: no cover - default no-op
        pass

    def on_request(self, route: str, status: int,
                   ms: float) -> Optional[Dict[str, str]]:
        return None

    def stop(self) -> None:  # pragma: no cover - default no-op
        pass


def _sanitize(s: str) -> str:
    """Strip CR/LF so a plugin-supplied value cannot inject headers."""
    return str(s).replace("\r", " ").replace("\n", " ")


class MetricsPlugin(ServerPlugin):
    """Exemplar plugin: feed ``on_request`` into the shared obs registry.

    Proves the plugin seam and the built-in server instrumentation report
    through the SAME pipeline: this plugin's
    ``pio_plugin_requests_total{route,status}`` series and the server's
    built-in ``pio_*_requests_total`` counters land in one registry and
    one ``/metrics`` exposition, and must agree on totals.  Enable with::

        PIO_EVENTSERVER_PLUGINS=predictionio_tpu_torch.server.plugins:make_metrics_plugin

    Note the ``route`` label carries the raw request path, so its
    cardinality is client-controlled (e.g. ``/events/<id>.json``) — fine
    for a trusted deployment, something to aggregate for a public one.
    """

    name = "metrics"

    def __init__(self, registry=None):
        from predictionio_tpu_torch.obs import get_registry

        reg = registry or get_registry()
        self.requests = reg.counter(
            "pio_plugin_requests_total",
            "Requests seen by the metrics plugin, by route and status.",
            ("route", "status"))
        self.latency = reg.histogram(
            "pio_plugin_request_latency_ms",
            "Request latency as seen by the metrics plugin.")

    def on_request(self, route: str, status: int,
                   ms: float) -> Optional[Dict[str, str]]:
        self.requests.inc(route=route, status=str(status))
        self.latency.observe(ms)
        return None


def make_metrics_plugin() -> MetricsPlugin:
    """Env-spec factory (``module:factory`` discovery contract)."""
    return MetricsPlugin()


class PluginManager:
    """Loads, starts, and fans requests out to the server's plugins."""

    def __init__(self, plugins: Iterable[ServerPlugin] = ()):
        self.plugins: List[ServerPlugin] = list(plugins)
        self._lock = threading.Lock()
        self._started = False

    @classmethod
    def from_env(cls, env_var: str,
                 extra_specs: Sequence[str] = ()) -> "PluginManager":
        """``module:factory[,module:factory...]`` from ``env_var`` plus
        any explicit ``extra_specs`` (e.g. an engine.json list)."""
        specs = [s.strip() for s in os.environ.get(env_var, "").split(",")
                 if s.strip()]
        specs.extend(extra_specs)
        plugins = []
        for spec in specs:
            try:
                mod_name, _, factory_name = spec.partition(":")
                if not factory_name:
                    raise ValueError(
                        f"plugin spec {spec!r} must be module:factory")
                factory = getattr(importlib.import_module(mod_name),
                                  factory_name)
                plugins.append(factory())
            except Exception:
                logger.exception("failed to load server plugin %r", spec)
        return cls(plugins)

    def start(self, server) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        for p in self.plugins:
            try:
                p.start(server)
            except Exception:
                logger.exception("plugin %s start failed",
                                 getattr(p, "name", p))

    def on_request(self, route: str, status: int, ms: float) -> Dict[str, str]:
        """Fan out one request notification; merge injected headers."""
        headers: Dict[str, str] = {}
        for p in self.plugins:
            try:
                h = p.on_request(route, status, ms)
                if h:
                    headers.update({_sanitize(k): _sanitize(v)
                                    for k, v in h.items()})
            except Exception:
                logger.exception("plugin %s on_request failed",
                                 getattr(p, "name", p))
        return headers

    def header_block(self, route: str, status: int, ms: float) -> str:
        """CRLF-joined header lines for the native frontend's
        ``pio_batch_respond_ex``; empty string when nothing to inject."""
        headers = self.on_request(route, status, ms)
        if not headers:
            return ""
        return "".join(f"{k}: {v}\r\n" for k, v in headers.items())

    def stop(self) -> None:
        for p in self.plugins:
            try:
                p.stop()
            except Exception:
                logger.exception("plugin %s stop failed",
                                 getattr(p, "name", p))

    def __bool__(self) -> bool:
        return bool(self.plugins)
