"""Admin API server — app and key management and runtime operations
over REST.

Port of ``predictionio_tpu/server/admin.py`` (reference:
tools/.../tools/admin/, the experimental ``pio adminserver``, default
:7071), exposing the console's app commands as JSON endpoints:

- ``GET  /``                     → status
- ``GET  /v1/cmd/app``           → list apps (with access keys)
- ``POST /v1/cmd/app``           → create app  ``{"name": ..., "description"?}``
- ``DELETE /v1/cmd/app/<name>``  → delete app and all its data
- ``DELETE /v1/cmd/app/<name>/data`` → wipe event data only

Runtime introspection:

- ``POST /admin/profile?duration_ms=`` → arm a bounded on-demand
  ``torch.profiler`` capture of this process; answers the artifact
  path immediately, 409 while a capture runs, and a clear **501** when
  the platform cannot capture (instead of crashing).  ``GET
  /admin/profile`` → status; ``GET /admin/profile/artifact`` → the last
  finished capture as a tar.gz (404 with none, 409 while one runs).
- ``GET /timeline.json`` → the per-step pipeline timeline ring
  (``?format=chrome`` for chrome://tracing).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Storage,
    get_storage,
)
from predictionio_tpu_torch.obs.profiler import (
    ProfilerBusy,
    ProfilerUnavailable,
    get_profiler,
)
from predictionio_tpu_torch.server.http import (
    BaseHandler,
    ThreadingHTTPServer,
    timeline_payload,
)
from predictionio_tpu_torch.version import __version__

logger = logging.getLogger(__name__)

__all__ = ["AdminServer"]


class AdminServer:
    # Binds loopback by default: this surface lists every access key and
    # performs unconfirmed destructive deletes (the reference's experimental
    # adminserver is localhost-only too).  Exposing it externally requires
    # an explicit --ip.
    def __init__(self, storage: Optional[Storage] = None, host: str = "127.0.0.1",
                 port: int = 7071):
        self.storage = storage or get_storage()
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def handle(self, method: str, path: str, body: bytes,
               params: Optional[Dict[str, List[str]]] = None
               ) -> tuple:
        """(status, payload) or (status, bytes, ctype) for the binary
        artifact download."""
        params = params or {}
        try:
            if path == "/" and method == "GET":
                return 200, {"status": "alive", "version": __version__}
            if path == "/admin/profile":
                return self._handle_profile(method, params)
            if path == "/admin/profile/artifact" and method == "GET":
                # Download the finished capture as a tar.gz: a remote or
                # fleet operator needs no access to the server's disk.
                try:
                    art = get_profiler().artifact()
                except ProfilerBusy as e:
                    return 409, {"message": str(e)}
                if art is None:
                    return 404, {"message": "no finished profiler capture "
                                            "in this process"}
                data, filename = art
                return 200, data, "application/gzip", {
                    "Content-Disposition":
                        f'attachment; filename="{filename}"'}
            if path == "/timeline.json" and method == "GET":
                return 200, timeline_payload(params)
            if path == "/v1/cmd/app" and method == "GET":
                apps = self.storage.get_apps().get_all()
                keys = self.storage.get_access_keys()
                return 200, [
                    {"name": a.name, "id": a.id,
                     "accessKeys": [k.key for k in keys.get_by_app_id(a.id)]}
                    for a in apps
                ]
            if path == "/v1/cmd/app" and method == "POST":
                obj = json.loads(body.decode() or "{}")
                name = obj.get("name")
                if not name:
                    return 400, {"message": "name is required."}
                app_id = self.storage.get_apps().insert(
                    App(id=None, name=name, description=obj.get("description")))
                if app_id is None:
                    return 409, {"message": f"App {name!r} already exists."}
                self.storage.get_events().init(app_id)
                key = self.storage.get_access_keys().insert(
                    AccessKey(key="", app_id=app_id))
                return 201, {"name": name, "id": app_id, "accessKey": key}
            if path.startswith("/v1/cmd/app/") and method == "DELETE":
                rest = path[len("/v1/cmd/app/"):]
                wipe_only = rest.endswith("/data")
                name = rest[:-len("/data")] if wipe_only else rest
                app = self.storage.get_apps().get_by_name(name)
                if app is None:
                    return 404, {"message": f"App {name!r} does not exist."}
                events = self.storage.get_events()
                if wipe_only:
                    events.remove(app.id)
                    events.init(app.id)
                    return 200, {"message": f"Data of app {name!r} deleted."}
                for ch in self.storage.get_channels().get_by_app_id(app.id):
                    events.remove(app.id, ch.id)
                    self.storage.get_channels().delete(ch.id)
                events.remove(app.id)
                for k in self.storage.get_access_keys().get_by_app_id(app.id):
                    self.storage.get_access_keys().delete(k.key)
                self.storage.get_apps().delete(app.id)
                return 200, {"message": f"App {name!r} deleted."}
            return 404, {"message": "Not Found"}
        except json.JSONDecodeError as e:
            return 400, {"message": f"Invalid JSON: {e}"}
        except Exception:
            logger.exception("admin server error")
            return 500, {"message": "Internal server error."}

    def _handle_profile(self, method: str,
                        params: Dict[str, List[str]]) -> Tuple[int, dict]:
        """On-demand profiler capture."""
        profiler = get_profiler()
        if method == "GET":
            return 200, profiler.status()
        if method != "POST":
            return 404, {"message": "Not Found"}
        raw = params.get("duration_ms", ["2000"])[0]
        try:
            duration_ms = float(raw)
            if not duration_ms > 0:
                raise ValueError
        except ValueError:
            return 400, {"message": f"bad duration_ms: {raw!r}"}
        out_dir = params.get("out", [None])[0]
        try:
            info = profiler.start(duration_ms, out_dir)
        except ProfilerBusy as e:
            return 409, {"message": str(e)}
        except ProfilerUnavailable as e:
            # The clear degrade: this platform or process cannot
            # capture — a 501 the caller can act on, never a crash/500.
            return 501, {"message": f"profiler capture unavailable: {e}"}
        return 200, {"status": "profiling", **info}

    def _make_handler(server_self):
        class Handler(BaseHandler):
            server_log_name = "admin"
            trace_server_name = "admin"

            def pio_handle(self, method, path, params, body):
                return server_self.handle(method, path, body, params)

            def do_GET(self):  # noqa: N802
                self.dispatch("GET")

            def do_POST(self):  # noqa: N802
                self.dispatch("POST")

            def do_DELETE(self):  # noqa: N802
                self.dispatch("DELETE")

        return Handler

    def start(self, block: bool = False) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        logger.info("Admin server listening on %s:%d", self.host, self.port)
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
