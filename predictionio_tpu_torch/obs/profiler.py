"""On-demand ``torch.profiler`` capture.

Port of ``predictionio_tpu/obs/profiler.py``.  A continuous capture is
too heavy to leave on, so a capture is armed on demand, runs for a
bounded window (at most :data:`MAX_CAPTURE_MS`) and stops itself.  One
capture at a time per process: :class:`ProfilerBusy` otherwise.  The
reference captures a JAX xplane directory; the port's artifact is a
Chrome trace, ``trace.json`` in the capture directory (CPU activity,
and the card's kernels by name when CUDA is available), which
chrome://tracing and Perfetto open.  A platform that cannot capture
raises :class:`ProfilerUnavailable`.

The start and stop callables are injectable, so the tests drive the
whole state machine (busy, finished, cannot capture) with fakes and no
real profiler artifacts.  :meth:`ProfilerSession.capture_call` runs one
function under a capture: ``run_train``'s ``PIO_PROFILE_DIR`` path.  The
admin route and ``pio profile`` arrive with the admin server.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, TypeVar

from predictionio_tpu_torch.obs.runtime import publish_event

logger = logging.getLogger(__name__)

__all__ = [
    "MAX_CAPTURE_MS",
    "TRACE_FILE",
    "ProfilerUnavailable",
    "ProfilerBusy",
    "ProfilerSession",
    "get_profiler",
    "set_profiler",
]

# Hard ceiling on a requested capture window: an unattended multi-minute
# capture can fill a disk.
MAX_CAPTURE_MS = 600_000.0
# The Chrome trace a capture writes into its directory.
TRACE_FILE = "trace.json"

T = TypeVar("T")


class ProfilerUnavailable(RuntimeError):
    """This platform or process cannot capture a profile."""


class ProfilerBusy(RuntimeError):
    """A capture is already running."""


class _TorchCapture:
    """The default backend: ``torch.profiler`` with CPU activity, and
    CUDA's where the card is available; :meth:`stop` writes the Chrome
    trace to ``<path>/trace.json``."""

    def __init__(self):
        self._prof: Optional[Any] = None
        self._path: Optional[str] = None

    def start(self, path: str) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
        except Exception as e:  # pragma: no cover - torch is a dependency
            raise ProfilerUnavailable(
                f"torch.profiler unavailable: {e}") from e
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(path, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:
            raise ProfilerUnavailable(
                f"profiler capture unsupported here: {e}") from e
        self._prof, self._path = prof, path

    def stop(self) -> None:
        prof, path, self._prof, self._path = \
            self._prof, self._path, None, None
        if prof is None:
            return
        import torch

        if torch.cuda.is_initialized():
            # The window's kernels finish inside it, so their records
            # are complete when the trace stops.
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(path, TRACE_FILE))


class ProfilerSession:
    """One-at-a-time timed profiler capture with an injectable backend.

    ``start(duration_ms)`` arms the capture and schedules the stop on a
    timer thread; ``stop()`` is idempotent and safe to call early.  The
    artifact directory defaults to a fresh ``pio_profile_*`` temporary
    directory (override per call or through ``PIO_PROFILE_OUT``).  The
    backend defaults to ``torch.profiler`` (:class:`_TorchCapture`).
    """

    def __init__(self,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 timer_factory: Callable[..., threading.Timer]
                 = threading.Timer):
        backend = _TorchCapture()
        self._start_fn = start_fn or backend.start
        self._stop_fn = stop_fn or backend.stop
        self._clock = clock
        self._timer_factory = timer_factory
        self._lock = threading.Lock()
        self._active_path: Optional[str] = None
        self._started_at: Optional[float] = None
        self._duration_ms: float = 0.0
        self._timer: Optional[threading.Timer] = None
        self._last_path: Optional[str] = None

    def _arm(self, path: str) -> None:
        """Start the backend (under the lock); raises ProfilerBusy when a
        capture is running."""
        if self._active_path is not None:
            raise ProfilerBusy(
                f"capture already running to {self._active_path}")
        self._start_fn(path)  # ProfilerUnavailable propagates un-armed
        self._active_path = path
        self._started_at = self._clock()

    def start(self, duration_ms: float,
              out_dir: Optional[str] = None) -> Dict[str, Any]:
        """Arm a capture; returns {"path", "durationMs"}.

        Raises :class:`ProfilerBusy` when a capture is running and
        :class:`ProfilerUnavailable` when the platform cannot capture.
        """
        try:
            duration_ms = float(duration_ms)
        except (TypeError, ValueError):
            raise ValueError(f"bad duration_ms: {duration_ms!r}") from None
        if not duration_ms > 0:
            raise ValueError("duration_ms must be > 0")
        duration_ms = min(duration_ms, MAX_CAPTURE_MS)
        path = (out_dir or os.environ.get("PIO_PROFILE_OUT")
                or tempfile.mkdtemp(prefix="pio_profile_"))
        with self._lock:
            self._arm(path)
            self._duration_ms = duration_ms
            self._timer = self._timer_factory(duration_ms / 1e3, self.stop)
            self._timer.daemon = True
            self._timer.start()
        publish_event("profiler.start", path=path,
                      durationMs=round(duration_ms, 1))
        logger.info("profiler capture started: %s (%.0f ms)", path,
                    duration_ms)
        return {"path": path, "durationMs": duration_ms}

    def stop(self) -> Optional[str]:
        """Finish the active capture; returns its path (None if idle)."""
        with self._lock:
            path = self._active_path
            if path is None:
                return None
            timer, self._timer = self._timer, None
            self._active_path = None
            self._started_at = None
            self._last_path = path
            try:
                self._stop_fn()
            except Exception:
                # The window still produced whatever landed on disk
                # before the stop failed: report the path anyway.
                logger.exception("profiler stop failed (artifacts may be "
                                 "partial): %s", path)
        if timer is not None:
            timer.cancel()
        publish_event("profiler.stop", path=path)
        logger.info("profiler capture finished: %s", path)
        return path

    def capture_call(self, path: str, fn: Callable[[], T]) -> T:
        """Run ``fn`` under a capture into ``path`` (no timer: the
        capture lasts exactly the call) and return its result; the
        capture stops whether ``fn`` returns or raises."""
        with self._lock:
            self._arm(path)
            self._duration_ms = 0.0
        publish_event("profiler.start", path=path)
        logger.info("profiler capture of the call started: %s", path)
        try:
            return fn()
        finally:
            self.stop()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            if self._active_path is None:
                return {"active": False, "lastPath": self._last_path}
            elapsed_ms = (self._clock() - (self._started_at or 0.0)) * 1e3
            return {"active": True, "path": self._active_path,
                    "durationMs": self._duration_ms,
                    "remainingMs": max(self._duration_ms - elapsed_ms, 0.0)}


_profiler = ProfilerSession()
_profiler_lock = threading.Lock()


def get_profiler() -> ProfilerSession:
    """THE process profiler session."""
    return _profiler


def set_profiler(session: ProfilerSession) -> ProfilerSession:
    """Swap the process session (tests); returns the previous one."""
    global _profiler
    with _profiler_lock:
        prev, _profiler = _profiler, session
    return prev

