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
admin server arms a timed capture (``POST /admin/profile``) and serves
the last one as a tar.gz (:meth:`ProfilerSession.artifact`, ``GET
/admin/profile/artifact``); :func:`capture` is the local ``pio
profile``.  A timed capture is held by a thread of its own from start to
stop (:class:`_TorchCapture`).
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, TypeVar

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
    "capture",
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


# Set by ProfilerSession.capture_call around its start: that capture
# starts and stops on the calling thread.
_SAME_THREAD = threading.local()


class _TorchCapture:
    """The default backend: ``torch.profiler`` with CPU activity, and
    CUDA's where the card is available; :meth:`stop` writes the Chrome
    trace to ``<path>/trace.json``.

    ``torch.profiler``'s state is thread-local: a stop on another thread
    than the start finds no session, and the process can crash.  A timed
    capture is armed on one thread (an admin handler) and stopped on
    another (its timer), so :meth:`start` hands the profiler to a capture
    thread of its own, which holds it for the capture's whole life, and
    :meth:`stop` asks that thread to stop it and write the trace.  The
    card's kernels are recorded whichever thread launched them (CUPTI
    traces the whole process: the batcher's worker launches K3); CPU
    operator events are only the capture thread's.  A capture of one call
    (:meth:`ProfilerSession.capture_call`) starts and stops on the
    calling thread instead, so the call's own operators are recorded.
    ``profile_factory`` (default ``torch.profiler.profile(activities=
    ...)``) is injectable so a test pins which thread calls the
    profiler."""

    def __init__(self, profile_factory: Optional[Callable[[], Any]] = None):
        self._factory = profile_factory
        self._here: Optional[Tuple[Any, str]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_ev: Optional[threading.Event] = None
        self._box: Dict[str, BaseException] = {}

    @staticmethod
    def _torch_profile():
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    @staticmethod
    def _finish(prof, path: str) -> None:
        import torch

        if torch.cuda.is_initialized():
            # The window's kernels finish inside it, so their records
            # are complete when the trace stops.
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(path, TRACE_FILE))

    def start(self, path: str) -> None:
        factory = self._factory
        if factory is None:
            try:
                import torch.profiler  # noqa: F401
            except Exception as e:  # pragma: no cover - torch is a dependency
                raise ProfilerUnavailable(
                    f"torch.profiler unavailable: {e}") from e
            factory = self._torch_profile
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as e:
            raise ProfilerUnavailable(
                f"cannot write the capture to {path}: {e}") from e
        if getattr(_SAME_THREAD, "on", False):
            try:
                prof = factory()
                prof.start()
            except Exception as e:
                raise ProfilerUnavailable(
                    f"profiler capture unsupported here: {e}") from e
            self._here = (prof, path)
            return
        ready, stop_ev, box = threading.Event(), threading.Event(), {}

        def hold() -> None:
            try:
                prof = factory()
                prof.start()
            except BaseException as e:  # noqa: BLE001 - handed to start()
                box["start"] = e
                ready.set()
                return
            ready.set()
            stop_ev.wait()
            try:
                self._finish(prof, path)
            except BaseException as e:  # noqa: BLE001 - handed to stop()
                box["stop"] = e

        thread = threading.Thread(target=hold, name="pio-profiler",
                                  daemon=True)
        thread.start()
        ready.wait()
        if "start" in box:
            thread.join()
            raise ProfilerUnavailable(
                f"profiler capture unsupported here: {box['start']}"
            ) from box["start"]
        self._thread, self._stop_ev, self._box = thread, stop_ev, box

    def stop(self) -> None:
        if self._here is not None:
            (prof, path), self._here = self._here, None
            self._finish(prof, path)
            return
        thread, stop_ev, box = self._thread, self._stop_ev, self._box
        self._thread = self._stop_ev = None
        if thread is None:
            return
        stop_ev.set()
        thread.join()
        if "stop" in box:
            raise box["stop"]


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
        # Serializes in-memory artifact tar builds (see artifact()).
        self._artifact_lock = threading.Lock()
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
            _SAME_THREAD.on = True
            try:
                self._arm(path)
            finally:
                _SAME_THREAD.on = False
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

    def artifact(self) -> Optional[Tuple[bytes, str]]:
        """(tar.gz bytes, filename) of the LAST finished capture — the
        download behind ``GET /admin/profile/artifact``, so a remote
        operator needs no access to the server's disk.

        Only the session's own ``_last_path`` is ever archived — the
        endpoint cannot be steered at arbitrary server paths.  Returns
        None when no finished capture exists (HTTP 404 upstream); raises
        :class:`ProfilerBusy` while one is running (the artifact is
        still being written).

        The archive is built in memory; concurrent downloads serialize
        on a build lock so N clients cost ONE archive's peak at a time,
        not N."""
        import io
        import tarfile

        with self._artifact_lock:
            # Busy-check INSIDE the build lock: a waiter that queued
            # behind another download must re-validate, or a capture
            # armed meanwhile (same PIO_PROFILE_OUT dir) gets archived
            # while being written.
            with self._lock:
                if self._active_path is not None:
                    raise ProfilerBusy(
                        f"capture still running to {self._active_path}")
                path = self._last_path
            if not path or not os.path.isdir(path):
                return None
            buf = io.BytesIO()
            base = os.path.basename(os.path.normpath(path)) or "pio_profile"
            try:
                with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                    tar.add(path, arcname=base)
            except OSError as e:
                # Files vanished or changed mid-walk: a capture started
                # into this directory after the busy-check — the same
                # verdict as catching it before (409), never a
                # truncated archive.
                raise ProfilerBusy(
                    f"capture artifacts changed while archiving: {e}")
            return buf.getvalue(), f"{base}.tar.gz"


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


def capture(duration_ms: float, out_dir: Optional[str] = None,
            sleep: Callable[[float], None] = time.sleep) -> str:
    """Blocking capture (the local ``pio profile``): start, wait the
    window out, stop, return the artifact path."""
    session = get_profiler()
    info = session.start(duration_ms, out_dir)
    # start() caps the window at MAX_CAPTURE_MS — wait out the CAPPED
    # duration, not the raw request, or an over-asked CLI blocks long
    # after the timer already stopped the capture.
    sleep(info["durationMs"] / 1e3)
    return session.stop() or info["path"]
