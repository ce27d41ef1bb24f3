"""Run supervision: the crash-safe training loop and the reload's
model validation.

Port of ``predictionio_tpu/resilience/supervision.py``:

- :class:`StepWatchdog` — a device step exceeding ``PIO_STEP_TIMEOUT_S``
  fires ``pio_watchdog_fired_total{fn}``, logs the last step-timeline
  entry, flushes pending checkpoint saves (so the resume point is
  durable), and aborts the run instead of hanging forever; with
  ``PIO_STEP_TIMEOUT_KILL`` a run that does not unwind within the grace
  is killed.  Injectable clock — the tests run on fakes with no sleeps.
- :class:`DivergenceGuard` — a non-finite loss or parameter tree rolls
  the run back to the last-good checkpoint (:class:`RollbackRequested`),
  at most ``PIO_DIVERGENCE_RETRIES`` times, then raises
  :class:`TrainDiverged`.  A NaN model is never silently persisted.
- Preemption — SIGTERM sets a process-wide flag
  (:func:`install_preemption_handler`); the loops notice at the next
  step boundary, write a final checkpoint and raise
  :class:`TrainPreempted` (``pio train`` exits
  :data:`PREEMPTED_EXIT_CODE`; ``pio train --follow`` stops on it).
- :func:`validate_model_finite` — the finite-params gate of the engine
  server's staged reload, over :func:`iter_model_arrays`.

The reference walks pytrees with ``jax.tree_util``; the port takes
tensors, numpy arrays, floats, and (nested) lists, tuples and dicts of
them.  A tensor is reduced where it lives, so one boolean crosses to
the host; integer leaves (PQ codes, IVF lists) are skipped.  Each divergence,
watchdog fire and hard kill also lands in the trace ring as the
reference's ``train.diverged``, ``watchdog.fired`` and
``watchdog.killed`` events.
"""

from __future__ import annotations

import json
import logging
import math
import os
import signal
import threading
import time
import _thread
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.obs import get_registry, publish_event

logger = logging.getLogger(__name__)

__all__ = [
    "PREEMPTED_EXIT_CODE",
    "StepTimedOut",
    "TrainDiverged",
    "TrainPreempted",
    "RollbackRequested",
    "ModelValidationError",
    "StepWatchdog",
    "DivergenceGuard",
    "install_preemption_handler",
    "request_preemption",
    "preemption_requested",
    "clear_preemption",
    "all_finite",
    "iter_model_arrays",
    "validate_model_finite",
]

# Exit code `pio train` uses after a SIGTERM-triggered preemption:
# 128 + SIGTERM, the code a supervisor already expects from a
# terminated process.
PREEMPTED_EXIT_CODE = 143


class StepTimedOut(RuntimeError):
    """A device step exceeded ``PIO_STEP_TIMEOUT_S`` (watchdog abort)."""


class TrainDiverged(RuntimeError):
    """Training produced non-finite state and exhausted its rollbacks."""

    def __init__(self, fn: str, step: int, what: str, rollbacks: int):
        super().__init__(
            f"{fn} training diverged at step {step} ({what}) after "
            f"{rollbacks} rollback(s) to the last-good checkpoint; the "
            "non-finite model was NOT persisted.  Lower the learning "
            "rate or inspect the data for this window.")
        self.fn = fn
        self.step = step
        self.rollbacks = rollbacks


class TrainPreempted(RuntimeError):
    """SIGTERM during training: the run handed back.

    ``checkpointed`` says whether a resume point exists (False when the
    run had no checkpoint directory — the rerun then starts fresh)."""

    def __init__(self, fn: str, step: int, checkpointed: bool):
        how = ("final checkpoint written — a rerun resumes from it"
               if checkpointed else
               "no checkpoint dir — a rerun restarts from scratch")
        super().__init__(
            f"{fn} training preempted at step {step} ({how}).")
        self.fn = fn
        self.step = step
        self.checkpointed = checkpointed


class RollbackRequested(Exception):
    """Internal control flow: re-enter the training loop from the last
    checkpoint.  Never escapes a ``train()`` entry point."""

    def __init__(self, step: int, what: str):
        super().__init__(f"rollback from step {step}: {what}")
        self.step = step
        self.what = what


class ModelValidationError(RuntimeError):
    """A candidate model failed reload validation (finite check/canary)."""


# -- preemption flag ---------------------------------------------------------

_preempted = threading.Event()


def request_preemption() -> None:
    """Ask the running training loops to hand back."""
    _preempted.set()


def preemption_requested() -> bool:
    return _preempted.is_set()


def clear_preemption() -> None:
    _preempted.clear()


def install_preemption_handler() -> bool:
    """SIGTERM → preemption flag (idempotent; False off the main thread).
    SIGINT keeps its KeyboardInterrupt semantics."""

    def _handler(signum, frame):
        logger.warning("SIGTERM: preemption requested — training will "
                       "hand back at the next step boundary and exit %d",
                       PREEMPTED_EXIT_CODE)
        request_preemption()

    try:
        signal.signal(signal.SIGTERM, _handler)
        return True
    except (ValueError, OSError):  # non-main thread / exotic platform
        return False


# -- finiteness --------------------------------------------------------------

def _leaf_finite(x: Any) -> bool:
    """True when ``x`` is not a non-finite float tensor/array/scalar (a
    sharded array: none of its blocks)."""
    from predictionio_tpu_torch.parallel.mesh import ShardedTensor

    if isinstance(x, ShardedTensor):
        return all(_leaf_finite(t) for t in x.shards if t is not None)
    if isinstance(x, torch.Tensor):
        if not (x.is_floating_point() or x.is_complex()):
            return True
        # Reduced where it lives: one boolean crosses to the host.
        return bool(torch.isfinite(x).all())
    if isinstance(x, np.ndarray):
        if not np.issubdtype(x.dtype, np.inexact):
            return True
        return bool(np.isfinite(x).all())
    if isinstance(x, (float, np.floating)):
        return math.isfinite(float(x))
    return True


def all_finite(tree: Any) -> bool:
    """Every floating-point leaf of ``tree`` is finite."""
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(all_finite(v) for v in tree)
    return _leaf_finite(tree)


_ATOMIC = (str, bytes, bool, int, float, complex, type(None))


def iter_model_arrays(obj: Any, max_depth: int = 6,
                      _path: str = "model") -> Iterator[Tuple[str, Any]]:
    """Yield ``(path, array)`` for every tensor or numpy array (or
    numpy scalar) reachable
    inside an arbitrary model object (dataclasses, dicts, sequences,
    plain ``__dict__`` objects), bounded by ``max_depth``.  Attributes
    starting with ``_`` (transient serving state) are not walked."""
    if max_depth < 0 or isinstance(obj, _ATOMIC):
        return
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        yield _path, obj
        return
    # Atomic children are filtered BEFORE any path-string formatting: a
    # model holding a large plain dict (str → score) costs one
    # isinstance per entry here, not a formatted path per entry.
    if isinstance(obj, dict):
        items = ((f"{_path}[{k!r}]", v) for k, v in obj.items()
                 if not isinstance(v, _ATOMIC))
    elif isinstance(obj, (list, tuple)):
        items = ((f"{_path}[{i}]", v) for i, v in enumerate(obj)
                 if not isinstance(v, _ATOMIC))
    elif hasattr(obj, "__dict__"):
        items = ((f"{_path}.{k}", v) for k, v in vars(obj).items()
                 if not k.startswith("_") and not isinstance(v, _ATOMIC))
    else:
        return
    for p, v in items:
        yield from iter_model_arrays(v, max_depth - 1, p)


def validate_model_finite(model: Any, name: str = "model") -> None:
    """Raise :class:`ModelValidationError` naming the first non-finite
    array found anywhere inside ``model`` (the reload sanity gate)."""
    for path, arr in iter_model_arrays(model, _path=name):
        if not _leaf_finite(arr):
            raise ModelValidationError(
                f"candidate model has non-finite values at {path} "
                f"(shape {tuple(arr.shape)}) — refusing to "
                "serve it")


# -- divergence guard --------------------------------------------------------

class DivergenceGuard:
    """Bounded-rollback divergence policy for one training run.

    ``check(loss, step)`` / ``check_params(tree, step)`` return silently
    while the values are finite.  On the first non-finite observation
    they raise :class:`RollbackRequested` (the loop re-enters from the
    last-good checkpoint); after ``max_rollbacks`` observations they
    raise :class:`TrainDiverged`.  Every observation increments
    ``pio_train_divergence_total{fn}`` and lands a ``train.diverged``
    event in the trace ring."""

    def __init__(self, fn: str, max_rollbacks: Optional[int] = None,
                 registry=None):
        if max_rollbacks is None:
            try:
                max_rollbacks = int(
                    os.environ.get("PIO_DIVERGENCE_RETRIES", "2"))
            except ValueError:
                max_rollbacks = 2
        self.fn = fn
        self.max_rollbacks = max(0, int(max_rollbacks))
        self.rollbacks = 0
        self._registry = registry

    def _counter(self):
        return (self._registry or get_registry()).counter(
            "pio_train_divergence_total",
            "Non-finite loss/params observations per training loop.",
            ("fn",))

    def check(self, loss: Any, step: int) -> None:
        """Host-side finiteness check of a READY loss scalar (one
        float())."""
        try:
            value = float(loss)
        except TypeError:
            return
        if math.isfinite(value):
            return
        self.diverged(step, f"loss={value}")

    def check_vector(self, losses: Any, steps: Any) -> None:
        """Finiteness check of a fused window's per-step loss vector.

        ``losses`` is the K-vector a fused window returned (or a scalar —
        the unfused path); ``steps`` maps each slot to its
        global step number (scalar or sequence, aligned with ``losses``).
        The loops call this after the probe's sync, so the vector is
        ready and the check costs one host read of K floats.  A
        NaN at slot j attributes the divergence to slot j's step — the
        rollback target (always a fusion-boundary checkpoint) precedes
        it by construction."""
        if isinstance(losses, torch.Tensor):
            losses = losses.detach().cpu().numpy()
        arr = np.asarray(losses, dtype=np.float64).reshape(-1)
        bad = np.flatnonzero(~np.isfinite(arr))
        if bad.size == 0:
            return
        j = int(bad[0])
        step_list = np.asarray(steps).reshape(-1)
        step = int(step_list[min(j, len(step_list) - 1)])
        what = f"loss={arr[j]}"
        if arr.size > 1:
            what += f" (slot {j + 1}/{arr.size} of the fused window)"
        self.diverged(step, what)

    def check_params(self, tree: Any, step: int) -> None:
        if all_finite(tree):
            return
        self.diverged(step, "non-finite params")

    def diverged(self, step: int, what: str) -> None:
        """Record one observed divergence: raises
        :class:`RollbackRequested` while rollbacks remain, then
        :class:`TrainDiverged`."""
        self._counter().inc(fn=self.fn)
        will_rollback = self.rollbacks < self.max_rollbacks
        publish_event("train.diverged", fn=self.fn, step=int(step),
                      what=what, rollback=will_rollback)
        if not will_rollback:
            raise TrainDiverged(self.fn, step, what, self.rollbacks)
        self.rollbacks += 1
        logger.warning(
            "%s: non-finite training state at step %d (%s) — rolling "
            "back to the last-good checkpoint (rollback %d/%d)",
            self.fn, step, what, self.rollbacks, self.max_rollbacks)
        raise RollbackRequested(step, what)


# -- step watchdog -----------------------------------------------------------

def _default_abort() -> None:
    """Raise KeyboardInterrupt in the main thread — unwinds ``pio train``
    through its normal teardown.  A runtime hung inside a C call may not
    honor it; ``PIO_STEP_TIMEOUT_KILL`` (below) or the supervisor's
    process-level timeout is the backstop."""
    _thread.interrupt_main()


def _default_kill() -> None:
    """Hard escalation: SIGKILL this process.  The soft abort above
    cannot unwind a runtime wedged inside a C call (a CUDA call, a
    stuck collective) — interrupt_main only fires when the interpreter
    next runs bytecode.  By the time this runs the checkpoint flush already
    happened at fire time, so the kill loses nothing a resume needs."""
    os.kill(os.getpid(), signal.SIGKILL)


class StepWatchdog:
    """Deadline monitor over individual device steps.

    The training loop arms the watchdog before blocking on a step and
    disarms after the step dispatches; a step still armed past
    ``timeout_s`` (env ``PIO_STEP_TIMEOUT_S``; unset/0 disables) fires
    exactly once: ``pio_watchdog_fired_total{fn}`` increments, the last
    step-timeline entry is logged, ``checkpoint_fn`` runs (the loops pass the
    checkpointer's flush, making the resume point durable), then
    ``abort_fn`` aborts the run instead of letting it hang forever.

    **Hard escalation** (opt-in, ``PIO_STEP_TIMEOUT_KILL`` = grace
    seconds): the soft abort raises KeyboardInterrupt in the main
    thread, which a runtime wedged inside a C call never observes.  With
    a kill grace set, the poller keeps watching after a fire; if the run
    has not unwound (reached :meth:`stop`) within the grace, it
    escalates to ``kill_fn`` (default: SIGKILL self).  The fire-time
    checkpoint flush already made the resume point durable, so the kill
    trades a clean traceback for actually releasing the supervisor.

    ``clock`` / ``abort_fn`` / ``checkpoint_fn`` / ``kill_fn`` are
    injectable and :meth:`poll` is public, so the fault matrix drives
    expiry AND escalation on a fake clock with no wall sleeps and no
    real signals.  The background poller thread starts lazily on the
    first :meth:`arm` (never when disabled, or when
    ``poll_interval_s <= 0``)."""

    def __init__(self, fn: str, timeout_s: Optional[float] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 checkpoint_fn: Optional[Callable[[], None]] = None,
                 abort_fn: Callable[[], None] = _default_abort,
                 kill_grace_s: Optional[float] = None,
                 kill_fn: Callable[[], None] = _default_kill,
                 poll_interval_s: Optional[float] = None,
                 registry=None, timeline=None):
        if timeout_s is None:
            try:
                timeout_s = float(os.environ.get("PIO_STEP_TIMEOUT_S", "0"))
            except ValueError:
                timeout_s = 0.0
        if kill_grace_s is None:
            try:
                kill_grace_s = float(
                    os.environ.get("PIO_STEP_TIMEOUT_KILL", "0"))
            except ValueError:
                kill_grace_s = 0.0
        self.fn = fn
        self.timeout_s = float(timeout_s)
        self.kill_grace_s = float(kill_grace_s)
        self._clock = clock
        self._checkpoint_fn = checkpoint_fn
        self._abort_fn = abort_fn
        self._kill_fn = kill_fn
        self._fired_at: Optional[float] = None
        self._killed = False
        if poll_interval_s is None:
            poll_interval_s = min(1.0, self.timeout_s / 4) \
                if self.timeout_s > 0 else 0.0
        self.poll_interval_s = float(poll_interval_s)
        self._registry = registry
        self._timeline = timeline
        self._lock = threading.Lock()
        self._armed: Optional[Tuple[int, float]] = None  # (step, deadline)
        self.fired_steps: List[int] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def _counter(self):
        return (self._registry or get_registry()).counter(
            "pio_watchdog_fired_total",
            "Device steps that exceeded PIO_STEP_TIMEOUT_S.", ("fn",))

    def arm(self, step: int, scale: int = 1) -> None:
        """Arm for one device dispatch.  ``scale`` stretches the deadline
        for fused dispatches covering K steps: the timeout stays a
        per-step budget, so K fused steps get K times the wall."""
        if not self.enabled:
            return
        deadline = self._clock() + self.timeout_s * max(int(scale), 1)
        with self._lock:
            self._armed = (int(step), deadline)
        self._ensure_thread()

    def disarm(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._armed = None

    def poll(self) -> bool:
        """Check the armed deadline; fire (once) when expired.  After a
        fire, keep watching for the opt-in hard escalation: a run that
        has not unwound (stopped this watchdog) within
        ``kill_grace_s`` of the fire is wedged past what the soft abort
        can reach — ``kill_fn`` it."""
        with self._lock:
            if self._armed is None:
                if (self._fired_at is not None and self.kill_grace_s > 0
                        and not self._killed
                        and self._clock() - self._fired_at
                        >= self.kill_grace_s):
                    self._killed = True
                else:
                    return False
                escalate = True
            else:
                step, deadline = self._armed
                if self._clock() < deadline:
                    return False
                self._armed = None  # consume: fire exactly once per arm
                escalate = False
        if escalate:
            self._escalate()
            return True
        self._fire(step)
        return True

    def _escalate(self) -> None:
        self._kill_counter().inc(fn=self.fn)
        publish_event("watchdog.killed", fn=self.fn,
                      graceS=self.kill_grace_s)
        logger.critical(
            "%s: run did not unwind within PIO_STEP_TIMEOUT_KILL=%.1fs of "
            "the watchdog abort (runtime wedged in a C call?) — hard-"
            "killing the process; the fire-time checkpoint flush is the "
            "resume point", self.fn, self.kill_grace_s)
        self._kill_fn()

    def _kill_counter(self):
        return (self._registry or get_registry()).counter(
            "pio_watchdog_killed_total",
            "Hard kills after a fired watchdog failed to unwind within "
            "PIO_STEP_TIMEOUT_KILL.", ("fn",))

    def _fire(self, step: int) -> None:
        self.fired_steps.append(step)
        with self._lock:
            self._fired_at = self._clock()
        self._counter().inc(fn=self.fn)
        from predictionio_tpu_torch.obs.runtime import get_timeline

        last = (self._timeline or get_timeline()).recent(1, model=self.fn)
        # JSON-encoded: trace attrs keep only primitives, and the last
        # timeline entry is the evidence ("the step before the hang
        # looked like THIS") an operator reads out of /traces.json.
        publish_event("watchdog.fired", fn=self.fn, step=step,
                      timeoutS=self.timeout_s,
                      lastStep=json.dumps(last[0]) if last else None)
        logger.critical(
            "%s: device step %d exceeded PIO_STEP_TIMEOUT_S=%.1fs — "
            "flushing checkpoints and aborting the run (last timeline "
            "entry: %s)", self.fn, step, self.timeout_s,
            json.dumps(last[0]) if last else "none")
        if self._checkpoint_fn is not None:
            try:
                self._checkpoint_fn()
            except Exception:
                logger.exception("watchdog checkpoint flush failed")
        self._abort_fn()

    # -- background poller ---------------------------------------------------

    def _ensure_thread(self) -> None:
        if self.poll_interval_s <= 0:
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"pio-watchdog-{self.fn}",
                daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll()
            except Exception:
                logger.exception("watchdog poll failed")

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        with self._lock:
            # Reaching stop() IS the unwind the kill escalation waits
            # for — the abort worked, stand down.
            self._fired_at = None
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None
        self.disarm()
