"""Overlapped input pipeline: background batch prep + device prefetch.

Port of ``predictionio_tpu/data/prefetch.py``.  :class:`DevicePrefetcher`
moves the serialized host work of a training step — tail-batch padding,
dtype conversion and the host-to-device copy — off the step loop:

- a background **prep thread** pulls raw batches from the host iterator
  (``numpy_epochs`` / ``feeder_epochs``), runs the caller's ``prep_fn``
  and eagerly issues the device transfer (:func:`device_put`, or a
  caller ``put_fn``), so batch N+1's copy rides under batch N's device
  compute instead of serializing after it;
- a **bounded queue** (depth ``PIO_PREFETCH_DEPTH``, default 2) keeps the
  prep thread at most ``depth`` batches ahead;
- **resume fast-forward** (``skip_steps``): batches a checkpoint restore
  already covers are consumed from the source (the per-epoch shuffles
  must advance identically) but skipped before any prep or transfer;
- **superbatch staging** (``fuse_steps`` K / a shared
  :class:`~predictionio_tpu_torch.data.fusion.FusionPlan`): K
  consecutive prepped batches are stacked along a new leading axis and
  transferred as ONE superbatch (``fused_put_fn``) for the models' K-step
  fused windows; ``batch_scale`` M additionally concatenates M prepped
  batches per slot.  A stream ending mid-window flushes complete slots
  singly and leftovers at their base shape; a resume landing mid-window
  replays the remainder unfused so windows stay aligned to the absolute
  boundaries an uninterrupted run would use;
- **clean shutdown + exception propagation**: errors raised by the
  source, ``prep_fn`` or the transfer surface in the consuming thread at
  the next ``next()``; ``close()`` (or leaving the ``with`` block) stops
  the thread, closes the source generator on the prep thread, and joins.

The transfer (:func:`device_put`, the reference's ``jax.device_put``):
on a CUDA device each array is copied from pinned host memory with
``.to(device, non_blocking=True)`` on a side ``torch.cuda.Stream`` and an
event is recorded there; the consumer, at ``next()``, makes its current
stream wait on that event and calls ``record_stream`` on the tensors
so the allocator cannot hand their memory out again while the step that
reads them is queued.  On the CPU the put is ``torch.from_numpy``.
Superbatch assembly may reuse host buffers (:class:`StagingPool`,
allocated pinned with ``torch.empty(..., pin_memory=True)`` when CUDA is
present): ``PIO_PINNED_STAGING=auto`` pools when the prefetcher's device
is CUDA.  ``put_fn``/clock are injectable so unit tests exercise
ordering, backpressure and shutdown with fakes.
"""


from __future__ import annotations

import atexit
import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

from predictionio_tpu_torch.data.fusion import FusionPlan

__all__ = ["DevicePrefetcher", "PrefetchedBatch", "prefetch_depth",
           "StagingPool", "device_put"]

# Live prefetchers, swept at interpreter exit: a prep thread still inside
# a device transfer or a native-feeder call while CPython tears down is a
# crash (daemon threads are frozen mid-C-call; C++ static destructors
# then run under them).  Normal lifecycles never reach this — the sweep
# is the backstop for abandoned iterators.
_live: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _close_live_prefetchers() -> None:
    for pf in list(_live):
        try:
            pf.close()
        except Exception:
            pass

DEFAULT_DEPTH = 2

# Producer-side poll granularity for stop/backpressure checks.  Queue
# put/get with a timeout wake immediately on space/data; the timeout only
# bounds how stale a stop request can go unnoticed.
_POLL_S = 0.05

_PAGE_ALIGN = 4096  # host staging buffers align to a page boundary


def _aligned_empty(shape, dtype, align: int = _PAGE_ALIGN):
    """Uninitialized host array whose data pointer is page-aligned —
    what a PCIe DMA engine wants to see on the staging side."""
    import numpy as np

    dt = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dt.itemsize
    raw = np.empty(nbytes + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + nbytes].view(dt).reshape(shape)


def _pinned_empty(shape, dtype):
    """Uninitialized page-locked host array (a numpy view of a pinned
    ``torch.empty``; the view keeps the tensor alive) — what the card's
    DMA engine copies from without a bounce buffer."""
    import numpy as np
    import torch

    dt = np.dtype(dtype)
    t = torch.empty(int(np.prod(shape)) * dt.itemsize, dtype=torch.uint8,
                    pin_memory=True)
    return t.numpy().view(dt).reshape(shape)


class StagingPool:
    """Ring of page-aligned, REUSABLE host buffers for superbatch
    assembly: a fused window otherwise pays a fresh multi-MB allocation
    and page-fault walk.

    One ring per (shape, dtype) key; the first ``slots`` requests
    allocate, later ones rotate through the ring.  Safety contract: a
    buffer handed out is rewritten only after ``slots`` newer windows
    were staged — with ``slots = depth + 2`` the copy of the batch it
    carried completed long before reuse *provided the device put COPIES
    the host memory* (a CUDA put does; the CPU put aliases numpy buffers
    zero-copy, which is why pooling is gated off there — see
    ``DevicePrefetcher`` ``pin_buffers``).  ``pinned`` (default: CUDA is
    available) allocates page-locked memory through PyTorch; otherwise
    the buffers are page-aligned numpy.

    Single-producer by design: only the prep thread touches a pool.
    """

    __slots__ = ("slots", "pinned", "_rings", "_next", "reused",
                 "allocated")

    def __init__(self, slots: int, pinned: Optional[bool] = None):
        self.slots = max(int(slots), 2)
        if pinned is None:
            import torch

            pinned = torch.cuda.is_available()
        self.pinned = bool(pinned)
        self._rings: dict = {}
        self._next: dict = {}
        self.reused = 0
        self.allocated = 0

    def take(self, shape, dtype, tag: int = 0):
        import numpy as np

        # ``tag`` separates pytree leaves that share a shape/dtype —
        # two leaves drawing from one ring would halve the rotation
        # distance the safety contract is built on.
        key = (tag, tuple(int(s) for s in shape), np.dtype(dtype).str)
        ring = self._rings.setdefault(key, [])
        if len(ring) < self.slots:
            buf = (_pinned_empty if self.pinned else _aligned_empty)(
                shape, dtype)
            ring.append(buf)
            self.allocated += 1
            return buf
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % self.slots
        self.reused += 1
        return ring[i]


def prefetch_depth(default: int = DEFAULT_DEPTH) -> int:
    """``PIO_PREFETCH_DEPTH`` (min 1): staged batches the prep thread may
    run ahead.  2 = classic double buffering (one in flight on the
    device, one staged)."""
    try:
        depth = int(os.environ.get("PIO_PREFETCH_DEPTH", str(default)))
    except ValueError:
        depth = default
    return max(depth, 1)


class PrefetchedBatch:
    """One staged batch: device args + the overlap-window bookkeeping.

    A fused superbatch (``k > 1``) carries ``k`` scan slots stacked on a
    new leading axis; ``steps`` counts the raw source batches consumed
    (``k`` · batch_scale), so ``step`` — the LAST raw batch number — and
    ``step - steps + 1`` bound the window."""

    __slots__ = ("step", "args", "examples", "h2d_ms", "staged_s",
                 "steps", "k")

    def __init__(self, step: int, args: Any, examples: int,
                 h2d_ms: float, staged_s: float,
                 steps: int = 1, k: int = 1):
        self.step = step          # 1-based global batch number (post-skip)
        self.args = args          # device tensors, ready to dispatch
        self.examples = examples  # real (pre-padding) examples
        self.h2d_ms = h2d_ms      # prep + transfer time on the prep thread
        self.staged_s = staged_s  # wall clock when staging finished
        self.steps = steps        # raw source batches in this dispatch
        self.k = k                # scan slots (fused depth; 1 = unfused)


class _Done:
    """End-of-stream sentinel (the producer's last queue item)."""

    __slots__ = ()


_DONE = _Done()


class DevicePrefetcher:
    """Background batch-prep + bounded device prefetch over a host iterator.

    Integration shape (two_tower ``_train_attempt``)::

        with DevicePrefetcher(epochs(), prep_fn, put_fn=put,
                              skip_steps=start_step, model="two_tower") as pf:
            for batch in probe.iter_prefetched(pf):   # PrefetchedBatch
                probe.sync()                          # wait on step N-1
                state, loss = train_step(state, *batch.args, cfg)
                probe.dispatched(state, examples=batch.examples)

    ``prep_fn(raw_batch)`` runs on the prep thread and returns the padded,
    dtype-converted host arrays; ``put_fn(arrays)`` issues the device
    transfer (default: :func:`device_put` onto ``device``, the card
    unless ``"cpu"`` is asked for) — on the card the copy proceeds while
    the device executes the previous step, which is the point.
    ``count_fn(raw_batch)`` reports the real example count
    before padding (default ``len(batch[0])``).

    ``fuse_steps`` / ``batch_scale`` (or a live ``fuse_plan`` the
    autotuner retargets between windows) turn on superbatch staging:
    each window consumes K·M prepped batches, concatenates M per scan
    slot, stacks the K slots on a new leading axis and transfers the
    result via ``fused_put_fn`` (default: ``put_fn``).
    """

    def __init__(
        self,
        source: Iterable,
        prep_fn: Callable[[Any], Any],
        *,
        put_fn: Optional[Callable[[Any], Any]] = None,
        fused_put_fn: Optional[Callable[[Any], Any]] = None,
        depth: Optional[int] = None,
        skip_steps: int = 0,
        fuse_steps: int = 1,
        batch_scale: int = 1,
        fuse_plan: Optional[FusionPlan] = None,
        pin_buffers: Optional[bool] = None,
        device=None,
        count_fn: Optional[Callable[[Any], int]] = None,
        clock: Callable[[], float] = time.perf_counter,
        wall_clock: Callable[[], float] = time.time,
        model: str = "",
        registry=None,
    ):
        self.depth = prefetch_depth() if depth is None else max(int(depth), 1)
        self._source = source
        self._prep_fn = prep_fn
        # The device a default put copies onto, and what
        # PIO_PINNED_STAGING=auto reads; unknown (None) with a caller's
        # put_fn and no device named.
        self._device = None
        if put_fn is None or device is not None:
            from predictionio_tpu_torch.device import device as resolve

            self._device = resolve(device)
        if put_fn is None:
            dev = self._device
            put_fn = lambda arrays: device_put(arrays, dev)  # noqa: E731
        self._put_fn = put_fn
        self._fused_put_fn = fused_put_fn if fused_put_fn is not None \
            else self._put_fn
        self._count_fn = count_fn if count_fn is not None \
            else (lambda batch: len(batch[0]))
        self._skip = max(int(skip_steps), 0)
        self._plan = fuse_plan if fuse_plan is not None \
            else FusionPlan(fuse_steps, batch_scale)
        # K-aware resume: a restore landing mid-window replays the
        # remainder unfused so fused windows stay aligned to the absolute
        # K·M boundaries an uninterrupted run would dispatch (and the
        # divergence-rollback target — always a window boundary — stays
        # reachable by the same grouping).
        w = self._plan.window_batches
        self._realign = (w - self._skip % w) % w if (self._skip and w > 1) \
            else 0
        # Pinned host staging: superbatch assembly reuses page-aligned
        # buffers instead of allocating per window.  None = resolve
        # lazily at the first multi-batch emit (PIO_PINNED_STAGING
        # on|off|auto; auto = the device is CUDA — the CPU put aliases
        # numpy buffers zero-copy, and a reused buffer would then
        # rewrite a staged batch in flight).
        self._pin = pin_buffers
        self._pool: Optional[StagingPool] = None
        self._clock = clock
        self._wall_clock = wall_clock
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None
        self._closed = False
        # Real batches in the queue (gauge source — qsize() would count
        # the _DONE sentinel too).  Updated from both threads, so the
        # read-modify-write rides a lock.
        self._staged = 0
        self._staged_lock = threading.Lock()
        self._depth_gauge = None
        self._pinned_counter = None
        if model:
            from predictionio_tpu_torch.obs.metrics import get_registry

            reg = registry or get_registry()
            self._depth_gauge = reg.gauge(
                "pio_prefetch_queue_depth",
                "Staged batches waiting in the prefetch queue.",
                ("model",))
            self._pinned_counter = reg.counter(
                "pio_prefetch_pinned_reuse_total",
                "Superbatch stagings that reused a pinned host buffer "
                "instead of allocating.", ("model",))
            self._model = model
        self._thread = threading.Thread(
            target=self._run, name=f"pio-prefetch-{model or 'batch'}",
            daemon=True)
        _live.add(self)
        self._thread.start()

    # -- producer ------------------------------------------------------------

    def _run(self) -> None:
        it = iter(self._source)
        try:
            step = 0
            realign = self._realign
            window: List[Tuple[Any, int, float, int]] = []
            km = (1, 1)
            while not self._stop.is_set():
                try:
                    raw = next(it)
                except StopIteration:
                    break
                step += 1
                if step <= self._skip:
                    continue  # resume fast-forward: no prep, no transfer
                t0 = self._clock()
                examples = int(self._count_fn(raw))
                prepped = self._prep_fn(raw)
                prep_ms = (self._clock() - t0) * 1e3
                if realign > 0:
                    # Mid-window resume: replay to the next absolute
                    # window boundary at the base (unfused) shape.
                    realign -= 1
                    if not self._emit_slot([(prepped, examples, prep_ms,
                                             step)]):
                        return
                    continue
                if not window:
                    # Plan snapshot per window: the autotuner retargets
                    # between windows, never inside one.
                    km = self._plan.get()
                if km[0] * km[1] <= 1:
                    if not self._emit_slot([(prepped, examples, prep_ms,
                                             step)]):
                        return
                    continue
                window.append((prepped, examples, prep_ms, step))
                if len(window) < km[0] * km[1]:
                    continue
                if not self._emit_window(window, *km):
                    return
                window = []
            # End of stream mid-window: flush complete slots at their
            # slot shape, leftover raw batches at the base shape —
            # every compiled program involved already exists.
            if not self._stop.is_set() and window:
                k, m = km
                while len(window) >= m and m > 1:
                    if not self._emit_slot(window[:m]):
                        return
                    window = window[m:]
                for entry in window:
                    if not self._emit_slot([entry]):
                        return
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            self._exc = e
        finally:
            self._done.set()
            self._offer(_DONE, brief=True)
            close = getattr(it, "close", None)
            if close is not None:
                # Close the source generator ON the prep thread: its
                # finally blocks (temp dirs, native feeders) belong to
                # the thread that was executing it.
                try:
                    close()
                except Exception:
                    pass

    def _offer(self, item: Any, brief: bool = False) -> bool:
        """Bounded put that stays responsive to close(); ``brief`` makes
        one best-effort attempt (the terminal sentinel — the consumer
        also watches ``_done``, so a full queue loses nothing)."""
        while True:
            try:
                self._q.put(item, timeout=_POLL_S)
            except queue.Full:
                if brief or self._stop.is_set():
                    return False
                continue
            if not isinstance(item, _Done):
                with self._staged_lock:
                    self._staged += 1
                    staged = self._staged
                if self._depth_gauge is not None:
                    self._depth_gauge.set(staged, model=self._model)
            return True

    def _staging_pool(self) -> Optional[StagingPool]:
        """The prep thread's buffer pool, or None when pinned staging is
        off.  Resolved once, at the first multi-batch emit."""
        if self._pin is None:
            raw = os.environ.get("PIO_PINNED_STAGING",
                                 "auto").strip().lower()
            if raw in ("on", "1", "true", "yes"):
                self._pin = True
            elif raw in ("off", "0", "false", "no"):
                self._pin = False
            else:
                self._pin = (self._device is not None
                             and self._device.type == "cuda")
        if self._pin and self._pool is None:
            # depth staged + 1 in the consumer's hands + 1 margin for an
            # asynchronously-draining transfer = safe rotation distance.
            self._pool = StagingPool(self.depth + 2)
        return self._pool if self._pin else None

    def _note_pinned(self, pool: Optional[StagingPool],
                     reused_before: int) -> None:
        if pool is not None and self._pinned_counter is not None \
                and pool.reused > reused_before:
            self._pinned_counter.inc(pool.reused - reused_before,
                                     model=self._model)

    def _emit_slot(self, entries: List[Tuple[Any, int, float, int]]) -> bool:
        """Stage one optimizer step's batch: a single prepped batch, or
        ``batch_scale`` prepped batches concatenated (both ride
        ``put_fn`` — no leading scan axis)."""
        t0 = self._clock()
        pool = self._staging_pool() if len(entries) > 1 else None
        reused = pool.reused if pool is not None else 0
        arrays = entries[0][0] if len(entries) == 1 \
            else _tree_concat([e[0] for e in entries], pool)
        self._note_pinned(pool, reused)
        staged = self._put_fn(arrays)
        h2d_ms = sum(e[2] for e in entries) + (self._clock() - t0) * 1e3
        return self._offer(PrefetchedBatch(
            entries[-1][3], staged, sum(e[1] for e in entries), h2d_ms,
            self._wall_clock(), steps=len(entries), k=1))

    def _emit_window(self, window: List[Tuple[Any, int, float, int]],
                     k: int, m: int) -> bool:
        """Stage one fused superbatch: K slots (each M prepped batches
        concatenated) stacked on a new leading axis, transferred via
        ``fused_put_fn`` in one go."""
        if k <= 1:
            return self._emit_slot(window)
        t0 = self._clock()
        pool = self._staging_pool()
        reused = pool.reused if pool is not None else 0
        slots = [window[i * m:(i + 1) * m] for i in range(k)]
        # Only the FINAL superbatch rides the pool — inner batch-scale
        # concats are transients the stack copies out of immediately.
        arrays = _tree_stack([
            s[0][0] if m == 1 else _tree_concat([e[0] for e in s])
            for s in slots], pool)
        self._note_pinned(pool, reused)
        staged = self._fused_put_fn(arrays)
        h2d_ms = sum(e[2] for e in window) + (self._clock() - t0) * 1e3
        return self._offer(PrefetchedBatch(
            window[-1][3], staged, sum(e[1] for e in window), h2d_ms,
            self._wall_clock(), steps=len(window), k=k))

    # -- consumer ------------------------------------------------------------

    def __iter__(self) -> Iterator[PrefetchedBatch]:
        return self

    def __next__(self) -> PrefetchedBatch:
        if self._closed:
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if not self._done.is_set():
                    continue
                # Producer exited.  ``_done`` is set only after every real
                # batch was enqueued, so one non-blocking drain closes the
                # timed-out-get vs late-put race.
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    item = _DONE
            if isinstance(item, _Done):
                self._finish()
                raise StopIteration
            with self._staged_lock:
                self._staged -= 1
                staged = self._staged
            if self._depth_gauge is not None:
                self._depth_gauge.set(staged, model=self._model)
            _consume(item.args)
            return item

    def _finish(self) -> None:
        """End of stream: join the producer and surface its error."""
        self._thread.join(timeout=5.0)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            self._closed = True
            raise exc

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Stop the prep thread and release staged batches (idempotent).

        Safe mid-stream: a producer blocked on a full queue observes the
        stop flag within one poll tick; staged device buffers are dropped
        (the tensors are garbage-collected, nothing to flush).
        """
        if self._closed:
            return
        self._closed = True
        _live.discard(self)
        self._stop.set()
        while True:  # unblock a producer waiting for queue space
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if self._depth_gauge is not None:
            self._depth_gauge.set(0, model=self._model)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class _Staged(tuple):
    """A transferred batch: the device tensors, plus the CUDA event the
    side stream recorded after the copies (None on the CPU)."""

    event = None


_side_streams: dict = {}
_side_lock = threading.Lock()


def _side_stream(dev):
    """One copy stream per CUDA device, shared by the process's
    prefetchers (each copy is ordered by its own event)."""
    import torch

    with _side_lock:
        s = _side_streams.get(dev)
        if s is None:
            s = _side_streams[dev] = torch.cuda.Stream(dev)
        return s


def device_put(arrays: Any, device) -> Any:
    """Transfer a tuple/list of host arrays (or one array) onto
    ``device``.  CPU: ``torch.from_numpy`` (zero-copy).  CUDA: each
    array is staged in pinned host memory (unless it already is) and
    copied with ``non_blocking=True`` on a side stream; the result
    carries the event recorded after the copies, which the consumer's
    stream waits on at ``next()``."""
    import numpy as np
    import torch

    dev = torch.device(device)
    single = not isinstance(arrays, (tuple, list))
    leaves = [arrays] if single else list(arrays)
    hosts = [torch.from_numpy(np.ascontiguousarray(a)) for a in leaves]
    if dev.type == "cpu":
        return hosts[0] if single else type(arrays)(hosts)
    stream = _side_stream(dev)
    with torch.cuda.stream(stream):
        out = [h.to(dev, non_blocking=True) if h.is_pinned()
               else h.pin_memory().to(dev, non_blocking=True)
               for h in hosts]
        event = torch.cuda.Event()
        event.record(stream)
    staged = _Staged(out)
    staged.event = event
    return staged


def _consume(args: Any) -> None:
    """Consumer side of a CUDA :func:`device_put`: the current stream
    waits on the copies' event, and each tensor is marked as used by
    that stream so its memory is not reused before the step reading it
    has run."""
    event = getattr(args, "event", None)
    if event is None:
        return
    import torch

    stream = torch.cuda.current_stream(args[0].device)
    stream.wait_event(event)
    for t in args:
        t.record_stream(stream)


def _pooled_stack(leaves: List[Any], pool: Optional[StagingPool],
                  tag: int = 0):
    """np.stack, assembled into a reusable page-aligned buffer when a
    pool is active and the leaves agree on shape/dtype (a ragged window
    falls back to a fresh allocation — correctness over reuse)."""
    import numpy as np

    first = leaves[0]
    if pool is None or any(
            getattr(leaf, "shape", None) != first.shape
            or getattr(leaf, "dtype", None) != first.dtype
            for leaf in leaves):
        return np.stack(leaves)
    out = pool.take((len(leaves),) + tuple(first.shape), first.dtype,
                    tag=tag)
    for i, leaf in enumerate(leaves):
        np.copyto(out[i], leaf)
    return out


def _pooled_concat(leaves: List[Any], pool: Optional[StagingPool],
                   tag: int = 0):
    """np.concatenate into a reusable buffer (same fallback rules as
    :func:`_pooled_stack`; rows may differ, trailing dims may not)."""
    import numpy as np

    first = leaves[0]
    if pool is None or any(
            getattr(leaf, "shape", ())[1:] != first.shape[1:]
            or getattr(leaf, "dtype", None) != first.dtype
            for leaf in leaves):
        return np.concatenate(leaves)
    rows = sum(leaf.shape[0] for leaf in leaves)
    out = pool.take((rows,) + tuple(first.shape[1:]), first.dtype,
                    tag=tag)
    off = 0
    for leaf in leaves:
        np.copyto(out[off:off + leaf.shape[0]], leaf)
        off += leaf.shape[0]
    return out


def _tree_stack(items: List[Any],
                pool: Optional[StagingPool] = None) -> Any:
    """Stack prepped batches leaf-wise along a NEW leading axis (the slot
    axis of a fused superbatch).  Batches are tuples/lists of arrays by
    the prep convention; a bare array stacks directly."""
    if isinstance(items[0], (tuple, list)):
        return type(items[0])(
            _pooled_stack([it[j] for it in items], pool, tag=j)
            for j in range(len(items[0])))
    return _pooled_stack(items, pool)


def _tree_concat(items: List[Any],
                 pool: Optional[StagingPool] = None) -> Any:
    """Concatenate prepped batches leaf-wise along the batch axis (the
    batch-autoscale widening)."""
    if isinstance(items[0], (tuple, list)):
        return type(items[0])(
            _pooled_concat([it[j] for it in items], pool, tag=j)
            for j in range(len(items[0])))
    return _pooled_concat(items, pool)
