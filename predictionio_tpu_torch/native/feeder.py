"""Python binding for the port's C++ event-log feeder (``feeder.cc``).

Port of ``predictionio_tpu/native/feeder.py``.  Write path:
:func:`write_cache` converts indexed COO interactions (the output of a
template DataSource) into the mmap-able PIOF1 columnar cache (version 3:
any number of categorical u32 id columns plus optional extra f32 feature
columns; v1/v2 files remain readable).  Read path: :class:`EventFeeder`
iterates shuffled batches assembled by the native library — numpy
buffers are passed straight into C (no copies on the C side; the arrays
handed back are copies of the reusable buffers).

The library is the port's own copy of the source, built by
:func:`~predictionio_tpu_torch.native.build.load_library` into
``build/torch_native/``; a failed build raises with the compiler's
message.  The format, the C API and the per-(seed, epoch) shuffle are
the reference's, so one cache and seed yield the same batches from
either package's library.  The reference also publishes a
``feeder.epoch`` trace-ring event at each epoch boundary; the port has
no trace ring yet, so only the metrics remain.
"""

from __future__ import annotations

import ctypes
import struct
import time
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.native.build import load_library
from predictionio_tpu_torch.obs import get_registry

__all__ = ["write_cache", "EventFeeder"]

_MAGIC = b"PIOF1"


def write_cache(path, user_ids=None, item_ids=None, values=None, times=None,
                extras=None, cats=None) -> Path:
    """Write the PIOF1 v3 binary columnar event cache.

    Either ``user_ids`` + ``item_ids`` (the classic 2-column case) or
    ``cats`` — an ``[n, F]`` uint32 matrix of F categorical id columns —
    must be given.  ``extras``: optional ``[n, n_extra]`` float32 feature
    matrix, stored column-major per the format (``feeder.cc``'s header
    comment).
    """
    path = Path(path)
    if cats is None:
        if user_ids is None or item_ids is None:
            raise ValueError("write_cache needs user_ids+item_ids or cats")
        cats = np.stack([np.asarray(user_ids), np.asarray(item_ids)], axis=1)
    cats = np.ascontiguousarray(cats, dtype=np.uint32)
    if cats.ndim == 1:
        cats = cats[:, None]
    n, n_cat = cats.shape
    if not 1 <= n_cat <= 1024:
        # Mirror the reader's bound — fail at the writer, loudly.
        raise ValueError(f"n_cat must be in [1, 1024], got {n_cat}")
    if values is None:
        values = np.ones(n, dtype=np.float32)
    if times is None:
        times = np.zeros(n, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float32)
    times = np.ascontiguousarray(times, dtype=np.int64)
    if extras is not None:
        extras = np.ascontiguousarray(extras, dtype=np.float32)
        if extras.ndim == 1:
            extras = extras[:, None]
        if extras.shape[0] != n:
            raise ValueError("extras rows must match the event count")
    n_extra = 0 if extras is None else extras.shape[1]
    if n_extra > 65536:
        raise ValueError(f"n_extra must be <= 65536, got {n_extra}")
    with open(path, "wb") as f:
        f.write(_MAGIC + b"\x00" + struct.pack("<H", 3))
        f.write(struct.pack("<Q", n))
        f.write(struct.pack("<II", n_extra, n_cat))
        for c in range(n_cat):
            f.write(np.ascontiguousarray(cats[:, c]).tobytes())
        f.write(values.tobytes())
        pos = 24 + n * (4 * n_cat + 4)
        f.write(b"\x00" * (-pos % 8))  # times are 8-byte aligned in v2+
        f.write(times.tobytes())
        for c in range(n_extra):
            f.write(np.ascontiguousarray(extras[:, c]).tobytes())
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the feeder library (idempotent)."""
    if lib.pio_feeder_open.restype == ctypes.c_void_p:
        return lib
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pio_feeder_open.restype = ctypes.c_void_p
    lib.pio_feeder_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_int]
    lib.pio_feeder_num_rows.restype = ctypes.c_int64
    lib.pio_feeder_num_rows.argtypes = [ctypes.c_void_p]
    lib.pio_feeder_n_extra.restype = ctypes.c_int32
    lib.pio_feeder_n_extra.argtypes = [ctypes.c_void_p]
    lib.pio_feeder_n_cat.restype = ctypes.c_int32
    lib.pio_feeder_n_cat.argtypes = [ctypes.c_void_p]
    lib.pio_feeder_next_batch.restype = ctypes.c_int64
    lib.pio_feeder_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, u32p, u32p, f32p, i64p,
        f32p]  # extras [batch, n_extra]
    lib.pio_feeder_next_batch_cats.restype = ctypes.c_int64
    lib.pio_feeder_next_batch_cats.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, u32p,  # cats [batch, n_cat]
        f32p, i64p, f32p]
    lib.pio_feeder_close.argtypes = [ctypes.c_void_p]
    return lib


class EventFeeder:
    """Shuffled minibatch iterator over a PIOF1 cache, assembly in C++."""

    def __init__(self, path, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True):
        lib = _bind(load_library("feeder"))
        self._lib = lib
        self._h = lib.pio_feeder_open(str(path).encode(), seed, int(shuffle))
        if not self._h:
            raise RuntimeError(f"cannot open event cache {path!r}")
        self.batch_size = batch_size
        self.n_extra = int(lib.pio_feeder_n_extra(self._h))
        self.n_cat = int(lib.pio_feeder_n_cat(self._h))
        # Pipeline observability: wait time per native assembly call and
        # how much of the epoch is still queued behind the training loop.
        reg = get_registry()
        self._m_wait = reg.histogram(
            "pio_feeder_wait_ms",
            "Host wait per native batch-assembly call.")
        self._m_batches = reg.counter(
            "pio_feeder_batches_total", "Batches served by the feeder.")
        self._m_rows = reg.counter(
            "pio_feeder_rows_total", "Rows served by the feeder.")
        self._m_depth = reg.gauge(
            "pio_feeder_queue_depth",
            "Rows remaining in the feeder's current epoch.")
        self._epoch_served = 0
        self._m_depth.set(int(lib.pio_feeder_num_rows(self._h)))
        self._users = np.empty(batch_size, np.uint32)
        self._items = np.empty(batch_size, np.uint32)
        self._cats = np.empty((batch_size, self.n_cat), np.uint32)
        self._vals = np.empty(batch_size, np.float32)
        self._times = np.empty(batch_size, np.int64)
        self._extras = (np.empty((batch_size, self.n_extra), np.float32)
                        if self.n_extra else None)

    def __len__(self) -> int:
        return int(self._lib.pio_feeder_num_rows(self._h))

    def _extras_ptr(self):
        return (self._extras.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                if self._extras is not None
                else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)))

    def _finish_batch(self, n, lead, wait_ms: float):
        """Shared batch tail: error/epoch-boundary handling, metrics,
        copies."""
        if n < 0:
            raise RuntimeError("feeder error")
        self._m_wait.observe(wait_ms)
        if n == 0:
            # Epoch boundary: the whole dataset is queued again.
            self._epoch_served = 0
            self._m_depth.set(len(self))
            return None
        n = int(n)
        self._m_batches.inc()
        self._m_rows.inc(n)
        self._epoch_served += n
        self._m_depth.set(max(len(self) - self._epoch_served, 0))
        out = tuple(a[:n].copy() for a in lead) + (self._vals[:n].copy(),)
        if self._extras is not None:
            out = out + (self._extras[:n].copy(),)
        return out

    def next_batch(self) -> Optional[Tuple[np.ndarray, ...]]:
        """One batch of (users, items, values[, extras]); None at an epoch
        boundary."""
        if self.n_cat < 2:
            raise RuntimeError(
                f"cache has {self.n_cat} categorical column(s); the "
                "(users, items) batch API needs >= 2 — use "
                "next_batch_cats()/epoch_cats()")
        t0 = time.perf_counter()
        n = self._lib.pio_feeder_next_batch(
            self._h, self.batch_size,
            self._users.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self._items.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self._vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._extras_ptr())
        return self._finish_batch(n, (self._users, self._items),
                                  (time.perf_counter() - t0) * 1e3)

    def next_batch_cats(self) -> Optional[Tuple[np.ndarray, ...]]:
        """One batch of (cats [n, n_cat], values[, extras]); None at an
        epoch boundary.  Works for any column count (v3 caches)."""
        t0 = time.perf_counter()
        n = self._lib.pio_feeder_next_batch_cats(
            self._h, self.batch_size,
            self._cats.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self._vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._extras_ptr())
        return self._finish_batch(n, (self._cats,),
                                  (time.perf_counter() - t0) * 1e3)

    def epoch(self) -> Iterator[Tuple[np.ndarray, ...]]:
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def epoch_cats(self) -> Iterator[Tuple[np.ndarray, ...]]:
        while True:
            b = self.next_batch_cats()
            if b is None:
                return
            yield b

    def close(self) -> None:
        if self._h:
            self._lib.pio_feeder_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
