"""Training checkpoints + resume.

Port of ``predictionio_tpu/workflow/checkpoint.py``.  A killed train
resumes from its last checkpoint when a training loop starts over the
same directory::

    ckpt = TrainCheckpointer(dir, save_every=200, fingerprint=fp)
    start = ckpt.restore_step(state_like, total_steps=total)  # 0 if fresh
    state = ckpt.restored_state or state
    for step in range(start, total):
        state, loss = train_step(...)
        ckpt.maybe_save(step + 1, state)
    ckpt.complete()   # clear — a finished run leaves no checkpoints
    ckpt.close()      # behind to stale-resume the next one

The reference writes orbax checkpoints asynchronously.  The port writes
each step with ``torch.save`` (tensors copied to the host first) to a
temporary name in the directory, then moves it onto ``<step>.pt`` with
``os.replace``, so a step file on disk is always complete; saves are
synchronous, so :meth:`TrainCheckpointer.flush` has nothing to wait
for.  The on-disk format is the port's own: neither package reads the
other's checkpoints.  A state is any nesting of dicts, lists, tuples
(named ones included), tensors, :class:`~predictionio_tpu_torch.
parallel.mesh.ShardedTensor` s and plain values; :meth:`restore_step`
maps the restored tensors onto the device of ``state_like``.  A sharded
array is saved as its spec, its global shape and its distinct blocks
(positions that share a tensor share one saved block); restore places
each block back on its position's device of ``state_like``'s mesh,
shared as it was, after checking that the spec and shape agree.

In a gang (``parallel.distributed``, more than one process) every
process writes and reads files of its own, so no two processes write one
path: process ``r`` of ``n`` saves ``<step>.p<r>of<n>.pt`` (its own
positions' blocks, -1 for another process's) and keeps
``fingerprint.p<r>of<n>.txt``.  A save returns once every process has
written that step (a barrier), and a resume takes the newest step every
process has on disk, so a preempted gang restarts from one sweep.  A
gang of another size starts fresh.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from pathlib import Path
from typing import Any, List, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["TrainCheckpointer"]

def _gang() -> tuple:
    """(rank, size) of this process's gang ((0, 1) alone)."""
    from predictionio_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

    return process_index(), process_count()


_SHARDED = "__pio_sharded__"


def _sharded_to_host(x) -> dict:
    """A :class:`ShardedTensor` as a plain record: its spec, its global
    shape and its distinct blocks on the CPU, with the block index of
    each of this process's positions (-1 for another process's)."""
    index, blocks, ids = [], [], {}
    for t in x.shards:
        if t is None:
            index.append(-1)
            continue
        if id(t) not in ids:
            ids[id(t)] = len(blocks)
            blocks.append(t.detach().to("cpu", copy=True))
        index.append(ids[id(t)])
    return {_SHARDED: True, "spec": tuple(x.spec), "shape": tuple(x.shape),
            "index": index, "blocks": blocks}


def _sharded_from_host(record: dict, like):
    """Place a :func:`_sharded_to_host` record back on ``like``'s mesh:
    each position's block on that position's device."""
    from predictionio_tpu_torch.parallel.mesh import ShardedTensor

    if tuple(record["spec"]) != tuple(like.spec) \
            or tuple(record["shape"]) != tuple(like.shape):
        raise ValueError(
            f"checkpointed array laid out as {record['spec']!r} "
            f"{record['shape']}, the run's as {tuple(like.spec)!r} "
            f"{tuple(like.shape)}")
    placed: dict = {}
    shards = []
    for p, (i, t) in enumerate(zip(record["index"], like.shards)):
        if t is None:
            shards.append(None)
            continue
        key = (i, str(t.device))
        if key not in placed:
            placed[key] = record["blocks"][i].to(t.device)
        shards.append(placed[key])
    return ShardedTensor(like.sharding, like.shape, shards)


def _restore_like(state: Any, like: Any) -> Any:
    """``state`` (as loaded) with each sharded record placed as the
    matching leaf of ``like`` lies."""
    if isinstance(state, dict) and state.get(_SHARDED):
        return _sharded_from_host(state, like)
    if isinstance(state, dict):
        return {k: _restore_like(v, like[k] if isinstance(like, dict)
                                 else None) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_restore_like(v, w)
                             for v, w in zip(state, like)))
    if isinstance(state, (list, tuple)):
        return type(state)(_restore_like(v, w) for v, w in zip(state, like))
    return state


def _has_sharded(state: Any) -> bool:
    if isinstance(state, dict):
        return state.get(_SHARDED, False) or any(
            _has_sharded(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return any(_has_sharded(v) for v in state)
    return False


def _to_host(state: Any) -> Any:
    """``state`` with every tensor copied to the CPU (same nesting)."""
    from predictionio_tpu_torch.parallel.mesh import ShardedTensor

    if isinstance(state, ShardedTensor):
        return _sharded_to_host(state)
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_to_host(v) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    return state


def _device_of(state: Any) -> Optional[torch.device]:
    """The device of the first tensor in ``state`` (None: no tensor)."""
    if isinstance(state, torch.Tensor):
        return state.device
    values = state.values() if isinstance(state, dict) else (
        state if isinstance(state, (list, tuple)) else ())
    for v in values:
        dev = _device_of(v)
        if dev is not None:
            return dev
    return None


class TrainCheckpointer:
    """Step checkpoints of one training run in ``directory``.

    ``save_every`` 0 disables every operation (the loops construct one
    unconditionally).  ``keep`` bounds the step files kept on disk (the
    newest ones).  ``fingerprint`` names the config and data the run was
    started for: checkpoints written for another fingerprint are
    discarded, loudly, instead of resumed.
    """

    def __init__(self, directory, *, save_every: int = 0, keep: int = 3,
                 fingerprint: Optional[str] = None):
        self.directory = Path(directory).absolute()
        self.save_every = int(save_every)
        self.keep = keep
        self.fingerprint = fingerprint
        self.restored_state: Optional[Any] = None
        rank, size = _gang()
        self._gang = size > 1
        self._tag = f".p{rank}of{size}" if self._gang else ""
        self._step_file = re.compile(rf"^(\d+){re.escape(self._tag)}\.pt$")
        self._tmp_file = re.compile(
            rf"^\d+{re.escape(self._tag)}\.pt\.\d+\.pt\.tmp$")
        if self.enabled:
            self._check_fingerprint()

    @property
    def _fingerprint_path(self) -> Path:
        return self.directory / f"fingerprint{self._tag}.txt"

    def _steps(self) -> List[int]:
        """Complete step files of this process on disk, ascending."""
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for m in
                      (self._step_file.match(c.name)
                       for c in self.directory.iterdir()) if m)

    def _agreed_steps(self) -> List[int]:
        """The steps every process of the gang has on disk, ascending."""
        steps = self._steps()
        if not self._gang:
            return steps
        import torch.distributed as dist

        every: List = [None] * dist.get_world_size()
        dist.all_gather_object(every, steps)
        common = set(every[0]).intersection(*every[1:])
        return sorted(common)

    def _step_path(self, step: int) -> Path:
        return self.directory / f"{int(step)}{self._tag}.pt"

    def _check_fingerprint(self) -> None:
        """Refuse checkpoints written for a different config/data: a
        mismatched (or absent) fingerprint purges the stale steps so the
        run starts fresh — loudly.  Only checkpoint artifacts (step files
        and unfinished temporaries) are removed: the directory may hold
        unrelated files."""
        if self.fingerprint is None:
            return
        fp = self._fingerprint_path
        if fp.exists() or self._steps():
            stored = fp.read_text().strip() if fp.exists() else "<absent>"
            if stored != self.fingerprint:
                logger.warning(
                    "Checkpoint dir %s was written for a different "
                    "config/data (fingerprint %s != %s); discarding stale "
                    "checkpoints and training from scratch.",
                    self.directory, stored, self.fingerprint)
                for child in self.directory.iterdir():
                    if self._step_file.match(child.name) or \
                            self._tmp_file.match(child.name):
                        if child.is_dir():
                            shutil.rmtree(child, ignore_errors=True)
                        else:
                            child.unlink(missing_ok=True)
                fp.unlink(missing_ok=True)
        self.directory.mkdir(parents=True, exist_ok=True)
        fp.write_text(self.fingerprint)

    @property
    def enabled(self) -> bool:
        return self.save_every > 0

    def restore_step(self, state_like: Any,
                     total_steps: Optional[int] = None) -> int:
        """Restore the latest checkpoint into ``restored_state``, its
        tensors on ``state_like``'s device; returns the step to resume
        FROM (0 when no checkpoint exists).  Pass ``total_steps`` so a
        checkpoint at or beyond the end of the run — the loop would not
        run at all — is flagged loudly."""
        if not self.enabled:
            return 0
        steps = self._agreed_steps()
        if not steps:
            return 0
        latest = steps[-1]
        self.restored_state = torch.load(
            self._step_path(latest),
            map_location=_device_of(state_like) or "cpu",
            weights_only=False)
        if _has_sharded(self.restored_state):
            self.restored_state = _restore_like(self.restored_state,
                                                state_like)
        logger.info("Resumed training from checkpoint step %d (%s)",
                    latest, self.directory)
        if total_steps is not None and latest >= total_steps:
            logger.warning(
                "Checkpoint step %d >= total training steps %d: the "
                "training loop will not run and the checkpointed state is "
                "returned as-is.  If this is a fresh retrain, the previous "
                "run did not complete cleanly (a completed run clears its "
                "checkpoints); delete %s to train from scratch.",
                latest, total_steps, self.directory)
        return int(latest)

    def maybe_save(self, step: int, state: Any) -> bool:
        if not self.enabled or step % self.save_every != 0:
            return False
        self._write(step, state)
        return True

    def save(self, step: int, state: Any) -> None:
        """Off-cadence forced save (window boundaries, preemption).  A
        step already on disk is not written again: its state is already
        durable."""
        if self.enabled and not self._step_path(step).exists():
            self._write(step, state)

    def _write(self, step: int, state: Any) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._step_path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.pt.tmp")
        torch.save(_to_host(state), tmp)
        os.replace(tmp, path)
        if self._gang:
            from predictionio_tpu_torch.parallel.distributed import barrier

            barrier()
        for old in self._steps()[:-max(int(self.keep), 1)]:
            self._step_path(old).unlink(missing_ok=True)

    def flush(self) -> None:
        """Every save is durable when it returns: nothing to wait for
        (the watchdog calls this before aborting a hung run)."""

    def complete(self) -> None:
        """Mark the run finished: CLEAR its checkpoints.  A completed
        train persists its final model through the model store; leaving
        mid-train checkpoints behind would make the next retrain over the
        same directory fast-forward past its loop."""
        if not self.enabled:
            return
        for step in self._steps():
            self._step_path(step).unlink(missing_ok=True)
        if self.fingerprint is not None:
            self._fingerprint_path.unlink(missing_ok=True)

    def close(self) -> None:
        """Nothing is held open between saves."""
