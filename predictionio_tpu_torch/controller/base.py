"""DASE base classes — the engine-author SDK.

Counterpart of ``predictionio_tpu/controller/base.py``.  The port's
:class:`RuntimeContext` carries the ``torch.device`` its models train
and serve on (see :func:`predictionio_tpu_torch.device.device`) and,
next to it, the device mesh of sharded compute
(:mod:`predictionio_tpu_torch.parallel`), whose shards follow that
device: the card by default, the CPU when asked.
"""

from __future__ import annotations

import abc
import dataclasses
import os
import pickle
from typing import Any, Dict, Generic, List, Optional, Sequence, Tuple, TypeVar

import torch

from predictionio_tpu_torch.controller.params import EmptyParams, Params

__all__ = [
    "RuntimeContext",
    "DataSource",
    "Preparator",
    "IdentityPreparator",
    "Algorithm",
    "Serving",
    "FirstServing",
    "PersistentModel",
    "WarmStartFallback",
    "model_to_bytes",
    "model_from_bytes",
]


class WarmStartFallback(Exception):
    """A warm-start (delta) train cannot proceed — fall back to a full
    retrain.

    Raised by :meth:`Algorithm.warm_start` when the algorithm does not
    support incremental continuation, when the delta window is too large
    a fraction of the corpus for continuation to be trustworthy, or when
    the warm-started model regresses against the generation it started
    from.  ``run_train`` catches it and re-runs the engine in full mode
    over the complete window — the refresh always lands a generation,
    just a more expensive one.
    """

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason

TD = TypeVar("TD")   # training data
PD = TypeVar("PD")   # prepared data
M = TypeVar("M")     # model
Q = TypeVar("Q")     # query
P = TypeVar("P")     # predicted result
A = TypeVar("A")     # actual result
EI = TypeVar("EI")   # evaluation info


@dataclasses.dataclass
class RuntimeContext:
    """What a DASE role gets instead of the reference's SparkContext.

    - ``storage``: the port's :class:`~predictionio_tpu_torch.data.storage.Storage`
    - ``event_store``: name-resolving read API
      (:class:`~predictionio_tpu_torch.data.store.EventStore`)
    - ``device``: the ``torch.device`` models train on and stage their
      tensors on
    - ``mesh``: the device mesh for sharded compute (None = the one
      device)
    - ``seed``: base RNG seed for the run (reproducible training)
    - ``workflow_params``: the run's knobs (``profile_dir``: capture the
      train under ``torch.profiler``)
    """

    storage: Any = None
    event_store: Any = None
    device: Optional[torch.device] = None
    mesh: Any = None
    seed: int = 0
    workflow_params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(storage=None, device=None, seed: int = 0,
               mesh_spec: Optional[str] = None, mesh=None,
               **workflow_params) -> "RuntimeContext":
        """Build the run context; this is where multi-device bring-up
        happens.  ``device`` goes through
        :func:`~predictionio_tpu_torch.device.device`: the CUDA card
        unless ``"cpu"`` is asked for, raising when CUDA is absent.

        ``mesh_spec`` (or env ``PIO_MESH``, e.g. ``data=8,model=2`` /
        ``auto``) builds the device mesh over ``device``'s kind of
        device; a multi-process gang joins first through
        ``initialize_distributed`` (env ``PIO_COORDINATOR_ADDRESS``;
        NCCL on the card, gloo on the CPU).  Engines only consume
        ``ctx.mesh``."""
        from predictionio_tpu_torch.data.storage import get_storage
        from predictionio_tpu_torch.data.store import EventStore
        from predictionio_tpu_torch.device import device as resolve_device

        dev = resolve_device(device)
        if mesh is None:
            spec = mesh_spec if mesh_spec is not None \
                else os.environ.get("PIO_MESH")
            if spec:
                from predictionio_tpu_torch.parallel.distributed import (
                    initialize_distributed,
                )
                from predictionio_tpu_torch.parallel.mesh import (
                    mesh_from_spec,
                )

                initialize_distributed(
                    backend="nccl" if dev.type == "cuda" else "gloo")
                mesh = mesh_from_spec(spec, device=dev)
        storage = storage or get_storage()
        return RuntimeContext(storage=storage,
                              event_store=EventStore(storage),
                              device=dev, mesh=mesh, seed=seed,
                              workflow_params=dict(workflow_params))


class _HasParams:
    """Every DASE role is constructed with its Params (reference: Doer)."""

    params_class: type = EmptyParams

    def __init__(self, params: Optional[Params] = None):
        self.params = params if params is not None else self.params_class()


class DataSource(_HasParams, Generic[TD, EI, Q, A], abc.ABC):
    """Reference: PDataSource/LDataSource — reads training and eval data."""

    @abc.abstractmethod
    def read_training(self, ctx: RuntimeContext) -> TD: ...

    def read_eval(self, ctx: RuntimeContext
                  ) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
        """K folds of (training data, eval info, [(query, actual)])
        (reference: PDataSource.readEval).  Default: no eval support."""
        return []


class Preparator(_HasParams, Generic[TD, PD], abc.ABC):
    """Reference: PPreparator/LPreparator."""

    @abc.abstractmethod
    def prepare(self, ctx: RuntimeContext, training_data: TD) -> PD: ...


class IdentityPreparator(Preparator[TD, TD]):
    """Reference: IdentityPreparator — passes training data through."""

    def prepare(self, ctx: RuntimeContext, training_data: TD) -> TD:
        return training_data


class Algorithm(_HasParams, Generic[PD, M, Q, P], abc.ABC):
    """Reference: PAlgorithm/P2LAlgorithm/LAlgorithm.

    ``reads_live_state``: True for an algorithm whose ``predict`` reads
    state that changes without a new generation (events written after
    the train); the engine server then keeps no cached answers for it
    (the port's own attribute)."""

    reads_live_state = False

    @abc.abstractmethod
    def train(self, ctx: RuntimeContext, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def batch_predict(self, model: M, queries: Sequence[Tuple[int, Q]]) -> List[Tuple[int, P]]:
        """Reference: PAlgorithm.batchPredict.  Default maps
        :meth:`predict`; algorithms override with a vectorized path."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def warm_start(self, ctx: RuntimeContext, prepared_delta: PD,
                   prev_model: M, warm: Any) -> M:
        """Continue training ``prev_model`` on a DELTA window of prepared
        data (event-delta warm-start refresh).

        ``prepared_delta`` was read through a window-scoped event store
        covering only ``[previous generation's watermark, new
        watermark)``; ``warm`` is the
        :class:`~predictionio_tpu_torch.refresh.WarmStartContext`
        carrying the window and the fallback thresholds.
        Implementations either return a model trained on previous state
        + delta, or raise :class:`WarmStartFallback` — the workflow then
        re-runs the whole engine in full mode.  The default declines:
        algorithms without an incremental form always retrain fully on
        refresh.
        """
        raise WarmStartFallback(
            f"{type(self).__name__} does not support warm-start "
            "continuation")


class Serving(_HasParams, Generic[Q, P], abc.ABC):
    """Reference: LServing — combine predictions of all algorithms."""

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P: ...

    def supplement(self, query: Q) -> Q:
        """Reference: LServing.supplement hook — enrich query pre-predict."""
        return query


class FirstServing(Serving[Q, P]):
    """Reference: FirstServing — returns the first algorithm's prediction."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class PersistentModel(abc.ABC):
    """Opt-in custom model persistence (reference: PersistentModel +
    PersistentModelLoader).  Models that don't implement this are
    pickled into the MODELDATA blob store keyed by engine-instance id."""

    @abc.abstractmethod
    def save(self, instance_id: str, ctx: RuntimeContext) -> bool:
        """Persist under ``instance_id``; return False to fall back to pickle."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Params, ctx: RuntimeContext) -> "PersistentModel":
        ...


def model_to_bytes(model: Any) -> bytes:
    """Default model serialization (reference: P2L/L auto-persistence):
    a pickle; an engine with exotic state implements
    :class:`PersistentModel` instead."""
    return pickle.dumps(model, protocol=pickle.HIGHEST_PROTOCOL)


def model_from_bytes(blob: bytes) -> Any:
    return pickle.loads(blob)
