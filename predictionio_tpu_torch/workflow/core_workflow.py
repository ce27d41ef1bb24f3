"""CoreWorkflow — train runs, engine-instance lifecycle, model persistence.

Port of ``predictionio_tpu/workflow/core_workflow.py`` (reference:
CoreWorkflow.scala runTrain):

    run_train: bind params → EngineInstance(TRAINING) → Engine.train
      → persist models → EngineInstance(COMPLETED | FAILED)

One manifest blob per engine instance (each model pickled or
self-persisted), ``load_models`` with the ``post_load`` hook, and the
instance-params rebinding the server uses.  ``persist_instance`` is the
tail of ``run_train`` with the models given instead of trained.  Not
ported yet: the warm-start branch, the memory sampler and the profiler
capture of the reference's ``run_train``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import importlib
import json
import logging
import pickle
import traceback
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.controller import (
    Engine,
    EngineParams,
    EngineVariant,
    PersistentModel,
    RuntimeContext,
)
from predictionio_tpu_torch.data.storage import EngineInstance, Model, Storage

logger = logging.getLogger(__name__)

__all__ = ["WorkflowError", "run_train", "persist_instance", "load_models",
           "instance_engine_params", "DATA_WATERMARK_KEY"]

# EngineInstance.env key of the data high-watermark of a train run
# (ISO-8601; the read saw exactly event_time < watermark).
DATA_WATERMARK_KEY = "dataWatermark"


class WorkflowError(RuntimeError):
    pass


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _class_path(obj: Any) -> str:
    cls = obj if isinstance(obj, type) else type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def _start_instance(engine: Engine, variant: EngineVariant,
                    storage: Storage, env: Optional[dict] = None,
                    engine_id: Optional[str] = None,
                    engine_version: str = __version__
                    ) -> Tuple[EngineInstance, EngineParams]:
    """Bind the variant's params (strictly, as a train does) and insert a
    TRAINING row that snapshots them, so the server later rebinds
    exactly what the generation was made with."""
    engine_params = engine.bind_engine_params(variant.raw)
    ep_json = engine_params.to_json_dict()
    instance = EngineInstance(
        id=None,
        status="TRAINING",
        start_time=_now(),
        end_time=None,
        engine_id=engine_id or variant.engine_factory,
        engine_version=engine_version,
        engine_variant=variant.variant_id,
        engine_factory=variant.engine_factory,
        env=dict(env or {}),
        datasource_params=json.dumps(ep_json["datasource"]["params"]),
        preparator_params=json.dumps(ep_json["preparator"]["params"]),
        algorithms_params=json.dumps(ep_json["algorithms"]),
        serving_params=json.dumps(ep_json["serving"]["params"]),
    )
    storage.get_engine_instances().insert(instance)
    return instance, engine_params


def _finish(storage: Storage, instance: EngineInstance, status: str) -> None:
    instance.status = status
    instance.end_time = _now()
    storage.get_engine_instances().update(instance)


def run_train(engine: Engine, variant: EngineVariant,
              ctx: Optional[RuntimeContext] = None, *,
              engine_id: Optional[str] = None,
              engine_version: str = __version__) -> str:
    """Train an engine variant; returns the COMPLETED engine-instance id.

    Reference: CoreWorkflow.runTrain, including the FAILED-status write
    on any error, which callers rely on.  The run stamps a data
    watermark BEFORE the datasource reads and scopes the read to
    ``event_time < watermark`` (through
    :class:`~predictionio_tpu_torch.data.store.WindowedEventStore`),
    recording it in ``instance.env[dataWatermark]``: events landing
    mid-read belong to the next generation.  ``ctx`` defaults to
    :meth:`RuntimeContext.create` (the card).
    """
    from predictionio_tpu_torch.data.store import WindowedEventStore
    from predictionio_tpu_torch.obs import phase

    ctx = ctx or RuntimeContext.create()
    storage: Storage = ctx.storage
    watermark = _now()
    instance, engine_params = _start_instance(
        engine, variant, storage,
        env={DATA_WATERMARK_KEY: watermark.isoformat()},
        engine_id=engine_id, engine_version=engine_version)
    logger.info("EngineInstance %s TRAINING (factory=%s)", instance.id,
                variant.engine_factory)
    try:
        wctx = dataclasses.replace(
            ctx, event_store=WindowedEventStore(storage, None, watermark))
        models = engine.train(wctx, engine_params)
        with phase("train.persist"):
            _persist_models(models, instance.id, ctx)
    except BaseException:
        # BaseException: an interrupted run must land as FAILED, not sit
        # in TRAINING as a phantom live train.
        _finish(storage, instance, "FAILED")
        logger.error("EngineInstance %s FAILED:\n%s", instance.id,
                     traceback.format_exc())
        raise
    _finish(storage, instance, "COMPLETED")
    logger.info("EngineInstance %s COMPLETED in %.1fs", instance.id,
                (instance.end_time - instance.start_time).total_seconds())
    return instance.id


def persist_instance(engine: Engine, variant: EngineVariant,
                     models: Sequence[Any], storage: Storage) -> str:
    """Write ``models`` as a COMPLETED engine instance of ``variant``;
    returns the instance id.  The variant's params are bound and
    snapshotted on the row as :func:`run_train` does."""
    instance, _ = _start_instance(engine, variant, storage)
    try:
        _persist_models(models, instance.id,
                        RuntimeContext(storage=storage))
    except BaseException:
        _finish(storage, instance, "FAILED")
        raise
    _finish(storage, instance, "COMPLETED")
    logger.info("EngineInstance %s COMPLETED (factory=%s)", instance.id,
                variant.engine_factory)
    return instance.id


def _persist_models(models: Sequence[Any], instance_id: str, ctx: RuntimeContext) -> None:
    """One manifest blob per instance; each entry pickled or self-persisted."""
    entries: List[dict] = []
    payloads: List[Optional[bytes]] = []
    for i, model in enumerate(models):
        if isinstance(model, PersistentModel):
            saved = model.save(f"{instance_id}.{i}", ctx)
            if saved:
                entries.append({"kind": "persistent", "class": _class_path(model)})
                payloads.append(None)
                continue
        entries.append({"kind": "pickle", "class": _class_path(model)})
        payloads.append(pickle.dumps(model, protocol=pickle.HIGHEST_PROTOCOL))
    blob = pickle.dumps({"entries": entries, "payloads": payloads},
                        protocol=pickle.HIGHEST_PROTOCOL)
    ctx.storage.get_models().insert(Model(id=instance_id, models=blob))


def load_models(engine: Engine, instance: EngineInstance,
                ctx: RuntimeContext) -> List[Any]:
    """Load the models of a COMPLETED instance (reference: CreateServer
    model loading / PersistentModelLoader), then run each model's
    ``post_load(ctx)`` hook — where a model takes its serving device."""
    blob = ctx.storage.get_models().get(instance.id)
    if blob is None:
        raise WorkflowError(f"No model data for engine instance {instance.id}.")
    manifest = pickle.loads(blob.models)
    engine_params = _bind_instance_params(engine, instance)
    algo_params = dict(engine_params.algorithms_params)
    models: List[Any] = []
    for i, (entry, payload) in enumerate(zip(manifest["entries"], manifest["payloads"])):
        if entry["kind"] == "pickle":
            models.append(pickle.loads(payload))
        else:
            mod_name, _, qual = entry["class"].partition(":")
            cls = importlib.import_module(mod_name)
            for part in qual.split("."):
                cls = getattr(cls, part)
            name_i = list(algo_params)[i] if i < len(algo_params) else None
            models.append(cls.load(f"{instance.id}.{i}", algo_params.get(name_i), ctx))
    for m in models:
        hook = getattr(m, "post_load", None)
        if callable(hook):
            try:
                hook(ctx)
            except Exception:
                logger.exception("model post_load hook failed; serving "
                                 "continues with the loaded layout")
    return models


def _bind_instance_params(engine: Engine, instance: EngineInstance) -> EngineParams:
    """Rebind the params snapshot stored on the instance row."""
    variant_like = {
        "datasource": {"params": json.loads(instance.datasource_params)},
        "preparator": {"params": json.loads(instance.preparator_params)},
        "algorithms": json.loads(instance.algorithms_params),
        "serving": {"params": json.loads(instance.serving_params)},
    }
    return engine.bind_engine_params(variant_like)


def instance_engine_params(engine: Engine, instance: EngineInstance) -> EngineParams:
    """Public alias used by the serving layer."""
    return _bind_instance_params(engine, instance)
