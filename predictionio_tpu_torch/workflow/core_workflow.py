"""CoreWorkflow — engine-instance lifecycle and model persistence.

Port of the persistence half of ``predictionio_tpu/workflow/
core_workflow.py``: one manifest blob per engine instance (each model
pickled or self-persisted), ``load_models`` with the ``post_load`` hook,
and the instance-params rebinding the server uses.  ``persist_instance``
is the tail of the reference's ``run_train`` with the models given
instead of trained: it writes a COMPLETED ``EngineInstance`` and its
models.  ``run_train`` itself arrives with the training slice.
"""

from __future__ import annotations

import datetime as _dt
import importlib
import json
import logging
import pickle
from typing import Any, List, Optional, Sequence

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

__all__ = ["WorkflowError", "persist_instance", "load_models",
           "instance_engine_params"]


class WorkflowError(RuntimeError):
    pass


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _class_path(obj: Any) -> str:
    cls = obj if isinstance(obj, type) else type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def persist_instance(engine: Engine, variant: EngineVariant,
                     models: Sequence[Any], storage: Storage) -> str:
    """Write ``models`` as a COMPLETED engine instance of ``variant``;
    returns the instance id.  The variant's params are bound (strictly,
    as a train would) and snapshotted on the row, so the server rebinds
    exactly what the generation was made with."""
    ep_json = engine.bind_engine_params(variant.raw).to_json_dict()
    started = _now()
    instance = EngineInstance(
        id=None,
        status="TRAINING",
        start_time=started,
        end_time=None,
        engine_id=variant.engine_factory,
        engine_version=__version__,
        engine_variant=variant.variant_id,
        engine_factory=variant.engine_factory,
        datasource_params=json.dumps(ep_json["datasource"]["params"]),
        preparator_params=json.dumps(ep_json["preparator"]["params"]),
        algorithms_params=json.dumps(ep_json["algorithms"]),
        serving_params=json.dumps(ep_json["serving"]["params"]),
    )
    instances = storage.get_engine_instances()
    instance_id = instances.insert(instance)
    try:
        _persist_models(models, instance_id,
                        RuntimeContext(storage=storage))
    except BaseException:
        instance.status = "FAILED"
        instance.end_time = _now()
        instances.update(instance)
        raise
    instance.status = "COMPLETED"
    instance.end_time = _now()
    instances.update(instance)
    logger.info("EngineInstance %s COMPLETED (factory=%s)", instance_id,
                variant.engine_factory)
    return instance_id


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
