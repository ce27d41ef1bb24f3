"""CoreWorkflow — train runs, engine-instance lifecycle, model persistence.

Port of ``predictionio_tpu/workflow/core_workflow.py`` (reference:
CoreWorkflow.scala runTrain):

    run_train: bind params → EngineInstance(TRAINING) → Engine.train
      → persist models → EngineInstance(COMPLETED | FAILED)

One manifest blob per engine instance (each model pickled or
self-persisted), ``load_models`` with the ``post_load`` hook, and the
instance-params rebinding the server uses.  ``persist_instance`` is the
tail of ``run_train`` with the models given instead of trained.
``run_evaluation`` sweeps engine-params candidates (reference:
CoreWorkflow.runEvaluation).  ``run_train(warm_from=...)`` is the
refresh loop's delta warm start: it reads only ``[previous watermark,
new watermark)`` and falls back to a full retrain in the same engine
instance when an algorithm declines (``refreshMode`` ``warm`` /
``full`` / ``full_fallback`` on the instance's env).  Each train is one
``workflow.train`` trace (the DASE phases and ``train.persist`` are its
spans), runs under the device-memory sampler's fresh peak window, and
with ``PIO_PROFILE_DIR`` (or the workflow param ``profile_dir``) under a
``torch.profiler`` capture whose Chrome trace lands in that directory.
``run_evaluation(checkpoint_dir=...)`` (or ``PIO_EVAL_CHECKPOINT_DIR``)
keeps each finished (candidate, fold) unit of the sweep, so a preempted
sweep resumes (:class:`~predictionio_tpu_torch.controller.engine.
EvalCheckpoint`).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import importlib
import json
import logging
import os
import pickle
import traceback
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.version import __version__
from predictionio_tpu_torch.controller import (
    Engine,
    EngineParams,
    EngineParamsGenerator,
    EngineVariant,
    Evaluation,
    MetricEvaluatorResult,
    PersistentModel,
    RuntimeContext,
    WarmStartFallback,
)
from predictionio_tpu_torch.data.storage import (
    EngineInstance,
    EvaluationInstance,
    Model,
    Storage,
)
from predictionio_tpu_torch.obs import (
    get_memory_sampler,
    phase,
    publish_event,
)
from predictionio_tpu_torch.obs import trace as obs_trace
from predictionio_tpu_torch.resilience.supervision import TrainPreempted

logger = logging.getLogger(__name__)

__all__ = ["WorkflowError", "run_train", "persist_instance", "load_models",
           "instance_engine_params", "run_evaluation", "data_watermark",
           "DATA_WATERMARK_KEY", "REFRESH_MODE_KEY", "WARM_FROM_KEY"]

# EngineInstance.env keys of the refresh loop.  The env dict rides every
# backend's row format, so none needs a schema change.
DATA_WATERMARK_KEY = "dataWatermark"   # ISO-8601 until-bound of the data read
REFRESH_MODE_KEY = "refreshMode"       # "full" | "warm" | "full_fallback"
WARM_FROM_KEY = "warmStartFrom"        # parent COMPLETED instance id


def data_watermark(instance: EngineInstance) -> Optional[_dt.datetime]:
    """The data high-watermark recorded on a train run: every event with
    ``event_time < watermark`` was visible to (and bounded the read of)
    that generation.  None for an instance that records none."""
    raw = (instance.env or {}).get(DATA_WATERMARK_KEY)
    if not raw:
        return None
    try:
        return _dt.datetime.fromisoformat(raw)
    except ValueError:
        return None


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
    # The id is the insert's answer: a remote store (``pioserver``)
    # cannot fill in the caller's object, and every later update of the
    # row goes by ``instance.id``.
    instance.id = storage.get_engine_instances().insert(instance)
    return instance, engine_params


def _finish(storage: Storage, instance: EngineInstance, status: str) -> None:
    instance.status = status
    instance.end_time = _now()
    storage.get_engine_instances().update(instance)


def run_train(engine: Engine, variant: EngineVariant,
              ctx: Optional[RuntimeContext] = None, *,
              engine_id: Optional[str] = None,
              engine_version: str = __version__,
              warm_from: Any = None) -> str:
    """Train an engine variant; returns the COMPLETED engine-instance id.

    Reference: CoreWorkflow.runTrain, including the FAILED-status write
    on any error, which callers rely on.  The run stamps a data
    watermark BEFORE the datasource reads and scopes the read to
    ``event_time < watermark`` (through
    :class:`~predictionio_tpu_torch.data.store.WindowedEventStore`),
    recording it in ``instance.env[dataWatermark]``: events landing
    mid-read belong to the next generation.  ``ctx`` defaults to
    :meth:`RuntimeContext.create` (the card).

    ``warm_from`` (a :class:`~predictionio_tpu_torch.refresh.
    WarmStartContext`) switches the run to delta warm start: the
    datasource reads only ``[previous watermark, new watermark)`` and
    each algorithm continues its previous model.  A
    :class:`~predictionio_tpu_torch.controller.WarmStartFallback` falls
    back to a full retrain over the complete window inside the SAME
    engine instance (``refreshMode`` ``full_fallback``).  A
    :class:`TrainPreempted` lands the instance as PREEMPTED.
    """
    from predictionio_tpu_torch.data.store import WindowedEventStore

    ctx = ctx or RuntimeContext.create()
    storage: Storage = ctx.storage
    # The watermark is pinned before ANY event is read.
    watermark = _now()
    env = {DATA_WATERMARK_KEY: watermark.isoformat(),
           REFRESH_MODE_KEY: "warm" if warm_from is not None else "full"}
    if warm_from is not None and getattr(warm_from, "instance", None):
        env[WARM_FROM_KEY] = warm_from.instance.id
    instance, engine_params = _start_instance(
        engine, variant, storage, env=env,
        engine_id=engine_id, engine_version=engine_version)
    logger.info("EngineInstance %s TRAINING (factory=%s)", instance.id,
                variant.engine_factory)
    # Per-run device-memory peak: a fresh peak window at the start, the
    # poll thread tracks the high-water mark, and the final sample pins
    # pio_device_mem_peak_bytes to THIS run.
    sampler = get_memory_sampler()
    sampler.reset_peak()
    sampler.start()

    def _windowed(start: Optional[_dt.datetime]) -> RuntimeContext:
        return dataclasses.replace(
            ctx, event_store=WindowedEventStore(storage, start, watermark))

    try:
        # One trace per train: the DASE phases inside Engine.train and
        # the persist phase below hang off this root; recorded to the
        # ring (and PIO_TRACE_FILE) on exit.
        with obs_trace("workflow.train",
                       engine_factory=variant.engine_factory,
                       instance=instance.id,
                       mode=env[REFRESH_MODE_KEY]):
            models = None
            if warm_from is not None:
                try:
                    wctx = _windowed(warm_from.start_time)
                    models = _maybe_profiled(
                        ctx, lambda: engine.train(wctx, engine_params,
                                                  warm=warm_from))
                except WarmStartFallback as e:
                    # The fallback is part of the contract, not a
                    # failure: retrain fully over the complete window,
                    # same instance, and record which road was taken.
                    logger.warning(
                        "EngineInstance %s: warm-start declined (%s) — "
                        "falling back to a full retrain", instance.id,
                        e.reason)
                    publish_event("refresh.warm_fallback",
                                  instance=instance.id,
                                  reason=e.reason[:200])
                    instance.env[REFRESH_MODE_KEY] = "full_fallback"
            if models is None:
                fctx = _windowed(None)
                models = _maybe_profiled(
                    ctx, lambda: engine.train(fctx, engine_params))
            with phase("train.persist"):
                _persist_models(models, instance.id, ctx)
            sampler.sample_once()
    except TrainPreempted as e:
        # SIGTERM preemption: the distinct status tells a supervisor
        # this run hands back (and, with checkpoints, resumes), not
        # failed.
        _finish(storage, instance, "PREEMPTED")
        logger.warning("EngineInstance %s PREEMPTED at step %d",
                       instance.id, e.step)
        raise
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


def _maybe_profiled(ctx: RuntimeContext, fn):
    """``PIO_PROFILE_DIR`` (or the workflow param ``profile_dir``): run
    ``fn`` under a ``torch.profiler`` capture whose Chrome trace lands in
    that directory (the reference captures a JAX xplane trace there)."""
    trace_dir = ctx.workflow_params.get("profile_dir") or os.environ.get(
        "PIO_PROFILE_DIR")
    if not trace_dir:
        return fn()
    from predictionio_tpu_torch.obs.profiler import get_profiler

    logger.info("Capturing a torch.profiler trace to %s", trace_dir)
    return get_profiler().capture_call(str(trace_dir), fn)


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
    ``post_load(ctx)`` hook — where a model takes its serving device
    and, with ``ctx.mesh``, re-lays itself out over the mesh (the
    recommendation corpus row-shards).  A failed hook is logged and the
    model serves with the layout it loaded with."""
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


def run_evaluation(
    evaluation: Evaluation,
    params_generator: EngineParamsGenerator,
    ctx: Optional[RuntimeContext] = None,
    *,
    evaluation_class: str = "",
    params_generator_class: str = "",
    checkpoint_dir: Optional[str] = None,
) -> Tuple[str, MetricEvaluatorResult]:
    """Sweep engine-params candidates and score them (reference:
    CoreWorkflow.runEvaluation + MetricEvaluator.evaluateBase): each
    candidate over the ``read_eval`` folds (:meth:`Engine.eval_multi`),
    scored by the evaluation's metrics, the best by the first metric;
    the sweep lands as an EVALCOMPLETED :class:`EvaluationInstance`
    (EVALFAILED on an error).

    ``checkpoint_dir`` (default ``PIO_EVAL_CHECKPOINT_DIR``) makes the
    sweep preemption-safe: each finished (candidate, fold) unit is kept
    as it finishes, a SIGTERM mid-sweep marks the instance
    EVALPREEMPTED and raises ``TrainPreempted`` (``pio eval`` exits
    143), and the same command run again resumes from the kept units,
    which are cleared once the sweep lands."""
    from predictionio_tpu_torch.controller.engine import EvalCheckpoint

    ctx = ctx or RuntimeContext.create()
    storage: Storage = ctx.storage
    ck_dir = checkpoint_dir or os.environ.get("PIO_EVAL_CHECKPOINT_DIR")
    checkpoint = EvalCheckpoint(ck_dir) if ck_dir else None
    instance = EvaluationInstance(
        id=None,
        status="EVALRUNNING",
        start_time=_now(),
        end_time=None,
        evaluation_class=evaluation_class or _class_path(evaluation.engine),
        engine_params_generator_class=(params_generator_class
                                       or _class_path(params_generator)),
    )
    instances = storage.get_evaluation_instances()
    instance_id = instance.id = instances.insert(instance)
    try:
        candidates = list(params_generator.engine_params_list)
        if not candidates:
            raise WorkflowError(
                "EngineParamsGenerator produced no candidates.")
        if checkpoint is not None and checkpoint.completed():
            logger.info("eval sweep resuming: %d completed "
                        "(candidate, fold) unit(s) found in %s",
                        checkpoint.completed(), ck_dir)
        scored: List[Tuple[EngineParams, float, List[float]]] = []
        all_eval_data = evaluation.engine.eval_multi(
            ctx, candidates, checkpoint=checkpoint)
        for i, (engine_params, eval_data) in enumerate(
                zip(candidates, all_eval_data)):
            score = evaluation.metric.calculate(eval_data)
            others = [m.calculate(eval_data)
                      for m in evaluation.other_metrics]
            scored.append((engine_params, score, others))
            logger.info("eval candidate %d/%d: %s=%s", i + 1,
                        len(candidates), evaluation.metric.header, score)
        best_index = max(range(len(scored)), key=lambda i: (scored[i][1],))
        result = MetricEvaluatorResult(
            best_score=scored[best_index][1],
            best_engine_params=scored[best_index][0],
            best_index=best_index,
            metric_header=evaluation.metric.header,
            other_metric_headers=[m.header
                                  for m in evaluation.other_metrics],
            candidate_scores=scored,
        )
        instance.status = "EVALCOMPLETED"
        instance.end_time = _now()
        instance.evaluator_results = result.summary()
        instance.evaluator_results_json = json.dumps({
            "bestScore": result.best_score,
            "bestIndex": result.best_index,
            "metric": result.metric_header,
            "bestEngineParams": result.best_engine_params.to_json_dict(),
            "candidates": [
                {"engineParams": p.to_json_dict(), "score": s, "others": o}
                for p, s, o in scored
            ],
        })
        instances.update(instance)
        if checkpoint is not None:
            checkpoint.clear()  # landed: a rerun is a fresh sweep
        return instance_id, result
    except TrainPreempted:
        # SIGTERM mid-sweep: the finished units are on disk and the CLI
        # owns the exit code — not a failed evaluation.
        instance.status = "EVALPREEMPTED"
        instance.end_time = _now()
        instances.update(instance)
        raise
    except Exception:
        instance.status = "EVALFAILED"
        instance.end_time = _now()
        instances.update(instance)
        raise
