"""The port's ``pio`` command-line console.

Port of ``predictionio_tpu/cli/main.py`` (reference: tools/.../tools/
console/Console.scala and tools/.../commands/).  Verbs, with the
reference's output lines::

    pio status       [--metrics-url URL | --fleet URLS]
    pio app new <name> | list | delete <name> | data-delete <name>
    pio app channel-new <app> <channel> | channel-delete <app> <channel>
    pio accesskey new <app> [event ...] | list [app] | delete <key>
    pio build        --engine-json engine.json
    pio train        --engine-json engine.json [--seed N] [--device D]
                     [--mesh SPEC] [--checkpoint-dir D --checkpoint-every N]
                     [--follow [--refresh-interval S] [--promote-url URL]
                      [--canary-window S] [--trigger-staleness S]
                      [--trigger-delta-count N]]
    pio eval         <EvaluationClass> <EngineParamsGeneratorClass>
                     [--device D] [--mesh SPEC] [--checkpoint-dir D]
    pio deploy       --engine-json engine.json --port 8000 [--device D]
                     [--mesh SPEC] [--native] [--max-batch N]
                     [--max-wait-us U]
                     [--no-batcher] [--batch-window-ms MS]
                     [--queue-depth N] [--batch-p99-target-ms MS]
    pio eventserver  --ip 0.0.0.0 --port 7070 [--native]
    pio spill        inspect|drain|requeue-dead [--dir D] [--backend B]
    pio batchpredict --input q.ndjson --output p.ndjson [--device D]
                     [--mesh SPEC]
    pio import       --appid N --input events.ndjson [--from-line L]
    pio export       --appid N --output events.ndjson
    pio adminserver  --ip 127.0.0.1 --port 7071
    pio dashboard    --ip 127.0.0.1 --port 9000 [--fleet URLS]
    pio profile      [--url URL] [--out DIR] [--duration-ms MS]
    pio rollout      [--instances URLS] [--engine-instance-id ID]
                     [--waves SPEC] [--bake-s S] [--poll-s S]
                     [--state FILE] [--resume | --unwind]
    pio storageserver --ip 127.0.0.1 --port 7077 [--secret S]
    pio template get <template> <directory>
    pio shell

Storage is the ``PIO_STORAGE_*`` registry (by default sqlite and model
files under ``PIO_HOME``), so ``train`` in one process and ``deploy`` in
another share it.  ``--device`` takes the place of the reference's
``JAX_PLATFORMS``: the CUDA card by default, the CPU only when
``--device cpu`` is given; without CUDA a verb that computes fails
rather than run on the CPU.  ``--mesh SPEC`` (env ``PIO_MESH``; the
reference's grammar) lays a device mesh over that kind of device —
every card, or with ``--device cpu`` the CPU positions
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` asks for — and
the four compute verbs first join the ``PIO_COORDINATOR_ADDRESS`` /
``PIO_NUM_PROCESSES`` / ``PIO_PROCESS_ID`` gang when it is set (NCCL
on the card, gloo on the CPU).  ``deploy``'s scheduler flags override the
``PIO_BATCH_*`` / ``PIO_QUEUE_*`` knobs; ``--native`` serves through
the C++ continuous-batching frontend, built from the port's own source
at first use (a failed build ends the verb with the compiler's message;
there is no fallback to the Python transport).  ``train --follow`` is
the refresh daemon: it retrains on a cadence (ALS warm start on the
delta when it can) and promotes each generation through a deploy's
``POST /reload`` (several ``--promote-url`` servers: a wave rollout
through ``FleetPromoter``).  ``rollout`` promotes one generation across
a fleet in gated waves and rolls the whole fleet back when the merged
SLO or quality gate trips; ``status --fleet`` and ``dashboard --fleet``
merge the fleet's ``/metrics``; ``adminserver`` and ``profile --url``
capture a ``torch.profiler`` trace of a running process.
``storageserver`` hosts this ``PIO_HOME``'s storage over TCP for other
processes, which select it with ``type=pioserver``
(:mod:`predictionio_tpu_torch.data.storage.remote`); ``template get``
scaffolds an engine from the checkout's ``examples/<template>/`` with
the port's ``engineFactory``; ``shell`` is a Python REPL with the
storage, the package, numpy and torch preloaded.  ``train
--prefetch-depth`` / ``--fuse-steps`` / ``--batch-autoscale`` set the
deep models' input pipeline knobs
(``PIO_PREFETCH_DEPTH`` / ``PIO_FUSE_STEPS`` / ``PIO_BATCH_AUTOSCALE``);
a SIGTERM'd train hands back and exits 143; with ``--checkpoint-dir``
and ``--checkpoint-every`` (``PIO_CHECKPOINT_DIR`` /
``PIO_CHECKPOINT_EVERY``) ALS saves every N sweeps and the same command
run again resumes from the last complete sweep.  ``eval
--checkpoint-dir`` (``PIO_EVAL_CHECKPOINT_DIR``) keeps each finished
(candidate, fold) unit, so a SIGTERM'd sweep (exit 143) resumes.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
import logging
import os
import re
import signal
import sys
from pathlib import Path
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from predictionio_tpu_torch.version import __version__

logger = logging.getLogger(__name__)

# Streamed-import commit granularity (module-level so tests can shrink
# it to exercise the chunk-boundary resume path).
IMPORT_CHUNK = 50_000


def _storage():
    from predictionio_tpu_torch.data.storage import get_storage

    return get_storage()


def _die(msg: str, code: int = 1) -> "NoReturn":  # noqa: F821
    print(f"[error] {msg}", file=sys.stderr)
    raise SystemExit(code)


def _device(args):
    """The verb's ``torch.device``: the card unless ``--device cpu``;
    no CUDA and no ``--device cpu`` ends the verb with an error."""
    from predictionio_tpu_torch.device import device

    try:
        return device(args.device)
    except (RuntimeError, ValueError) as e:
        _die(str(e))


def _join_gang(args) -> None:
    """Check ``--mesh`` (its grammar errors end the verb with the
    parser's message before anything loads), then join the
    multi-process gang when ``PIO_COORDINATOR_ADDRESS`` is set (a no-op
    otherwise): NCCL for the card, gloo for ``--device cpu``."""
    from predictionio_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from predictionio_tpu_torch.parallel.mesh import parse_mesh_spec

    spec = getattr(args, "mesh", None)
    if spec is not None and spec.strip().lower() not in ("none", "off"):
        try:
            parse_mesh_spec(spec)
        except ValueError as e:
            _die(str(e))
    dev = getattr(args, "device", None)
    cpu = dev is not None and str(dev).strip().lower().startswith("cpu")
    initialize_distributed(backend="gloo" if cpu else "nccl")


def _context(args, **kwargs):
    """The verb's :class:`RuntimeContext`, on ``--device`` and over
    ``--mesh`` (env ``PIO_MESH`` without the flag); a mesh the devices
    cannot form ends the verb with the reason."""
    from predictionio_tpu_torch.controller import RuntimeContext

    try:
        return RuntimeContext.create(storage=_storage(), device=_device(args),
                                     mesh_spec=args.mesh, **kwargs)
    except ValueError as e:
        _die(str(e))


def _variant_and_engine(args):
    from predictionio_tpu_torch.controller import (
        EngineVariant,
        load_engine_factory,
    )

    variant_path = Path(args.engine_json)
    if not variant_path.exists():
        _die(f"{variant_path} not found (expected an engine.json).")
    variant = EngineVariant.from_file(variant_path)
    return variant, load_engine_factory(variant.engine_factory)()


# --------------------------------------------------------------------------
# pio status
# --------------------------------------------------------------------------

def cmd_status(args) -> int:
    import torch

    from predictionio_tpu_torch.config import load_config

    cfg = load_config()
    print(f"predictionio_tpu_torch {__version__}")
    print(f"PIO_HOME: {cfg.home}")
    try:
        repo_types = _storage().verify()
    except Exception as e:
        _die(f"storage verification failed: {e}")
    for repo, t in repo_types.items():
        src = cfg.source_for(repo)
        print(f"  {repo}: type={t} path={src.path or '-'}")
    if torch.cuda.is_available():
        free, total = torch.cuda.mem_get_info(0)
        print(f"devices: {torch.cuda.device_count()} x cuda "
              f"({torch.cuda.get_device_name(0)})")
        print(f"  device memory: {free / 2**30:.2f} GiB free of "
              f"{total / 2**30:.2f} GiB")
    else:
        print("devices: unavailable (CUDA is not available; verbs that "
              "compute need --device cpu)")
    fleet = getattr(args, "fleet", None)
    metrics_url = getattr(args, "metrics_url", None)
    # An explicit --metrics-url outranks the ambient PIO_FLEET_INSTANCES:
    # the operator asked about ONE process, not the fleet the env
    # happens to describe.  --fleet (also explicit) still wins over it.
    if fleet is not None or (metrics_url is None
                             and os.environ.get("PIO_FLEET_INSTANCES")):
        _print_fleet_status(fleet)
    else:
        _print_metrics_snapshot(metrics_url)
    print("(sanity check OK)")
    return 0


def _print_fleet_status(fleet_arg: Optional[str]) -> None:
    """`pio status --fleet URL,URL`: scrape every instance's
    /metrics + SLO state, merge type-correctly (obs.fleet), and print
    the operator summary — per-instance readiness next to fleet-summed
    traffic counters."""
    from predictionio_tpu_torch.obs.fleet import (
        FleetAggregator,
        fleet_instances_from_env,
    )

    urls = ([u.strip().rstrip("/") for u in fleet_arg.split(",")
             if u.strip()] if fleet_arg else fleet_instances_from_env())
    if not urls:
        print("fleet: no instances configured (--fleet URL,URL or "
              "PIO_FLEET_INSTANCES)")
        return
    agg = FleetAggregator(urls)
    doc = agg.scrape()
    print(f"fleet: {len(urls)} instance(s)")
    for row in doc["instances"]:
        state = "STALE" if row["stale"] else "up"
        parts = [state]
        slo = row.get("slo")
        if slo:
            parts.append("degraded" if slo.get("degraded") else "healthy")
            if slo.get("saturated"):
                parts.append("saturated")
            fast = slo.get("burn", {}).get("fast", {})
            parts.append(f"burn fast a={fast.get('availability', 0):g}"
                         f"/l={fast.get('latency', 0):g}")
        if row.get("error"):
            parts.append(row["error"])
        print(f"  {row['instance']}: {', '.join(parts)}")
    counters = doc["merged"]["counters"]
    interesting = ("pio_query_requests_total", "pio_query_errors_total",
                   "pio_event_requests_total", "pio_queue_rejected_total",
                   "pio_deadline_shed_total")
    shown = {k: v for k, v in counters.items()
             if any(k.startswith(p) for p in interesting)}
    if shown:
        print("  fleet totals:")
        for k, v in sorted(shown.items()):
            print(f"    {k} {v:g}")
    q = doc["merged"]["histogramQuantiles"].get("pio_query_latency_ms", {})
    for key, row in sorted(q.items()):
        print(f"  fleet {key}: p50 {row['p50']:g}ms p99 {row['p99']:g}ms "
              f"over {row['count']:g} requests")
    _print_fleet_plane(doc)


def _print_fleet_plane(doc) -> None:
    """The fleet plane's lines for `pio status --fleet`: shared spill-queue depth
    (scraped gauges first, storage second) and the journaled rollout
    wave state."""
    gauges = doc["merged"].get("gauges", {})
    shared = {k: v for k, v in gauges.items()
              if k.startswith("pio_spill_shared_depth")}
    if shared:
        print(f"  shared spill queue: {max(shared.values()):g} event(s) "
              "pending/leased (per-instance view of one fleet queue)")
    else:
        # No event server in the scraped set — best-effort direct read
        # of THIS process's configured storage.
        try:
            from predictionio_tpu_torch.resilience.shared_spill import (
                SharedSpillQueue,
            )

            st = SharedSpillQueue(_storage()).stats()
            print(f"  shared spill queue: {st.get('pendingEvents', 0)} "
                  f"pending / {st.get('leasedEvents', 0)} leased / "
                  f"{st.get('deadEvents', 0)} dead event(s)")
        except Exception:
            pass
    try:
        from predictionio_tpu_torch.fleet import rollout_state_path

        state = json.loads(rollout_state_path().read_text())
    except Exception:
        return
    line = (f"  rollout [{state.get('rolloutId')}]: "
            f"{state.get('status')} — wave {state.get('wave')} of "
            f"{len(state.get('waveCounts') or [])}, "
            f"{len(state.get('promoted') or [])} promoted, "
            f"{len(state.get('skipped') or {})} skipped")
    if state.get("haltReason"):
        line += f", halt: {state['haltReason']}"
    print(line)


def _print_metrics_snapshot(metrics_url: Optional[str]) -> None:
    """Metrics view for `pio status`: scrape a running server's /metrics
    when --metrics-url is given, else render this process's registry (the
    sanity checks above already touched storage, so it is non-empty only
    if instrumented code ran — say so rather than print nothing)."""
    if metrics_url:
        from urllib.request import urlopen

        url = metrics_url.rstrip("/")
        if not url.endswith("/metrics"):
            url += "/metrics"
        try:
            with urlopen(url, timeout=10) as resp:
                text = resp.read().decode()
        except Exception as e:
            print(f"metrics: cannot scrape {url} ({e})")
            return
        _print_serving_snapshot(text.splitlines())
        print(f"metrics (scraped from {url}):")
        for line in text.splitlines():
            if line and not line.startswith("#"):
                print(f"  {line}")
        return
    from predictionio_tpu_torch.obs import get_registry

    metrics = get_registry().metrics()
    samples = [line for m in metrics for line in m.render()]
    if not samples:
        print("metrics: none recorded in this process "
              "(use --metrics-url http://HOST:PORT to scrape a server)")
        return
    _print_serving_snapshot(samples)
    print("metrics (this process):")
    for line in samples:
        print(f"  {line}")


_BREAKER_STATES = {0: "closed", 1: "half-open", 2: "open"}
_METRIC_LINE = None  # compiled lazily (keep the import-light CLI startup)


def _parse_metric_lines(lines):
    """(name, labels-dict, value) triples from Prometheus text lines."""
    import re

    global _METRIC_LINE
    if _METRIC_LINE is None:
        _METRIC_LINE = re.compile(
            r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
            r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$')
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # Strip OpenMetrics exemplar suffixes (pio_serve_stage_ms buckets
        # carry ` # {trace_id="..."} v` after the sample value).
        line = line.split(" # ", 1)[0].rstrip()
        m = _METRIC_LINE.match(line)
        if not m:
            continue
        labels = {}
        for part in (m.group("labels") or "").split(","):
            if "=" in part:
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        try:
            yield m.group("name"), labels, float(m.group("value"))
        except ValueError:
            continue


def _print_serving_snapshot(lines) -> None:
    """Model-lifecycle view for `pio status`: the
    serving generation, reload outcomes, and breaker states out of a
    metrics exposition — printed alongside the device-memory snapshot so
    one `pio status --metrics-url` answers "what model is live and is
    its storage healthy"."""
    generation = None
    reloads = {}
    breakers = {}
    watchdog = {}
    batcher = {}
    latest_ts = {}
    staleness = None
    refresh_runs = {}
    quality = {}
    recall = {}
    rcache = {}

    def _b(model):
        return batcher.setdefault(model, {})

    for name, labels, value in _parse_metric_lines(lines):
        if name == "pio_model_generation":
            generation = int(value)
        elif name == "pio_events_latest_ts":
            latest_ts[labels.get("app", "?")] = value
        elif name == "pio_refresh_staleness_s":
            staleness = value
        elif name == "pio_refresh_runs_total" and value > 0:
            refresh_runs[labels.get("result", "?")] = int(value)
        elif name == "pio_quality_drift":
            quality.setdefault("drift", {})[
                f"{labels.get('metric', '?')}_{labels.get('window', '?')}"
            ] = value
        elif name == "pio_quality_drift_tripped":
            quality["tripped"] = bool(value)
        elif name == "pio_quality_reporting_only" and value > 0:
            quality["reporting_only"] = True
        elif name == "pio_quality_shadow_overlap":
            quality["shadow_overlap"] = value
        elif name == "pio_quality_online_hit_rate":
            quality["hit_rate"] = value
        elif name == "pio_quality_gate_rollback":
            quality["gate_rollback"] = bool(value)
        elif name == "pio_quality_sampled_total" and value > 0:
            quality["sampled"] = int(value)
        elif name == "pio_retrieval_recall":
            if labels.get("window") == "fast":
                recall.setdefault("rungs", {})[
                    labels.get("rung", "?")] = value
                recall["k"] = labels.get("k", "?")
        elif name == "pio_retrieval_recall_baseline":
            recall.setdefault("baselines", {})[
                labels.get("rung", "?")] = value
        elif name == "pio_retrieval_recall_tripped" and value > 0:
            recall["tripped"] = True
        elif name == "pio_retrieval_recall_reporting_only" and value > 0:
            recall["reporting_only"] = True
        elif name == "pio_result_cache_hits_total":
            rcache["hits"] = rcache.get("hits", 0) + int(value)
        elif name == "pio_result_cache_misses_total":
            rcache["misses"] = int(value)
        elif name == "pio_result_cache_hit_rate":
            rcache["hit_rate"] = value
        elif name == "pio_result_cache_entries":
            rcache["entries"] = int(value)
        elif name == "pio_result_cache_bytes":
            rcache["bytes"] = int(value)
        elif name == "pio_result_cache_evictions_total" and value > 0:
            rcache["evictions"] = int(value)
        elif name == "pio_result_cache_shared_errors_total" and value > 0:
            rcache["shared_errors"] = int(value)
        elif name == "pio_model_reload_total":
            reloads[labels.get("result", "?")] = int(value)
        elif name == "pio_breaker_state":
            breakers[labels.get("breaker", "?")] = \
                _BREAKER_STATES.get(int(value), str(value))
        elif name == "pio_watchdog_fired_total" and value > 0:
            watchdog[labels.get("fn", "?")] = int(value)
        elif name == "pio_batch_window_ms":
            _b(labels.get("model", "?"))["window_ms"] = value
        elif name == "pio_batch_max_size":
            _b(labels.get("model", "?"))["max"] = int(value)
        elif name == "pio_queue_depth":
            _b(labels.get("model", "?"))["queued"] = int(value)
        elif name == "pio_batch_dispatch_total":
            _b(labels.get("model", "?"))["dispatches"] = int(value)
        elif name == "pio_batch_requests_total":
            _b(labels.get("model", "?"))["requests"] = int(value)
        elif name == "pio_queue_rejected_total" and value > 0:
            _b(labels.get("model", "?"))["rejected"] = int(value)
        elif name == "pio_queue_shed_total" and value > 0:
            shed = _b(labels.get("model", "?")).setdefault("shed", {})
            shed[labels.get("reason", "?")] = int(value)
    if generation is None and not reloads and not breakers and not batcher \
            and not latest_ts and not refresh_runs and staleness is None \
            and not quality and not recall and not rcache:
        return
    if generation is not None:
        print(f"serving: model generation {generation}")
    # Freshness: ingest high-watermark per app + the refresh
    # loop's event→servable staleness, when the scraped process runs it.
    for app, ts in sorted(latest_ts.items()):
        iso = _dt.datetime.fromtimestamp(
            ts, tz=_dt.timezone.utc).isoformat(timespec="seconds")
        print(f"  events latest [app {app}]: {iso}")
    if staleness is not None:
        print(f"  refresh staleness: {staleness:g}s event→servable")
    if refresh_runs:
        parts = ", ".join(f"{k}={v}" for k, v in sorted(refresh_runs.items()))
        print(f"  refresh runs: {parts}")
    # Model quality: drift vs the training scorecard, shadow
    # canary overlap, online hit-rate, and the promotion-gate verdict.
    if quality:
        parts = []
        drift = quality.get("drift", {})
        if "psi_fast" in drift or "psi_slow" in drift:
            parts.append(f"psi fast={drift.get('psi_fast', 0):.3f}"
                         f"/slow={drift.get('psi_slow', 0):.3f}")
        if quality.get("tripped"):
            parts.append("DRIFT TRIPPED")
        if quality.get("reporting_only"):
            parts.append("reporting-only (no trusted scorecard)")
        if "shadow_overlap" in quality:
            parts.append(f"shadow overlap {quality['shadow_overlap']:.2f}")
        if "hit_rate" in quality:
            parts.append(f"online hit-rate {quality['hit_rate']:.3f}")
        if quality.get("gate_rollback"):
            parts.append("GATE=ROLLBACK")
        if "sampled" in quality:
            parts.append(f"sampled {quality['sampled']}")
        if parts:
            print(f"  quality: {', '.join(parts)}")
    # Retrieval recall: live sampled recall@k per approximate
    # rung vs the generation's own baked baseline.
    if recall:
        parts = []
        baselines = recall.get("baselines", {})
        for rung, v in sorted(recall.get("rungs", {}).items()):
            b = baselines.get(rung)
            parts.append(f"{rung} {v:.3f}"
                         + (f" (baseline {b:.3f})" if b is not None
                            else ""))
        if recall.get("tripped"):
            parts.append("RECALL TRIPPED")
        if recall.get("reporting_only"):
            parts.append("reporting-only (no trusted recall scorecard)")
        if parts:
            k = recall.get("k", "?")
            print(f"  recall@{k}: {', '.join(parts)}")
    # Result cache: the serve fast path — hit rate, residency,
    # and whether the shared tier is degrading to local-only.
    if rcache:
        parts = []
        if "hit_rate" in rcache:
            parts.append(f"hit-rate {rcache['hit_rate']:.3f}")
        if "hits" in rcache or "misses" in rcache:
            parts.append(f"hits {rcache.get('hits', 0)}"
                         f"/misses {rcache.get('misses', 0)}")
        if "entries" in rcache:
            parts.append(f"entries {rcache['entries']}")
        if "bytes" in rcache:
            parts.append(f"{rcache['bytes'] / 1024:.0f}KiB")
        if rcache.get("evictions"):
            parts.append(f"evictions {rcache['evictions']}")
        if rcache.get("shared_errors"):
            parts.append(f"SHARED-TIER ERRORS {rcache['shared_errors']}")
        if parts:
            print(f"  result cache: {', '.join(parts)}")
    if reloads:
        parts = ", ".join(f"{k}={v}" for k, v in sorted(reloads.items()))
        print(f"  model reloads: {parts}")
    for b, st in sorted(breakers.items()):
        print(f"  breaker [{b}]: {st}")
    for fn, n in sorted(watchdog.items()):
        print(f"  watchdog fired [{fn}]: {n}")
    # Batcher snapshot: coalescing health per model lane.
    for model, row in sorted(batcher.items()):
        disp, reqs = row.get("dispatches", 0), row.get("requests", 0)
        parts = [f"window {row.get('window_ms', 0):g}ms",
                 f"max {row.get('max', '?')}",
                 f"queued {row.get('queued', 0)}",
                 f"requests {reqs}", f"dispatches {disp}"]
        if disp:
            parts.append(f"mean batch {reqs / disp:.2f}")
        if row.get("rejected"):
            parts.append(f"rejected(429) {row['rejected']}")
        for reason, n in sorted(row.get("shed", {}).items()):
            parts.append(f"shed[{reason}] {n}")
        print(f"  batcher [{model}]: {', '.join(parts)}")


# --------------------------------------------------------------------------
# pio app ...
# --------------------------------------------------------------------------

def cmd_app_new(args) -> int:
    from predictionio_tpu_torch.data.storage import AccessKey, App

    s = _storage()
    app_id = s.get_apps().insert(App(id=None, name=args.name,
                                     description=args.description))
    if app_id is None:
        _die(f"App {args.name!r} already exists.")
    s.get_events().init(app_id)
    key = s.get_access_keys().insert(
        AccessKey(key=args.access_key or "", app_id=app_id))
    print("Created a new app:")
    print(f"      Name: {args.name}")
    print(f"        ID: {app_id}")
    print(f"Access Key: {key}")
    return 0


def cmd_app_list(args) -> int:
    s = _storage()
    apps = s.get_apps().get_all()
    keys = s.get_access_keys()
    print(f"{'Name':20} {'ID':>4}  Access Key")
    for app in apps:
        ks = keys.get_by_app_id(app.id)
        first = ks[0].key if ks else "-"
        print(f"{app.name:20} {app.id:>4}  {first}")
    print(f"Finished listing {len(apps)} app(s).")
    return 0


def cmd_app_delete(args) -> int:
    s = _storage()
    app = s.get_apps().get_by_name(args.name)
    if app is None:
        _die(f"App {args.name!r} does not exist.")
    if not args.force:
        ans = input(f"Delete app {args.name!r} and ALL its data? "
                    "(YES to confirm): ")
        if ans.strip() != "YES":
            print("Aborted.")
            return 1
    for ch in s.get_channels().get_by_app_id(app.id):
        s.get_events().remove(app.id, ch.id)
        s.get_channels().delete(ch.id)
    s.get_events().remove(app.id)
    for k in s.get_access_keys().get_by_app_id(app.id):
        s.get_access_keys().delete(k.key)
    s.get_apps().delete(app.id)
    print(f"Deleted app {args.name}.")
    return 0


def cmd_app_data_delete(args) -> int:
    s = _storage()
    app = s.get_apps().get_by_name(args.name)
    if app is None:
        _die(f"App {args.name!r} does not exist.")
    channel_id = None
    if args.channel:
        chans = s.get_channels().get_by_app_id(app.id)
        ch = next((c for c in chans if c.name == args.channel), None)
        if ch is None:
            _die(f"Channel {args.channel!r} does not exist in app "
                 f"{args.name!r}.")
        channel_id = ch.id
    if not args.force:
        where = f"channel {args.channel!r} of " if args.channel else ""
        ans = input(f"Delete all event data of {where}app {args.name!r}? "
                    "(YES to confirm): ")
        if ans.strip() != "YES":
            print("Aborted.")
            return 1
    ev = s.get_events()
    ev.remove(app.id, channel_id)
    ev.init(app.id, channel_id)
    print("Event data deleted.")
    return 0


def cmd_app_channel_new(args) -> int:
    from predictionio_tpu_torch.data.storage import Channel

    s = _storage()
    app = s.get_apps().get_by_name(args.app)
    if app is None:
        _die(f"App {args.app!r} does not exist.")
    cid = s.get_channels().insert(Channel(id=None, name=args.channel,
                                          app_id=app.id))
    if cid is None:
        _die(f"Invalid or duplicate channel name {args.channel!r} "
             "(1-16 chars, [a-zA-Z0-9-]).")
    s.get_events().init(app.id, cid)
    print(f"Created channel {args.channel} (ID {cid}) in app {args.app}.")
    return 0


def cmd_app_channel_delete(args) -> int:
    s = _storage()
    app = s.get_apps().get_by_name(args.app)
    if app is None:
        _die(f"App {args.app!r} does not exist.")
    ch = next((c for c in s.get_channels().get_by_app_id(app.id)
               if c.name == args.channel), None)
    if ch is None:
        _die(f"Channel {args.channel!r} does not exist in app {args.app!r}.")
    s.get_events().remove(app.id, ch.id)
    s.get_channels().delete(ch.id)
    print(f"Deleted channel {args.channel} from app {args.app}.")
    return 0


# --------------------------------------------------------------------------
# pio accesskey ...
# --------------------------------------------------------------------------

def cmd_accesskey_new(args) -> int:
    from predictionio_tpu_torch.data.storage import AccessKey

    s = _storage()
    app = s.get_apps().get_by_name(args.app)
    if app is None:
        _die(f"App {args.app!r} does not exist.")
    key = s.get_access_keys().insert(
        AccessKey(key="", app_id=app.id, events=tuple(args.events)))
    print(f"Created new access key: {key}")
    if args.events:
        print(f"  (restricted to events: {', '.join(args.events)})")
    return 0


def cmd_accesskey_list(args) -> int:
    s = _storage()
    keys = s.get_access_keys()
    if args.app:
        app = s.get_apps().get_by_name(args.app)
        if app is None:
            _die(f"App {args.app!r} does not exist.")
        rows = keys.get_by_app_id(app.id)
    else:
        rows = keys.get_all()
    for k in rows:
        ev = ",".join(k.events) if k.events else "(all)"
        print(f"{k.key}  app={k.app_id}  events={ev}")
    print(f"Finished listing {len(rows)} access key(s).")
    return 0


def cmd_accesskey_delete(args) -> int:
    if not _storage().get_access_keys().delete(args.key):
        _die(f"Access key {args.key!r} does not exist.")
    print("Deleted access key.")
    return 0


# --------------------------------------------------------------------------
# pio build / train / eval
# --------------------------------------------------------------------------

def cmd_build(args) -> int:
    """Reference: ``pio build`` compiles the engine with sbt; a Python
    engine has nothing to compile, so this validates: the engine.json
    parses, the factory imports and the params bind."""
    variant, engine = _variant_and_engine(args)
    params = engine.bind_engine_params(variant.raw)
    print(f"Engine factory {variant.engine_factory} OK "
          f"({len(params.algorithms_params)} algorithm(s): "
          f"{', '.join(n for n, _ in params.algorithms_params)}).")
    print("Engine variant params bind cleanly. Build successful.")
    return 0


def cmd_train(args) -> int:
    from predictionio_tpu_torch.resilience.supervision import (
        PREEMPTED_EXIT_CODE,
        TrainPreempted,
        install_preemption_handler,
    )
    from predictionio_tpu_torch.workflow.core_workflow import run_train

    _join_gang(args)
    if getattr(args, "checkpoint_dir", None):
        if args.checkpoint_every <= 0:
            _die("--checkpoint-dir requires --checkpoint-every N (the save "
                 "cadence); without it no checkpoints would be written and "
                 "a killed train could not resume.")
        os.environ["PIO_CHECKPOINT_DIR"] = args.checkpoint_dir
        os.environ["PIO_CHECKPOINT_EVERY"] = str(args.checkpoint_every)
    elif getattr(args, "checkpoint_every", 0) > 0:
        _die("--checkpoint-every requires --checkpoint-dir DIR (where to "
             "save); without it no checkpoints would be written.")
    if getattr(args, "prefetch_depth", 0) > 0:
        # Overlapped input pipeline (data/prefetch.py): the deep-model
        # train loop reads this when constructing its DevicePrefetcher.
        os.environ["PIO_PREFETCH_DEPTH"] = str(args.prefetch_depth)
    if getattr(args, "fuse_steps", None):
        # K-step fused dispatch (data/fusion.py): an int pins the window
        # depth, "auto" hands it to the HBM-guided autotuner.
        text = str(args.fuse_steps).strip().lower()
        if text != "auto":
            try:
                if int(text) < 1:
                    _die("--fuse-steps must be a positive integer or "
                         "'auto'.")
            except ValueError:
                _die(f"--fuse-steps {args.fuse_steps!r} is neither an "
                     "integer nor 'auto'.")
        os.environ["PIO_FUSE_STEPS"] = text
    if getattr(args, "batch_autoscale", False):
        # Opt-in: wider (concatenated) optimizer steps once fusion depth
        # caps out — a semantics change, so never on by default.
        os.environ["PIO_BATCH_AUTOSCALE"] = "on"
    if args.pq:
        # Quantized-corpus build policy, read at train time by the
        # templates (retrieval.build_train_pq).
        text = str(args.pq).strip().lower()
        if text not in ("auto", "on", "off"):
            _die(f"--pq {args.pq!r} must be auto|on|off.")
        os.environ["PIO_PQ"] = text
    if args.pq_m:
        if args.pq_m < 1:
            _die("--pq-m must be a positive integer (subspace count).")
        os.environ["PIO_PQ_M"] = str(args.pq_m)
    variant, engine = _variant_and_engine(args)
    ctx = _context(args, seed=args.seed)
    if ctx.mesh is not None:
        print(f"Mesh: {dict(ctx.mesh.shape)} over {ctx.mesh.devices.size} device(s)")
    if args.follow:
        return _train_follow(args, engine, variant, ctx)
    # SIGTERM during the train → the loops hand back at the next step
    # boundary and the verb exits 143 (the reference's preemption
    # contract); the process's own handler is back once the verb ends.
    previous = signal.getsignal(signal.SIGTERM)
    installed = install_preemption_handler()
    try:
        instance_id = run_train(engine, variant, ctx)
    except TrainPreempted as e:
        print(f"[preempted] {e}", file=sys.stderr)
        print("[preempted] rerun the same `pio train` command to resume.",
              file=sys.stderr)
        return PREEMPTED_EXIT_CODE
    finally:
        if installed:
            signal.signal(signal.SIGTERM, previous)
    print(f"Training completed. Engine instance ID: {instance_id}")
    return 0


def _train_follow(args, engine, variant, ctx) -> int:
    """``pio train --follow``: the continuous-refresh daemon.

    Retrains on a cadence — delta warm start when the last generation
    carries a watermark and continuable state, a full retrain otherwise
    — and, with ``--promote-url`` / ``PIO_REFRESH_PROMOTE_URL``, promotes
    each generation through the serving server's staged-reload gate.
    SIGTERM/SIGINT stop the loop after the current cycle, exit 0; a
    train in flight that checks the flag hands back at its next step
    boundary instead (``TrainPreempted``, exit 143), as in the
    reference: the two-tower and DLRM loops, and ALS under
    ``--checkpoint-dir``, after its current chunk of sweeps."""
    from predictionio_tpu_torch.refresh import RefreshConfig
    from predictionio_tpu_torch.refresh.daemon import RefreshDaemon
    from predictionio_tpu_torch.resilience.supervision import (
        PREEMPTED_EXIT_CODE,
        TrainPreempted,
        clear_preemption,
        request_preemption,
    )

    clear_preemption()   # a stop asked of an earlier run stops no new one
    cfg = RefreshConfig.from_env(
        interval_s=args.refresh_interval,
        promote_url=args.promote_url,
        canary_window_s=args.canary_window,
        trigger_staleness_s=args.trigger_staleness,
        trigger_delta_count=args.trigger_delta_count,
    )
    daemon = RefreshDaemon(engine, variant, ctx, config=cfg)

    def _stop(signum, frame):
        print(f"[follow] signal {signum}: stopping after the current "
              "cycle", file=sys.stderr, flush=True)
        request_preemption()
        daemon.stop()   # the between-cycles wait wakes at once

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _stop)
        except (ValueError, OSError):
            continue
    where = f", promoting via {cfg.promote_url}" if cfg.promote_url else \
        " (no promote URL — serving servers reload on their own)"
    if cfg.trigger_staleness_s is not None \
            or cfg.trigger_delta_count is not None:
        trig = []
        if cfg.trigger_staleness_s is not None:
            trig.append(f"staleness≥{cfg.trigger_staleness_s:g}s")
        if cfg.trigger_delta_count is not None:
            trig.append(f"delta≥{cfg.trigger_delta_count} events")
        print(f"Refresh daemon: trigger mode ({' or '.join(trig)}, "
              f"backstop every {cfg.interval_s:g}s){where}. Ctrl-C to "
              "stop.", flush=True)
    else:
        print(f"Refresh daemon: retraining every {cfg.interval_s:g}s"
              f"{where}. Ctrl-C to stop.", flush=True)
    try:
        cycles = daemon.follow(on_cycle=lambda out: print(
            "Refresh cycle: " + json.dumps(out), flush=True))
    except TrainPreempted as e:
        print(f"[preempted] {e}", file=sys.stderr)
        return PREEMPTED_EXIT_CODE
    print(f"Refresh daemon stopped after {cycles} cycle(s).")
    return 0


def cmd_eval(args) -> int:
    from predictionio_tpu_torch.controller import load_engine_factory
    from predictionio_tpu_torch.resilience.supervision import (
        PREEMPTED_EXIT_CODE,
        TrainPreempted,
        install_preemption_handler,
    )
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation

    _join_gang(args)
    evaluation = load_engine_factory(args.evaluation_class)()
    generator = load_engine_factory(args.params_generator_class)()
    ctx = _context(args, seed=args.seed)
    # The training preemption contract: SIGTERM keeps the sweep's
    # finished (candidate, fold) units and exits 143; the same command
    # run again resumes.  The process's own handler is back once the
    # verb ends.
    previous = signal.getsignal(signal.SIGTERM)
    installed = install_preemption_handler()
    try:
        instance_id, result = run_evaluation(
            evaluation, generator, ctx,
            evaluation_class=args.evaluation_class,
            params_generator_class=args.params_generator_class,
            checkpoint_dir=args.checkpoint_dir)
    except TrainPreempted as e:
        print(f"[preempted] {e}", file=sys.stderr)
        print("[preempted] rerun the same `pio eval` command to resume "
              "from the checkpointed folds.", file=sys.stderr)
        return PREEMPTED_EXIT_CODE
    finally:
        if installed:
            signal.signal(signal.SIGTERM, previous)
    print(result.summary())
    print(f"Evaluation instance ID: {instance_id}")
    if args.output_json:
        inst = ctx.storage.get_evaluation_instances().get(instance_id)
        Path(args.output_json).write_text(inst.evaluator_results_json)
        print(f"Results written to {args.output_json}")
    return 0


# --------------------------------------------------------------------------
# pio deploy / batchpredict
# --------------------------------------------------------------------------

def _install_drain_handlers(drain) -> None:
    """SIGTERM/SIGINT → stop accepting, finish in-flight requests, exit
    0 (a failed drain exits 1)."""
    def _handler(signum, frame):
        logger.info("signal %d: draining", signum)
        try:
            drain()
        except Exception:
            logger.exception("drain failed")
            raise SystemExit(1) from None
        raise SystemExit(0)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except (ValueError, OSError):  # not the main thread
            continue


def _server(args, engine, variant, **kwargs):
    """The verb's engine server, on ``--device`` and over ``--mesh``; a
    mesh the devices cannot form ends the verb with the reason."""
    from predictionio_tpu_torch.server.engine_server import EngineServer

    device = _device(args)
    try:
        return EngineServer(engine, variant, _storage(), device=device,
                            mesh_spec=args.mesh,
                            instance_id=args.engine_instance_id, **kwargs)
    except ValueError as e:
        _die(str(e))


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.serving import SchedulerConfig

    _join_gang(args)
    variant, engine = _variant_and_engine(args)
    # Serving-scheduler knobs: flags override the PIO_BATCH_*/PIO_QUEUE_*
    # env (SchedulerConfig.from_env ignores None overrides).
    sched_cfg = SchedulerConfig.from_env(
        enabled=False if args.no_batcher else None,
        window_ms=args.batch_window_ms,
        queue_depth=args.queue_depth,
        max_batch=args.max_batch,
        p99_target_ms=args.batch_p99_target_ms,
    )
    srv = _server(args, engine, variant, host=args.ip, port=args.port,
                  scheduler_config=sched_cfg)
    if args.native:
        return _deploy_native(args, srv, sched_cfg)
    _install_drain_handlers(srv.stop)
    srv.start(block=False)
    thread = srv._thread
    print(f"Engine Server listening on {args.ip}:{srv.port} "
          f"(instance {srv._instance.id}; device {srv.ctx.device}; "
          "Ctrl-C to stop)", flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def _deploy_native(args, srv, sched_cfg) -> int:
    """``pio deploy --native``: the C++ frontend answers ``/queries.json``
    in batches through ``srv.query_batch``; every other route goes to
    ``srv.handle`` (``GET /`` and ``GET /metrics`` stay the frontend's
    own), ``POST /stop`` ends the verb with exit 0."""
    import threading

    from predictionio_tpu_torch.native.frontend import NativeFrontend

    stop_event = threading.Event()

    def engine_fallback(method, path_with_qs, body):
        # /stop must stop the FRONTEND, and not from inside its own
        # callback thread (pio_frontend_stop joins the batchers): answer
        # first, then the main thread tears down.
        parsed = urlparse(path_with_qs)
        if parsed.path == "/stop" and method == "POST":
            stop_event.set()
            return 200, {"status": "stopping"}
        return srv.handle(method, parsed.path, body, parse_qs(parsed.query))

    try:
        # One batch ceiling for both batching stacks: the flag beats
        # PIO_BATCH_MAX beats 64.
        fe = NativeFrontend(srv.query_batch, host=args.ip, port=args.port,
                            max_batch=sched_cfg.max_batch,
                            max_wait_us=args.max_wait_us,
                            fallback=engine_fallback,
                            plugin_hook=(srv.plugins.header_block
                                         if srv.plugins else None))
    except RuntimeError as e:
        srv.stop()
        _die(f"native frontend unavailable: {e}")

    def _drain_native_deploy():
        fe.stop()
        srv.stop()

    _install_drain_handlers(_drain_native_deploy)
    port = fe.start()
    print(f"Native engine frontend on {args.ip}:{port} "
          f"(instance {srv._instance.id}; device {srv.ctx.device}; "
          f"continuous batching ≤{sched_cfg.max_batch}; Ctrl-C to stop)",
          flush=True)
    try:
        stop_event.wait()
    except KeyboardInterrupt:
        pass
    _drain_native_deploy()
    return 0


def cmd_eventserver(args) -> int:
    """The event server over the storage registry; prints the bound port
    (``--port 0`` picks a free one) and drains on SIGTERM/SIGINT.
    ``--native`` serves through the C++ frontend, which groups concurrent
    single-event POSTs into one insert."""
    from predictionio_tpu_torch.server.event_server import EventServer

    srv = EventServer(storage=_storage(), host=args.ip, port=args.port)
    if args.native:
        import threading

        from predictionio_tpu_torch.native.frontend import NativeFrontend

        try:
            fe = NativeFrontend(None, host=args.ip, port=args.port,
                                fallback_batch=srv.native_fallback_batch,
                                plugin_hook=(srv.plugins.header_block
                                             if srv.plugins else None))
        except RuntimeError as e:
            srv.stop()
            _die(f"native frontend unavailable: {e}")

        def _drain_native():
            fe.stop()
            srv.drain()

        _install_drain_handlers(_drain_native)
        port = fe.start()
        print(f"Event Server (native frontend) listening on "
              f"{args.ip}:{port} (Ctrl-C to stop)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            _drain_native()
        return 0
    _install_drain_handlers(srv.drain)
    srv.start(block=False)
    print(f"Event Server listening on {args.ip}:{srv.port} "
          "(Ctrl-C to stop)", flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.drain()
    return 0


def cmd_batchpredict(args) -> int:
    """Reference: ``pio batchpredict`` — bulk queries from NDJSON through
    the server's batched dispatch, ``--query-partitions`` queries a
    call."""
    _join_gang(args)
    variant, engine = _variant_and_engine(args)
    srv = _server(args, engine, variant)
    queries = []
    with open(args.input) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                queries.append(json.loads(line))
            except json.JSONDecodeError as e:
                _die(f"{args.input}:{line_no}: {e}")
    n = 0
    with open(args.output, "w") as out:
        for start in range(0, len(queries), args.query_partitions):
            chunk = queries[start:start + args.query_partitions]
            for q, r in zip(chunk, srv.query_batch(chunk)):
                out.write(json.dumps({"query": q, "prediction": r}) + "\n")
                n += 1
    print(f"Wrote {n} predictions to {args.output}.")
    return 0


# --------------------------------------------------------------------------
# pio spill inspect | drain | requeue-dead
# --------------------------------------------------------------------------

def _spill_dir(args) -> Path:
    from predictionio_tpu_torch.config import load_config
    from predictionio_tpu_torch.resilience.spill import resolve_spill_dir

    d = resolve_spill_dir(getattr(args, "dir", None), load_config().home)
    if d is None:
        _die("spilling is disabled (PIO_SPILL_DIR=off and no --dir given).")
    return d


def _spill_cli_backend(args) -> str:
    """local|shared for the spill verbs: --backend > PIO_SPILL_BACKEND >
    auto (local on every source the port has)."""
    from predictionio_tpu_torch.resilience.shared_spill import (
        resolve_spill_backend,
    )

    try:
        ev_type = _storage().config.source_for("EVENTDATA").type
    except KeyError:
        ev_type = None
    return resolve_spill_backend(getattr(args, "backend", None), ev_type)


def _shared_spill(args):
    from predictionio_tpu_torch.data.storage import StorageError
    from predictionio_tpu_torch.resilience.shared_spill import (
        SharedSpillQueue,
    )

    try:
        storage = _storage()
        storage.get_spill_queues()  # probe support
    except StorageError as e:
        _die(f"shared spill queue unavailable on this storage: {e}")
    return SharedSpillQueue(storage)


def cmd_spill_inspect(args) -> int:
    from predictionio_tpu_torch.resilience.spill import journal_summary

    if _spill_cli_backend(args) == "shared":
        q = _shared_spill(args)
        st = q.stats()
        print(f"shared spill queue [{q.queue}] "
              f"(storage-backed, fleet-wide):")
        print(f"  pending: {st.get('pending', 0)} record(s) / "
              f"{st.get('pendingEvents', 0)} event(s)")
        print(f"  leased: {st.get('leased', 0)} record(s) "
              f"({st.get('expired', 0)} with expired leases awaiting "
              "takeover)")
        print(f"  dead-lettered: {st.get('dead', 0)} record(s) / "
              f"{st.get('deadEvents', 0)} event(s)")
        if args.json:
            print(json.dumps(st))
        return 0
    s = journal_summary(_spill_dir(args))
    print(f"spill journal: {s['dir']}")
    print(f"  pending: {s['pendingRecords']} record(s) / "
          f"{s['pendingEvents']} event(s) "
          f"(offset {s['replayedOffset']}/{s['records']})")
    if s["pendingTokens"]:
        print(f"  next tokens: "
              f"{', '.join(t or '-' for t in s['pendingTokens'])}")
    print(f"  dead-lettered: {s['deadRecords']} record(s) / "
          f"{s['deadEvents']} event(s)")
    for inst in s["privateInstanceDirs"]:
        print(f"  private instance dir (locked-journal divert): {inst}")
    if args.json:
        print(json.dumps(s))
    return 0


def _open_spill_exclusive(args):
    """The mutating verbs need THE journal, not a diverted private one."""
    from predictionio_tpu_torch.resilience.spill import SpillJournal

    try:
        return SpillJournal(_spill_dir(args), divert_if_locked=False)
    except RuntimeError as e:
        _die(str(e))


def _spill_insert_fn(storage):
    """One journal/queue record → storage, token-pinned (shared by both
    drain backends).  A bulk record (per-item ``tokens``) replays through
    ``create_batch``, as the event server's replay does, so rows a
    crashed attempt already landed are not written twice; the
    reference's CLI takes ``insert_batch`` for every record."""
    from predictionio_tpu_torch.data.json_support import event_from_json
    from predictionio_tpu_torch.resilience import idempotency_key

    def insert(record):
        evs = [event_from_json(e) for e in record["events"]]
        events = storage.get_events()
        tokens = record.get("tokens")
        with idempotency_key(record["token"]):
            if tokens is not None:
                events.create_batch(evs, record["appId"],
                                    record.get("channelId"), tokens=tokens)
            else:
                events.insert_batch(evs, record["appId"],
                                    record.get("channelId"))
    return insert


def cmd_spill_drain(args) -> int:
    """Foreground replay into storage — the same record-at-a-time,
    token-pinned insert the event server's background worker does, for
    when that server is gone but its spill must not be.  Against the
    shared queue this is just another lease drainer (safe next to live
    instances — leases serialize the work); against the local journal it
    takes the exclusive flock."""
    from predictionio_tpu_torch.resilience.spill import ReplayWorker

    storage = _storage()
    if _spill_cli_backend(args) == "shared":
        from predictionio_tpu_torch.resilience.shared_spill import (
            LeaseDrainer,
        )

        q = _shared_spill(args)
        # owner=None → LeaseDrainer mints a pid+uuid identity: two
        # operators draining concurrently must never share an owner.
        drainer = LeaseDrainer(q, _spill_insert_fn(storage),
                               batch=args.batch)
        landed = drainer.drain_once()
        remaining = q.depth()
        print(f"Replayed {landed} event(s); {remaining} still pending "
              "in the shared queue"
              + (" (storage unavailable or leased elsewhere — re-run "
                 "after recovery)." if remaining else "."))
        return 0 if remaining == 0 else 1
    journal = _open_spill_exclusive(args)
    worker = ReplayWorker(journal, _spill_insert_fn(storage),
                          batch=args.batch)
    try:
        landed = worker.drain_once()
        remaining = journal.depth()
    finally:
        journal.close()
    print(f"Replayed {landed} event(s); {remaining} still pending"
          + (" (storage unavailable — re-run after recovery)."
             if remaining else "."))
    return 0 if remaining == 0 else 1


def cmd_spill_requeue_dead(args) -> int:
    if _spill_cli_backend(args) == "shared":
        n = _shared_spill(args).requeue_dead()
        if n == 0:
            print("No dead-lettered records in the shared queue.")
        else:
            print(f"Requeued {n} dead-lettered event(s) — any instance's "
                  "drainer (or `pio spill drain`) replays them.")
        return 0
    journal = _open_spill_exclusive(args)
    try:
        n = journal.requeue_dead()
    finally:
        journal.close()
    if n == 0:
        print("No dead-lettered records.")
    else:
        print(f"Requeued {n} dead-lettered event(s) for replay "
              "(drain with `pio spill drain` or restart the event server).")
    return 0


# --------------------------------------------------------------------------
# pio import / export
# --------------------------------------------------------------------------

def cmd_import(args) -> int:
    """Streamed import: parse and insert in bounded chunks, one
    group-committed ``insert_batch`` each (reference: FileToEvents).
    Chunks committed before a parse error stay committed (ids are
    store-assigned, so a naive re-run would duplicate them); the error
    names the resume point, and ``--from-line`` skips the imported
    prefix on the retry."""
    from predictionio_tpu_torch.data.json_support import event_from_json

    s = _storage()
    channel_id = _resolve_channel(s, args.appid, args.channel)
    ev = s.get_events()
    ev.init(args.appid, channel_id)
    start_line = max(1, args.from_line or 1)
    total = 0
    chunk = []
    last_committed_line = start_line - 1
    with open(args.input) as f:
        for line_no, line in enumerate(f, 1):
            if line_no < start_line:
                continue
            line = line.strip()
            if not line:
                continue
            try:
                chunk.append(event_from_json(json.loads(line)))
            except Exception as e:
                _die(
                    f"{args.input}:{line_no}: {e}\n"
                    f"{total} event(s) up to line {last_committed_line} "
                    f"were already imported and remain stored; fix the "
                    f"line and re-run with --from-line "
                    f"{last_committed_line + 1} to avoid duplicates.")
            if len(chunk) >= IMPORT_CHUNK:
                total += len(ev.insert_batch(chunk, args.appid, channel_id))
                chunk = []
                last_committed_line = line_no
    if chunk:
        total += len(ev.insert_batch(chunk, args.appid, channel_id))
    print(f"Imported {total} events to app {args.appid}.")
    return 0


def cmd_export(args) -> int:
    from predictionio_tpu_torch.data.json_support import event_to_json

    s = _storage()
    channel_id = _resolve_channel(s, args.appid, args.channel)
    n = 0
    with open(args.output, "w") as f:
        for ev in s.get_events().find(args.appid, channel_id):
            f.write(json.dumps(event_to_json(ev)) + "\n")
            n += 1
    print(f"Exported {n} events from app {args.appid} to {args.output}.")
    return 0


def _resolve_channel(s, app_id: int, channel_name: Optional[str]
                     ) -> Optional[int]:
    if not channel_name:
        return None
    ch = next((c for c in s.get_channels().get_by_app_id(app_id)
               if c.name == channel_name), None)
    if ch is None:
        _die(f"Channel {channel_name!r} does not exist in app {app_id}.")
    return ch.id


# --------------------------------------------------------------------------
# pio adminserver / profile / dashboard
# --------------------------------------------------------------------------

def cmd_adminserver(args) -> int:
    from predictionio_tpu_torch.server.admin import AdminServer

    srv = AdminServer(storage=_storage(), host=args.ip, port=args.port)
    srv.start(block=False)
    print(f"Admin server listening on {args.ip}:{srv.port} (Ctrl-C to stop)")
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_template_get(args) -> int:
    """Reference: `pio template get <gallery-repo> <dir>` scaffolds a new
    engine from the template gallery.  The gallery is the source
    checkout's examples/<name>; this copies the engine.json + quickstart
    into the target directory, ready for `pio build` / `pio train`.  The
    shipped engine.json names the JAX package's factory; the copy names
    the port's (``predictionio_tpu_torch.templates.<t>:engine``), so a
    `pio train` there trains with the port."""
    import shutil

    gallery = Path(__file__).resolve().parents[2] / "examples"
    if not gallery.is_dir():
        # pip wheels ship only the packages; the scaffold gallery lives
        # in the source checkout.
        _die("No template gallery in this installation (pip wheels ship "
             "only the package) — run from a source checkout, which has "
             "examples/<template>/engine.json scaffolds.")
    name = args.template.rstrip("/").split("/")[-1]  # accept repo-ish paths
    src = gallery / name
    if not src.is_dir():
        avail = sorted(d.name for d in gallery.iterdir()
                       if d.is_dir() and not d.name.startswith("_"))
        _die(f"Unknown template {name!r}. Available: {', '.join(avail)}")
    dst = Path(args.directory)
    if dst.exists() and (not dst.is_dir() or any(dst.iterdir())):
        _die(f"{dst} exists and is not empty.")
    shutil.copytree(src, dst, dirs_exist_ok=True)
    engine_json = dst / "engine.json"
    if engine_json.is_file():
        text = engine_json.read_text()
        engine_json.write_text(re.sub(
            r'("engineFactory"\s*:\s*")predictionio_tpu\.templates\.',
            r"\1predictionio_tpu_torch.templates.", text))
    print(f"Template {name!r} copied to {dst}/")
    for f in sorted(p.name for p in dst.iterdir()):
        print(f"  {f}")
    print("Next: edit engine.json (appName), then `pio train` there.")
    return 0


def _shell_device() -> str:
    """The device the port's entry points would use, for the banner."""
    import torch

    if torch.cuda.is_available():
        return f"cuda ({torch.cuda.get_device_name(0)})"
    return "none (CUDA is not available; pass device='cpu')"


def cmd_shell(args) -> int:
    """Reference: `pio-shell` (a spark-shell with the pio jars).  Here: a
    Python REPL with the storage, config, and template modules preloaded."""
    import code

    import numpy as np
    import torch

    import predictionio_tpu_torch as pio
    from predictionio_tpu_torch import config as pio_config

    storage = _storage()
    banner = (
        f"predictionio_tpu_torch shell\n"
        f"  storage  -> {type(storage).__name__} "
        f"({storage.config.repositories['METADATA'].source} metadata)\n"
        f"  apps     -> storage.get_apps().get_all()\n"
        f"  events   -> storage.get_events()\n"
        f"  device   -> {_shell_device()}\n"
        f"Modules: predictionio_tpu_torch (pio), numpy (np), torch"
    )
    code.interact(banner=banner, local={
        "storage": storage, "pio": pio, "np": np, "torch": torch,
        "config": pio_config,
    })
    return 0


def cmd_storageserver(args) -> int:
    """Host this process's configured storage over TCP (data/storage/remote.py)
    so OTHER processes can select it with type=pioserver — the reference's
    network-storage deployment shape (JDBC/HBase/ES) without their servers."""
    from predictionio_tpu_torch.data.storage.remote import StorageServer

    secret = args.secret or os.environ.get("PIO_STORAGE_SERVER_SECRET")
    srv = StorageServer(_storage(), host=args.ip, port=args.port,
                        secret=secret)
    srv.start()
    print(f"Storage server listening on {args.ip}:{srv.port} (Ctrl-C to stop)")
    print("Clients: PIO_STORAGE_SOURCES_REMOTE_TYPE=pioserver "
          f"PIO_STORAGE_SOURCES_REMOTE_HOSTS={args.ip} "
          f"PIO_STORAGE_SOURCES_REMOTE_PORTS={srv.port} "
          "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=REMOTE", flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_profile(args) -> int:
    """On-demand profiler capture (obs.profiler).

    With --url, arms the capture on a RUNNING admin server
    (POST /admin/profile) and returns immediately — the artifact lands on
    the server's disk.  Without it, captures THIS process for the window
    (mostly useful under `pio shell` or to smoke-test the platform)."""
    duration_ms = args.duration_ms
    if args.url:
        from urllib.error import HTTPError
        from urllib.request import Request, urlopen

        base = args.url.rstrip("/")
        url = base + f"/admin/profile?duration_ms={duration_ms:g}"
        try:
            with urlopen(Request(url, method="POST"), timeout=30) as resp:
                body = json.loads(resp.read() or b"{}")
        except HTTPError as e:
            payload = e.read()
            try:
                msg = json.loads(payload).get("message", "")
            except Exception:
                msg = payload.decode(errors="replace")[:200]
            _die(f"profile request failed: HTTP {e.code}: {msg}")
        except OSError as e:
            _die(f"cannot reach {args.url}: {e}")
        print(f"Profiling for {body.get('durationMs', duration_ms):g} ms; "
              f"artifacts: {body.get('path')}")
        if not args.out:
            print("(view trace.json in chrome://tracing or Perfetto once "
                  "the window closes; --out FILE downloads the archive)")
            return 0
        # The capture path above is SERVER-local: wait the window out,
        # then pull the archive down over HTTP so remote or fleet
        # operation never needs access to the server's disk.
        import time as _time

        _time.sleep(float(body.get("durationMs", duration_ms)) / 1e3)
        deadline = _time.monotonic() + 30
        while _time.monotonic() < deadline:
            try:
                with urlopen(base + "/admin/profile", timeout=10) as resp:
                    if not json.loads(resp.read() or b"{}").get("active"):
                        break
            except OSError:
                pass
            _time.sleep(0.25)
        try:
            with urlopen(base + "/admin/profile/artifact",
                         timeout=60) as resp:
                data = resp.read()
                disposition = resp.headers.get("Content-Disposition", "")
        except HTTPError as e:
            _die(f"artifact download failed: HTTP {e.code}")
        except OSError as e:
            _die(f"artifact download failed: {e}")
        out = Path(args.out)
        if out.is_dir():
            # The server names the archive after its capture dir
            # (Content-Disposition); fall back to a stable default.
            m = re.search(r'filename="([^"/\\]+)"', disposition)
            out = out / (m.group(1) if m else "pio_profile.tar.gz")
        out.write_bytes(data)
        print(f"Profile archive downloaded: {out} ({len(data):,} bytes)")
        return 0
    from predictionio_tpu_torch.obs.profiler import ProfilerUnavailable, capture

    try:
        path = capture(duration_ms, args.out)
    except ValueError as e:  # bad --duration-ms: same clean error as --url
        _die(str(e))
    except ProfilerUnavailable as e:
        _die(f"this platform cannot capture a profile: {e}")
    print(f"Profile captured: {path}")
    return 0


def cmd_dashboard(args) -> int:
    from predictionio_tpu_torch.server.dashboard import DashboardServer

    fleet = ([u.strip() for u in args.fleet.split(",") if u.strip()]
             if getattr(args, "fleet", None) else None)
    srv = DashboardServer(storage=_storage(), host=args.ip, port=args.port,
                          fleet=fleet)
    srv.start(block=False)
    print(f"Dashboard listening on {args.ip}:{srv.port} (Ctrl-C to stop)")
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()
    return 0


# --------------------------------------------------------------------------
# pio rollout — coordinated wave promotion across a fleet
# --------------------------------------------------------------------------

def cmd_rollout(args) -> int:
    from predictionio_tpu_torch.fleet import RolloutConfig, RolloutController
    from predictionio_tpu_torch.obs.fleet import fleet_instances_from_env

    urls = ([u.strip().rstrip("/") for u in args.instances.split(",")
             if u.strip()] if args.instances
            else fleet_instances_from_env())
    if not urls:
        _die("no instances (--instances URL,URL or PIO_FLEET_INSTANCES)")
    cfg = RolloutConfig.from_env(
        waves=args.waves, bake_s=args.bake_s, poll_s=args.poll_s,
        state_path=args.state)
    ctl = RolloutController(urls, cfg)
    if args.resume or args.unwind:
        try:
            state = ctl.resume(unwind=args.unwind)
        except RuntimeError as e:
            _die(str(e))
    else:
        prior = ctl.load_state()
        if prior and prior.get("status") in ("in_progress",
                                             "rolling_back"):
            _die(f"rollout {prior.get('rolloutId')} is journaled "
                 f"{prior.get('status')!r} at {ctl.state_path} — finish "
                 "it first (--resume to continue, --unwind to roll it "
                 "back)")
        state = ctl.run(args.engine_instance_id)
    print(f"rollout {state.get('rolloutId')}: {state['status']} "
          f"(target instance {state.get('target')})")
    print(f"  promoted: {len(state.get('promoted', []))}/"
          f"{len(state.get('instances', []))} instance(s)"
          + (f" through wave {state.get('wave')}"
             if state.get('wave') is not None else ""))
    for url, why in (state.get("skipped") or {}).items():
        print(f"  skipped {url}: {why}")
    if state.get("haltReason"):
        print(f"  halt: {state['haltReason']}")
    for url in state.get("rolledBack", []):
        print(f"  rolled back {url}")
    for url, why in (state.get("unwindFailures") or {}).items():
        print(f"  UNWIND FAILED {url}: {why} — roll this instance back "
              "by hand (POST /admin/rollback)")
    print(f"  state journal: {ctl.state_path}")
    # An explicitly requested unwind that rolled every instance back IS
    # the success case; a rollout (or resumed rollout) that got halted
    # and rolled back is not.
    ok = state["status"] == "promoted" or (
        args.unwind and state["status"] == "rolled_back"
        and not state.get("unwindFailures"))
    return 0 if ok else 1


# --------------------------------------------------------------------------
# parser
# --------------------------------------------------------------------------

def _device_flag(parser) -> None:
    parser.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="where to compute: the CUDA card by default ('cuda', "
             "'cuda:N'), 'cpu' only when named; no CUDA and no "
             "'--device cpu' is an error")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio", description="predictionio_tpu_torch console")
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="verb", required=True)

    st = sub.add_parser("status", help="storage + device sanity check "
                                       "+ metrics snapshot")
    st.add_argument("--metrics-url", dest="metrics_url", default=None,
                    metavar="URL",
                    help="scrape a running server's /metrics into the "
                         "status report (e.g. http://127.0.0.1:7070)")
    st.add_argument("--fleet", dest="fleet", default=None,
                    metavar="URLS",
                    help="comma-separated instance base URLs (or unset: "
                         "PIO_FLEET_INSTANCES) — scrape and merge "
                         "/metrics + SLO state across the fleet instead "
                         "of one process")
    st.set_defaults(fn=cmd_status)

    app = sub.add_parser("app", help="app management").add_subparsers(
        dest="app_verb", required=True)
    a = app.add_parser("new")
    a.add_argument("name")
    a.add_argument("--description")
    a.add_argument("--access-key", dest="access_key")
    a.set_defaults(fn=cmd_app_new)
    app.add_parser("list").set_defaults(fn=cmd_app_list)
    a = app.add_parser("delete")
    a.add_argument("name")
    a.add_argument("-f", "--force", action="store_true")
    a.set_defaults(fn=cmd_app_delete)
    a = app.add_parser("data-delete")
    a.add_argument("name")
    a.add_argument("--channel")
    a.add_argument("-f", "--force", action="store_true")
    a.set_defaults(fn=cmd_app_data_delete)
    a = app.add_parser("channel-new")
    a.add_argument("app")
    a.add_argument("channel")
    a.set_defaults(fn=cmd_app_channel_new)
    a = app.add_parser("channel-delete")
    a.add_argument("app")
    a.add_argument("channel")
    a.set_defaults(fn=cmd_app_channel_delete)

    ak = sub.add_parser("accesskey", help="access key management"
                        ).add_subparsers(dest="ak_verb", required=True)
    a = ak.add_parser("new")
    a.add_argument("app")
    a.add_argument("events", nargs="*")
    a.set_defaults(fn=cmd_accesskey_new)
    a = ak.add_parser("list")
    a.add_argument("app", nargs="?")
    a.set_defaults(fn=cmd_accesskey_list)
    a = ak.add_parser("delete")
    a.add_argument("key")
    a.set_defaults(fn=cmd_accesskey_delete)

    b = sub.add_parser("build", help="validate an engine variant")
    b.add_argument("--engine-json", default="engine.json")
    b.set_defaults(fn=cmd_build)

    t = sub.add_parser("train", help="train an engine variant")
    t.add_argument("--engine-json", default="engine.json")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None,
                   help="checkpoint root; with --checkpoint-every, a "
                        "killed train resumes from the last complete step")
    t.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=0, metavar="N",
                   help="save every N sweeps/steps (0 = off)")
    t.add_argument("--prefetch-depth", dest="prefetch_depth", type=int,
                   default=0, metavar="N",
                   help="staged batches the input pipeline keeps ahead "
                        "of the device (default: env PIO_PREFETCH_DEPTH, "
                        "else 2; raise on fast-feeder/slow-step "
                        "workloads, lower if HBM headroom warns)")
    t.add_argument("--fuse-steps", dest="fuse_steps", default=None,
                   metavar="K|auto",
                   help="optimizer steps issued per window with no host "
                        "sync inside (bitwise-equal to K=1).  'auto' "
                        "grows depth until the HBM headroom guardrail "
                        "pushes back, then backs off one notch and pins "
                        "(default: env PIO_FUSE_STEPS, else 1)")
    t.add_argument("--batch-autoscale", dest="batch_autoscale",
                   action="store_true",
                   help="let the fusion autotuner also widen the "
                        "effective batch (concatenate prepped batches) "
                        "once fusion depth caps out — fewer, wider "
                        "optimizer steps: a semantics change, opt-in "
                        "(env PIO_BATCH_AUTOSCALE=on)")
    t.add_argument("--pq", dest="pq", default=None, metavar="auto|on|off",
                   help="quantized-corpus build policy: residual PQ codes "
                        "next to the IVF index (default: env PIO_PQ, "
                        "else auto — builds above PIO_PQ_MIN_ITEMS)")
    t.add_argument("--pq-m", dest="pq_m", type=int, default=0, metavar="M",
                   help="PQ subspace count (bytes/item = 1+M; default: "
                        "env PIO_PQ_M, else ~dim/4)")
    t.add_argument("--follow", action="store_true",
                   help="continuous refresh: retrain on a cadence "
                        "(delta warm start when possible), promote "
                        "through the serving server's staged-reload "
                        "gate (--promote-url), roll back when the canary "
                        "window trips; SIGTERM/SIGINT stop after the "
                        "current cycle")
    t.add_argument("--refresh-interval", dest="refresh_interval",
                   type=float, default=None, metavar="S",
                   help="follow-mode cadence in seconds (default env "
                        "PIO_REFRESH_INTERVAL_S, else 300)")
    t.add_argument("--promote-url", dest="promote_url", default=None,
                   metavar="URL",
                   help="engine-server base URL each refreshed "
                        "generation is promoted through (POST /reload; "
                        "several comma-separated URLs: a gated wave "
                        "rollout across them; default env "
                        "PIO_REFRESH_PROMOTE_URL; unset = train only)")
    t.add_argument("--canary-window", dest="canary_window", type=float,
                   default=None, metavar="S",
                   help="post-promotion watch window; a trip rolls the "
                        "promotion back (default env "
                        "PIO_REFRESH_CANARY_WINDOW_S, else 60; 0 = off)")
    t.add_argument("--trigger-staleness", dest="trigger_staleness",
                   type=float, default=None, metavar="S",
                   help="follow-mode trigger: fire a refresh cycle when "
                        "event→servable staleness crosses S seconds "
                        "(default env PIO_REFRESH_TRIGGER_STALENESS_S; "
                        "the --refresh-interval cadence becomes a "
                        "backstop ceiling)")
    t.add_argument("--trigger-delta-count", dest="trigger_delta_count",
                   type=int, default=None, metavar="N",
                   help="follow-mode trigger: fire a refresh cycle when "
                        "N events have landed past the served watermark "
                        "(default env PIO_REFRESH_TRIGGER_DELTA_COUNT)")
    _device_flag(t)
    t.add_argument("--mesh", default=None, metavar="SPEC",
                   help="device mesh, e.g. 'data=8,model=2' or 'auto' "
                        "(default: env PIO_MESH, else single device)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="evaluate engine-params candidates")
    e.add_argument("evaluation_class")
    e.add_argument("params_generator_class")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--output-json", dest="output_json")
    e.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None,
                   help="persist each completed (candidate, fold) unit "
                        "here so a SIGTERM'd sweep resumes instead of "
                        "restarting (default env PIO_EVAL_CHECKPOINT_DIR;"
                        " cleared when the sweep completes)")
    _device_flag(e)
    e.add_argument("--mesh", default=None, metavar="SPEC")
    e.set_defaults(fn=cmd_eval)

    d = sub.add_parser("deploy", help="serve a trained engine over HTTP")
    d.add_argument("--engine-json", default="engine.json")
    d.add_argument("--ip", default="0.0.0.0")
    d.add_argument("--port", type=int, default=8000)
    d.add_argument("--engine-instance-id", dest="engine_instance_id")
    d.add_argument("--native", action="store_true",
                   help="serve via the C++ continuous-batching frontend")
    d.add_argument("--max-batch", type=int, default=None,
                   help="max queries per batched dispatch — applies to "
                        "the serving scheduler AND the native frontend "
                        "(default env PIO_BATCH_MAX, else 64)")
    d.add_argument("--max-wait-us", type=int, default=2000,
                   help="the native frontend's linger for stragglers")
    d.add_argument("--no-batcher", action="store_true",
                   help="disable the serving micro-batcher (per-request "
                        "dispatch; admission control stays on)")
    d.add_argument("--batch-window-ms", dest="batch_window_ms", type=float,
                   default=None,
                   help="initial batch gather window (default env "
                        "PIO_BATCH_WINDOW_MS, else 2.0; autotuned live)")
    d.add_argument("--queue-depth", dest="queue_depth", type=int,
                   default=None,
                   help="admission queue depth; full queue answers 429 "
                        "(default env PIO_QUEUE_DEPTH, else 128)")
    d.add_argument("--batch-p99-target-ms", dest="batch_p99_target_ms",
                   type=float, default=None,
                   help="autotuner served-latency p99 target (default env "
                        "PIO_BATCH_P99_TARGET_MS, else 100)")
    _device_flag(d)
    d.add_argument("--mesh", default=None, metavar="SPEC",
                   help="device mesh for model re-load/serve sharding")
    d.set_defaults(fn=cmd_deploy)

    es = sub.add_parser("eventserver",
                        help="start the event ingestion server")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--native", action="store_true",
                    help="serve through the C++ continuous-batching "
                         "frontend (group-committed ingest)")
    es.set_defaults(fn=cmd_eventserver)

    sp = sub.add_parser("spill", help="inspect/drain the storage-outage "
                                      "spill journal")
    spsub = sp.add_subparsers(dest="spill_verb", required=True)
    _backend_help = ("spill home to operate on: 'shared' = the "
                     "storage-backed fleet queue, 'local' = this box's "
                     "JSONL journal (default: PIO_SPILL_BACKEND, else "
                     "auto)")
    si = spsub.add_parser("inspect", help="pending/dead-letter counts "
                                          "(read-only; safe while the "
                                          "event server runs)")
    sd = spsub.add_parser("drain", help="foreground replay into storage "
                                        "(local: event server must be "
                                        "stopped; shared: safe anytime — "
                                        "leases serialize)")
    sq = spsub.add_parser("requeue-dead",
                          help="move dead-lettered records back into the "
                               "queue/journal for replay")
    for s_ in (si, sd, sq):
        s_.add_argument("--dir", default=None,
                        help="journal directory (default: PIO_SPILL_DIR, "
                             "else $PIO_HOME/spill)")
        s_.add_argument("--backend", default=None,
                        choices=("auto", "local", "shared"),
                        help=_backend_help)
    si.add_argument("--json", action="store_true",
                    help="also print the summary as one JSON line")
    si.set_defaults(fn=cmd_spill_inspect)
    sd.add_argument("--batch", type=int, default=100,
                    help="records per replay batch")
    sd.set_defaults(fn=cmd_spill_drain)
    sq.set_defaults(fn=cmd_spill_requeue_dead)

    bp = sub.add_parser("batchpredict",
                        help="bulk predict from NDJSON queries")
    bp.add_argument("--engine-json", default="engine.json")
    bp.add_argument("--input", required=True)
    bp.add_argument("--output", required=True)
    bp.add_argument("--engine-instance-id", dest="engine_instance_id")
    bp.add_argument("--query-partitions", type=int, default=256,
                    help="queries per vectorized predict chunk")
    _device_flag(bp)
    bp.add_argument("--mesh", default=None, metavar="SPEC")
    bp.set_defaults(fn=cmd_batchpredict)

    adm = sub.add_parser("adminserver", help="app-management REST API server")
    adm.add_argument("--ip", default="127.0.0.1")
    adm.add_argument("--port", type=int, default=7071)
    adm.set_defaults(fn=cmd_adminserver)

    tpl = sub.add_parser("template", help="engine template gallery")
    tplsub = tpl.add_subparsers(dest="template_cmd", required=True)
    tg = tplsub.add_parser("get", help="scaffold an engine from a template")
    tg.add_argument("template", help="template name (e.g. recommendation)")
    tg.add_argument("directory", help="target directory")
    tg.set_defaults(fn=cmd_template_get)

    sh = sub.add_parser("shell", help="interactive shell with storage "
                                      "preloaded (reference: pio-shell)")
    sh.set_defaults(fn=cmd_shell)

    ss = sub.add_parser("storageserver",
                        help="serve this PIO_HOME's storage over TCP "
                             "(clients use type=pioserver)")
    ss.add_argument("--ip", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=7077)
    ss.add_argument("--secret", default=None,
                    help="shared auth secret clients must present "
                         "(default: env PIO_STORAGE_SERVER_SECRET); "
                         "strongly recommended when binding non-loopback")
    ss.set_defaults(fn=cmd_storageserver)

    db = sub.add_parser("dashboard", help="engine/evaluation instance dashboard")
    db.add_argument("--ip", default="127.0.0.1")
    db.add_argument("--port", type=int, default=9000)
    db.add_argument("--fleet", default=None, metavar="URLS",
                    help="comma-separated instance base URLs to aggregate "
                         "at GET /fleet.json (default: "
                         "PIO_FLEET_INSTANCES)")
    db.set_defaults(fn=cmd_dashboard)

    pf = sub.add_parser("profile", help="on-demand torch.profiler capture "
                                        "(local, or a running admin "
                                        "server via --url)")
    pf.add_argument("--duration-ms", dest="duration_ms", type=float,
                    default=2000.0, help="capture window (default 2000)")
    pf.add_argument("--url", default=None,
                    help="admin server base URL (e.g. "
                         "http://127.0.0.1:7071) — capture happens there")
    pf.add_argument("--out", default=None,
                    help="local capture: artifact directory (default: "
                         "fresh temp dir; env PIO_PROFILE_OUT). With "
                         "--url: LOCAL file/dir the capture archive is "
                         "downloaded to after the window closes "
                         "(GET /admin/profile/artifact)")
    pf.set_defaults(fn=cmd_profile)

    ro = sub.add_parser("rollout",
                        help="promote a generation across a fleet in "
                             "gated waves, rolling the WHOLE fleet back "
                             "on degradation")
    ro.add_argument("--instances", default=None, metavar="URLS",
                    help="comma-separated engine-server base URLs "
                         "(default: PIO_FLEET_INSTANCES)")
    ro.add_argument("--engine-instance-id", dest="engine_instance_id",
                    default=None,
                    help="candidate engine instance id (default: the "
                         "first promoted server's latest COMPLETED, "
                         "then pinned fleet-wide)")
    ro.add_argument("--waves", default=None, metavar="SPEC",
                    help="wave tranches, counts or percentages "
                         "(default env PIO_ROLLOUT_WAVES, else "
                         "'1,25%%,100%%')")
    ro.add_argument("--bake-s", dest="bake_s", type=float, default=None,
                    help="per-wave observation window watching the "
                         "fleet-merged SLO burn + quality gate "
                         "(default env PIO_ROLLOUT_BAKE_S, else 10)")
    ro.add_argument("--poll-s", dest="poll_s", type=float, default=None,
                    help="gate poll cadence inside the bake (default "
                         "env PIO_ROLLOUT_POLL_S, else 1)")
    ro.add_argument("--state", default=None, metavar="FILE",
                    help="wave-state journal (default env "
                         "PIO_ROLLOUT_STATE, else "
                         "$PIO_HOME/rollout/state.json)")
    ro.add_argument("--resume", action="store_true",
                    help="continue a preempted rollout from its journal "
                         "(re-verifies what each instance serves first)")
    ro.add_argument("--unwind", action="store_true",
                    help="roll back everything the journaled rollout "
                         "already promoted, instead of continuing")
    ro.set_defaults(fn=cmd_rollout)

    imp = sub.add_parser("import", help="import NDJSON events")
    imp.add_argument("--appid", type=int, required=True)
    imp.add_argument("--channel")
    imp.add_argument("--input", required=True)
    imp.add_argument("--from-line", type=int, default=1, dest="from_line",
                     help="resume a partially-committed import at this "
                          "1-based line (printed by a failed run)")
    imp.set_defaults(fn=cmd_import)

    exp = sub.add_parser("export", help="export events as NDJSON")
    exp.add_argument("--appid", type=int, required=True)
    exp.add_argument("--channel")
    exp.add_argument("--output", required=True)
    exp.set_defaults(fn=cmd_export)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(levelname)s] [%(name)s] %(message)s",
    )
    from predictionio_tpu_torch.controller import ParamsBindingError
    from predictionio_tpu_torch.data.storage import StorageError
    from predictionio_tpu_torch.workflow.core_workflow import WorkflowError

    try:
        return args.fn(args)
    except SystemExit:
        raise
    except KeyboardInterrupt:
        return 130
    except (ParamsBindingError, StorageError, WorkflowError) as e:
        # User-input errors get a clean message; unexpected ones traceback.
        print(f"[error] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
