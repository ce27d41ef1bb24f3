"""The PyTorch port stands alone: no JAX, no optax or orbax, no pyarrow
and nothing of the JAX package.

``predictionio_tpu_torch`` and ``chip_smoke.py`` run on machines that have
PyTorch but neither JAX nor pyarrow, and they carry their own copy of
everything they need from ``predictionio_tpu``.  Two checks: importing
every module of the port in a fresh interpreter leaves ``jax``,
``optax``, ``orbax``, ``pyarrow`` and ``predictionio_tpu`` out of
``sys.modules``, and no source file names them in an import.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import predictionio_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "pyarrow", "predictionio_tpu",
                      "optax", "orbax")
             or m.startswith(("jax.", "jaxlib.", "pyarrow.",
                              "predictionio_tpu.", "optax.", "orbax.")))
print(json.dumps({"modules": names, "bad": bad}))
"""

# Every module of the training slice must be among those imported.
TRAINING_SLICE = (
    "ops.ragged", "ops.linalg", "ops.fused_gram", "ops.ridge_solve",
    "ops.threefry", "ops.device_prep",
    "resilience.supervision", "models.als", "data.event",
    "data.storage.base", "data.storage.memory", "data.store",
    "data.columnar", "controller.engine", "templates.recommendation.engine",
    "workflow.core_workflow",
)
# ... and every module of the IVF/PQ slice, the tools included: they
# import without a card and build their inputs only when run.
IVF_PQ_SLICE = (
    "retrieval.ivf", "retrieval.pq", "ops.pq_scan", "ops.gather",
    "tools.exp_gram", "tools.exp_gather2", "tools.exp_gram_calls",
    "tools.exp_pq", "tools.exp_topk",
)
# ... and every module of the storage registry and CLI slice, the
# console's ``__main__`` included (it runs only as ``python -m``).
CLI_SLICE = (
    "config", "version", "data.json_support", "data.storage.sqlite",
    "data.storage.localfs_models", "controller.metrics",
    "templates.recommendation.evaluation", "cli.main", "cli.__main__",
)
# ... and every module of the event server slice.
EVENT_SERVER_SLICE = (
    "resilience", "resilience.deadline", "resilience.policy",
    "resilience.faults", "resilience.spill", "resilience.shared_spill",
    "data.storage", "data.storage.memory", "data.webhooks",
    "data.webhooks.connectors", "server.http", "server.plugins",
    "server.event_server", "server.engine_server", "sdk",
)

# ... and every module of the serving-scheduler slice: the scheduler,
# the result cache and the native frontend.
SCHEDULER_SLICE = (
    "serving", "serving.queue", "serving.batcher", "serving.autotune",
    "serving.result_cache", "native", "native.build", "native.frontend",
)


# ... and every module of the two-tower slice: the model, its template,
# and the train loop's substrate (feeder, prefetcher, fusion, probe,
# runtime introspection, supervision, checkpoints).
TWO_TOWER_SLICE = (
    "models.two_tower", "templates.twotower", "templates.twotower.engine",
    "native.feeder", "obs.pipeline", "obs.runtime", "data.prefetch",
    "data.fusion", "resilience.supervision", "workflow.checkpoint",
)
# ... and every module of the DLRM slice: the model, its template and
# the embedding gather the two models share.
DLRM_SLICE = (
    "models.dlrm", "templates.dlrm", "templates.dlrm.engine",
    "ops.embedding",
)
TRACE_SLICE = (
    "obs.trace", "obs.runtime", "obs.profiler",
    "tools.exp_als_repeat",
)
# ... and every module of the serving-observability slice: the latency
# waterfall, the SLO engine and the quality and recall monitors.
OBS_SLICE = (
    "obs", "obs.waterfall", "obs.slo", "obs.quality", "obs.recall",
)
# ... and every module of the fleet plane: the merged telemetry, the wave
# rollout, the admin server, the dashboard and the attribution tools.
FLEET_SLICE = (
    "obs.fleet", "fleet", "fleet.rollout", "server.admin",
    "server.dashboard", "tools.attribute_serve", "tools.attribute_quality",
)
# ... and every module of the storage server and the entry surfaces: the
# remote store, the registry that selects it, the CLI that serves it and
# the entry point.
REMOTE_SLICE = (
    "data.storage.remote", "data.storage", "cli.main", "obs.runtime",
    "entry",
)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "pyarrow", "predictionio_tpu", "optax",
                   "orbax")


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(probe["modules"]) >= 30
    missing = [m for m in TRAINING_SLICE + IVF_PQ_SLICE + CLI_SLICE
               + EVENT_SERVER_SLICE + SCHEDULER_SLICE + TWO_TOWER_SLICE
               + DLRM_SLICE + TRACE_SLICE + OBS_SLICE + FLEET_SLICE
               + REMOTE_SLICE
               if f"predictionio_tpu_torch.{m}" not in probe["modules"]]
    assert missing == []
    assert probe["bad"] == [], f"the port pulled in {probe['bad']}"


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def test_the_native_build_reads_only_the_ports_sources():
    """The port compiles its own copy of the frontend: every C++ source
    its build can name lies under ``predictionio_tpu_torch/native/``,
    and nothing in the package points at the repository's ``native/``."""
    from predictionio_tpu_torch.native import build

    assert build.SOURCE_DIR == PORT / "native"
    assert sorted(p.name for p in build.SOURCE_DIR.glob("*.cc")) == \
        ["feeder.cc", "serving_frontend.cc"]
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "NATIVE_DIR" not in text, path
        assert 'parents[2] / "native"' not in text, path
