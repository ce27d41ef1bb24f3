"""The PyTorch port stands alone: no JAX and nothing of the JAX package.

``predictionio_tpu_torch`` and ``chip_smoke.py`` run on machines that have
PyTorch but not JAX, and they carry their own copy of everything they
need from ``predictionio_tpu``.  Two checks: importing every module of
the port in a fresh interpreter leaves ``jax`` and ``predictionio_tpu``
out of ``sys.modules``, and no source file names them in an import.
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
             if m in ("jax", "jaxlib", "predictionio_tpu")
             or m.startswith(("jax.", "jaxlib.", "predictionio_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""

# Every module of the training slice must be among those imported.
TRAINING_SLICE = (
    "ops.ragged", "ops.linalg", "ops.fused_gram", "ops.ridge_solve",
    "resilience.supervision", "models.als", "data.event",
    "data.storage.base", "data.storage.memory", "data.store",
    "data.columnar", "controller.engine", "templates.recommendation.engine",
    "workflow.core_workflow",
)
# ... and every module of the IVF/PQ slice, the tools included: they
# import without a card and build their inputs only when run.
IVF_PQ_SLICE = (
    "retrieval.ivf", "retrieval.pq", "ops.pq_scan", "ops.gather",
    "tools.exp_gram", "tools.exp_gather2",
)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "predictionio_tpu")


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(probe["modules"]) >= 30
    missing = [m for m in TRAINING_SLICE + IVF_PQ_SLICE
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
