"""Phase 14 of chip_smoke.py (100,000 events through `pio eventserver`
by 8 SDK threads) in two trees on one card, alternating.

The other tree is another commit unpacked by ``git archive`` into a
directory that .gitignore lists (``build/parent``).  The runs are other,
this, this with ``PIO_SEGMENTS=off`` (no segment tee), this, other, each
a process of its own started in its tree.  Prints the card's name and
power limit, then one line ``<n> <run> {json}`` a run: events/s, client
p50 and p99 a batch (ms), the ingest and phase walls (s).  Exits 1 if a
run fails.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 chip_ab.py build/parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

RUNS = (("other", False), ("this", False), ("this_tee_off", True),
        ("this", False), ("other", False))
KEYS = ("n_events", "events_per_s", "batch_p50_ms", "batch_p99_ms",
        "ingest_s", "phase_s")
# one phase 14 in the tree that is the working directory
_RUN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from predictionio_tpu_torch.cli.main import main as pio
from predictionio_tpu_torch.controller import RuntimeContext
from predictionio_tpu_torch.device import set_float32_precision
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.ops import fused_topk as ft
from predictionio_tpu_torch.ops import ridge_solve as rs
from predictionio_tpu_torch.ops.topk import topk_mismatch
from predictionio_tpu_torch.templates.recommendation import engine

card = cs.card_line()
_build.build()
set_float32_precision()
out = cs.eventserver_phase(torch.device("cuda"), 0, {
    "fg": fg, "rs": rs, "ft": ft, "engine": engine, "pio": pio,
    "topk_mismatch": topk_mismatch, "RuntimeContext": RuntimeContext},
    card)
print("phase14 " + json.dumps({k: out[k] for k in %r}), flush=True)
""" % (KEYS,)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    other = Path(sys.argv[1]).resolve()
    if not (other / "chip_smoke.py").exists():
        print(f"{other} holds no chip_smoke.py", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    failed = False
    for n, (run, tee_off) in enumerate(RUNS, 1):
        env = dict(os.environ)
        env.pop("PIO_SEGMENTS", None)
        if tee_off:
            env["PIO_SEGMENTS"] = "off"
        proc = subprocess.run(
            [sys.executable, "-c", _RUN], cwd=other if run == "other"
            else here, env=env, capture_output=True, text=True,
            timeout=600)
        got = [ln[len("phase14 "):] for ln in proc.stdout.splitlines()
               if ln.startswith("phase14 ")]
        if proc.returncode != 0 or not got:
            failed = True
            print(f"{n} {run} failed (rc {proc.returncode}): "
                  f"{proc.stderr[-1500:]}", flush=True)
            continue
        print(f"{n} {run} {json.dumps(json.loads(got[-1]))}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
