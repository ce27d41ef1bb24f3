"""The same ALS train at the MovieLens-25M shape, run several times on the
card: are the factors bit for bit equal, and what does an iteration cost?

    python -m predictionio_tpu_torch.tools.exp_als_repeat [runs]

Buckets ``exp_gram_calls.ml25m_ratings`` once (rank 64, reg 0.01, 10
iterations, ``solver="auto"``: K1 and K2), trains ``runs`` times (default
3) from the same inputs after one warm-up iteration, and prints one JSON
line: each run's ms/iter, whether each run's factors are
``torch.equal`` to the first run's and the largest difference, the
number of split-bucket chunks (the sweep's segment sums), and the card's
name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.tools import require_cuda
from predictionio_tpu_torch.tools.exp_gram_calls import (
    ITEMS,
    USERS,
    ml25m_ratings,
)

ITERATIONS = 10


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else 3
    dev = require_cuda()
    from predictionio_tpu_torch.device import set_float32_precision
    from predictionio_tpu_torch.ops import _build

    _build.build()
    set_float32_precision()
    users, items, ratings = ml25m_ratings(0)
    cfg = als.ALSConfig(rank=64, iterations=ITERATIONS, reg=0.01,
                        solver="auto", seed=0)
    inputs = als.prepare_als_inputs(users, items, ratings, USERS, ITEMS,
                                    cfg, device=dev)
    als.train_als_prepared(inputs, dataclasses.replace(cfg, iterations=1))
    models, ms_iter = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models.append(als.train_als_prepared(inputs, cfg))
        ms_iter.append((time.perf_counter() - t0) * 1e3 / ITERATIONS)
    first = models[0]
    equal, max_diff = [], []
    for m in models[1:]:
        pairs = ((torch.from_numpy(m.user_factors),
                  torch.from_numpy(first.user_factors)),
                 (torch.from_numpy(m.item_factors),
                  torch.from_numpy(first.item_factors)))
        equal.append(all(torch.equal(a, b) for a, b in pairs))
        max_diff.append(max(float((a - b).abs().max()) for a, b in pairs))
    print(json.dumps({
        "runs": runs, "iterations": ITERATIONS, "rank": 64,
        "ms_iter": ms_iter,
        "equal_to_first": equal, "max_abs_diff_to_first": max_diff,
        "split_chunks": sum(c.kind == "merged"
                            for c in inputs.user_buckets
                            + inputs.item_buckets),
        "card": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
