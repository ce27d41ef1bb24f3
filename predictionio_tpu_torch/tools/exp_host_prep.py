"""The host route's ALS prep at the MovieLens-25M shape, on the card.

    python predictionio_tpu_torch/tools/exp_host_prep.py [runs]

Buckets ``exp_gram_calls.ml25m_ratings`` on the host and stages the
chunks on the card (``prepare_als_inputs`` with ``device_prep=False``,
rank 64), ``runs`` times (default 1), and prints one JSON line: each
prep's seconds (synchronized) and, within it, each side's bucketing
(``bucket_by_length``) and staging (``_device_buckets``, synchronized)
seconds, the chunks a side, whether the staging
rode the prefetcher (a ``pio_prefetch_*`` sample for ``model="als"``),
which package was timed, and the card's name and power limit.  Run as a
file with ``PYTHONPATH`` naming another checkout's root, it times that
checkout's package: how two versions are compared in one call.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else 1
    import torch

    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.obs import get_registry
    from predictionio_tpu_torch.tools.exp_gram_calls import (
        ITEMS,
        USERS,
        ml25m_ratings,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("this tool times the card and CUDA is not "
                           "available")
    dev = torch.device("cuda")
    users, items, ratings = ml25m_ratings(0)
    cfg = als.ALSConfig(rank=64, iterations=10, reg=0.01, seed=0,
                        device_prep=False)
    torch.zeros(1, device=dev)
    steps = {"bucket": [], "stage": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            steps[name].append(time.perf_counter() - t0)
            return out
        return run

    als.bucket_by_length = timed("bucket", als.bucket_by_length)
    als._device_buckets = timed("stage", als._device_buckets)
    seconds, chunks = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = als.prepare_als_inputs(users, items, ratings, USERS, ITEMS,
                                        cfg, device=dev)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        chunks = [len(inputs.user_buckets), len(inputs.item_buckets)]
        del inputs
    prefetch = any(line.startswith("pio_prefetch_") and 'model="als"' in line
                   for line in get_registry().render().splitlines())
    print(json.dumps({
        "host_prep_s": seconds, "bucket_s": steps["bucket"],
        "stage_s": steps["stage"], "chunks": chunks,
        "staged_through_prefetcher": prefetch, "package": als.__file__,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
