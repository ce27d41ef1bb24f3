"""Micro-experiments on the card, ports of the reference's ``tools/`` scratch
experiments.  Each runs as ``python -m predictionio_tpu_torch.tools.<name>
[section ...]``, needs an NVIDIA card, and builds its inputs inside
``main()``, never at import.  ``attribute_serve`` and
``attribute_quality`` are the exceptions: they read a server's outputs
(``/metrics``, ``PIO_REQUEST_LOG``, ``/quality.json``) on the host.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Callable, Dict, Mapping

import torch

from predictionio_tpu_torch.ops import _build

__all__ = ["cuda_ms", "edited_libraries", "require_cuda", "single_ms"]


def require_cuda() -> torch.device:
    """The CUDA card; raises when there is none (the tools time the card
    and have no CPU mode)."""
    if not torch.cuda.is_available():
        raise RuntimeError("this tool times kernels on an NVIDIA card and "
                           "CUDA is not available")
    return torch.device("cuda")


def cuda_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3
            ) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, between
    two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def single_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """Median device ms of single calls of ``fn``, each between its own
    CUDA events, after one warm-up call; a spin kernel queued ahead of
    each call hides the host's enqueue."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]


def edited_libraries(source: str, variants: Mapping[str, Mapping[str, str]],
                     report: str = "") -> Dict[str, ctypes.CDLL]:
    """Build and load variants of ``csrc/<source>.cu``: each an edited
    copy (``{old text: new}``, every ``old`` must occur) in the build
    directory, one ``nvcc`` each, all started together.  Prints each
    variant's ptxas registers and spills for the kernels whose mangled
    name contains ``report``.  Returns the loaded libraries by name; the
    caller sets their ``argtypes``.  The package's own sources stay as
    they are: this is how a tool times designs the package does not
    keep."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text0 = (_build.CSRC_DIR / f"{source}.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = text0
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"{source} variant {name}: {old!r} is not "
                                   f"in csrc/{source}.cu")
            text = text.replace(old, new)
        # beside the package's sources' build, so local headers resolve
        src = _build.BUILD_DIR / f"exp_{source}_{name}.cu"
        src.write_text(text)
        out = _build.BUILD_DIR / f"libexp_{source}_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} variant {name}:\n"
                               f"{log}")
        lines, kernel = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1] if "'" in ln else ln.strip()
            elif report in kernel and ("registers" in ln or "spill" in ln):
                lines.append(f"{kernel}: {ln.strip()}")
        print(f"{source} variant {name}: ptxas " + json.dumps(lines),
              flush=True)
        libs[name] = ctypes.CDLL(str(out))
    return libs
