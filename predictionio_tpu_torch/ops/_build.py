"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``predictionio_tpu_torch/csrc/<name>.cu`` has a plain C interface and
compiles with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/torch_kernels/`` at the repository root (git-ignored).  The
library's file name carries a digest of the source, of the ``csrc/``
headers it includes (``topk_select.cuh``) and of the flags, so an edited
source or header rebuilds and an unchanged one is reused.  A build takes
seconds: no source includes PyTorch's headers.  Each build also keeps
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) next
to the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "library_path",
           "build", "load"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> Dict[str, Path]:
    """Every kernel source in the package (``csrc/*.cu``), by name."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the port's CUDA kernels are built from source at "
                       "first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _local_headers(src: Path) -> List[Path]:
    """The headers under ``csrc/`` that ``src`` includes (``#include
    "..."``), directly or through another such header, in include order."""
    found: List[Path] = []
    todo = [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_bytes()):
            path = CSRC_DIR / name.decode()
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives: its file name carries a
    digest of the source, every local header it includes, and the
    flags, so an edited header rebuilds each source that uses it."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for header in _local_headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the wall
    seconds each build took (0.0 for a library already built).  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib
