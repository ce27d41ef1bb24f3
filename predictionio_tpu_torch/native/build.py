"""Compile-at-first-use loader for the port's C++ components.

Port of ``predictionio_tpu/native/build.py``.  Each source is the port's
own copy under this package (``predictionio_tpu_torch/native/<name>.cc``);
``g++ -O2 -shared`` builds it into ``build/torch_native/`` at the
repository root (git-ignored), under a file name that carries a digest of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  Plain ``extern "C"`` + ctypes: no PyTorch headers, so a
build takes seconds.

The build is safe for many processes starting at once (a test run's
workers, two servers deployed side by side):

- the compiler writes a temporary file in the same directory, which
  ``os.replace`` then moves onto the library's name, so no process ever
  sees a half-written library;
- an ``fcntl`` lock on ``<library>.lock`` beside it is held while one
  process builds; the others wait on it, then find the library built;
- a library is ``dlopen``\\ ed only once it exists under its final name;
- a failed build raises ``RuntimeError`` carrying the compiler's stderr,
  never returns None.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["SOURCE_DIR", "BUILD_DIR", "CXX_FLAGS", "source_path",
           "library_path", "compile_command", "load_library"]

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
BUILD_TIMEOUT_S = 300

_cache: Dict[Tuple[str, str], ctypes.CDLL] = {}
_lock = threading.Lock()


def source_path(name: str) -> Path:
    """``predictionio_tpu_torch/native/<name>.cc``; raises when absent."""
    src = SOURCE_DIR / f"{name}.cc"
    if not src.is_file():
        raise RuntimeError(f"native source {src} missing")
    return src


def library_path(name: str, build_dir: Optional[Path] = None) -> Path:
    """Where the library of ``name`` lives: its file name carries a digest
    of the source and the flags."""
    h = hashlib.sha1(source_path(name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"lib{name}-{h.hexdigest()[:12]}.so"


def compile_command(name: str, out: Path) -> List[str]:
    """The one ``g++`` call that builds ``name`` into ``out``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the port's native "
                           "frontend is built from source at first use")
    return [cxx, *CXX_FLAGS, str(source_path(name)), "-o", str(out)]


def _build(name: str, out: Path) -> None:
    """Build ``out`` unless another process already has; the caller holds
    no lock — the file lock below serializes the builders."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return  # built by another process while we waited
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = compile_command(name, tmp)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ timed out building {name}.cc after "
                    f"{BUILD_TIMEOUT_S} s") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed for {name}.cc (exit {proc.returncode}):\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_library(name: str, build_dir: Optional[Path] = None
                 ) -> ctypes.CDLL:
    """Load ``name``'s library, building it first if needed; raises
    ``RuntimeError`` (with the compiler's message) when it cannot."""
    out = library_path(name, build_dir)
    key = (name, str(out))
    with _lock:
        lib = _cache.get(key)
        if lib is None:
            if not out.exists():
                _build(name, out)
            lib = ctypes.CDLL(str(out))
            _cache[key] = lib
        return lib
