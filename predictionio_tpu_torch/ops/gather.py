"""Row gather + sum (kernel T2) — the gather experiment of ``tools/exp_gather2.py``.

Port of ``pallas_gather`` in ``tools/exp_gather2.py``, whose modes
``take``, ``loop8`` and ``loop`` are three TPU spellings of one function,
``out[r] = Σ_l y[idx[r, l]]`` for ``idx`` [R, L] int32 and ``y`` [I, K]
float32.  Three functions:

- :func:`gather_sum_reference` — the plain PyTorch version:
  ``index_select``, view [R, L, K], ``sum(1)``.
- :func:`gather_sum_cuda` — launches the hand-written CUDA kernel
  (``predictionio_tpu_torch/csrc/gather_sum.cu``), float32 sums in
  registers; the [R, L, K] block never exists.  Two designs: ``"vec4"``
  (K % 4 == 0, K <= 128: a group of lanes a row, a float4 a lane, the
  indices read as int4s by every lane of the group, four row loads in
  flight) and ``"warp"`` (any K: one warp a row, indices broadcast by
  warp shuffles).  Both add each column's terms in l order and give the
  same bits; the wrapper takes ``"vec4"`` where it applies.
- :func:`gather_sum` — the dispatcher: CPU tensors take the reference,
  CUDA tensors take the kernel or raise.  There is no fallback.

``LAUNCHES`` counts kernel launches (one per :func:`gather_sum_cuda`
call).  The kernel adds each row's L terms one after another; the plain
version's ``sum`` adds them in another order.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from predictionio_tpu_torch.ops import _build

__all__ = ["gather_sum", "gather_sum_cuda", "gather_sum_reference",
           "design_for", "DESIGNS", "LAUNCHES"]

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()
DESIGNS = ("warp", "vec4")     # csrc/gather_sum.cu design 0 and 1


def gather_sum_reference(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``y[idx]`` → [R, L, K], summed over L in
    float32."""
    r, l = idx.shape
    g = y.index_select(0, idx.reshape(-1).long()).reshape(r, l, -1)
    return g.float().sum(1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a library built from csrc/gather_sum.cu
    (the package's, or a tool's edited copy)."""
    fn = lib.pio_gather_sum
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
    return lib


def design_for(k: int, y_ptr: int) -> str:
    """The design the wrapper takes for rows of ``k`` floats at address
    ``y_ptr``: ``"vec4"`` for whole, 16-byte aligned float4 rows of at
    most 128 floats, else ``"warp"``."""
    return "vec4" if k % 4 == 0 and k <= 128 and y_ptr % 16 == 0 else "warp"


def gather_sum_cuda(y: torch.Tensor, idx: torch.Tensor, *,
                    design: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel: ``y`` [I, K] float32 and ``idx`` [R, L]
    int32 in [0, I), both contiguous on one CUDA device.  Returns [R, K]
    float32 on that device, queued on PyTorch's current stream.
    ``design`` (one of ``DESIGNS``) forces a design, to time one against
    the other; by default :func:`design_for` picks."""
    global LAUNCHES
    dev = y.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"gather_sum_cuda needs both tensors on one CUDA "
                         f"device (got {y.device} and {idx.device})")
    if y.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_sum_cuda takes float32 rows and int32 "
                        f"indices (got {y.dtype} and {idx.dtype})")
    if y.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"gather_sum_cuda needs [I, K] rows and [R, L] "
                         f"indices (got {tuple(y.shape)} and "
                         f"{tuple(idx.shape)})")
    if not (y.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_sum_cuda needs contiguous tensors")
    if y.data_ptr() % 8:
        raise ValueError("gather_sum_cuda needs 8-byte aligned rows")
    r, l = idx.shape
    k = y.shape[1]
    design = design or design_for(k, y.data_ptr())
    if design not in DESIGNS or (design == "vec4" and
                                 design_for(k, y.data_ptr()) != "vec4"):
        raise ValueError(f"gather_sum_cuda: design {design!r} does not take "
                         f"K={k} rows at this alignment")
    out = torch.empty((r, k), dtype=torch.float32, device=dev)
    lib = bind(_build.load("gather_sum"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_gather_sum(y.data_ptr(), idx.data_ptr(), r, l, k,
                                DESIGNS.index(design), out.data_ptr(),
                                stream)
    if rc != 0:
        raise RuntimeError(f"gather_sum kernel launch failed: "
                           f"{lib.pio_cuda_error_string(rc).decode()} "
                           f"(code {rc}, R={r}, L={l}, K={k})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out


def gather_sum(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: CPU tensors take :func:`gather_sum_reference`;
    anything else goes to :func:`gather_sum_cuda`, which launches the
    kernel or raises."""
    if y.device.type == "cpu" and idx.device.type == "cpu":
        return gather_sum_reference(y, idx)
    return gather_sum_cuda(y, idx)
