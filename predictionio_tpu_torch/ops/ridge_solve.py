"""Batched SPD ridge solves (kernels K2 and K4) for the ALS sweep.

Port of ``ridge_solve_lu_pallas`` (K2, shrinking elimination) and
``ridge_solve_gj_pallas`` (K4, Gauss-Jordan) in
``predictionio_tpu/ops/pallas_kernels.py``.  Both solve
``(A + diag(reg)) x = b`` for ``A [B, K, K]``, ``b [B, K]``, ``reg [B]``
in float32 without pivoting (ALS-WR makes every system SPD).  Per method:

- ``ridge_solve_*_reference`` — the plain PyTorch version: the same
  elimination, one batched step per pivot.
- :func:`ridge_solve_cuda` — launches the hand-written CUDA kernels
  (``predictionio_tpu_torch/csrc/ridge_solve.cu``, one source for all).
  K2 on the card is a Cholesky factorisation with the system in
  registers up to rank ``REG_MAX_RANK`` (64; one thread per system to
  rank 16, one warp per system above), and an elimination in shared
  memory at ranks 65-128.  Up to rank 64 it reads only the lower
  triangle of A, so A must be symmetric (K1 writes it so).  K4 is
  Gauss-Jordan with the system in registers up to rank 64 too (one
  thread per system to rank ``GJ_THREAD_MAX_RANK``, 12; one warp per
  system above) and in shared memory at ranks 65-128; it reads all of A
  and solves A as it is given, symmetric or not.
- :func:`ridge_solve_lu` / :func:`ridge_solve_gj` — the dispatchers: CPU
  tensors take the reference, CUDA tensors take the kernel or raise.
  There is no fallback.

``LU_LAUNCHES`` and ``GJ_LAUNCHES`` count kernel launches per method.
``KERNEL_LAUNCHES`` counts them by the kernel the library reports it
launched: for K2 ``"chol_thread"`` (one thread a system), ``"chol_warp"``
(one warp a system) and ``"lu_shared"`` (the shared-memory LU); for K4
``"gj_thread"``, ``"gj_warp"`` and ``"gj_shared"``.
The methods ``"lu_shared"``, ``"chol_warp"`` and ``"chol_thread16"``
force one of K2's designs whatever the rank, only so that the tools
time the designs on the same calls.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from predictionio_tpu_torch.ops import _build

__all__ = ["ridge_solve_lu", "ridge_solve_gj", "ridge_solve_cuda",
           "ridge_solve_lu_reference", "ridge_solve_gj_reference",
           "supports", "solve_flops", "solve_cost", "MAX_RANK",
           "REG_MAX_RANK", "GJ_THREAD_MAX_RANK", "LU_LAUNCHES",
           "GJ_LAUNCHES", "KERNEL_LAUNCHES"]

LU_LAUNCHES = 0
GJ_LAUNCHES = 0
_KERNELS = {2: "lu_shared", 3: "chol_warp", 4: "chol_thread",
            5: "gj_shared", 6: "gj_warp", 7: "gj_thread"}
KERNEL_LAUNCHES = dict.fromkeys(_KERNELS.values(), 0)
_LAUNCHES_LOCK = threading.Lock()

MAX_RANK = 128          # csrc/ridge_solve.cu kMaxK
REG_MAX_RANK = 64       # csrc/ridge_solve.cu kRegMaxK: K2 and K4 in
                        # registers
GJ_THREAD_MAX_RANK = 12  # kGJThreadMaxK: K4 one thread a system
_METHODS = {"lu": 0, "gj": 1, "lu_shared": 2, "chol_warp": 3,
            "chol_thread16": 4}
_SECTOR = 32            # bytes the memory moves at a time


def supports(k: int) -> bool:
    """Whether the kernels take rank ``k`` (the counterpart of the
    reference's ``gj_fits_vmem``)."""
    return 1 <= k <= MAX_RANK


def solve_flops(k: int, method: str) -> int:
    """Floating-point operations the kernel spends on one rank-``k``
    system (a reciprocal, multiply or fused multiply-add counts its
    arithmetic: 1, 1 and 2)."""
    if method == "lu":
        fwd = sum(1 + (k - j) * (1 + 2 * (k - 1 - j)) for j in range(k))
        back = sum(2 + 2 * j for j in range(k))
        return fwd + back
    if method == "gj":
        return sum(1 + (k - j) * (1 + 2 * (k - 1)) for j in range(k))
    if method == "cholesky":
        # pivot j: square root, reciprocal, y_j; column j scaled, y below
        # it updated, the trailing triangle updated; then Lᵀ x = y
        fwd = sum(3 + 3 * (k - 1 - j) + (k - 1 - j) * (k - j)
                  for j in range(k))
        back = sum(1 + 2 * j for j in range(k))
        return fwd + back
    raise ValueError(f"unknown method {method!r}; use 'lu', 'gj' or "
                     f"'cholesky'")


def _lower_triangle_sectors(n: int, k: int) -> int:
    """32-byte sectors holding the lower triangles (diagonal included) of
    ``n`` contiguous float32 ``k x k`` matrices whose first starts on a
    sector.  The layout repeats every ``period`` matrices."""
    per_sector = _SECTOR // 4
    period = per_sector // math.gcd(k * k, per_sector)

    def sectors(m: int) -> int:
        i, j = (t.reshape(-1) for t in torch.tril_indices(k, k))
        flat = (torch.arange(m)[:, None] * (k * k) + (i * k + j)[None, :])
        return int(torch.unique(flat // per_sector).numel()) if m else 0

    return n // period * sectors(period) + sectors(n % period)


def solve_cost(n: int, k: int, method: str) -> Tuple[int, int]:
    """(bytes, flops) that ``n`` rank-``k`` systems need at least: b and
    reg read, x written, and A read; flops per :func:`solve_flops`.  K2
    ("lu") up to ``REG_MAX_RANK`` reads only A's lower triangle, counted
    in the 32-byte sectors that hold it, and does the Cholesky count;
    above that rank, and for K4 ("gj"), all of A and the method's own
    count."""
    vectors = n * (2 * k + 1) * 4
    if method == "lu" and k <= REG_MAX_RANK:
        return (_lower_triangle_sectors(n, k) * _SECTOR + vectors,
                n * solve_flops(k, "cholesky"))
    return n * k * k * 4 + vectors, n * solve_flops(k, method)


def _augmented(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor):
    m = a.float().clone()
    m.diagonal(dim1=1, dim2=2).add_(reg.float()[:, None])
    return m, b.float().clone()


def ridge_solve_lu_reference(a: torch.Tensor, b: torch.Tensor,
                             reg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: shrinking forward elimination (rows below the
    pivot only), then back substitution."""
    m, v = _augmented(a, b, reg)
    k = m.shape[-1]
    for j in range(k):
        inv = 1.0 / m[:, j, j]
        row_n = m[:, j, j + 1:] * inv[:, None]
        bj = v[:, j] * inv
        col = m[:, j + 1:, j]
        m[:, j + 1:, j + 1:] -= col[:, :, None] * row_n[:, None, :]
        v[:, j + 1:] -= col * bj[:, None]
    x = torch.empty_like(v)
    for j in range(k - 1, -1, -1):
        xj = v[:, j] * (1.0 / m[:, j, j])
        x[:, j] = xj
        v[:, :j] -= m[:, :j, j] * xj[:, None]
    return x


def ridge_solve_gj_reference(a: torch.Tensor, b: torch.Tensor,
                             reg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4: Gauss-Jordan, pivot row normalised, every other
    row eliminated; x is the final right-hand side."""
    m, v = _augmented(a, b, reg)
    k = m.shape[-1]
    for j in range(k):
        inv = 1.0 / m[:, j, j]
        row_n = m[:, j, j + 1:] * inv[:, None]
        bj = v[:, j] * inv
        col = m[:, :, j].clone()
        col[:, j] = 0.0
        m[:, :, j + 1:] -= col[:, :, None] * row_n[:, None, :]
        v -= col * bj[:, None]
        m[:, j, j + 1:] = row_n
        v[:, j] = bj
    return v


def _lib() -> ctypes.CDLL:
    lib = _build.load("ridge_solve")
    fn = lib.pio_ridge_solve
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, p, p, ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ridge_solve_cuda(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor,
                     method: str) -> torch.Tensor:
    """Launch a CUDA kernel: ``a`` [B, K, K], ``b`` [B, K], ``reg`` [B],
    float32, contiguous, on one CUDA device, ``K <= MAX_RANK``.  Returns
    x [B, K] float32 on that device, queued on PyTorch's current stream.

    ``method``: "lu" = K2 (Cholesky in registers to ``REG_MAX_RANK``,
    the shared-memory LU above it), "gj" = K4 (Gauss-Jordan in registers
    to ``REG_MAX_RANK``, in shared memory above it; reads all of A and
    takes A as it is, symmetric or not); for timing only, one of K2's
    designs at any rank it takes:
    "lu_shared" (the shared-memory LU), "chol_warp" (one warp a system,
    ``K <= REG_MAX_RANK``), "chol_thread16" (one thread a system, padded
    to rank 16, ``K <= 16``).  Up to ``REG_MAX_RANK`` "lu" reads only the lower triangle of A (on
    and below the diagonal) and solves the symmetric system it spans: A
    must be symmetric, as ALS's normal equations are (bitwise from K1;
    to float32 rounding after the split-row sums and + YᵀY)."""
    global LU_LAUNCHES, GJ_LAUNCHES
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; use one of "
                         f"{sorted(_METHODS)}")
    dev = a.device
    if dev.type != "cuda" or b.device != dev or reg.device != dev:
        raise ValueError(f"ridge_solve_cuda needs every tensor on one CUDA "
                         f"device (got {a.device}, {b.device}, "
                         f"{reg.device})")
    if any(t.dtype != torch.float32 for t in (a, b, reg)):
        raise TypeError(f"ridge_solve_cuda takes float32 (got {a.dtype}, "
                        f"{b.dtype}, {reg.dtype})")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or b.dim() != 2 \
            or b.shape != a.shape[:2] or reg.shape != a.shape[:1]:
        raise ValueError(f"ridge_solve_cuda needs [B, K, K], [B, K], [B] "
                         f"(got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(reg.shape)})")
    if not all(t.is_contiguous() for t in (a, b, reg)):
        raise ValueError("ridge_solve_cuda needs contiguous tensors")
    n, k = b.shape
    if not supports(k):
        raise ValueError(f"ridge_solve_cuda: rank {k} outside "
                         f"[1, {MAX_RANK}]")
    x = torch.empty((n, k), dtype=torch.float32, device=dev)
    lib = _lib()
    kernel = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_ridge_solve(_METHODS[method], a.data_ptr(),
                                 b.data_ptr(), reg.data_ptr(), n, k,
                                 x.data_ptr(), stream, ctypes.byref(kernel))
    if rc != 0:
        raise RuntimeError(f"ridge_solve ({method}) kernel launch failed: "
                           f"{lib.pio_cuda_error_string(rc).decode()} "
                           f"(code {rc}, B={n}, K={k})")
    with _LAUNCHES_LOCK:
        if method == "lu":
            LU_LAUNCHES += 1
        elif method == "gj":
            GJ_LAUNCHES += 1
        KERNEL_LAUNCHES[_KERNELS[kernel.value]] += 1
    return x


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def ridge_solve_lu(a: torch.Tensor, b: torch.Tensor,
                   reg: torch.Tensor) -> torch.Tensor:
    """K2 by device: CPU tensors take :func:`ridge_solve_lu_reference`,
    anything else the kernel or an exception."""
    if _on_cpu(a, b, reg):
        return ridge_solve_lu_reference(a, b, reg)
    return ridge_solve_cuda(a, b, reg, "lu")


def ridge_solve_gj(a: torch.Tensor, b: torch.Tensor,
                   reg: torch.Tensor) -> torch.Tensor:
    """K4 by device: CPU tensors take :func:`ridge_solve_gj_reference`,
    anything else the kernel or an exception."""
    if _on_cpu(a, b, reg):
        return ridge_solve_gj_reference(a, b, reg)
    return ridge_solve_cuda(a, b, reg, "gj")
