"""Fused gather + weighted Gram (kernel K1) — the ALS normal-equation build.

Port of ``fused_gram_vector_pallas`` / ``fused_gram_vector_xla`` in
``predictionio_tpu/ops/pallas_kernels.py``.  For each solve row ``r`` of
a bucket, with ``f_l = factors[indices[r, l]]``::

    A[r] = Σ_l w[r,l] · f_l f_lᵀ        b[r] = Σ_l c[r,l] · f_l

Where the reference gathers ``factors[indices]`` into an [R, L, K] block
and hands that to its kernel, the port's functions take the factor matrix
and the indices and gather themselves.  Three functions:

- :func:`fused_gram_vector_reference` — the plain PyTorch version: the
  gather, then the reference's two float32 einsums.
- :func:`fused_gram_vector_cuda` — launches the hand-written CUDA kernel
  (``predictionio_tpu_torch/csrc/fused_gram.cu``), which gathers inside
  and never writes the [R, L, K] block.
- :func:`fused_gram_vector` — the dispatcher: CPU tensors take the
  reference, CUDA tensors take the kernel or raise.  There is no fallback.

A fourth, :func:`fused_gram_vector_library`, is not K1: it is the
reference's other route, ``fused_gram_vector_xla``, which the reference
trains through where it runs no kernel (a rank above ``fits_vmem``'s 256,
or ``use_pallas=False``): the gather, then the two float32 contractions
as library calls, on whatever device the tensors lie.  ALS chooses it by
rank and ``use_pallas`` alone (``models.als._resolve_loop_statics``),
never because K1 failed to build or launch.

``LAUNCHES`` counts kernel launches (one per :func:`fused_gram_vector_cuda`
call that launches), so a run can show its training sweep went through
the kernel.

Kernel T1, the port of ``pallas_vmem_gather_gram`` in
``tools/exp_gram.py`` (``A[r] = Σ_l w[r,l] · y_l y_lᵀ`` with ``y_l =
y[idx[r, l]]``: K1's ``A`` without ``b``), lives here too:
:func:`gather_gram_reference` (the gather, then
``einsum("blk,bl,blm->bkm")``), :func:`gather_gram_cuda` (K1's kernel
compiled without ``b``, entry ``pio_gather_gram`` of the same source) and
the dispatcher :func:`gather_gram`.  Its launches count in
``GATHER_GRAM_LAUNCHES``, apart from K1's, so the training path's count
stays K1's alone.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from predictionio_tpu_torch.ops import _build

__all__ = ["fused_gram_vector", "fused_gram_vector_cuda",
           "fused_gram_vector_library", "fused_gram_vector_reference",
           "gather_gram", "gather_gram_cuda",
           "gather_gram_reference", "supports", "MAX_RANK", "LAUNCHES",
           "GATHER_GRAM_LAUNCHES"]

LAUNCHES = 0               # K1
GATHER_GRAM_LAUNCHES = 0   # T1
_LAUNCHES_LOCK = threading.Lock()

MAX_RANK = 256   # csrc/fused_gram.cu kMaxK (band_gram_kernel above 128)


def supports(k: int) -> bool:
    """Whether the kernel takes rank ``k``: the ranks of the reference's
    ``fits_vmem`` (``k <= 256``; only the rank bounds the working set)."""
    return 1 <= k <= MAX_RANK


def fused_gram_vector_reference(factors: torch.Tensor, indices: torch.Tensor,
                                w: torch.Tensor, c: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather ``factors[indices]`` → [R, L, K]
    float32, then ``A = einsum(f, w, f)`` and ``b = einsum(f, c)``."""
    r, l = indices.shape
    f = factors.index_select(0, indices.reshape(-1)).reshape(r, l, -1).float()
    a = torch.einsum("blk,bl,blm->bkm", f, w.float(), f)
    b = torch.einsum("blk,bl->bk", f, c.float())
    return a, b


def fused_gram_vector_library(factors: torch.Tensor, indices: torch.Tensor,
                              w: torch.Tensor, c: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``fused_gram_vector_xla`` route: gather
    ``factors[indices]`` → [R, L, K] float32, then ``A = (f·w)ᵀ f`` and
    ``b = fᵀ c`` as two float32 ``torch.bmm`` calls, on the tensors' own
    device.  Any rank; launches no kernel of the port and counts
    nothing."""
    r, l = indices.shape
    f = factors.index_select(0, indices.reshape(-1)).reshape(r, l, -1).float()
    ft = f.transpose(1, 2)
    a = torch.bmm(ft * w.float().unsqueeze(1), f)
    b = torch.bmm(ft, c.float().unsqueeze(2)).squeeze(2)
    return a, b


def gather_gram_reference(factors: torch.Tensor, indices: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """T1's plain PyTorch version: gather ``factors[indices]`` → [R, L, K]
    float32, then ``A = einsum("blk,bl,blm->bkm")``."""
    r, l = indices.shape
    f = factors.index_select(0, indices.reshape(-1)).reshape(r, l, -1).float()
    return torch.einsum("blk,bl,blm->bkm", f, w.float(), f)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_gram")
    fn = lib.pio_fused_gram
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        lib.pio_gather_gram.argtypes = [p, i, p, p, i, i, i, p, p]
        lib.pio_gather_gram.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, factors: torch.Tensor, indices: torch.Tensor,
           *weights: torch.Tensor) -> None:
    """Raise unless the kernel takes these tensors: float32/bfloat16
    [N, K] factors with K <= MAX_RANK, int32 [R, L] indices and float32
    [R, L] weights, all contiguous on one CUDA device."""
    ts = (factors, indices, *weights)

    def got(attr):
        return ", ".join(str(attr(t)) for t in ts)

    if factors.device.type != "cuda" \
            or any(t.device != factors.device for t in ts):
        raise ValueError(f"{name} needs every tensor on one CUDA device "
                         f"(got {got(lambda t: t.device)})")
    if factors.dtype not in (torch.float32, torch.bfloat16) \
            or indices.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in weights):
        raise TypeError(f"{name} takes float32/bfloat16 factors, int32 "
                        f"indices and float32 weights "
                        f"(got {got(lambda t: t.dtype)})")
    if factors.dim() != 2 or indices.dim() != 2 \
            or any(t.shape != indices.shape for t in weights):
        raise ValueError(f"{name} needs [N, K] factors and [R, L] indices "
                         f"and weights (got {got(lambda t: tuple(t.shape))})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous tensors")
    if not supports(factors.shape[1]):
        raise ValueError(f"{name}: rank {factors.shape[1]} outside "
                         f"[1, {MAX_RANK}]")


def fused_gram_vector_cuda(factors: torch.Tensor, indices: torch.Tensor,
                           w: torch.Tensor, c: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``factors`` [N, K] float32 or bfloat16,
    ``indices`` [R, L] int32 in [0, N), ``w`` and ``c`` [R, L] float32,
    all contiguous on one CUDA device, ``K <= MAX_RANK``.  Returns
    (A [R, K, K], b [R, K]) float32 on that device, queued on PyTorch's
    current stream."""
    global LAUNCHES
    _check("fused_gram_vector_cuda", factors, indices, w, c)
    dev = factors.device
    r, l = indices.shape
    k = factors.shape[1]
    a = torch.empty((r, k, k), dtype=torch.float32, device=dev)
    b = torch.empty((r, k), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_fused_gram(
            factors.data_ptr(), int(factors.dtype == torch.bfloat16),
            indices.data_ptr(), w.data_ptr(), c.data_ptr(), r, l, k,
            a.data_ptr(), b.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_gram kernel launch failed: "
                           f"{lib.pio_cuda_error_string(rc).decode()} "
                           f"(code {rc}, R={r}, L={l}, K={k})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return a, b


def fused_gram_vector(factors: torch.Tensor, indices: torch.Tensor,
                      w: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by device: CPU tensors take
    :func:`fused_gram_vector_reference`; anything else goes to
    :func:`fused_gram_vector_cuda`, which launches the kernel or raises."""
    if all(t.device.type == "cpu" for t in (factors, indices, w, c)):
        return fused_gram_vector_reference(factors, indices, w, c)
    return fused_gram_vector_cuda(factors, indices, w, c)


def gather_gram_cuda(factors: torch.Tensor, indices: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Launch kernel T1: ``factors`` [N, K] float32 or bfloat16,
    ``indices`` [R, L] int32 in [0, N), ``w`` [R, L] float32, all
    contiguous on one CUDA device, ``K <= MAX_RANK``.  Returns A [R, K, K]
    float32 on that device, queued on PyTorch's current stream."""
    global GATHER_GRAM_LAUNCHES
    _check("gather_gram_cuda", factors, indices, w)
    dev = factors.device
    r, l = indices.shape
    k = factors.shape[1]
    a = torch.empty((r, k, k), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_gather_gram(
            factors.data_ptr(), int(factors.dtype == torch.bfloat16),
            indices.data_ptr(), w.data_ptr(), r, l, k, a.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_gram kernel launch failed: "
                           f"{lib.pio_cuda_error_string(rc).decode()} "
                           f"(code {rc}, R={r}, L={l}, K={k})")
    with _LAUNCHES_LOCK:
        GATHER_GRAM_LAUNCHES += 1
    return a


def gather_gram(factors: torch.Tensor, indices: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Dispatch T1 by device: CPU tensors take
    :func:`gather_gram_reference`; anything else goes to
    :func:`gather_gram_cuda`, which launches the kernel or raises."""
    if all(t.device.type == "cpu" for t in (factors, indices, w)):
        return gather_gram_reference(factors, indices, w)
    return gather_gram_cuda(factors, indices, w)
