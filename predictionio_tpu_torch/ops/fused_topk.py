"""Fused corpus score + top-k (kernel K3) — the chunked exact rung's kernel.

Port of ``fused_topk_pallas`` / ``fused_topk`` in
``predictionio_tpu/ops/pallas_kernels.py``.  Three functions:

- :func:`fused_topk_reference` — the plain PyTorch version (``matmul`` +
  mask + ``torch.topk``); it materializes the [B, N] score block.
- :func:`fused_topk_cuda` — launches the hand-written CUDA kernel
  (``predictionio_tpu_torch/csrc/fused_topk.cu``), which never writes the
  score block: one read of the corpus plus O(B·chunks·k) scratch.
- :func:`fused_topk` — the dispatcher: CPU tensors take the reference,
  CUDA tensors take the kernel or raise.  There is no fallback.

``LAUNCHES`` counts kernel launches (one per :func:`fused_topk_cuda`
call), so a run can show that its serving path went through the kernel.

Ties: the kernel ranks the lower item id first among exactly equal
scores; the Pallas kernel keeps the lowest running slot and
``torch.topk`` promises no order, so callers compare id sets where
scores tie.  Slots the corpus cannot fill (fewer than k rows below
``n_valid``) hold score ``NEG_INF``: the kernel gives them id -1, the
reference the id of a masked row.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.topk import NEG_INF

__all__ = ["fused_topk", "fused_topk_cuda", "fused_topk_reference",
           "plan", "Plan", "LAUNCHES"]

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

# Launch geometry; csrc/fused_topk.cu holds the same thread and query
# counts as kThreads / kMaxQ.
THREADS = 256                 # threads per block = corpus rows per tile
MAX_QUERIES_PER_BLOCK = 8
SMEM_BUDGET = 200 * 1024      # dynamic shared memory a block may take
TARGET_BLOCKS = 264           # two waves over the H100's 132 SMs
MAX_CANDIDATES = 1 << 17      # per query, handed to the merge pass
MIN_ROWS_PER_CHUNK = 2 * THREADS

_CAND_BYTES = 8               # (float score, int id)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch plan of one call: ``queries_per_block`` queries share a
    score-pass block; each query keeps a ``buffer``-slot shared-memory
    candidate buffer; the corpus splits into ``n_chunks`` ranges of
    ``rows_per_chunk`` rows, and the merge pass reads ``n_chunks·k``
    candidates per query."""

    queries_per_block: int
    buffer: int
    n_chunks: int
    rows_per_chunk: int


def plan(b: int, n_real: int, d: int, k: int) -> Plan:
    """Grid and buffer sizes for ``b`` queries of width ``d`` against
    ``n_real`` scored corpus rows.  Raises ``ValueError`` when one
    query's buffer cannot fit the shared-memory budget (k near 25,000)."""
    if b < 1 or d < 1 or k < 1:
        raise ValueError(f"fused_topk plan needs b, d, k >= 1 "
                         f"(got b={b}, d={d}, k={k})")
    buffer = 1 << (k + THREADS - 1).bit_length()
    per_query = buffer * _CAND_BYTES + d * 4
    qb = min(MAX_QUERIES_PER_BLOCK, b, SMEM_BUDGET // per_query)
    if qb < 1:
        raise ValueError(f"fused_topk: k={k} at d={d} needs {per_query} "
                         f"bytes of shared memory per query, over the "
                         f"{SMEM_BUDGET}-byte budget")
    groups = -(-b // qb)
    n_chunks = min(-(-TARGET_BLOCKS // groups),
                   max(1, MAX_CANDIDATES // k),
                   max(1, -(-n_real // MIN_ROWS_PER_CHUNK)))
    rows = -(-max(n_real, 1) // n_chunks)
    rows = -(-rows // THREADS) * THREADS
    return Plan(queries_per_block=qb, buffer=buffer,
                n_chunks=max(1, -(-n_real // rows)), rows_per_chunk=rows)


def fused_topk_reference(queries: torch.Tensor, items: torch.Tensor, k: int,
                         *, n_valid: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: float32 scores, rows at or past ``n_valid``
    set to ``NEG_INF``, ``torch.topk``.  ``1 <= k <= N``."""
    scores = queries.float() @ items.float().T
    n = items.shape[0]
    if n_valid is not None and n_valid < n:
        scores[:, max(n_valid, 0):] = NEG_INF
    s, i = torch.topk(scores, k, dim=1)
    return s, i.to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_topk")
    fn = lib.pio_fused_topk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_topk_cuda(queries: torch.Tensor, items: torch.Tensor, k: int, *,
                    n_valid: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``queries`` [B, D] and ``items`` [N, D],
    both contiguous float32 on one CUDA device, ``1 <= k <= N``.
    Returns ([B, k] float32 descending, [B, k] int32) on that device,
    queued on PyTorch's current stream."""
    global LAUNCHES
    if queries.device.type != "cuda" or items.device != queries.device:
        raise ValueError(f"fused_topk_cuda needs both tensors on one CUDA "
                         f"device (got {queries.device} and {items.device})")
    if queries.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError(f"fused_topk_cuda takes float32 (got "
                        f"{queries.dtype} and {items.dtype})")
    if queries.dim() != 2 or items.dim() != 2 \
            or queries.shape[1] != items.shape[1]:
        raise ValueError(f"fused_topk_cuda needs [B, D] and [N, D] (got "
                         f"{tuple(queries.shape)} and {tuple(items.shape)})")
    if not (queries.is_contiguous() and items.is_contiguous()):
        raise ValueError("fused_topk_cuda needs contiguous tensors")
    b, d = queries.shape
    n = items.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"fused_topk_cuda: k={k} outside [1, {n}]")
    n_real = n if n_valid is None else max(0, min(n_valid, n))
    p = plan(b, n_real, d, k)
    if p.n_chunks * p.rows_per_chunk + THREADS >= 2 ** 31:
        # the kernel walks corpus rows with int32 indices
        raise ValueError(f"fused_topk_cuda: N={n} is too large")
    dev = queries.device
    part_s = torch.empty((b, p.n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, p.n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    vec4 = int(d % 4 == 0 and items.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_fused_topk(
            queries.data_ptr(), items.data_ptr(), b, d, n_real, k, p.buffer,
            p.queries_per_block, p.rows_per_chunk, p.n_chunks, vec4,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: "
                           f"{lib.pio_cuda_error_string(rc).decode()} "
                           f"(code {rc}, B={b}, N={n}, D={d}, k={k})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out_s, out_i


def fused_topk(queries: torch.Tensor, items: torch.Tensor, k: int, *,
               n_valid: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by device, mirroring the reference dispatcher's contract:
    ``k <= 0`` gives empty [B, 0] outputs and ``k`` is clamped to N.
    CPU tensors take :func:`fused_topk_reference`; anything else goes to
    :func:`fused_topk_cuda`, which launches the kernel or raises."""
    b = queries.shape[0]
    if k <= 0:
        return (torch.zeros((b, 0), dtype=torch.float32,
                            device=queries.device),
                torch.zeros((b, 0), dtype=torch.int32,
                            device=queries.device))
    k = min(k, items.shape[0])
    if queries.device.type == "cpu" and items.device.type == "cpu":
        return fused_topk_reference(queries, items, k, n_valid=n_valid)
    return fused_topk_cuda(queries, items, k, n_valid=n_valid)
